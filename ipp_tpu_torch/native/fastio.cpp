// fastio — native IO runtime for ipp_tpu_torch (a copy of ipp_tpu/native/fastio.cpp).
//
// C++17 equivalents of the reference's native IO layer
// (LsDeconvolveMultiGPU/load_bl_tif.cpp: threaded ROI TIFF block loader;
// save_bl_tif.cpp: parallel TIFF series writer; save_lz4_mex.c /
// load_lz4_mex.c / load_slab_lz4.cpp: compressed brick cache), built for
// the TIFF subset this framework writes (classic+BigTIFF, grayscale
// u8/u16/u32/f32, strips, compression none/deflate/packbits) with zstd
// replacing LZ4 (zstd is what this image ships).
//
// Exposed as a C ABI consumed via ctypes (ipp_tpu_torch/native/__init__.py).
// Built on first use by ipp_tpu_torch/native/__init__.py (g++ -O3 -shared -fPIC ... -lz -lzstd).

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include <zlib.h>
#include <zstd.h>

namespace {

// ---------------------------------------------------------------------------
// minimal TIFF parsing (same subset as ipp_tpu_torch/io/tiff.py)
// ---------------------------------------------------------------------------

struct TiffPage {
  uint32_t width = 0, height = 0;
  uint16_t bits = 0, compression = 1, sample_format = 1, samples = 1;
  uint16_t predictor = 1;  // tag 317: 1=none, 2=horizontal differencing
  uint32_t rows_per_strip = 0;
  std::vector<uint64_t> strip_offsets;
  std::vector<uint64_t> strip_counts;
  bool little_endian = true;
};

struct FileBuf {
  FILE* f = nullptr;
  ~FileBuf() {
    if (f) fclose(f);
  }
};

template <typename T>
T rd(const uint8_t* p, bool le) {
  T v;
  std::memcpy(&v, p, sizeof(T));
  if (!le) {  // byteswap
    uint8_t* b = reinterpret_cast<uint8_t*>(&v);
    for (size_t i = 0; i < sizeof(T) / 2; ++i) std::swap(b[i], b[sizeof(T) - 1 - i]);
  }
  return v;
}

int type_size(uint16_t t) {
  switch (t) {
    case 1: case 2: case 6: case 7: return 1;
    case 3: case 8: return 2;
    case 4: case 9: case 11: return 4;
    case 5: case 10: case 12: case 16: case 17: case 18: return 8;
    default: return 1;
  }
}

uint64_t read_tag_value(FILE* f, const uint8_t* entry, bool le, bool big,
                        uint16_t typ, uint64_t count, uint64_t index) {
  int sz = type_size(typ);
  uint64_t total = sz * count;
  if (total > (1ull << 27)) return 0;  // corrupt count: cap allocations
  int inline_cap = big ? 8 : 4;
  const uint8_t* valptr = entry + (big ? 12 : 8);
  std::vector<uint8_t> heap;
  const uint8_t* data;
  if ((int64_t)total <= inline_cap) {
    data = valptr;
  } else {
    uint64_t off = big ? rd<uint64_t>(valptr, le) : rd<uint32_t>(valptr, le);
    heap.resize(total);
    long save = ftell(f);
    fseek(f, (long)off, SEEK_SET);
    if (fread(heap.data(), 1, total, f) != total) return 0;
    fseek(f, save, SEEK_SET);
    data = heap.data();
  }
  const uint8_t* p = data + index * sz;
  switch (typ) {
    case 1: return p[0];
    case 3: return rd<uint16_t>(p, le);
    case 4: return rd<uint32_t>(p, le);
    case 16: return rd<uint64_t>(p, le);
    default: return 0;
  }
}

// Read an entire array-valued tag in ONE pass (read_tag_value re-reads the
// out-of-line heap per element — O(count^2) on large/corrupt strip tables).
bool read_tag_array(FILE* f, const uint8_t* entry, bool le, bool big,
                    uint16_t typ, uint64_t count,
                    std::vector<uint64_t>* out) {
  int sz = type_size(typ);
  uint64_t total = sz * count;
  if (count > (1u << 22) || total > (1ull << 27)) return false;
  int inline_cap = big ? 8 : 4;
  const uint8_t* valptr = entry + (big ? 12 : 8);
  std::vector<uint8_t> heap;
  const uint8_t* data;
  if ((int64_t)total <= inline_cap) {
    data = valptr;
  } else {
    uint64_t off = big ? rd<uint64_t>(valptr, le) : rd<uint32_t>(valptr, le);
    heap.resize(total);
    long save = ftell(f);
    fseek(f, (long)off, SEEK_SET);
    size_t got = fread(heap.data(), 1, total, f);
    fseek(f, save, SEEK_SET);
    if (got != total) return false;
    data = heap.data();
  }
  out->resize(count);
  for (uint64_t k = 0; k < count; ++k) {
    const uint8_t* p = data + k * sz;
    switch (typ) {
      case 1: (*out)[k] = p[0]; break;
      case 3: (*out)[k] = rd<uint16_t>(p, le); break;
      case 4: (*out)[k] = rd<uint32_t>(p, le); break;
      case 16: (*out)[k] = rd<uint64_t>(p, le); break;
      default: return false;
    }
  }
  return true;
}

bool parse_tiff_page(FILE* f, TiffPage* page) {
  uint8_t head[16];
  fseek(f, 0, SEEK_SET);
  if (fread(head, 1, 8, f) != 8) return false;
  bool le;
  if (head[0] == 'I' && head[1] == 'I') le = true;
  else if (head[0] == 'M' && head[1] == 'M') le = false;
  else return false;
  uint16_t magic = rd<uint16_t>(head + 2, le);
  bool big = false;
  uint64_t ifd_off;
  if (magic == 42) {
    ifd_off = rd<uint32_t>(head + 4, le);
  } else if (magic == 43) {
    big = true;
    if (fread(head + 8, 1, 8, f) != 8) return false;
    ifd_off = rd<uint64_t>(head + 8, le);
  } else {
    return false;
  }
  page->little_endian = le;
  fseek(f, (long)ifd_off, SEEK_SET);
  uint64_t n_entries;
  if (big) {
    uint8_t cnt[8];
    if (fread(cnt, 1, 8, f) != 8) return false;
    n_entries = rd<uint64_t>(cnt, le);
  } else {
    uint8_t cnt[2];
    if (fread(cnt, 1, 2, f) != 2) return false;
    n_entries = rd<uint16_t>(cnt, le);
  }
  if (n_entries > 65535) return false;  // corrupt IFD count
  size_t entry_sz = big ? 20 : 12;
  std::vector<uint8_t> entries(n_entries * entry_sz);
  if (fread(entries.data(), 1, entries.size(), f) != entries.size()) return false;
  for (uint64_t i = 0; i < n_entries; ++i) {
    const uint8_t* e = entries.data() + i * entry_sz;
    uint16_t tag = rd<uint16_t>(e, le);
    uint16_t typ = rd<uint16_t>(e + 2, le);
    uint64_t count = big ? rd<uint64_t>(e + 4, le) : rd<uint32_t>(e + 4, le);
    switch (tag) {
      case 256: page->width = (uint32_t)read_tag_value(f, e, le, big, typ, count, 0); break;
      case 257: page->height = (uint32_t)read_tag_value(f, e, le, big, typ, count, 0); break;
      case 258: page->bits = (uint16_t)read_tag_value(f, e, le, big, typ, count, 0); break;
      case 259: page->compression = (uint16_t)read_tag_value(f, e, le, big, typ, count, 0); break;
      case 277: page->samples = (uint16_t)read_tag_value(f, e, le, big, typ, count, 0); break;
      case 278: page->rows_per_strip = (uint32_t)read_tag_value(f, e, le, big, typ, count, 0); break;
      case 317: page->predictor = (uint16_t)read_tag_value(f, e, le, big, typ, count, 0); break;
      case 339: page->sample_format = (uint16_t)read_tag_value(f, e, le, big, typ, count, 0); break;
      case 273:
        if (!read_tag_array(f, e, le, big, typ, count, &page->strip_offsets))
          return false;
        break;
      case 279:
        if (!read_tag_array(f, e, le, big, typ, count, &page->strip_counts))
          return false;
        break;
      default: break;
    }
  }
  if (page->rows_per_strip == 0) page->rows_per_strip = page->height;
  // sanity: reject corrupt headers (implausible dims/bits) so callers
  // fall back to the robust Python codec instead of mis-decoding
  if (page->bits != 8 && page->bits != 16 && page->bits != 32 &&
      page->bits != 64)
    return false;
  if (page->samples == 0 || page->samples > 16) return false;
  if (page->width > (1u << 22) || page->height > (1u << 22)) return false;
  if ((uint64_t)page->width * page->height * page->samples *
          (page->bits / 8) > (1ull << 36))
    return false;
  return page->width && page->height && !page->strip_offsets.empty();
}

bool packbits_decode(const uint8_t* src, size_t n, uint8_t* dst, size_t cap) {
  size_t i = 0, o = 0;
  while (i < n && o < cap) {
    uint8_t h = src[i++];
    if (h < 128) {
      size_t len = h + 1;
      if (i + len > n || o + len > cap) len = std::min(n - i, cap - o);
      std::memcpy(dst + o, src + i, len);
      i += len;
      o += len;
    } else if (h > 128) {
      size_t len = 257 - h;
      if (i >= n) break;
      if (o + len > cap) len = cap - o;
      std::memset(dst + o, src[i], len);
      i += 1;
      o += len;
    }
  }
  return o == cap;
}

// Undo TIFF horizontal differencing (predictor=2) in place: per row, per
// sample channel, cumulative sum along the width axis.
template <typename T>
void undo_predictor_rows(uint8_t* data, uint32_t nrows, uint32_t width,
                         uint16_t samples) {
  for (uint32_t r = 0; r < nrows; ++r) {
    T* row = reinterpret_cast<T*>(data) + (size_t)r * width * samples;
    for (uint32_t x = 1; x < width; ++x)
      for (uint16_t s = 0; s < samples; ++s)
        row[x * samples + s] = (T)(row[x * samples + s] + row[(x - 1) * samples + s]);
  }
}

// decode the full image into `out` (row-major, native byte order)
bool decode_page(FILE* f, const TiffPage& pg, uint8_t* out) {
  // predictor=2 (horizontal differencing) handled below for integer data;
  // predictor=3 (floating-point) falls back to the Python codec
  if (pg.predictor != 1 && (pg.predictor != 2 || pg.sample_format == 3))
    return false;
  // big-endian: only 8/16-bit swaps are implemented — wider types fall
  // back to the Python codec rather than returning byteswapped garbage
  if (!pg.little_endian && pg.bits > 16) return false;
  size_t px_bytes = pg.bits / 8 * pg.samples;
  size_t row_bytes = (size_t)pg.width * px_bytes;
  uint32_t rps = pg.rows_per_strip;
  std::vector<uint8_t> comp, raw;
  size_t out_row = 0;
  for (size_t s = 0; s < pg.strip_offsets.size(); ++s) {
    uint32_t nrows = std::min<uint32_t>(rps, pg.height - (uint32_t)out_row);
    if (nrows == 0) break;
    size_t expect = (size_t)nrows * row_bytes;
    size_t csize = s < pg.strip_counts.size() ? (size_t)pg.strip_counts[s] : expect;
    comp.resize(csize);
    fseek(f, (long)pg.strip_offsets[s], SEEK_SET);
    if (fread(comp.data(), 1, csize, f) != csize) return false;
    uint8_t* dst = out + out_row * row_bytes;
    if (pg.compression == 1) {
      if (csize < expect) return false;
      std::memcpy(dst, comp.data(), expect);
    } else if (pg.compression == 8 || pg.compression == 32946) {
      uLongf dlen = expect;
      if (uncompress(dst, &dlen, comp.data(), csize) != Z_OK || dlen != expect)
        return false;
    } else if (pg.compression == 32773) {
      if (!packbits_decode(comp.data(), csize, dst, expect)) return false;
    } else {
      return false;
    }
    // big-endian data: swap to native little-endian
    if (!pg.little_endian && pg.bits == 16) {
      uint16_t* w = reinterpret_cast<uint16_t*>(dst);
      for (size_t i = 0; i < expect / 2; ++i) w[i] = (uint16_t)((w[i] >> 8) | (w[i] << 8));
    }
    if (pg.predictor == 2) {  // differencing operates on native sample values
      switch (pg.bits) {
        case 8: undo_predictor_rows<uint8_t>(dst, nrows, pg.width, pg.samples); break;
        case 16: undo_predictor_rows<uint16_t>(dst, nrows, pg.width, pg.samples); break;
        case 32: undo_predictor_rows<uint32_t>(dst, nrows, pg.width, pg.samples); break;
        default: return false;
      }
    }
    out_row += nrows;
  }
  return out_row == pg.height;
}

}  // namespace

extern "C" {

// Probe a TIFF: returns 0 on success, fills width/height/bits/sample_format.
int fastio_tiff_info(const char* path, int32_t* width, int32_t* height,
                     int32_t* bits, int32_t* sample_format) {
  FileBuf fb;
  fb.f = fopen(path, "rb");
  if (!fb.f) return -1;
  TiffPage pg;
  if (!parse_tiff_page(fb.f, &pg)) return -2;
  *width = (int32_t)pg.width;
  *height = (int32_t)pg.height;
  *bits = pg.bits;
  *sample_format = pg.sample_format;
  return 0;
}

// Decode a whole grayscale TIFF into out (size height*width*bits/8).
int fastio_tiff_read(const char* path, uint8_t* out, int64_t out_cap) {
  FileBuf fb;
  fb.f = fopen(path, "rb");
  if (!fb.f) return -1;
  TiffPage pg;
  if (!parse_tiff_page(fb.f, &pg)) return -2;
  int64_t need = (int64_t)pg.width * pg.height * (pg.bits / 8) * pg.samples;
  if (need > out_cap) return -3;
  return decode_page(fb.f, pg, out) ? 0 : -4;
}

// Threaded ROI block loader: one TIFF per z plane -> (nz, y1-y0, x1-x0)
// contiguous block (the load_bl_tif.cpp role).  paths is an array of nz
// C strings.  Work is distributed by an atomic index; each thread owns its
// file handle.  Returns 0 on success, else the count of failed planes.
// Failed planes are zero-filled and flagged in failed_mask (nullable,
// nz bytes) so the caller can re-read them through a robust codec instead
// of silently accepting zeros (the reference always substitutes a dummy
// only for genuinely missing files, tsv/volume.py:378-397).
// Bumped whenever any exported signature changes; the Python side
// refuses (and rebuilds) a .so whose version does not match — the
// mtime-only freshness check can be fooled by mtime-preserving deploys
// (rsync -a, tar), and calling an old ABI with new argument lists would
// corrupt memory.
int fastio_abi_version() { return 2; }

int fastio_read_block(const char** paths, int32_t nz, int32_t y0, int32_t y1,
                      int32_t x0, int32_t x1, uint8_t* out,
                      int32_t bytes_per_px, int32_t expected_sfmt,
                      int32_t nthreads, uint8_t* failed_mask) {
  const int64_t plane_out = (int64_t)(y1 - y0) * (x1 - x0) * bytes_per_px;
  std::atomic<int> next{0};
  std::atomic<int> failures{0};
  auto worker = [&]() {
    std::vector<uint8_t> full;
    for (;;) {
      int z = next.fetch_add(1);
      if (z >= nz) return;
      uint8_t* dst = out + (int64_t)z * plane_out;
      FileBuf fb;
      fb.f = fopen(paths[z], "rb");
      TiffPage pg;
      // expected_sfmt: TIFF SampleFormat the caller's dtype implies
      // (1 unsigned, 2 signed, 3 IEEE float; 0 = don't care).  A byte-size
      // match alone would memcpy e.g. f32 bits into a u32 buffer — the
      // mismatch must fall back to the value-casting Python re-read.
      // SampleFormat 4 (VOID) must be treated as UINT per the TIFF spec
      // (old ImageJ/MATLAB writers emit it for plain u16 data)
      int32_t sfmt_eff = 0;
      bool ok = fb.f && parse_tiff_page(fb.f, &pg);
      if (ok) {
        sfmt_eff = (pg.sample_format == 4) ? 1 : (int32_t)pg.sample_format;
        ok = pg.bits / 8 * pg.samples == bytes_per_px &&
             (expected_sfmt == 0 || sfmt_eff == expected_sfmt) &&
             (int32_t)pg.width >= x1 && (int32_t)pg.height >= y1;
      }
      if (ok) {
        full.resize((size_t)pg.width * pg.height * bytes_per_px);
        ok = decode_page(fb.f, pg, full.data());
        if (ok) {
          size_t row_bytes = (size_t)pg.width * bytes_per_px;
          size_t out_row_bytes = (size_t)(x1 - x0) * bytes_per_px;
          for (int32_t y = y0; y < y1; ++y) {
            std::memcpy(dst + (size_t)(y - y0) * out_row_bytes,
                        full.data() + (size_t)y * row_bytes + (size_t)x0 * bytes_per_px,
                        out_row_bytes);
          }
        }
      }
      if (failed_mask) failed_mask[z] = ok ? 0 : 1;
      if (!ok) {
        std::memset(dst, 0, plane_out);
        failures.fetch_add(1);
      }
    }
  };
  int nt = std::max(1, std::min(nthreads, nz));
  std::vector<std::thread> threads;
  for (int t = 0; t < nt; ++t) threads.emplace_back(worker);
  for (auto& th : threads) th.join();
  return failures.load();
}

// Write a grayscale TIFF (strips, optional deflate) atomically (.tmp then
// rename), the save_bl_tif.cpp role for one plane; the Python layer fans
// out planes over threads.
int fastio_tiff_write(const char* path, const uint8_t* data, int32_t height,
                      int32_t width, int32_t bits, int32_t sample_format,
                      int32_t compress_level) {
  const bool compress = compress_level > 0;
  const size_t px = bits / 8;
  const size_t row_bytes = (size_t)width * px;
  int32_t rps = (int32_t)std::max<size_t>(1, (1u << 20) / std::max<size_t>(1, row_bytes));
  if (rps > height) rps = height;
  int n_strips = (height + rps - 1) / rps;

  std::vector<std::vector<uint8_t>> strips(n_strips);
  for (int s = 0; s < n_strips; ++s) {
    int nrows = std::min(rps, height - s * rps);
    const uint8_t* src = data + (size_t)s * rps * row_bytes;
    size_t nbytes = (size_t)nrows * row_bytes;
    if (compress) {
      uLongf cap = compressBound(nbytes);
      strips[s].resize(cap);
      if (compress2(strips[s].data(), &cap, src, nbytes, compress_level) != Z_OK)
        return -2;
      strips[s].resize(cap);
    } else {
      strips[s].assign(src, src + nbytes);
    }
  }

  // classic TIFF, little-endian; 11 tags
  struct Entry {
    uint16_t tag, typ;
    uint32_t count, value;
  };
  // layout: header(8) + IFD + values area + strip data
  int n_tags = 11;
  uint32_t ifd_off = 8;
  uint32_t ifd_size = 2 + n_tags * 12 + 4;
  uint32_t extra_off = ifd_off + ifd_size;
  std::vector<uint8_t> extra;
  auto put_extra = [&](const void* p, size_t n) {
    uint32_t off = extra_off + (uint32_t)extra.size();
    extra.insert(extra.end(), (const uint8_t*)p, (const uint8_t*)p + n);
    if (extra.size() % 2) extra.push_back(0);
    return off;
  };

  std::vector<uint32_t> offsets(n_strips), counts(n_strips);
  for (int s = 0; s < n_strips; ++s) counts[s] = (uint32_t)strips[s].size();
  uint32_t strip_off_value, strip_cnt_value;
  if (n_strips == 1) {
    strip_cnt_value = counts[0];
  } else {
    strip_cnt_value = put_extra(counts.data(), counts.size() * 4);
  }
  uint32_t offsets_pos;  // where the offsets array lives (to patch later)
  if (n_strips == 1) {
    strip_off_value = 0;  // patched below
    offsets_pos = 0;
  } else {
    offsets_pos = extra_off + (uint32_t)extra.size();
    strip_off_value = put_extra(offsets.data(), offsets.size() * 4);
  }
  uint32_t data_base = extra_off + (uint32_t)extra.size();
  if (data_base % 2) data_base += 1;
  uint32_t pos = data_base;
  for (int s = 0; s < n_strips; ++s) {
    offsets[s] = pos;
    pos += counts[s];
    if (pos % 2) pos += 1;
  }
  if (n_strips == 1) strip_off_value = offsets[0];
  else std::memcpy(extra.data() + (offsets_pos - extra_off), offsets.data(),
                   offsets.size() * 4);

  Entry entries[11] = {
      {256, 4, 1, (uint32_t)width},
      {257, 4, 1, (uint32_t)height},
      {258, 3, 1, (uint32_t)bits},
      {259, 3, 1, compress ? 8u : 1u},
      {262, 3, 1, 1},
      {273, 4, (uint32_t)n_strips, strip_off_value},
      {277, 3, 1, 1},
      {278, 4, 1, (uint32_t)rps},
      {279, 4, (uint32_t)n_strips, strip_cnt_value},
      {284, 3, 1, 1},
      {339, 3, 1, (uint32_t)sample_format},
  };

  std::string tmp = std::string(path) + ".tmp";
  FILE* f = fopen(tmp.c_str(), "wb");
  if (!f) return -1;
  uint8_t header[8] = {'I', 'I', 42, 0, 0, 0, 0, 0};
  std::memcpy(header + 4, &ifd_off, 4);
  fwrite(header, 1, 8, f);
  uint16_t cnt16 = (uint16_t)n_tags;
  fwrite(&cnt16, 2, 1, f);
  for (auto& e : entries) {
    fwrite(&e.tag, 2, 1, f);
    fwrite(&e.typ, 2, 1, f);
    fwrite(&e.count, 4, 1, f);
    uint32_t v = e.value;
    if (e.typ == 3 && e.count == 1) {
      uint16_t v16 = (uint16_t)v;
      fwrite(&v16, 2, 1, f);
      uint16_t pad = 0;
      fwrite(&pad, 2, 1, f);
    } else {
      fwrite(&v, 4, 1, f);
    }
  }
  uint32_t next_ifd = 0;
  fwrite(&next_ifd, 4, 1, f);
  fwrite(extra.data(), 1, extra.size(), f);
  long cur = ftell(f);
  while (cur < (long)data_base) {
    fputc(0, f);
    cur++;
  }
  for (int s = 0; s < n_strips; ++s) {
    fwrite(strips[s].data(), 1, strips[s].size(), f);
    if (ftell(f) % 2) fputc(0, f);
  }
  fclose(f);
  if (rename(tmp.c_str(), path) != 0) return -5;
  return 0;
}

// ---------------------------------------------------------------------------
// zstd brick cache (save_lz4/load_lz4 equivalents)
// ---------------------------------------------------------------------------

// Save a brick: 16-byte header (magic, raw size) + zstd frame, atomic.
int fastio_zstd_save(const char* path, const uint8_t* data, int64_t nbytes,
                     int32_t level) {
  size_t cap = ZSTD_compressBound((size_t)nbytes);
  std::vector<uint8_t> comp(cap);
  size_t csize = ZSTD_compress(comp.data(), cap, data, (size_t)nbytes, level);
  if (ZSTD_isError(csize)) return -2;
  std::string tmp = std::string(path) + ".tmp";
  FILE* f = fopen(tmp.c_str(), "wb");
  if (!f) return -1;
  uint64_t magic = 0x49505059425249ULL;  // "IPPYBRI"
  uint64_t raw = (uint64_t)nbytes;
  fwrite(&magic, 8, 1, f);
  fwrite(&raw, 8, 1, f);
  fwrite(comp.data(), 1, csize, f);
  fclose(f);
  return rename(tmp.c_str(), path) == 0 ? 0 : -5;
}

// Returns raw size, or negative on error.  Pass out=nullptr to query size.
int64_t fastio_zstd_load(const char* path, uint8_t* out, int64_t out_cap) {
  FileBuf fb;
  fb.f = fopen(path, "rb");
  if (!fb.f) return -1;
  uint64_t magic = 0, raw = 0;
  if (fread(&magic, 8, 1, fb.f) != 1 || fread(&raw, 8, 1, fb.f) != 1) return -2;
  if (magic != 0x49505059425249ULL) return -3;
  if (!out) return (int64_t)raw;
  if ((int64_t)raw > out_cap) return -4;
  fseek(fb.f, 0, SEEK_END);
  long fsize = ftell(fb.f);
  fseek(fb.f, 16, SEEK_SET);
  std::vector<uint8_t> comp(fsize - 16);
  if (fread(comp.data(), 1, comp.size(), fb.f) != comp.size()) return -5;
  size_t got = ZSTD_decompress(out, (size_t)raw, comp.data(), comp.size());
  if (ZSTD_isError(got) || got != raw) return -6;
  return (int64_t)raw;
}

// Threaded slab assembly from bricks (the load_slab_lz4.cpp role): load
// nbricks zstd bricks, each a contiguous (bz, by, bx) block, into a slab at
// the given (y, x) offsets.  All bricks share bz and the slab z range.
int fastio_load_slab(const char** paths, int32_t nbricks, const int32_t* y0s,
                     const int32_t* x0s, const int32_t* bys, const int32_t* bxs,
                     int32_t bz, int32_t slab_h, int32_t slab_w,
                     uint8_t* out, int32_t bytes_per_px, int32_t nthreads) {
  std::atomic<int> next{0};
  std::atomic<int> failures{0};
  const size_t plane = (size_t)slab_h * slab_w * bytes_per_px;
  auto worker = [&]() {
    std::vector<uint8_t> brick;
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= nbricks) return;
      int64_t need = (int64_t)bz * bys[i] * bxs[i] * bytes_per_px;
      brick.resize((size_t)need);
      int64_t got = fastio_zstd_load(paths[i], brick.data(), need);
      if (got != need) {
        failures.fetch_add(1);
        continue;
      }
      size_t brick_row = (size_t)bxs[i] * bytes_per_px;
      for (int32_t z = 0; z < bz; ++z) {
        for (int32_t y = 0; y < bys[i]; ++y) {
          std::memcpy(out + z * plane +
                          ((size_t)(y0s[i] + y) * slab_w + x0s[i]) * bytes_per_px,
                      brick.data() + ((size_t)z * bys[i] + y) * brick_row,
                      brick_row);
        }
      }
    }
  };
  int nt = std::max(1, std::min(nthreads, nbricks));
  std::vector<std::thread> threads;
  for (int t = 0; t < nt; ++t) threads.emplace_back(worker);
  for (auto& th : threads) th.join();
  return failures.load();
}

}  // extern "C"
