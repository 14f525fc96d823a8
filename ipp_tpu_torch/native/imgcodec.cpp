// The host image codec's byte loops, for io/imgcodec.py (loaded through
// ctypes, so the reader threads decode side by side outside the GIL).  Built
// with g++ at first use into build/ipp_tpu_torch/.  There is no Python
// fallback: a read that needs this library raises when it does not build.
//
// - LZW as TIFF stores it (compression 5): codes MSB first, 9 to 12 bits,
//   Clear 256, EOI 257, the width growing one code early (at 511, 1023,
//   2047), as libtiff's LZWDecode reads it.
// - PNG's row filters (None, Sub, Up, Average, Paeth) and Adam7's seven
//   passes, into the packed rows of the whole image.
// - JPEG decode: baseline, extended-sequential and progressive Huffman
//   (SOF0 / SOF1 / SOF2), 8-bit samples, 1, 3 or 4 components at any
//   integral sampling factors, restart intervals, abbreviated streams with
//   their tables given apart (TIFF's JPEGTables).  The arithmetic is
//   libjpeg(-turbo)'s decoder at its defaults, so the pixels equal what PIL
//   shows: the integer "islow" IDCT with its range-limit table, fancy
//   upsampling (h2v1, h1v2, h2v2 "triangle" filters with their biases; box
//   replication for other ratios), the context rows at the image's edges
//   replicated, and YCbCr -> RGB in 16-bit fixed point.  A progressive
//   frame's scans (jdphuff.c: DC first and refine, AC first and refine,
//   EOB runs) fill a coefficient buffer that is inverse-transformed after
//   EOI; where its scans leave some of the first nine AC coefficients
//   unrefined, libjpeg-turbo 2.1's block smoothing (jdcoefct.c, a 5 x 5
//   neighbourhood of DC values) estimates them first.  Four components are
//   CMYK, or YCCK under an Adobe transform other than 0 (jdcolor.c's
//   ycck_cmyk_convert), handed out inverted as PIL's "CMYK;I" hands them.
//   Refused by name: arithmetic coding (SOF9-11, DAC), lossless (SOF3),
//   hierarchical (SOF5-7, SOF13-15), other precisions than 8, DNL.
// - JPEG encode as libjpeg(-turbo) does at PIL's settings (islow forward
//   DCT, the reciprocal quantiser, the standard Huffman tables, no
//   optimisation): RGB -> YCbCr in fixed point, 4:2:0 by the (1, 2, 1, 2 ...)
//   biased box, edges replicated to whole blocks, dummy blocks at the right
//   and bottom of an MCU, JFIF APP0 1.01.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <exception>
#include <vector>

namespace {

// ---------------------------------------------------------------- LZW

// A table entry is the previous code's string plus the first byte of the
// next, which the output holds contiguously where the previous string was
// written: so an entry is (offset into the output, length) and a code is
// one copy out of the output written so far.
int64_t lzw_decode(const uint8_t* in, int64_t n, uint8_t* out, int64_t cap) {
  if (n >= 2 && in[0] == 0 && (in[1] & 1)) return -3;  // old-style, LSB first
  std::vector<int64_t> offset(4096);
  std::vector<int32_t> length(4096, 1);
  int nbits = 9, next = 258, prev = -1;
  int64_t prev_pos = 0;
  uint64_t acc = 0;
  int have = 0;
  int64_t ip = 0, op = 0;
  while (op < cap) {
    while (have < nbits && ip < n) {
      acc = (acc << 8) | in[ip++];
      have += 8;
    }
    if (have < nbits) break;  // the stream ended without EOI
    int code = static_cast<int>((acc >> (have - nbits)) & ((1u << nbits) - 1));
    have -= nbits;
    if (code == 257) break;
    if (code == 256) {
      nbits = 9;
      next = 258;
      prev = -1;
      continue;
    }
    int64_t at = op;
    if (code < 256) {
      out[op++] = static_cast<uint8_t>(code);
    } else if (code < next && prev >= 0) {
      int64_t k = std::min<int64_t>(length[code], cap - op);
      std::memcpy(out + op, out + offset[code], static_cast<size_t>(k));
      op += k;
    } else if (code == next && prev >= 0) {  // KwKwK: prev + its first byte
      int64_t len = length[prev];
      int64_t k = std::min<int64_t>(len, cap - op);
      std::memcpy(out + op, out + prev_pos, static_cast<size_t>(k));
      op += k;
      if (op < cap) out[op++] = out[prev_pos];
    } else {
      return -1;
    }
    if (prev >= 0 && next < 4096) {
      offset[next] = prev_pos;
      length[next] = length[prev] + 1;
      ++next;
      if (next >= (1 << nbits) - 1 && nbits < 12) ++nbits;
    }
    prev = code;
    prev_pos = at;
  }
  return op;
}

// ---------------------------------------------------------------- PNG

inline uint8_t paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return static_cast<uint8_t>(a);
  if (pb <= pc) return static_cast<uint8_t>(b);
  return static_cast<uint8_t>(c);
}

// Unfilter `rows` rows of `stride` bytes (filter byte first) from raw into
// dst (packed rows).  bpp: bytes a pixel, at least 1.  Returns the raw
// bytes consumed or -1 / -2 (short data / bad filter type).
int64_t unfilter(const uint8_t* raw, int64_t n, uint8_t* dst, int64_t rows,
                 int64_t stride, int bpp) {
  if (n < rows * (stride + 1)) return -1;
  const uint8_t* up = nullptr;
  for (int64_t r = 0; r < rows; ++r) {
    const uint8_t* src = raw + r * (stride + 1);
    uint8_t* d = dst + r * stride;
    int ft = *src++;
    switch (ft) {
      case 0:
        std::memcpy(d, src, stride);
        break;
      case 1:
        for (int64_t i = 0; i < stride; ++i)
          d[i] = static_cast<uint8_t>(src[i] + (i >= bpp ? d[i - bpp] : 0));
        break;
      case 2:
        for (int64_t i = 0; i < stride; ++i)
          d[i] = static_cast<uint8_t>(src[i] + (up ? up[i] : 0));
        break;
      case 3:
        for (int64_t i = 0; i < stride; ++i) {
          int a = i >= bpp ? d[i - bpp] : 0, b = up ? up[i] : 0;
          d[i] = static_cast<uint8_t>(src[i] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (int64_t i = 0; i < stride; ++i) {
          int a = i >= bpp ? d[i - bpp] : 0, b = up ? up[i] : 0;
          int c = (up && i >= bpp) ? up[i - bpp] : 0;
          d[i] = static_cast<uint8_t>(src[i] + paeth(a, b, c));
        }
        break;
      default:
        return -2;
    }
    up = d;
  }
  return rows * (stride + 1);
}

inline int64_t row_bytes(int64_t w, int bits) { return (w * bits + 7) / 8; }

// Copy pixel x of a packed row (bits a pixel) into pixel X of another.
inline void put_pixel(const uint8_t* s, int64_t x, uint8_t* d, int64_t X,
                      int bits) {
  if (bits >= 8) {
    std::memcpy(d + X * (bits / 8), s + x * (bits / 8), bits / 8);
    return;
  }
  int per = 8 / bits, mask = (1 << bits) - 1;
  int v = (s[x / per] >> ((per - 1 - x % per) * bits)) & mask;
  int shift = (per - 1 - static_cast<int>(X % per)) * bits;
  uint8_t& t = d[X / per];
  t = static_cast<uint8_t>((t & ~(mask << shift)) | (v << shift));
}

int64_t png_unfilter(const uint8_t* raw, int64_t n, uint8_t* out, int64_t w,
                     int64_t h, int bits, int interlace) {
  int bpp = std::max(1, bits / 8);
  int64_t stride = row_bytes(w, bits);
  if (!interlace) {
    int64_t got = unfilter(raw, n, out, h, stride, bpp);
    return got < 0 ? got : 0;
  }
  static const int X0[7] = {0, 4, 0, 2, 0, 1, 0}, Y0[7] = {0, 0, 4, 0, 2, 0, 1};
  static const int DX[7] = {8, 8, 4, 4, 2, 2, 1}, DY[7] = {8, 8, 8, 4, 4, 2, 2};
  std::memset(out, 0, static_cast<size_t>(stride * h));
  std::vector<uint8_t> pass;
  int64_t pos = 0;
  for (int p = 0; p < 7; ++p) {
    int64_t pw = (w - X0[p] + DX[p] - 1) / DX[p];
    int64_t ph = (h - Y0[p] + DY[p] - 1) / DY[p];
    if (pw <= 0 || ph <= 0) continue;
    int64_t ps = row_bytes(pw, bits);
    pass.assign(static_cast<size_t>(ps * ph), 0);
    int64_t got = unfilter(raw + pos, n - pos, pass.data(), ph, ps, bpp);
    if (got < 0) return got;
    pos += got;
    for (int64_t y = 0; y < ph; ++y) {
      uint8_t* drow = out + (Y0[p] + y * DY[p]) * stride;
      const uint8_t* srow = pass.data() + y * ps;
      for (int64_t x = 0; x < pw; ++x)
        put_pixel(srow, x, drow, X0[p] + x * DX[p], bits);
    }
  }
  return 0;
}

// ---------------------------------------------------------------- JPEG

const int kZigzag[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    // extra entries so a corrupt run past 63 lands on a harmless slot
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct Error {
  char msg[200];
};

struct Huff {
  bool defined = false;
  bool dc_ok = false;  // every symbol fits a DC table (0..15), as jdhuff.c asks
  uint8_t bits[17] = {0};
  uint8_t vals[256] = {0};
  // decoding
  int32_t maxcode[18];
  int32_t valoff[18];
  uint8_t look_len[512];  // 9-bit lookahead: code length (0: longer)
  uint8_t look_val[512];
  // AC fast path: a code and its value in kFast bits at once, packed as
  // value << 16 | run << 8 | bits used (0: take the slow path)
  int32_t fast[1 << 10];
  // encoding
  uint16_t code[256];
  uint8_t size[256];
};

// jdhuff.c's jpeg_make_d_derived_tbl; false when the code lengths
// overflow their code space (a corrupt table, which libjpeg refuses too).
bool huff_derive(Huff& t) {
  int huffsize[257], huffcode[257];
  int p = 0;
  for (int l = 1; l <= 16; ++l)
    for (int i = 0; i < t.bits[l]; ++i) huffsize[p++] = l;
  huffsize[p] = 0;
  int lastp = p, code = 0, si = huffsize[0];
  p = 0;
  while (huffsize[p]) {
    while (huffsize[p] == si) huffcode[p++] = code++;
    if (code > (1 << si)) return false;
    code <<= 1;
    ++si;
  }
  p = 0;
  for (int l = 1; l <= 16; ++l) {
    if (t.bits[l]) {
      t.valoff[l] = p - huffcode[p];
      p += t.bits[l];
      t.maxcode[l] = huffcode[p - 1];
    } else {
      t.maxcode[l] = -1;
    }
  }
  t.maxcode[17] = 0x7FFFFFFF;
  std::memset(t.look_len, 0, sizeof t.look_len);
  p = 0;
  for (int l = 1; l <= 9; ++l)
    for (int i = 0; i < t.bits[l]; ++i, ++p) {
      int lookbits = huffcode[p] << (9 - l);
      for (int c = 0; c < (1 << (9 - l)); ++c) {
        t.look_len[lookbits + c] = static_cast<uint8_t>(l);
        t.look_val[lookbits + c] = t.vals[p];
      }
    }
  std::memset(t.fast, 0, sizeof t.fast);
  for (int i = 0; i < (1 << 10); ++i) {
    int l = t.look_len[i >> 1];
    if (!l) continue;
    int rs = t.look_val[i >> 1], r = rs >> 4, sz = rs & 15;
    if (!sz || l + sz > 10) continue;
    int v = (i >> (10 - l - sz)) & ((1 << sz) - 1);
    v = v < (1 << (sz - 1)) ? v - (1 << sz) + 1 : v;
    t.fast[i] = static_cast<int32_t>(static_cast<uint32_t>(v) << 16) |
                (r << 8) | (l + sz);
  }
  std::memset(t.size, 0, sizeof t.size);
  t.dc_ok = true;
  for (int i = 0; i < lastp; ++i) {
    t.code[t.vals[i]] = static_cast<uint16_t>(huffcode[i]);
    t.size[t.vals[i]] = static_cast<uint8_t>(huffsize[i]);
    if (t.vals[i] > 15) t.dc_ok = false;
  }
  t.defined = true;
  return true;
}

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int td = 0, ta = 0;
  int bw = 0, bh = 0;          // blocks covered by the plane
  int dw = 0, dh = 0;          // downsampled width and height
  std::vector<uint8_t> plane;  // bw * 8 by bh * 8 samples
  int pred = 0;
  bool seen = false;
  // progressive: bw * bh blocks of 64 coefficients (natural order), dummy
  // blocks included; the quantiser latched at the component's first scan
  // (jdinput.c's latch_quant_tables); the point transform Al each
  // coefficient was last sent with, -1 before its first scan
  std::vector<int16_t> coef;
  uint16_t q[64];
  int coef_bits[64];
  int16_t* block(int bx, int by) {
    return coef.data() + (int64_t(by) * bw + bx) * 64;
  }
};

struct BitReader {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t acc = 0;
  int have = 0;
  int marker = 0;  // a marker met inside the entropy data
  // zero bits put in after that marker or the end: the last `pad` bits of
  // acc, so have < pad once a decode has taken bits the stream lacks
  int64_t pad = 0;
  bool overrun() const { return have < pad; }
  void fill() {
    if (!marker && end - p >= 8) {  // eight bytes at a time without 0xFF
      uint64_t w;
      std::memcpy(&w, p, 8);
      uint64_t x = ~w;
      if (((x - 0x0101010101010101ULL) & ~x & 0x8080808080808080ULL) == 0) {
        int nb = (64 - have) >> 3;
        uint64_t be = __builtin_bswap64(w);
        if (nb < 8) be &= ~(~0ULL >> (8 * nb));
        acc |= be >> have;
        have += 8 * nb;
        p += nb;
        return;
      }
    }
    while (have <= 56) {
      int byte = 0;
      bool real = false;
      if (!marker && p < end) {
        byte = *p;
        real = true;
        if (byte == 0xFF) {
          int nxt = p + 1 < end ? p[1] : 0xD9;
          if (nxt == 0) {
            p += 2;
          } else {
            marker = nxt;
            byte = 0;
            real = false;
          }
        } else {
          ++p;
        }
      }
      if (!real) pad += 8;
      acc |= static_cast<uint64_t>(byte) << (56 - have);
      have += 8;
    }
  }
  inline int peek(int n) {
    if (have < n) fill();
    return static_cast<int>(acc >> (64 - n));
  }
  inline void skip(int n) {
    acc <<= n;
    have -= n;
  }
  inline int get(int n) {
    if (n == 0) return 0;
    int v = peek(n);
    skip(n);
    return v;
  }
  void reset() {  // at a restart marker: drop the partial byte
    acc = 0;
    have = 0;
    pad = 0;
  }
};

inline int extend(int v, int s) {
  return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

inline int huff_decode(BitReader& br, const Huff& t) {
  int look = br.peek(9);
  int l = t.look_len[look];
  if (l) {
    br.skip(l);
    return t.look_val[look];
  }
  int code = br.peek(16);
  for (l = 10; l <= 16; ++l) {
    int c = code >> (16 - l);
    if (c <= t.maxcode[l]) {
      br.skip(l);
      return t.vals[(c + t.valoff[l]) & 0xFF];
    }
  }
  br.skip(16);
  return 0;  // corrupt data: libjpeg warns and goes on with 0
}

// libjpeg's range-limit table for the IDCT's output: a value v + 128,
// clamped to [0, 255] for v in [-512, 511], wrapping mod 1024 beyond.
struct RangeLimit {
  uint8_t t[1024];
  RangeLimit() {
    for (int i = 0; i < 1024; ++i) {
      int v = i < 512 ? i : i - 1024;
      t[i] = static_cast<uint8_t>(std::min(255, std::max(0, v + 128)));
    }
  }
};
const RangeLimit kRange;

constexpr int CONST_BITS = 13, PASS1_BITS = 2;
constexpr int64_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270,
                  F0899 = 7373, F1175 = 9633, F1501 = 12299, F1847 = 15137,
                  F1961 = 16069, F2053 = 16819, F2562 = 20995, F3072 = 25172;

inline int64_t descale(int64_t x, int n) {
  return (x + (int64_t(1) << (n - 1))) >> n;
}

inline int32_t descale32(int32_t x, int n) {
  return (x + (int32_t(1) << (n - 1))) >> n;
}

// jidctint.c's jpeg_idct_islow: coef in natural order, q the quantiser.
// 32-bit arithmetic as libjpeg-turbo's SIMD form (the library is built
// with -fwrapv, so corrupt data wraps as it does there).
void idct_islow(const int16_t* coef, const uint16_t* q, uint8_t* out,
                int64_t ostride) {
  int ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* in = coef + c;
    const uint16_t* qq = q + c;
    if (!in[8] && !in[16] && !in[24] && !in[32] && !in[40] && !in[48] &&
        !in[56]) {
      int dc = static_cast<int>(int32_t(in[0]) * qq[0] * (1 << PASS1_BITS));
      for (int r = 0; r < 8; ++r) ws[r * 8 + c] = dc;
      continue;
    }
    int32_t z2 = int32_t(in[16]) * qq[16], z3 = int32_t(in[48]) * qq[48];
    int32_t z1 = (z2 + z3) * F0541;
    int32_t tmp2 = z1 + z3 * -F1847, tmp3 = z1 + z2 * F0765;
    z2 = int32_t(in[0]) * qq[0];
    z3 = int32_t(in[32]) * qq[32];
    int32_t tmp0 = (z2 + z3) * (int32_t(1) << CONST_BITS);
    int32_t tmp1 = (z2 - z3) * (int32_t(1) << CONST_BITS);
    int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int32_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = int32_t(in[56]) * qq[56];
    tmp1 = int32_t(in[40]) * qq[40];
    tmp2 = int32_t(in[24]) * qq[24];
    tmp3 = int32_t(in[8]) * qq[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int32_t z4 = tmp1 + tmp3;
    int32_t z5 = (z3 + z4) * F1175;
    tmp0 *= F0298;
    tmp1 *= F2053;
    tmp2 *= F3072;
    tmp3 *= F1501;
    z1 *= -F0899;
    z2 *= -F2562;
    z3 *= -F1961;
    z4 *= -F0390;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int sh = CONST_BITS - PASS1_BITS;
    ws[0 * 8 + c] = static_cast<int>(descale32(tmp10 + tmp3, sh));
    ws[7 * 8 + c] = static_cast<int>(descale32(tmp10 - tmp3, sh));
    ws[1 * 8 + c] = static_cast<int>(descale32(tmp11 + tmp2, sh));
    ws[6 * 8 + c] = static_cast<int>(descale32(tmp11 - tmp2, sh));
    ws[2 * 8 + c] = static_cast<int>(descale32(tmp12 + tmp1, sh));
    ws[5 * 8 + c] = static_cast<int>(descale32(tmp12 - tmp1, sh));
    ws[3 * 8 + c] = static_cast<int>(descale32(tmp13 + tmp0, sh));
    ws[4 * 8 + c] = static_cast<int>(descale32(tmp13 - tmp0, sh));
  }
  const int sh = CONST_BITS + PASS1_BITS + 3;
  for (int r = 0; r < 8; ++r) {
    const int* w = ws + r * 8;
    uint8_t* o = out + r * ostride;
    if (!w[1] && !w[2] && !w[3] && !w[4] && !w[5] && !w[6] && !w[7]) {
      uint8_t v = kRange.t[descale32(w[0], PASS1_BITS + 3) & 1023];
      std::memset(o, v, 8);
      continue;
    }
    int32_t z2 = w[2], z3 = w[6];
    int32_t z1 = (z2 + z3) * F0541;
    int32_t tmp2 = z1 + z3 * -F1847, tmp3 = z1 + z2 * F0765;
    int32_t tmp0 = (int32_t(w[0]) + w[4]) * (int32_t(1) << CONST_BITS);
    int32_t tmp1 = (int32_t(w[0]) - w[4]) * (int32_t(1) << CONST_BITS);
    int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int32_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int32_t z4 = tmp1 + tmp3;
    int32_t z5 = (z3 + z4) * F1175;
    tmp0 *= F0298;
    tmp1 *= F2053;
    tmp2 *= F3072;
    tmp3 *= F1501;
    z1 *= -F0899;
    z2 *= -F2562;
    z3 *= -F1961;
    z4 *= -F0390;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    o[0] = kRange.t[descale32(tmp10 + tmp3, sh) & 1023];
    o[7] = kRange.t[descale32(tmp10 - tmp3, sh) & 1023];
    o[1] = kRange.t[descale32(tmp11 + tmp2, sh) & 1023];
    o[6] = kRange.t[descale32(tmp11 - tmp2, sh) & 1023];
    o[2] = kRange.t[descale32(tmp12 + tmp1, sh) & 1023];
    o[5] = kRange.t[descale32(tmp12 - tmp1, sh) & 1023];
    o[3] = kRange.t[descale32(tmp13 + tmp0, sh) & 1023];
    o[4] = kRange.t[descale32(tmp13 - tmp0, sh) & 1023];
  }
}

// jdcolor.c's build_ycc_rgb_table
struct YccTables {
  int crr[256], cbb[256];
  int64_t crg[256], cbg[256];
  YccTables() {
    const int64_t ONE_HALF = int64_t(1) << 15;
    auto fix = [](double x) { return static_cast<int64_t>(x * 65536 + 0.5); };
    for (int i = 0, x = -128; i < 256; ++i, ++x) {
      crr[i] = static_cast<int>((fix(1.40200) * x + ONE_HALF) >> 16);
      cbb[i] = static_cast<int>((fix(1.77200) * x + ONE_HALF) >> 16);
      crg[i] = -fix(0.71414) * x;
      cbg[i] = -fix(0.34414) * x + ONE_HALF;
    }
  }
};
const YccTables kYcc;

struct Decoder {
  Error* err;
  uint16_t qt[4][64];  // natural order
  bool qdef[4] = {false, false, false, false};
  Huff dc[4], ac[4];
  int width = 0, height = 0, ncomp = 0, hmax = 1, vmax = 1;
  int restart = 0;
  bool frame = false, jfif = false, adobe = false, progressive = false;
  int eobrun = 0;  // blocks left in the current AC scan's end-of-band run
  int adobe_transform = -1;
  Component comp[4];
  int mcux = 0, mcuy = 0;
  bool header_only = false;
  int colour = -1;  // YCbCr to RGB: -1 as the markers say, 0 never, 1 always

  bool fail(const char* m) {
    std::snprintf(err->msg, sizeof err->msg, "%s", m);
    return false;
  }

  static int u16(const uint8_t* p) { return (p[0] << 8) | p[1]; }

  bool read_dqt(const uint8_t* p, int len) {
    int pos = 0;
    while (pos < len) {
      int pq = p[pos] >> 4, tq = p[pos] & 15;
      ++pos;
      if (tq > 3 || pq > 1) return fail("a DQT table out of range");
      int need = pq ? 128 : 64;
      if (pos + need > len) return fail("a DQT segment cut short");
      for (int k = 0; k < 64; ++k)
        qt[tq][kZigzag[k]] =
            static_cast<uint16_t>(pq ? u16(p + pos + 2 * k) : p[pos + k]);
      qdef[tq] = true;
      pos += need;
    }
    return true;
  }

  bool read_dht(const uint8_t* p, int len) {
    int pos = 0;
    while (pos < len) {
      if (pos + 17 > len) return fail("a DHT segment cut short");
      int tc = p[pos] >> 4, th = p[pos] & 15;
      if (tc > 1 || th > 3) return fail("a DHT table out of range");
      Huff& t = tc ? ac[th] : dc[th];
      int total = 0;
      t.bits[0] = 0;
      for (int l = 1; l <= 16; ++l) {
        t.bits[l] = p[pos + l];
        total += t.bits[l];
      }
      pos += 17;
      if (total > 256 || pos + total > len)
        return fail("a DHT table of more than 256 codes");
      std::memcpy(t.vals, p + pos, total);
      pos += total;
      if (!huff_derive(t)) return fail("a bad Huffman table");
    }
    return true;
  }

  bool read_sof(const uint8_t* p, int len, int marker) {
    if (marker != 0xC0 && marker != 0xC1 && marker != 0xC2) {
      static const char* names[16] = {
          "", "", "", "lossless (SOF3)", "", "hierarchical "
          "(SOF5)", "hierarchical progressive (SOF6)", "hierarchical lossless "
          "(SOF7)", "", "arithmetic-coded (SOF9)", "arithmetic-coded "
          "progressive (SOF10)", "arithmetic-coded lossless (SOF11)", "",
          "arithmetic-coded hierarchical (SOF13)", "arithmetic-coded "
          "hierarchical progressive (SOF14)", "arithmetic-coded hierarchical "
          "lossless (SOF15)"};
      std::snprintf(err->msg, sizeof err->msg,
                    "unsupported JPEG: %s; baseline, extended-sequential "
                    "and progressive Huffman JPEGs (SOF0 / SOF1 / SOF2) are "
                    "read",
                    names[marker - 0xC0]);
      return false;
    }
    if (frame) return fail("a second frame header");
    progressive = marker == 0xC2;
    if (len < 6) return fail("a frame header cut short");
    if (p[0] != 8) {
      std::snprintf(err->msg, sizeof err->msg,
                    "unsupported JPEG: %d-bit samples; 8-bit JPEGs are read",
                    p[0]);
      return false;
    }
    height = u16(p + 1);
    width = u16(p + 3);
    ncomp = p[5];
    if (height == 0) return fail("unsupported JPEG: height 0 (DNL)");
    if (width == 0) return fail("a JPEG of width 0");
    if (ncomp != 1 && ncomp != 3 && ncomp != 4) {
      std::snprintf(err->msg, sizeof err->msg,
                    "unsupported JPEG: %d components; gray, three- and "
                    "four-component JPEGs are read",
                    ncomp);
      return false;
    }
    if (len < 6 + 3 * ncomp) return fail("a frame header cut short");
    for (int i = 0; i < ncomp; ++i) {
      Component& c = comp[i];
      c.id = p[6 + 3 * i];
      c.h = p[7 + 3 * i] >> 4;
      c.v = p[7 + 3 * i] & 15;
      c.tq = p[8 + 3 * i];
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3)
        return fail("a bad sampling factor or table in the frame header");
      hmax = std::max(hmax, c.h);
      vmax = std::max(vmax, c.v);
    }
    mcux = (width + 8 * hmax - 1) / (8 * hmax);
    mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    for (int i = 0; i < ncomp; ++i) {
      Component& c = comp[i];
      if (hmax % c.h || vmax % c.v)
        return fail("unsupported JPEG: fractional sampling factors");
      c.dw = static_cast<int>((int64_t(width) * c.h + hmax - 1) / hmax);
      c.dh = static_cast<int>((int64_t(height) * c.v + vmax - 1) / vmax);
      c.bw = mcux * c.h;
      c.bh = mcuy * c.v;
      if (header_only) continue;
      c.plane.assign(static_cast<size_t>(c.bw) * 8 * c.bh * 8, 0);
      if (progressive) {
        c.coef.assign(static_cast<size_t>(c.bw) * c.bh * 64, 0);
        std::fill(c.coef_bits, c.coef_bits + 64, -1);
      }
    }
    frame = true;
    return true;
  }

  bool decode_block(BitReader& br, Component& c, int bx, int by) {
    int16_t coef[64];
    std::memset(coef, 0, sizeof coef);
    const Huff& hd = dc[c.td];
    const Huff& ha = ac[c.ta];
    int s = huff_decode(br, hd);
    int diff = s ? extend(br.get(s), s) : 0;
    c.pred += diff;
    coef[0] = static_cast<int16_t>(c.pred);
    for (int k = 1; k < 64; ++k) {
      int32_t f = ha.fast[br.peek(10)];
      if (f) {
        br.skip(f & 255);
        k += (f >> 8) & 15;
        coef[kZigzag[k]] = static_cast<int16_t>(f >> 16);
        continue;
      }
      int rs = huff_decode(br, ha);
      int r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        int v = extend(br.get(s), s);
        coef[kZigzag[k]] = static_cast<int16_t>(v);
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
    idct_islow(coef, qt[c.tq],
               c.plane.data() + (int64_t(by) * 8 * c.bw + bx) * 8,
               int64_t(c.bw) * 8);
    return true;
  }

  // The MCUs of one scan over sc[0..ns-1] (one block each when the scan
  // has one component: its ceil(dw / 8) x ceil(dh / 8) blocks, not the MCU
  // grid), the bit reader reset and the DC predictions and EOB run cleared
  // at every restart marker; block(br, c, bx, by) decodes one block.
  template <class F>
  bool walk_scan(BitReader& br, Component** sc, int ns, const uint8_t* end,
                 F&& block) {
    int nx, ny;
    if (ns == 1) {
      nx = (sc[0]->dw + 7) / 8;
      ny = (sc[0]->dh + 7) / 8;
    } else {
      nx = mcux;
      ny = mcuy;
    }
    int64_t total = int64_t(nx) * ny, todo = restart ? restart : total;
    for (int64_t m = 0; m < total; ++m) {
      if (restart && todo == 0) {
        // the RSTn marker: reset the bit reader and the DC predictions
        if (br.marker >= 0xD0 && br.marker <= 0xD7) {
          br.p += 2;
        } else {
          while (br.p + 1 < end &&
                 !(br.p[0] == 0xFF && br.p[1] >= 0xD0 && br.p[1] <= 0xD7))
            ++br.p;
          if (br.p + 1 >= end) return fail("a restart marker is missing");
          br.p += 2;
        }
        br.marker = 0;
        br.reset();
        for (int i = 0; i < ns; ++i) sc[i]->pred = 0;
        eobrun = 0;
        todo = restart;
      }
      int mx = static_cast<int>(m % nx), my = static_cast<int>(m / nx);
      if (ns == 1) {
        if (!block(br, *sc[0], mx, my)) return false;
      } else {
        for (int i = 0; i < ns; ++i)
          for (int v = 0; v < sc[i]->v; ++v)
            for (int h = 0; h < sc[i]->h; ++h)
              if (!block(br, *sc[i], mx * sc[i]->h + h, my * sc[i]->v + v))
                return false;
      }
      --todo;
    }
    return true;
  }

  bool read_scan(const uint8_t* p, int len, const uint8_t*& data,
                 const uint8_t* end) {
    if (!frame) return fail("a scan before the frame header");
    int ns = p[0];
    if (ns < 1 || ns > 4 || len < 4 + 2 * ns) return fail("a bad scan header");
    // spectral selection and successive approximation (progressive only)
    const int Ss = p[1 + 2 * ns], Se = p[2 + 2 * ns];
    const int Ah = p[3 + 2 * ns] >> 4, Al = p[3 + 2 * ns] & 15;
    const bool dc_scan = Ss == 0;
    Component* sc[4];
    for (int i = 0; i < ns; ++i) {
      int id = p[1 + 2 * i], t = p[2 + 2 * i];
      sc[i] = nullptr;
      for (int k = 0; k < ncomp; ++k)
        if (comp[k].id == id) sc[i] = &comp[k];
      if (!sc[i]) return fail("a scan names a component the frame lacks");
      sc[i]->td = t >> 4;
      sc[i]->ta = t & 15;
    }
    if (progressive && !start_progressive_scan(sc, ns, Ss, Se, Ah, Al))
      return false;
    for (int i = 0; i < ns; ++i) {
      Component& c = *sc[i];
      // the tables this scan decodes with (a DC refinement needs none)
      bool need_dc = !progressive || (dc_scan && Ah == 0);
      bool need_ac = !progressive || !dc_scan;
      if ((need_dc && (c.td > 3 || !dc[c.td].defined)) ||
          (need_ac && (c.ta > 3 || !ac[c.ta].defined)))
        return fail("a scan uses a Huffman table that is not defined");
      if (need_dc && !dc[c.td].dc_ok) return fail("a bad Huffman table");
      if (!qdef[c.tq])
        return fail("a component uses a quantisation table that is not "
                    "defined");
      if (progressive && !c.seen) std::memcpy(c.q, qt[c.tq], sizeof c.q);
      c.pred = 0;
      c.seen = true;
    }
    BitReader br{data, end};
    bool ok;
    if (!progressive) {
      ok = walk_scan(br, sc, ns, end,
                     [this](BitReader& b, Component& c, int x, int y) {
                       return decode_block(b, c, x, y);
                     });
    } else {
      eobrun = 0;
      auto cut = [this](const BitReader& b) {
        return !b.overrun() ||
               fail("a progressive JPEG scan cut short (its data ends "
                    "before its last block)");
      };
      if (dc_scan && Ah == 0) {
        ok = walk_scan(br, sc, ns, end,
                       [&](BitReader& b, Component& c, int x, int y) {
                         dc_first(b, c, c.block(x, y), Al);
                         return cut(b);
                       });
      } else if (dc_scan) {
        ok = walk_scan(br, sc, ns, end,
                       [&](BitReader& b, Component& c, int x, int y) {
                         if (b.get(1)) c.block(x, y)[0] |= 1 << Al;
                         return cut(b);
                       });
      } else if (Ah == 0) {
        ok = walk_scan(br, sc, ns, end,
                       [&](BitReader& b, Component& c, int x, int y) {
                         ac_first(b, ac[c.ta], c.block(x, y), Ss, Se, Al);
                         return cut(b);
                       });
      } else {
        ok = walk_scan(br, sc, ns, end,
                       [&](BitReader& b, Component& c, int x, int y) {
                         ac_refine(b, ac[c.ta], c.block(x, y), Ss, Se, Al);
                         return cut(b);
                       });
      }
    }
    if (!ok) return false;
    // move to the marker that ends the scan
    const uint8_t* q = br.p;
    while (q + 1 < end && !(q[0] == 0xFF && q[1] != 0 &&
                            !(q[1] >= 0xD0 && q[1] <= 0xD7)))
      ++q;
    data = q;
    return true;
  }

  // jdphuff.c's start_pass_phuff_decoder: the scan's parameters checked
  // (libjpeg's fatal errors, and here also its warnings of a bogus
  // progression: every refusal names the fault), then each coefficient's
  // point transform noted for the block smoothing.
  bool start_progressive_scan(Component** sc, int ns, int Ss, int Se, int Ah,
                              int Al) {
    const char* why = nullptr;
    if (Ss == 0 && Se != 0)
      why = "a DC scan that carries AC coefficients";
    else if (Ss > Se)
      why = "Se before Ss";
    else if (Se > 63)
      why = "Se past coefficient 63";
    else if (Ss > 0 && ns != 1)
      why = "an AC scan over several components";
    else if (Al > 13)
      why = "Al past 13";
    else if (Ah != 0 && Al != Ah - 1)
      why = "a refinement whose Al is not Ah - 1";
    for (int i = 0; i < ns && !why; ++i) {
      const int* bits = sc[i]->coef_bits;
      if (Ss > 0 && bits[0] < 0) why = "an AC scan before its DC scan";
      for (int k = Ss; k <= Se && !why; ++k)
        if (Ah != (bits[k] < 0 ? 0 : bits[k]))
          why = "a refinement whose Ah does not follow the scan before it";
    }
    if (why) {
      std::snprintf(err->msg, sizeof err->msg,
                    "a malformed JPEG progression: %s (Ss %d, Se %d, Ah %d, "
                    "Al %d)",
                    why, Ss, Se, Ah, Al);
      return false;
    }
    for (int i = 0; i < ns; ++i)
      for (int k = Ss; k <= Se; ++k) sc[i]->coef_bits[k] = Al;
    return true;
  }

  // jdphuff.c's decode_mcu_DC_first for one block
  void dc_first(BitReader& br, Component& c, int16_t* blk, int Al) {
    const int s = huff_decode(br, dc[c.td]);
    c.pred += s ? extend(br.get(s), s) : 0;
    blk[0] = static_cast<int16_t>(c.pred * (1 << Al));
  }

  // decode_mcu_AC_first: the band's values, shifted left by Al, or one
  // block of an end-of-band run
  void ac_first(BitReader& br, const Huff& t, int16_t* blk, int Ss, int Se,
                int Al) {
    if (eobrun > 0) {
      --eobrun;
      return;
    }
    for (int k = Ss; k <= Se; ++k) {
      int rs = huff_decode(br, t), r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        blk[kZigzag[k]] = static_cast<int16_t>(extend(br.get(s), s) * (1 << Al));
      } else if (r == 15) {
        k += 15;
      } else {
        eobrun = (1 << r) + (r ? br.get(r) : 0) - 1;
        break;
      }
    }
  }

  // decode_mcu_AC_refine: a correction bit for every coefficient of the
  // band already nonzero, new coefficients of +-(1 << Al) placed after
  // their run of zeros, and within an end-of-band run the correction bits
  // of each block's nonzero coefficients all the same
  void ac_refine(BitReader& br, const Huff& t, int16_t* blk, int Ss, int Se,
                 int Al) {
    const int p1 = 1 << Al, m1 = -p1;
    auto correct = [&](int16_t& coef) {
      if (br.get(1) && (coef & p1) == 0)
        coef = static_cast<int16_t>(coef + (coef >= 0 ? p1 : m1));
    };
    int k = Ss;
    if (eobrun == 0) {
      for (; k <= Se; ++k) {
        int rs = huff_decode(br, t), r = rs >> 4, s = rs & 15;
        if (s) {
          s = br.get(1) ? p1 : m1;  // libjpeg warns when the size is not 1
        } else if (r != 15) {
          eobrun = (1 << r) + (r ? br.get(r) : 0);
          break;  // the rest of the band is the run's
        }
        do {  // past r zeros, correcting the nonzero coefficients met
          int16_t& coef = blk[kZigzag[k]];
          if (coef)
            correct(coef);
          else if (--r < 0)
            break;
          ++k;
        } while (k <= Se);
        if (s) blk[kZigzag[k]] = static_cast<int16_t>(s);
      }
    }
    if (eobrun > 0) {
      for (; k <= Se; ++k) {
        int16_t& coef = blk[kZigzag[k]];
        if (coef) correct(coef);
      }
      --eobrun;
    }
  }

  // Walk the markers of one stream; `tables_only`: an abbreviated
  // tables stream (SOI, DQT / DHT, EOI).
  bool parse(const uint8_t* d, int64_t n, bool tables_only) {
    if (n < 4 || d[0] != 0xFF || d[1] != 0xD8) return fail("not a JPEG");
    const uint8_t* p = d + 2;
    const uint8_t* end = d + n;
    while (p < end) {
      if (*p != 0xFF) {
        ++p;  // junk between markers: libjpeg skips it with a warning
        continue;
      }
      while (p < end && *p == 0xFF) ++p;
      if (p >= end) break;
      int m = *p++;
      if (m == 0xD9) return true;  // EOI
      if (m == 0xD8 || (m >= 0xD0 && m <= 0xD7) || m == 0x01) continue;
      if (p + 2 > end) return fail("a JPEG cut short in a marker");
      int len = u16(p);
      if (len < 2 || p + len > end) return fail("a JPEG segment cut short");
      const uint8_t* s = p + 2;
      int sl = len - 2;
      p += len;
      if (m == 0xDB) {
        if (!read_dqt(s, sl)) return false;
      } else if (m == 0xC4) {
        if (!read_dht(s, sl)) return false;
      } else if (m == 0xDD) {
        if (sl < 2) return fail("a bad DRI segment");
        restart = u16(s);
      } else if (m == 0xCC) {
        return fail("unsupported JPEG: arithmetic coding (DAC)");
      } else if (m >= 0xC0 && m <= 0xCF && m != 0xC4 && m != 0xC8) {
        if (tables_only) return fail("a frame header in a tables stream");
        if (!read_sof(s, sl, m)) return false;
        if (header_only) return true;
      } else if (m == 0xDA) {
        if (tables_only) return fail("a scan in a tables stream");
        if (!read_scan(s, sl, p, end)) return false;
      } else if (m == 0xE0) {
        if (sl >= 5 && !std::memcmp(s, "JFIF\0", 5)) jfif = true;
      } else if (m == 0xEE) {
        if (sl >= 12 && !std::memcmp(s, "Adobe", 5)) {
          adobe = true;
          adobe_transform = s[11];
        }
      } else if (m == 0xDC) {
        return fail("unsupported JPEG: a DNL marker");
      }
    }
    if (tables_only) return true;
    return fail("a JPEG without its EOI marker (truncated)");
  }

  // After EOI, a progressive frame's blocks (those the output uses: ceil(dw
  // / 8) x ceil(dh / 8) a component) through the IDCT into the planes, as
  // libjpeg's decompress_data does, or decompress_smooth_data where
  // smoothing_ok says so.
  void finish_progressive() {
    const bool smooth = smoothing_ok();
    for (int i = 0; i < ncomp; ++i) {
      Component& c = comp[i];
      if (smooth) {
        smooth_component(c);
        continue;
      }
      const int wb = (c.dw + 7) / 8, hb = (c.dh + 7) / 8;
      for (int by = 0; by < hb; ++by)
        for (int bx = 0; bx < wb; ++bx) idct_to_plane(c, c.block(bx, by), bx, by);
    }
  }

  void idct_to_plane(Component& c, const int16_t* blk, int bx, int by) {
    idct_islow(blk, c.q, c.plane.data() + (int64_t(by) * 8 * c.bw + bx) * 8,
               int64_t(c.bw) * 8);
  }

  // jdcoefct.c's smoothing_ok (libjpeg-turbo 2.1 and later, which keep ten
  // coefficients): every component's DC sent and its quantisers of the DC
  // and the first nine AC coefficients nonzero, and some component with
  // one of those nine not sent to full precision.
  bool smoothing_ok() const {
    bool useful = false;
    for (int i = 0; i < ncomp; ++i) {
      const Component& c = comp[i];
      for (int k = 0; k < 10; ++k)
        if (c.q[kZigzag[k]] == 0) return false;
      if (c.coef_bits[0] < 0) return false;
      for (int k = 1; k < 10; ++k)
        if (c.coef_bits[k] != 0) useful = true;
    }
    return useful;
  }

  // jdcoefct.c's decompress_smooth_data for one component: the first nine
  // AC coefficients that are still zero and not known exactly estimated
  // from the DC values of the 5 x 5 blocks around (edges replicated); when
  // no AC coefficient has been sent at all, the DC too.  The row
  // neighbourhood follows libjpeg's counting, which in the last iMCU row
  // takes the block rows of that row as every row's count.
  void smooth_component(Component& c) {
    const int* bits = c.coef_bits;
    bool change_dc = true;
    for (int k = 1; k < 10; ++k)
      if (bits[k] != -1) change_dc = false;
    const int64_t Q00 = c.q[0], Q01 = c.q[1], Q10 = c.q[8], Q20 = c.q[16],
                  Q11 = c.q[9], Q02 = c.q[2], Q03 = c.q[3], Q12 = c.q[10],
                  Q21 = c.q[17], Q30 = c.q[24];
    const int total = mcuy, last_row = total - 1;
    const int hb = (c.dh + 7) / 8, last_col = (c.dw + 7) / 8 - 1;
    int16_t ws[64];
    // one estimate: applied when the coefficient is zero and not exact,
    // limited below 1 << Al where Al > 0
    auto est = [&](int zz, int64_t Q, int64_t sum) {
      const int al = bits[zz], pos = kZigzag[zz];
      if (al == 0 || ws[pos] != 0) return;
      int64_t num = Q00 * sum;
      int pred = static_cast<int>(((Q << 7) + (num >= 0 ? num : -num)) /
                                  (Q << 8));
      if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
      ws[pos] = static_cast<int16_t>(num >= 0 ? pred : -pred);
    };
    for (int im = 0; im < total; ++im) {
      int rows = c.v;
      if (im == last_row) {
        rows = hb % c.v;
        if (rows == 0) rows = c.v;
      }
      const int64_t image_rows = int64_t(rows) * total;
      for (int br = 0; br < rows; ++br) {
        const int64_t ibr = int64_t(im) * rows + br;
        const int row = im * c.v + br;
        const int prev = ibr > 0 ? row - 1 : row;
        const int prev2 = ibr > 1 ? row - 2 : prev;
        const int next = ibr < image_rows - 1 ? row + 1 : row;
        const int next2 = ibr < image_rows - 2 ? row + 2 : next;
        const int16_t* R[5] = {c.block(0, prev2), c.block(0, prev),
                               c.block(0, row), c.block(0, next),
                               c.block(0, next2)};
        for (int bx = 0; bx <= last_col; ++bx) {
          std::memcpy(ws, c.block(bx, row), sizeof ws);
          // D[r][j]: DC01 .. DC25 of libjpeg, rows r = -2 .. 2 and columns
          // j = -2 .. 2 around the block, the columns clamped to the row
          int D[5][5];
          for (int j = 0; j < 5; ++j) {
            const int64_t col = std::min(std::max(bx + j - 2, 0), last_col);
            for (int r = 0; r < 5; ++r) D[r][j] = R[r][64 * col];
          }
          const int(&a)[5] = D[0];
          const int(&b)[5] = D[1];
          const int(&m)[5] = D[2];
          const int(&d)[5] = D[3];
          const int(&e)[5] = D[4];
          if (change_dc) {
            est(1, Q01, -a[0] - a[1] + a[3] + a[4] - 3 * b[0] + 13 * b[1] -
                            13 * b[3] + 3 * b[4] - 3 * m[0] + 38 * m[1] -
                            38 * m[3] + 3 * m[4] - 3 * d[0] + 13 * d[1] -
                            13 * d[3] + 3 * d[4] - e[0] - e[1] + e[3] + e[4]);
            est(2, Q10, -a[0] - 3 * a[1] - 3 * a[2] - 3 * a[3] - a[4] - b[0] +
                            13 * b[1] + 38 * b[2] + 13 * b[3] - b[4] + d[0] -
                            13 * d[1] - 38 * d[2] - 13 * d[3] + d[4] + e[0] +
                            3 * e[1] + 3 * e[2] + 3 * e[3] + e[4]);
            est(3, Q20, a[2] + 2 * b[1] + 7 * b[2] + 2 * b[3] - 5 * m[1] -
                            14 * m[2] - 5 * m[3] + 2 * d[1] + 7 * d[2] +
                            2 * d[3] + e[2]);
            est(4, Q11, -a[0] + a[4] + 9 * b[1] - 9 * b[3] - 9 * d[1] +
                            9 * d[3] + e[0] - e[4]);
            est(5, Q02, 2 * b[1] - 5 * b[2] + 2 * b[3] + m[0] + 7 * m[1] -
                            14 * m[2] + 7 * m[3] + m[4] + 2 * d[1] - 5 * d[2] +
                            2 * d[3]);
            est(6, Q03, b[1] - b[3] + 2 * m[1] - 2 * m[3] + d[1] - d[3]);
            est(7, Q12, b[1] - 3 * b[2] + b[3] - d[1] + 3 * d[2] - d[3]);
            est(8, Q21, b[1] - b[3] - 3 * m[1] + 3 * m[3] + d[1] - d[3]);
            est(9, Q30, b[1] + 2 * b[2] + b[3] - d[1] - 2 * d[2] - d[3]);
            int64_t num = Q00 * (-2 * a[0] - 6 * a[1] - 8 * a[2] - 6 * a[3] -
                                 2 * a[4] - 6 * b[0] + 6 * b[1] + 42 * b[2] +
                                 6 * b[3] - 6 * b[4] - 8 * m[0] + 42 * m[1] +
                                 152 * m[2] + 42 * m[3] - 8 * m[4] - 6 * d[0] +
                                 6 * d[1] + 42 * d[2] + 6 * d[3] - 6 * d[4] -
                                 2 * e[0] - 6 * e[1] - 8 * e[2] - 6 * e[3] -
                                 2 * e[4]);
            int pred = static_cast<int>(
                ((Q00 << 7) + (num >= 0 ? num : -num)) / (Q00 << 8));
            ws[0] = static_cast<int16_t>(num >= 0 ? pred : -pred);
          } else {
            est(1, Q01, -7 * m[0] + 50 * m[1] - 50 * m[3] + 7 * m[4]);
            est(2, Q10, -7 * a[2] + 50 * b[2] - 50 * d[2] + 7 * e[2]);
            est(3, Q20, -a[2] + 13 * b[2] - 24 * m[2] + 13 * d[2] - e[2]);
            est(4, Q11, b[4] + d[0] - 10 * d[1] + 10 * d[3] - a[1] - d[4] +
                            e[1] - e[3] + a[3] - b[0] + 10 * b[1] - 10 * b[3]);
            est(5, Q02, -m[0] + 13 * m[1] - 24 * m[2] + 13 * m[3] - m[4]);
          }
          idct_to_plane(c, ws, bx, row);
        }
      }
    }
  }

  bool ycc() const {  // jdapimin.c's default_decompress_parms, 3 components
    if (jfif) return true;
    if (adobe) return adobe_transform != 0;
    if (comp[0].id == 1 && comp[1].id == 2 && comp[2].id == 3) return true;
    if (comp[0].id == 82 && comp[1].id == 71 && comp[2].id == 66) return false;
    return true;
  }

  // One component's samples at full size, rows clamped at the plane's
  // real edge (dw x dh): libjpeg's fancy upsampling with its context rows.
  void upsample(const Component& c, std::vector<uint8_t>& full) const {
    const int W = width, H = height;
    full.assign(static_cast<size_t>(W) * H, 0);
    const int64_t ps = int64_t(c.bw) * 8;
    const uint8_t* pl = c.plane.data();
    int hx = hmax / c.h, vx = vmax / c.v;
    auto row = [&](int r) { return pl + std::min(std::max(r, 0), c.dh - 1) * ps; };
    if (hx == 1 && vx == 1) {
      for (int y = 0; y < H; ++y) std::memcpy(&full[int64_t(y) * W], row(y), W);
      return;
    }
    const int dw = c.dw;
    if (hx == 2 && vx == 1 && dw > 2) {  // h2v1 fancy
      std::vector<uint8_t> o(static_cast<size_t>(2 * dw));
      for (int y = 0; y < H; ++y) {
        const uint8_t* in = row(y);
        o[0] = in[0];
        o[1] = static_cast<uint8_t>((in[0] * 3 + in[1] + 2) >> 2);
        for (int j = 1; j < dw - 1; ++j) {
          int v = in[j] * 3;
          o[2 * j] = static_cast<uint8_t>((v + in[j - 1] + 1) >> 2);
          o[2 * j + 1] = static_cast<uint8_t>((v + in[j + 1] + 2) >> 2);
        }
        o[2 * dw - 2] = static_cast<uint8_t>((in[dw - 1] * 3 + in[dw - 2] + 1) >> 2);
        o[2 * dw - 1] = in[dw - 1];
        std::memcpy(&full[int64_t(y) * W], o.data(), W);
      }
      return;
    }
    if (hx == 1 && vx == 2) {  // h1v2 fancy
      for (int y = 0; y < H; ++y) {
        int i = y / 2, v = y % 2;
        const uint8_t* in0 = row(i);
        const uint8_t* in1 = row(v ? i + 1 : i - 1);
        int bias = v ? 2 : 1;
        uint8_t* o = &full[int64_t(y) * W];
        for (int j = 0; j < W; ++j)
          o[j] = static_cast<uint8_t>((in0[j] * 3 + in1[j] + bias) >> 2);
      }
      return;
    }
    if (hx == 2 && vx == 2 && dw > 2) {  // h2v2 fancy
      std::vector<int> cs(static_cast<size_t>(dw));
      std::vector<uint8_t> o(static_cast<size_t>(2 * dw));
      for (int y = 0; y < H; ++y) {
        int i = y / 2, v = y % 2;
        const uint8_t* in0 = row(i);
        const uint8_t* in1 = row(v ? i + 1 : i - 1);
        for (int j = 0; j < dw; ++j) cs[j] = in0[j] * 3 + in1[j];
        o[0] = static_cast<uint8_t>((cs[0] * 4 + 8) >> 4);
        o[1] = static_cast<uint8_t>((cs[0] * 3 + cs[1] + 7) >> 4);
        for (int j = 1; j < dw - 1; ++j) {
          o[2 * j] = static_cast<uint8_t>((cs[j] * 3 + cs[j - 1] + 8) >> 4);
          o[2 * j + 1] = static_cast<uint8_t>((cs[j] * 3 + cs[j + 1] + 7) >> 4);
        }
        o[2 * dw - 2] = static_cast<uint8_t>((cs[dw - 1] * 3 + cs[dw - 2] + 8) >> 4);
        o[2 * dw - 1] = static_cast<uint8_t>((cs[dw - 1] * 4 + 7) >> 4);
        std::memcpy(&full[int64_t(y) * W], o.data(), W);
      }
      return;
    }
    // box replication: h2v1 / h2v2 at widths of 1-2, and every other ratio
    // (the rows of a v-expanded group come from one sample row, unclamped
    // within the plane, as int_upsample reads them)
    for (int y = 0; y < H; ++y) {
      const uint8_t* in = pl + int64_t(y / vx) * ps;
      uint8_t* o = &full[int64_t(y) * W];
      for (int x = 0; x < W; ++x) o[x] = in[x / hx];
    }
  }

  void output(uint8_t* out) const {
    const int64_t W = width, H = height;
    if (ncomp == 1) {
      const Component& c = comp[0];
      for (int64_t y = 0; y < H; ++y)
        std::memcpy(out + y * W, c.plane.data() + y * int64_t(c.bw) * 8, W);
      return;
    }
    std::vector<uint8_t> f[4];
    for (int i = 0; i < ncomp; ++i) upsample(comp[i], f[i]);
    const int64_t n = W * H;
    const int* crr = kYcc.crr; const int* cbb = kYcc.cbb;
    const int64_t* crg = kYcc.crg; const int64_t* cbg = kYcc.cbg;
    auto clamp = [](int v) { return static_cast<uint8_t>(v < 0 ? 0 : v > 255 ? 255 : v); };
    if (ncomp == 4) {
      // CMYK, or YCCK under an Adobe transform other than 0 (jdapimin.c),
      // turned to CMYK as ycck_cmyk_convert does (C, M, Y = 255 - the RGB
      // of Y, Cb, Cr; K as it is), then inverted as PIL's "CMYK;I"
      if (adobe && adobe_transform != 0) {
        for (int64_t i = 0; i < n; ++i) {
          int y = f[0][i], cb = f[1][i], cr = f[2][i];
          out[4 * i] = clamp(y + crr[cr]);
          out[4 * i + 1] = clamp(y + static_cast<int>((cbg[cb] + crg[cr]) >> 16));
          out[4 * i + 2] = clamp(y + cbb[cb]);
          out[4 * i + 3] = static_cast<uint8_t>(255 - f[3][i]);
        }
      } else {
        for (int64_t i = 0; i < n; ++i)
          for (int k = 0; k < 4; ++k)
            out[4 * i + k] = static_cast<uint8_t>(255 - f[k][i]);
      }
      return;
    }
    if (colour == 0 || (colour < 0 && !ycc())) {
      for (int64_t i = 0; i < n; ++i) {
        out[3 * i] = f[0][i];
        out[3 * i + 1] = f[1][i];
        out[3 * i + 2] = f[2][i];
      }
      return;
    }
    for (int64_t i = 0; i < n; ++i) {
      int y = f[0][i], cb = f[1][i], cr = f[2][i];
      out[3 * i] = clamp(y + crr[cr]);
      out[3 * i + 1] = clamp(y + static_cast<int>((cbg[cb] + crg[cr]) >> 16));
      out[3 * i + 2] = clamp(y + cbb[cb]);
    }
  }
};

// ---------------------------------------------------------------- encode

const uint8_t kStdLumaQ[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const uint8_t kStdChromaQ[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};
const uint8_t kDcLumaBits[17] = {0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcChromaBits[17] = {0, 0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumaBits[17] = {0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumaVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08,
    0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
    0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
    0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
    0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kAcChromaBits[17] = {0, 0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChromaVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
    0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
    0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
    0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7,
    0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
    0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

void std_table(Huff& t, const uint8_t* bits, const uint8_t* vals) {
  std::memcpy(t.bits, bits, 17);
  int total = 0;
  for (int l = 1; l <= 16; ++l) total += bits[l];
  std::memcpy(t.vals, vals, total);
  huff_derive(t);
}

// jccolor.c's rgb_ycc_start: R, G, B to Y, Cb, Cr in 16-bit fixed point
// (B to Cb and R to Cr share a table)
struct RgbYccTables {
  int64_t tab[8 * 256];
  RgbYccTables() {
    auto fix = [](double x) { return static_cast<int64_t>(x * 65536 + 0.5); };
    const int64_t ONE_HALF = int64_t(1) << 15, CBCR = int64_t(128) << 16;
    for (int i = 0; i < 256; ++i) {
      tab[i] = fix(0.29900) * i;
      tab[i + 256] = fix(0.58700) * i;
      tab[i + 512] = fix(0.11400) * i + ONE_HALF;
      tab[i + 768] = -fix(0.16874) * i;
      tab[i + 1024] = -fix(0.33126) * i;
      tab[i + 1280] = fix(0.50000) * i + CBCR + ONE_HALF - 1;
      tab[i + 1536] = -fix(0.41869) * i;
      tab[i + 1792] = -fix(0.08131) * i;
    }
  }
};
const RgbYccTables kRgbYcc;

// jfdctint.c's jpeg_fdct_islow, in place on level-shifted samples.
void fdct_islow(int* d) {
  for (int pass = 0; pass < 2; ++pass) {
    for (int i = 0; i < 8; ++i) {
      int step = pass ? 8 : 1;
      int* p = pass ? d + i : d + 8 * i;
      int32_t tmp0 = p[0] + p[7 * step], tmp7 = p[0] - p[7 * step];
      int32_t tmp1 = p[step] + p[6 * step], tmp6 = p[step] - p[6 * step];
      int32_t tmp2 = p[2 * step] + p[5 * step], tmp5 = p[2 * step] - p[5 * step];
      int32_t tmp3 = p[3 * step] + p[4 * step], tmp4 = p[3 * step] - p[4 * step];
      int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
      int32_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      int sh = pass ? CONST_BITS + PASS1_BITS : CONST_BITS - PASS1_BITS;
      if (pass) {
        p[0] = static_cast<int>(descale32(tmp10 + tmp11, PASS1_BITS));
        p[4 * step] = static_cast<int>(descale32(tmp10 - tmp11, PASS1_BITS));
      } else {
        p[0] = static_cast<int>((tmp10 + tmp11) * (1 << PASS1_BITS));
        p[4 * step] = static_cast<int>((tmp10 - tmp11) * (1 << PASS1_BITS));
      }
      int32_t z1 = (tmp12 + tmp13) * F0541;
      p[2 * step] = static_cast<int>(descale32(z1 + tmp13 * F0765, sh));
      p[6 * step] = static_cast<int>(descale32(z1 + tmp12 * -F1847, sh));
      z1 = tmp4 + tmp7;
      int32_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
      int32_t z5 = (z3 + z4) * F1175;
      tmp4 *= F0298;
      tmp5 *= F2053;
      tmp6 *= F3072;
      tmp7 *= F1501;
      z1 *= -F0899;
      z2 *= -F2562;
      z3 *= -F1961;
      z4 *= -F0390;
      z3 += z5;
      z4 += z5;
      p[7 * step] = static_cast<int>(descale32(tmp4 + z1 + z3, sh));
      p[5 * step] = static_cast<int>(descale32(tmp5 + z2 + z4, sh));
      p[3 * step] = static_cast<int>(descale32(tmp6 + z2 + z3, sh));
      p[step] = static_cast<int>(descale32(tmp7 + z1 + z4, sh));
    }
  }
}

// jcdctmgr.c's compute_reciprocal for 16-bit DCT elements (libjpeg-turbo's
// SIMD build, which PIL ships): quantisation as (|x| + c) * recip >> shift.
struct Divisor {
  uint32_t recip, corr;
  int shift;
};

Divisor reciprocal(uint32_t divisor) {
  if (divisor == 1) return {1, 0, 0};
  int b = 31 - __builtin_clz(divisor);  // flss(divisor) - 1
  int r = 16 + b;
  uint64_t fq = (uint64_t(1) << r) / divisor;
  uint64_t fr = (uint64_t(1) << r) % divisor;
  uint32_t c = divisor / 2;
  if (fr == 0) {
    fq >>= 1;
    --r;
  } else if (fr <= divisor / 2U) {
    ++c;
  } else {
    ++fq;
  }
  return {static_cast<uint32_t>(fq), c, r};
}

struct BitWriter {
  std::vector<uint8_t>& out;
  uint32_t acc = 0;
  int have = 0;
  void put(uint32_t code, int size) {
    acc = (acc << size) | (code & ((1u << size) - 1));
    have += size;
    while (have >= 8) {
      uint8_t b = static_cast<uint8_t>(acc >> (have - 8));
      out.push_back(b);
      if (b == 0xFF) out.push_back(0);
      have -= 8;
    }
  }
  void flush() {
    if (have) put(0x7F, 7);  // pad with 1-bits, as libjpeg's flush_bits
    have = 0;
    acc = 0;
  }
};

struct Encoder {
  int w, h, ncomp;
  uint16_t q[2][64];
  Divisor div[2][64];
  Huff dc[2], ac[2];

  void set_quality(int quality) {
    quality = std::max(1, std::min(100, quality));
    int scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
    for (int t = 0; t < 2; ++t)
      for (int i = 0; i < 64; ++i) {
        int64_t v = (int64_t((t ? kStdChromaQ : kStdLumaQ)[i]) * scale + 50) / 100;
        v = std::max<int64_t>(1, std::min<int64_t>(255, v));
        q[t][i] = static_cast<uint16_t>(v);
        div[t][i] = reciprocal(static_cast<uint32_t>(v) << 3);
      }
    std_table(dc[0], kDcLumaBits, kDcVals);
    std_table(ac[0], kAcLumaBits, kAcLumaVals);
    std_table(dc[1], kDcChromaBits, kDcVals);
    std_table(ac[1], kAcChromaBits, kAcChromaVals);
  }

  // forward DCT + quantisation of the block at (bx, by) of a plane
  void block(const uint8_t* plane, int64_t stride, int bx, int by, int t,
             int16_t* out) const {
    int d[64];
    for (int r = 0; r < 8; ++r) {
      const uint8_t* row = plane + (int64_t(by) * 8 + r) * stride + int64_t(bx) * 8;
      for (int c = 0; c < 8; ++c) d[r * 8 + c] = int(row[c]) - 128;
    }
    fdct_islow(d);
    for (int i = 0; i < 64; ++i) {
      const Divisor& dv = div[t][i];
      int x = d[i];
      uint32_t a = static_cast<uint32_t>(x < 0 ? -x : x);
      uint32_t v;
      if (dv.recip == 1 && dv.corr == 0 && dv.shift == 0) {
        v = a;
      } else {
        uint64_t prod = uint64_t(a + dv.corr) * dv.recip;
        v = static_cast<uint32_t>(prod >> (dv.shift));
        v &= 0xFFFF;
      }
      out[i] = static_cast<int16_t>(x < 0 ? -static_cast<int>(v) : static_cast<int>(v));
    }
  }

  static void emit(BitWriter& bw, const Huff& dct, const Huff& act,
                   const int16_t* b, int& pred) {
    int diff = b[0] - pred;
    pred = b[0];
    int t = diff, t2 = diff;
    if (t < 0) {
      t = -t;
      --t2;
    }
    int nb = t ? 32 - __builtin_clz(static_cast<unsigned>(t)) : 0;
    bw.put(dct.code[nb], dct.size[nb]);
    if (nb) bw.put(static_cast<uint32_t>(t2), nb);
    int run = 0;
    for (int k = 1; k < 64; ++k) {
      int v = b[kZigzag[k]];
      if (v == 0) {
        ++run;
        continue;
      }
      while (run > 15) {
        bw.put(act.code[0xF0], act.size[0xF0]);
        run -= 16;
      }
      t = v;
      t2 = v;
      if (t < 0) {
        t = -t;
        --t2;
      }
      nb = 32 - __builtin_clz(static_cast<unsigned>(t));
      int rs = (run << 4) + nb;
      bw.put(act.code[rs], act.size[rs]);
      bw.put(static_cast<uint32_t>(t2), nb);
      run = 0;
    }
    if (run > 0) bw.put(act.code[0], act.size[0]);
  }
};

void put16(std::vector<uint8_t>& o, int v) {
  o.push_back(static_cast<uint8_t>(v >> 8));
  o.push_back(static_cast<uint8_t>(v & 0xFF));
}

void marker_dqt(std::vector<uint8_t>& o, const uint16_t* q, int id) {
  o.push_back(0xFF);
  o.push_back(0xDB);
  put16(o, 67);
  o.push_back(static_cast<uint8_t>(id));
  for (int k = 0; k < 64; ++k) o.push_back(static_cast<uint8_t>(q[kZigzag[k]]));
}

void marker_dht(std::vector<uint8_t>& o, const Huff& t, int cls, int id) {
  int total = 0;
  for (int l = 1; l <= 16; ++l) total += t.bits[l];
  o.push_back(0xFF);
  o.push_back(0xC4);
  put16(o, 2 + 1 + 16 + total);
  o.push_back(static_cast<uint8_t>((cls << 4) | id));
  for (int l = 1; l <= 16; ++l) o.push_back(t.bits[l]);
  for (int i = 0; i < total; ++i) o.push_back(t.vals[i]);
}

// Encode: img holds h rows of w pixels of `in_comp` bytes (1 gray, 3 RGB).
// color: 0 writes one component (gray input only), 1 three (YCbCr 4:2:0;
// gray input gives Cb = Cr = 128).
bool jpeg_encode(const uint8_t* img, int w, int h, int in_comp, int quality,
                 int color, std::vector<uint8_t>& o) {
  Encoder e;
  e.w = w;
  e.h = h;
  e.ncomp = color ? 3 : 1;
  e.set_quality(quality);
  const int hs = color ? 2 : 1;  // the luma's sampling factors
  const int mw = 8 * hs, mh = 8 * hs;
  const int mcux = (w + mw - 1) / mw, mcuy = (h + mh - 1) / mh;
  // planes as jcprepct / jcsample leave them: luma at ceil(w / 8) blocks
  // wide, its right edge and bottom rows replicated
  const int ybw = (w + 7) / 8;
  const int ybh_rows = mcuy * mh;  // rows through the last iMCU row
  const int64_t ys = int64_t(ybw) * 8;
  std::vector<uint8_t> Y(static_cast<size_t>(ys * ybh_rows));
  std::vector<uint8_t> CB, CR;
  int cbw = 0;
  int64_t cs = 0;
  // the full-size chroma rows before downsampling
  std::vector<uint8_t> fcb, fcr;
  const int fw = color ? 2 * ((w + 15) / 16) * 8 : 0;  // 2 * output_cols
  if (color) {
    cbw = (w + 15) / 16;
    cs = int64_t(cbw) * 8;
    CB.assign(static_cast<size_t>(cs * mcuy * 8), 0);
    CR.assign(static_cast<size_t>(cs * mcuy * 8), 0);
    fcb.assign(static_cast<size_t>(2 * fw), 0);
    fcr.assign(static_cast<size_t>(2 * fw), 0);
  }
  const int64_t* tab = kRgbYcc.tab;
  const int rows_real = h;
  int crow = 0;  // downsampled chroma rows written
  for (int y = 0; y < ((rows_real + hs - 1) / hs) * hs; y += hs) {
    for (int k = 0; k < hs; ++k) {
      int sy = std::min(y + k, rows_real - 1);  // expand_bottom_edge
      const uint8_t* src = img + int64_t(sy) * w * in_comp;
      uint8_t* yr = &Y[int64_t(y + k) * ys];
      uint8_t* br = color ? &fcb[int64_t(k) * fw] : nullptr;
      uint8_t* rr = color ? &fcr[int64_t(k) * fw] : nullptr;
      for (int x = 0; x < w; ++x) {
        if (in_comp == 1) {
          yr[x] = src[x];
          if (color) {
            br[x] = 128;
            rr[x] = 128;
          }
        } else {
          int r = src[3 * x], g = src[3 * x + 1], b = src[3 * x + 2];
          yr[x] = static_cast<uint8_t>((tab[r] + tab[g + 256] + tab[b + 512]) >> 16);
          if (color) {
            br[x] = static_cast<uint8_t>((tab[r + 768] + tab[g + 1024] + tab[b + 1280]) >> 16);
            rr[x] = static_cast<uint8_t>((tab[r + 1280] + tab[g + 1536] + tab[b + 1792]) >> 16);
          }
        }
      }
      for (int x = w; x < ys; ++x) yr[x] = yr[w - 1];  // expand_right_edge
      if (color)
        for (int x = w; x < fw; ++x) {
          br[x] = br[w - 1];
          rr[x] = rr[w - 1];
        }
    }
    if (color) {  // h2v2_downsample, bias 1, 2, 1, 2 ...
      uint8_t* ob = &CB[int64_t(crow) * cs];
      uint8_t* orr = &CR[int64_t(crow) * cs];
      for (int x = 0; x < cs; ++x) {
        int bias = (x & 1) ? 2 : 1;
        ob[x] = static_cast<uint8_t>((fcb[2 * x] + fcb[2 * x + 1] + fcb[fw + 2 * x] +
                                      fcb[fw + 2 * x + 1] + bias) >> 2);
        orr[x] = static_cast<uint8_t>((fcr[2 * x] + fcr[2 * x + 1] + fcr[fw + 2 * x] +
                                       fcr[fw + 2 * x + 1] + bias) >> 2);
      }
      ++crow;
    }
  }
  // pad to whole iMCU rows by the last row (jcprepct's expand_bottom_edge)
  int yrows = ((rows_real + hs - 1) / hs) * hs;
  for (int y = yrows; y < ybh_rows; ++y)
    std::memcpy(&Y[int64_t(y) * ys], &Y[int64_t(yrows - 1) * ys], ys);
  if (color)
    for (int y = crow; y < mcuy * 8; ++y) {
      std::memcpy(&CB[int64_t(y) * cs], &CB[int64_t(crow - 1) * cs], cs);
      std::memcpy(&CR[int64_t(y) * cs], &CR[int64_t(crow - 1) * cs], cs);
    }

  // headers
  o.clear();
  o.reserve(static_cast<size_t>(w) * h / 2 + 1024);
  const uint8_t head[] = {0xFF, 0xD8, 0xFF, 0xE0, 0, 16, 'J', 'F', 'I', 'F', 0,
                          1,    1,    0,    0,    1, 0,  1,   0,   0};
  o.insert(o.end(), head, head + sizeof head);
  marker_dqt(o, e.q[0], 0);
  if (color) marker_dqt(o, e.q[1], 1);
  o.push_back(0xFF);
  o.push_back(0xC0);
  put16(o, 8 + 3 * e.ncomp);
  o.push_back(8);
  put16(o, h);
  put16(o, w);
  o.push_back(static_cast<uint8_t>(e.ncomp));
  for (int i = 0; i < e.ncomp; ++i) {
    o.push_back(static_cast<uint8_t>(i + 1));
    o.push_back(static_cast<uint8_t>(i == 0 ? (hs << 4) | hs : 0x11));
    o.push_back(static_cast<uint8_t>(i == 0 ? 0 : 1));
  }
  marker_dht(o, e.dc[0], 0, 0);
  marker_dht(o, e.ac[0], 1, 0);
  if (color) {
    marker_dht(o, e.dc[1], 0, 1);
    marker_dht(o, e.ac[1], 1, 1);
  }
  o.push_back(0xFF);
  o.push_back(0xDA);
  put16(o, 6 + 2 * e.ncomp);
  o.push_back(static_cast<uint8_t>(e.ncomp));
  for (int i = 0; i < e.ncomp; ++i) {
    o.push_back(static_cast<uint8_t>(i + 1));
    o.push_back(static_cast<uint8_t>(i == 0 ? 0x00 : 0x11));
  }
  o.push_back(0);
  o.push_back(63);
  o.push_back(0);

  BitWriter bw{o};
  int pred[3] = {0, 0, 0};
  int16_t blk[64];
  const int ybh = (h + 7) / 8;  // luma blocks down (the rest are dummies)
  if (!color) {
    for (int by = 0; by < ybh; ++by)
      for (int bx = 0; bx < ybw; ++bx) {
        e.block(Y.data(), ys, bx, by, 0, blk);
        Encoder::emit(bw, e.dc[0], e.ac[0], blk, pred[0]);
      }
  } else {
    const int last_col = ybw % 2 ? 1 : 2, last_row = ybh % 2 ? 1 : 2;
    for (int my = 0; my < mcuy; ++my)
      for (int mx = 0; mx < mcux; ++mx) {
        // jccoefct.c's compress_data: a block past the luma's real blocks
        // is a dummy, AC 0 and DC the block before it in the MCU (in a
        // bottom dummy row, the last block of the row above)
        int16_t yb[4][64];
        int cnt = mx < mcux - 1 ? 2 : last_col;
        for (int v = 0; v < 2; ++v) {
          bool real = my < mcuy - 1 || v < last_row;
          for (int u = 0; u < 2; ++u) {
            int16_t* b = yb[2 * v + u];
            if (real && u < cnt) {
              e.block(Y.data(), ys, 2 * mx + u, 2 * my + v, 0, b);
            } else {
              std::memset(b, 0, 64 * sizeof(int16_t));
              b[0] = real ? yb[2 * v + u - 1][0] : yb[2 * v - 1][0];
            }
          }
        }
        for (int k = 0; k < 4; ++k)
          Encoder::emit(bw, e.dc[0], e.ac[0], yb[k], pred[0]);
        e.block(CB.data(), cs, mx, my, 1, blk);
        Encoder::emit(bw, e.dc[1], e.ac[1], blk, pred[1]);
        e.block(CR.data(), cs, mx, my, 1, blk);
        Encoder::emit(bw, e.dc[1], e.ac[1], blk, pred[2]);
      }
  }
  bw.flush();
  o.push_back(0xFF);
  o.push_back(0xD9);
  return true;
}

}  // namespace

extern "C" {

int imgcodec_abi_version() { return 2; }

// LZW: the bytes written to out (at most cap), -1 when the stream is not
// valid, -3 for the old-style (LSB-first) LZW of early writers.
int64_t imgcodec_lzw_decode(const uint8_t* in, int64_t n, uint8_t* out,
                            int64_t cap) {
  try {
    return lzw_decode(in, n, out, cap);
  } catch (const std::exception&) {
    return -1;
  }
}

// PNG: raw is the inflated IDAT stream; out gets h rows of
// ceil(w * bits / 8) bytes.  bits: bits a pixel (depth x channels).
// 0 on success, -1 data cut short, -2 a bad filter type.
int64_t imgcodec_png_unfilter(const uint8_t* raw, int64_t n, uint8_t* out,
                              int64_t w, int64_t h, int32_t bits,
                              int32_t interlace) {
  try {
    return png_unfilter(raw, n, out, w, h, bits, interlace);
  } catch (const std::exception&) {
    return -1;
  }
}

// JPEG decode.  info[0..2] get width, height and components out (1, 3 or
// 4: CMYK, inverted as PIL's "CMYK;I").
// With out == nullptr only the markers up to the frame header are read.  tables:
// an abbreviated tables-only stream read first, or nullptr.  colour: three
// components turn from YCbCr to RGB as the markers say (-1, libjpeg's
// default), never (0: libtiff's JPEG outside photometric YCbCr, which then
// takes no subsampled component) or always (1); a TIFF's flag (0 or 1)
// refuses four components.  0 on success, -1 with a message in err.
int32_t imgcodec_jpeg_decode(const uint8_t* data, int64_t n,
                             const uint8_t* tables, int64_t tn, uint8_t* out,
                             int64_t cap, int32_t* info, char* err,
                             int32_t errcap, int32_t colour) {
  Error e;
  e.msg[0] = 0;
  bool ok = true;
  try {  // no C++ exception may cross into ctypes
    Decoder d;
    d.err = &e;
    if (tables && tn > 0) ok = d.parse(tables, tn, true);
    d.header_only = out == nullptr;
    d.colour = colour;
    if (ok) ok = d.parse(data, n, false);
    if (ok && !d.frame) ok = d.fail("a JPEG without a frame header");
    if (ok && out)
      for (int i = 0; i < d.ncomp; ++i)
        if (!d.comp[i].seen) ok = d.fail("a JPEG component without a scan");
    if (ok && colour >= 0 && d.ncomp == 4)
      ok = d.fail("a four-component JPEG inside a TIFF is not read");
    if (ok && colour == 0 && d.ncomp > 1)
      for (int i = 0; i < d.ncomp; ++i)
        if (d.comp[i].h != d.hmax || d.comp[i].v != d.vmax)
          ok = d.fail("subsampled JPEG components outside photometric "
                      "YCbCr (libtiff reads them 1:1 only)");
    if (ok) {
      info[0] = d.width;
      info[1] = d.height;
      info[2] = d.ncomp;
      if (out) {
        if (cap < int64_t(d.width) * d.height * d.ncomp)
          ok = d.fail("the output buffer is too small");
        else {
          if (d.progressive) d.finish_progressive();
          d.output(out);
        }
      }
    }
  } catch (const std::exception& x) {
    std::snprintf(e.msg, sizeof e.msg, "out of memory or internal error: %s",
                  x.what());
    ok = false;
  }
  if (!ok && err && errcap > 0) std::snprintf(err, errcap, "%s", e.msg);
  return ok ? 0 : -1;
}

// JPEG encode into out[0:cap]: the bytes written, -(bytes needed), or 0
// when the plane is out of JPEG's range or memory ran out.
int64_t imgcodec_jpeg_encode(const uint8_t* img, int32_t w, int32_t h,
                             int32_t in_comp, int32_t quality, int32_t color,
                             uint8_t* out, int64_t cap) {
  std::vector<uint8_t> o;
  if (w <= 0 || h <= 0 || w > 65535 || h > 65535) return 0;
  try {
    jpeg_encode(img, w, h, in_comp, quality, color, o);
  } catch (const std::exception&) {
    return 0;
  }
  int64_t n = static_cast<int64_t>(o.size());
  if (n > cap) return -n;
  std::memcpy(out, o.data(), o.size());
  return n;
}

}  // extern "C"
