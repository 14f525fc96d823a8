// Zstandard decoder (RFC 8878, sections 3.1 and 4), for io/zstd.py (loaded
// through ctypes; built with g++ at first use into build/ipp_tpu_torch/).
// It reads what a TIFF strip or tile compressed with zstd (compression
// 50000) holds, without libzstd: there is no Python fallback, so a read
// that needs this library raises when it does not build.
//
// Frames: every frame of the data in a row; skippable frames are skipped;
// the frame header's every field size (FCS of 0 / 1 / 2 (+256) / 4 / 8
// bytes, single-segment frames and window descriptors, a dictionary ID of
// 0).  Blocks: raw, RLE and compressed.  Literals: raw, RLE, Huffman-coded
// (1 or 4 streams) and treeless (the frame's last Huffman table), the table
// given by FSE-compressed or 4-bit direct weights.  Sequences: predefined,
// RLE, FSE-compressed and repeat tables for literal lengths, offsets and
// match lengths; repeat offsets; matches reaching back over earlier blocks
// of the frame.  The content checksum (XXH64, its low 32 bits) is checked.
//
// Everything else raises with a message naming it: a dictionary, a legacy
// (pre-1.0) frame (both "not read", return code -2), the reserved block
// type, a block past the frame's maximum, a checksum that does not match,
// and every malformed length, offset, table or bitstream (return code -1).
// Every read and write is bounded: the output is exactly the caller's
// buffer (no copy runs past it), and a backward bitstream is never read
// before its first byte.

#include <algorithm>
#include <cstdarg>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <exception>
#include <memory>
#include <string>

static_assert(__BYTE_ORDER__ == __ORDER_LITTLE_ENDIAN__,
              "zstd.cpp reads little-endian words with memcpy");

namespace {

struct ZstdError : std::exception {
  std::string msg;
  bool unsupported;
  ZstdError(std::string m, bool u) : msg(std::move(m)), unsupported(u) {}
  const char* what() const noexcept override { return msg.c_str(); }
};

[[noreturn]] __attribute__((format(printf, 1, 2))) void fail(const char* fmt,
                                                             ...) {
  char buf[256];
  va_list ap;
  va_start(ap, fmt);
  vsnprintf(buf, sizeof buf, fmt, ap);
  va_end(ap);
  throw ZstdError(buf, false);
}

[[noreturn]] void refuse(const std::string& m) { throw ZstdError(m, true); }

inline uint64_t load64(const uint8_t* p) {
  uint64_t v;
  memcpy(&v, p, 8);
  return v;
}
inline uint32_t le(const uint8_t* p, int n) {  // n <= 4
  uint32_t v = 0;
  for (int i = 0; i < n; ++i) v |= uint32_t(p[i]) << (8 * i);
  return v;
}
inline int highbit(uint32_t v) { return 31 - __builtin_clz(v); }  // v > 0

constexpr uint32_t kMagic = 0xFD2FB528u;
constexpr int64_t kBlockMax = 128 * 1024;

// ---------------------------------------------------------------- bits --

// LSB-first reader of an FSE table description (a few bytes, bit by bit).
struct ForwardBits {
  const uint8_t* p;
  uint64_t nbits, pos = 0;
  ForwardBits(const uint8_t* src, size_t n) : p(src), nbits(8 * uint64_t(n)) {}
  uint32_t read(int k) {
    if (pos + k > nbits) fail("an FSE table description runs past its data");
    uint32_t v = 0;
    for (int i = 0; i < k; ++i, ++pos) v |= ((p[pos >> 3] >> (pos & 7)) & 1u) << i;
    return v;
  }
  size_t bytes() const { return size_t((pos + 7) >> 3); }
};

// A backward bitstream (Huffman streams, FSE weights, sequences): read from
// the bit below the last byte's highest set bit towards bit 0; bits below
// bit 0 read as zeros and leave `pos` negative (an overrun the caller
// checks).
struct BackBits {
  const uint8_t* p = nullptr;
  int64_t n = 0, pos = 0;  // pos: bits not yet read
  void init(const uint8_t* src, int64_t len, const char* what) {
    if (len <= 0) fail("an empty %s bitstream", what);
    if (!src[len - 1]) fail("a %s bitstream whose last byte is 0", what);
    p = src;
    n = len;
    pos = 8 * (len - 1) + highbit(src[len - 1]);
  }
  inline uint64_t peek(int k) const {  // 0 <= k <= 56
    int64_t lo = pos - k;
    if (lo >= 0) {
      int64_t b = lo >> 3;  // < n, since pos < 8 n
      uint64_t v = 0;
      if (b + 8 <= n)
        v = load64(p + b);
      else
        memcpy(&v, p + b, size_t(n - b));
      return (v >> (lo & 7)) & ((uint64_t(1) << k) - 1);
    }
    if (pos <= 0) return 0;
    uint64_t v = 0;  // pos < k <= 56: bits [0, pos) lie in the first 7 bytes
    memcpy(&v, p, size_t(n < 8 ? n : 8));
    return (v & ((uint64_t(1) << pos) - 1)) << (-lo);
  }
  inline uint64_t read(int k) {
    uint64_t v = peek(k);
    pos -= k;
    return v;
  }
};

// ----------------------------------------------------------------- FSE --

struct FseCell {
  uint16_t base;
  uint8_t sym, nb;
};

struct Fse {
  int al = -1;  // -1: no table yet
  FseCell t[512];
};

void build_fse(Fse& f, const int16_t* norm, int nsym, int al) {
  const int size = 1 << al;
  uint8_t symbols[512];
  uint16_t next[256];
  int high = size;
  for (int s = 0; s < nsym; ++s)
    if (norm[s] == -1) {
      symbols[--high] = uint8_t(s);  // "less than 1": at the table's end
      next[s] = 1;
    }
  const int step = (size >> 1) + (size >> 3) + 3, mask = size - 1;
  int pos = 0;
  for (int s = 0; s < nsym; ++s) {
    if (norm[s] <= 0) continue;
    next[s] = uint16_t(norm[s]);
    for (int i = 0; i < norm[s]; ++i) {
      symbols[pos] = uint8_t(s);
      do pos = (pos + step) & mask;
      while (pos >= high);
    }
  }
  if (pos != 0) fail("an FSE table whose symbols do not fill its cells");
  for (int i = 0; i < size; ++i) {
    const int s = symbols[i];
    const uint32_t x = next[s]++;
    const int nb = al - highbit(x);
    f.t[i] = FseCell{uint16_t((x << nb) - size), uint8_t(s), uint8_t(nb)};
  }
  f.al = al;
}

void rle_fse(Fse& f, int sym) {
  f.t[0] = FseCell{0, uint8_t(sym), 0};
  f.al = 0;
}

// An FSE table description (RFC 8878 4.1.1) at src; returns its bytes.
size_t read_fse(const uint8_t* src, size_t avail, int max_al, int max_sym,
                Fse& f, const char* what) {
  ForwardBits br(src, avail);
  const int al = 5 + int(br.read(4));
  if (al > max_al)
    fail("the %s table's accuracy log %d is past %d", what, al, max_al);
  int16_t norm[256];
  int remaining = 1 << al, nsym = 0;
  while (remaining > 0) {
    if (nsym > max_sym) fail("the %s table has symbols past %d", what, max_sym);
    const int bits = highbit(uint32_t(remaining + 1)) + 1;
    uint32_t val = br.read(bits);
    const uint32_t low = (1u << (bits - 1)) - 1;
    const uint32_t threshold = (1u << bits) - 1 - uint32_t(remaining + 1);
    if ((val & low) < threshold) {
      br.pos -= 1;  // a small value: bits - 1 bits
      val &= low;
    } else if (val > low) {
      val -= threshold;
    }
    const int proba = int(val) - 1;  // -1: "less than 1"
    remaining -= proba < 0 ? -proba : proba;
    norm[nsym++] = int16_t(proba);
    if (proba == 0) {  // 2-bit repeat flags of further zero probabilities
      uint32_t repeat = br.read(2);
      for (;;) {
        for (uint32_t i = 0; i < repeat; ++i) {
          if (nsym > max_sym)
            fail("the %s table has symbols past %d", what, max_sym);
          norm[nsym++] = 0;
        }
        if (repeat != 3) break;
        repeat = br.read(2);
      }
    }
  }
  if (remaining != 0)
    fail("the %s table's probabilities do not sum to %d", what, 1 << al);
  build_fse(f, norm, nsym, al);
  return br.bytes();
}

// The predefined distributions (RFC 8878 3.1.1.3.2.2).
const int16_t kLLNorm[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2,
                             2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2,
                             2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t kMLNorm[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1,  1,  1,  1,
                             1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,  1,  1,  1,
                             1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,  1,  1,  1,
                             1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t kOFNorm[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                             1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

struct Predefined {
  Fse ll, ml, of;
  Predefined() {
    build_fse(ll, kLLNorm, 36, 6);
    build_fse(ml, kMLNorm, 53, 6);
    build_fse(of, kOFNorm, 29, 5);
  }
};

const Predefined& predefined() {
  static const Predefined p;
  return p;
}

// Literal and match length codes: baseline and extra bits (3.1.1.3.2.1).
const uint32_t kLLBase[36] = {0,    1,    2,     3,     4,     5,    6,    7,
                              8,    9,    10,    11,    12,    13,   14,   15,
                              16,   18,   20,    22,    24,    28,   32,   40,
                              48,   64,   128,   256,   512,   1024, 2048, 4096,
                              8192, 16384, 32768, 65536};
const uint8_t kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  0,  0,
                             0, 0, 0, 0, 1, 1, 1, 1, 2,  2,  3,  3,
                             4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t kMLBase[53] = {
    3,  4,  5,  6,  7,  8,  9,  10,  11,  12,  13,   14,   15,   16,
    17, 18, 19, 20, 21, 22, 23, 24,  25,  26,  27,   28,   29,   30,
    31, 32, 33, 34, 35, 37, 39, 41,  43,  47,  51,   59,   67,   83,
    99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const uint8_t kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3, 4, 4,
                             5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};

// ------------------------------------------------------------- Huffman --

struct Huffman {
  int maxbits = 0;  // 0: no table yet
  uint16_t cell[1 << 11];  // symbol | bits << 8
};

// The table of `n` explicit weights; the last symbol's weight is implied.
void build_huffman(Huffman& h, uint8_t* w, int n) {
  uint32_t total = 0;
  for (int i = 0; i < n; ++i) {
    if (w[i] > 11) fail("a Huffman weight of %d (11 at most)", w[i]);
    if (w[i]) total += 1u << (w[i] - 1);
  }
  if (total == 0) fail("a Huffman table with no weights");
  const int maxbits = highbit(total) + 1;
  if (maxbits > 11)
    fail("a Huffman table of %d bits (11 at most)", maxbits);
  const uint32_t left = (1u << maxbits) - total;
  if (left & (left - 1))
    fail("Huffman weights whose remainder %u is not a power of 2", left);
  w[n] = uint8_t(highbit(left) + 1);
  const int nsym = n + 1;
  int count[13] = {0};
  for (int s = 0; s < nsym; ++s)
    if (w[s]) ++count[maxbits + 1 - w[s]];
  if (count[maxbits] < 2 || (count[maxbits] & 1))
    fail("a Huffman table whose %d longest codes are not paired",
         count[maxbits]);
  uint32_t start[13];
  start[maxbits] = 0;  // the longest codes (lowest weights) come first
  for (int b = maxbits; b >= 1; --b)
    start[b - 1] = start[b] + (uint32_t(count[b]) << (maxbits - b));
  for (int s = 0; s < nsym; ++s) {
    if (!w[s]) continue;
    const int bits = maxbits + 1 - w[s];
    const uint32_t len = 1u << (maxbits - bits);
    for (uint32_t i = 0; i < len; ++i)
      h.cell[start[bits] + i] = uint16_t(s | bits << 8);
    start[bits] += len;
  }
  h.maxbits = maxbits;
}

// A Huffman tree description (4.2.1) at src; returns its bytes.
size_t read_huffman(const uint8_t* src, size_t avail, Huffman& h) {
  if (avail < 1) fail("the literals end before their Huffman table");
  const int hb = src[0];
  uint8_t w[256];
  int n = 0;
  size_t used;
  if (hb >= 128) {  // 4-bit direct weights
    n = hb - 127;
    const size_t bytes = size_t(n + 1) / 2;
    if (1 + bytes > avail) fail("the Huffman weights run past the literals");
    for (int i = 0; i < n; ++i)
      w[i] = (i & 1) ? (src[1 + i / 2] & 15) : (src[1 + i / 2] >> 4);
    used = 1 + bytes;
  } else {  // FSE-compressed weights, two interleaved states
    const size_t size = size_t(hb);
    if (size == 0 || 1 + size > avail)
      fail("FSE-compressed Huffman weights of %zu bytes", size);
    Fse f;
    const size_t head = read_fse(src + 1, size, 6, 12, f, "Huffman weight");
    if (head >= size) fail("the Huffman weights' FSE table leaves no stream");
    BackBits br;
    br.init(src + 1 + head, int64_t(size - head), "Huffman weight");
    uint32_t s1 = uint32_t(br.read(f.al)), s2 = uint32_t(br.read(f.al));
    for (;;) {
      if (n > 253) fail("more than 255 Huffman weights");
      w[n++] = f.t[s1].sym;
      s1 = f.t[s1].base + uint32_t(br.read(f.t[s1].nb));
      if (br.pos < 0) {
        w[n++] = f.t[s2].sym;
        break;
      }
      if (n > 253) fail("more than 255 Huffman weights");
      w[n++] = f.t[s2].sym;
      s2 = f.t[s2].base + uint32_t(br.read(f.t[s2].nb));
      if (br.pos < 0) {
        w[n++] = f.t[s1].sym;
        break;
      }
    }
    used = 1 + size;
  }
  build_huffman(h, w, n);
  return used;
}

// Huffman streams decoded side by side (1 or 4), each to its own count of
// literals and then checked to be consumed exactly: four independent chains
// of table reads keep the core busy where one would wait on each read.
struct HuffmanStream {
  BackBits br;
  uint8_t* out;
  int64_t count;
};

void huffman_streams(const Huffman& h, HuffmanStream* s, int k) {
  const int mb = h.maxbits;
  int64_t common = s[0].count;
  for (int j = 1; j < k; ++j) common = std::min(common, s[j].count);
  if (k == 4) {
    for (int64_t i = 0; i < common; ++i) {
      const uint16_t c0 = h.cell[s[0].br.peek(mb)];
      const uint16_t c1 = h.cell[s[1].br.peek(mb)];
      const uint16_t c2 = h.cell[s[2].br.peek(mb)];
      const uint16_t c3 = h.cell[s[3].br.peek(mb)];
      s[0].out[i] = uint8_t(c0);
      s[1].out[i] = uint8_t(c1);
      s[2].out[i] = uint8_t(c2);
      s[3].out[i] = uint8_t(c3);
      s[0].br.pos -= c0 >> 8;
      s[1].br.pos -= c1 >> 8;
      s[2].br.pos -= c2 >> 8;
      s[3].br.pos -= c3 >> 8;
    }
  } else {
    common = 0;
  }
  for (int j = 0; j < k; ++j) {
    BackBits& br = s[j].br;
    for (int64_t i = common; i < s[j].count; ++i) {
      const uint16_t c = h.cell[br.peek(mb)];
      s[j].out[i] = uint8_t(c);
      br.pos -= c >> 8;
    }
    if (br.pos != 0)
      fail("a Huffman stream that its %lld literals do not consume exactly",
           (long long)s[j].count);
  }
}

// --------------------------------------------------------------- XXH64 --

constexpr uint64_t P1 = 0x9E3779B185EBCA87ull, P2 = 0xC2B2AE3D27D4EB4Full,
                   P3 = 0x165667B19E3779F9ull, P4 = 0x85EBCA77C2B2AE63ull,
                   P5 = 0x27D4EB2F165667C5ull;
inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
inline uint64_t xround(uint64_t acc, uint64_t in) {
  return rotl(acc + in * P2, 31) * P1;
}
inline uint64_t xmerge(uint64_t h, uint64_t v) {
  return (h ^ xround(0, v)) * P1 + P4;
}

uint64_t xxh64(const uint8_t* p, size_t len) {  // seed 0
  const uint8_t* end = p + len;
  uint64_t h;
  if (len >= 32) {
    uint64_t v1 = P1 + P2, v2 = P2, v3 = 0, v4 = 0 - P1;
    for (; p + 32 <= end; p += 32) {
      v1 = xround(v1, load64(p));
      v2 = xround(v2, load64(p + 8));
      v3 = xround(v3, load64(p + 16));
      v4 = xround(v4, load64(p + 24));
    }
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = xmerge(xmerge(xmerge(xmerge(h, v1), v2), v3), v4);
  } else {
    h = P5;
  }
  h += len;
  for (; p + 8 <= end; p += 8) h = rotl(h ^ xround(0, load64(p)), 27) * P1 + P4;
  if (p + 4 <= end) {
    h = rotl(h ^ (uint64_t(le(p, 4)) * P1), 23) * P2 + P3;
    p += 4;
  }
  for (; p < end; ++p) h = rotl(h ^ (*p * P5), 11) * P1;
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

// --------------------------------------------------------------- frame --

struct Decoder {
  uint8_t* dst;
  int64_t cap;
  int64_t op = 0;      // bytes written
  int64_t fstart = 0;  // where the current frame's output starts
  int64_t fend = 0;    // where it must end (its content size), or cap
  int64_t block_max = kBlockMax;
  Huffman huf;
  Fse ll, of, ml;
  uint64_t rep[3];
  uint8_t lit[kBlockMax + 16];  // 16 bytes of slack for short copies

  // A block whose output would pass `block_end`: name the limit it passes.
  [[noreturn]] void past(int64_t block_end) const {
    if (block_end < std::min(cap, fend))
      fail("a block that decodes to more than %lld bytes",
           (long long)block_max);
    if (fend < cap)
      fail("a frame longer than its content size %lld",
           (long long)(fend - fstart));
    fail("the data hold more than the strip's %lld bytes", (long long)cap);
  }

  void literal_copy(const uint8_t* src, int64_t n) {
    memcpy(dst + op, src, size_t(n));
    op += n;
  }

  void match_copy(uint64_t offset, int64_t n) {
    uint8_t* d = dst + op;
    const uint8_t* s = d - offset;
    if (offset >= uint64_t(n)) {
      memcpy(d, s, size_t(n));
    } else if (offset == 1) {
      memset(d, *s, size_t(n));
    } else if (offset >= 8) {  // each 8-byte piece lies wholly behind d
      int64_t i = 0;
      for (; i + 8 <= n; i += 8) memcpy(d + i, s + i, 8);
      for (; i < n; ++i) d[i] = s[i];
    } else {
      for (int64_t i = 0; i < n; ++i) d[i] = s[i];
    }
    op += n;
  }

  // The literals section (3.1.1.3.1); returns its bytes and sets *lits,
  // *nlits.
  size_t literals(const uint8_t* ip, size_t avail, const uint8_t** lits,
                  int64_t* nlits) {
    const int type = ip[0] & 3, sf = (ip[0] >> 2) & 3;
    if (type <= 1) {  // raw or RLE
      size_t head;
      int64_t regen;
      if (sf == 0 || sf == 2) {
        head = 1;
        regen = ip[0] >> 3;
      } else {
        head = sf == 1 ? 2 : 3;
        if (head > avail) fail("the block ends inside its literals header");
        regen = (ip[0] >> 4) + (int64_t(ip[1]) << 4) +
                (head == 3 ? int64_t(ip[2]) << 12 : 0);
      }
      if (regen > block_max)
        fail("%lld literals in a block of %lld bytes at most",
             (long long)regen, (long long)block_max);
      if (type == 0) {
        if (head + regen > avail) fail("raw literals run past their block");
        *lits = ip + head;
        *nlits = regen;
        return head + size_t(regen);
      }
      if (head + 1 > avail) fail("RLE literals run past their block");
      memset(lit, ip[head], size_t(regen));
      *lits = lit;
      *nlits = regen;
      return head + 1;
    }
    // Huffman-coded (2) or treeless (3)
    static const int kHead[4] = {3, 3, 4, 5}, kBits[4] = {10, 10, 14, 18};
    const size_t head = size_t(kHead[sf]);
    if (head > avail) fail("the block ends inside its literals header");
    uint64_t h = 0;
    for (size_t i = 0; i < head; ++i) h |= uint64_t(ip[i]) << (8 * i);
    const uint64_t mask = (uint64_t(1) << kBits[sf]) - 1;
    const int64_t regen = int64_t((h >> 4) & mask);
    const int64_t comp = int64_t((h >> (4 + kBits[sf])) & mask);
    if (regen > block_max)
      fail("%lld literals in a block of %lld bytes at most",
           (long long)regen, (long long)block_max);
    if (head + size_t(comp) > avail)
      fail("compressed literals of %lld bytes run past their block",
           (long long)comp);
    const uint8_t* p = ip + head;
    const uint8_t* q = p + comp;
    if (type == 2) {
      p += read_huffman(p, size_t(q - p), huf);
    } else if (!huf.maxbits) {
      fail("treeless literals with no Huffman table earlier in the frame");
    }
    HuffmanStream hs[4];
    if (sf == 0) {
      hs[0].br.init(p, q - p, "Huffman");
      hs[0].out = lit;
      hs[0].count = regen;
      huffman_streams(huf, hs, 1);
    } else {
      if (q - p < 6) fail("4 Huffman streams without their jump table");
      const int64_t size[4] = {le(p, 2), le(p + 2, 2), le(p + 4, 2),
                               (q - p) - 6 - le(p, 2) - le(p + 2, 2) -
                                   le(p + 4, 2)};
      if (size[3] < 1) fail("a Huffman jump table past its literals");
      const int64_t seg = (regen + 3) / 4;
      if (3 * seg > regen)
        fail("%lld literals in 4 Huffman streams", (long long)regen);
      const uint8_t* at = p + 6;
      for (int j = 0; j < 4; ++j) {
        hs[j].br.init(at, size[j], "Huffman");
        hs[j].out = lit + j * seg;
        hs[j].count = j < 3 ? seg : regen - 3 * seg;
        at += size[j];
      }
      huffman_streams(huf, hs, 4);
    }
    *lits = lit;
    *nlits = regen;
    return head + size_t(comp);
  }

  // One table of the sequences section (3.1.1.3.2.2); returns its bytes.
  size_t seq_table(int mode, const uint8_t* ip, size_t avail, Fse& f,
                   const Fse& def, int max_al, int max_sym, const char* what) {
    switch (mode) {
      case 0:
        f = def;
        return 0;
      case 1:
        if (avail < 1) fail("the block ends before its %s RLE symbol", what);
        if (ip[0] > max_sym)
          fail("an RLE %s symbol %d past %d", what, ip[0], max_sym);
        rle_fse(f, ip[0]);
        return 1;
      case 2:
        return read_fse(ip, avail, max_al, max_sym, f, what);
      default:
        if (f.al < 0) fail("a repeated %s table with none before it", what);
        return 0;
    }
  }

  void compressed_block(const uint8_t* ip, size_t size) {
    const int64_t block_end = std::min(std::min(cap, fend), op + block_max);
    const uint8_t* end = ip + size;
    if (size < 1) fail("an empty compressed block");
    const uint8_t* lits;
    int64_t nlits;
    ip += literals(ip, size, &lits, &nlits);
    // sequences section header
    if (ip >= end) fail("the block ends before its sequences section");
    int64_t nseq = ip[0];
    if (nseq < 128) {
      ip += 1;
    } else if (nseq < 255) {
      if (end - ip < 2) fail("the block ends inside its sequence count");
      nseq = ((nseq - 128) << 8) + ip[1];
      ip += 2;
    } else {
      if (end - ip < 3) fail("the block ends inside its sequence count");
      nseq = ip[1] + (int64_t(ip[2]) << 8) + 0x7F00;
      ip += 3;
    }
    if (nseq == 0) {
      if (ip != end) fail("bytes after a block's empty sequences section");
      if (nlits > block_end - op) past(block_end);
      literal_copy(lits, nlits);
      return;
    }
    if (ip >= end) fail("the block ends before its symbol compression modes");
    const int modes = *ip++;
    if (modes & 3) fail("a sequences section with its reserved bits set");
    const Predefined& pre = predefined();
    ip += seq_table(modes >> 6, ip, size_t(end - ip), ll, pre.ll, 9, 35,
                    "literal length");
    ip += seq_table((modes >> 4) & 3, ip, size_t(end - ip), of, pre.of, 8, 31,
                    "offset");
    ip += seq_table((modes >> 2) & 3, ip, size_t(end - ip), ml, pre.ml, 9, 52,
                    "match length");
    if (ip >= end) fail("a sequences section without its bitstream");
    BackBits br;
    br.init(ip, end - ip, "sequences");
    uint32_t sll = uint32_t(br.read(ll.al));
    uint32_t sof = uint32_t(br.read(of.al));
    uint32_t sml = uint32_t(br.read(ml.al));
    const uint8_t* lit_end = lits + nlits;
    // literals may be read 16 at a time up to here: the slack of `lit`, or
    // the block that holds raw literals
    const uint8_t* lit_read = lits == lit ? lit + kBlockMax + 16 : end;
    for (int64_t i = 0; i < nseq; ++i) {
      const FseCell eo = of.t[sof], em = ml.t[sml], el = ll.t[sll];
      const uint64_t ofv = (uint64_t(1) << eo.sym) + br.read(eo.sym);
      const int64_t mlv = kMLBase[em.sym] + int64_t(br.read(kMLBits[em.sym]));
      const int64_t llv = kLLBase[el.sym] + int64_t(br.read(kLLBits[el.sym]));
      uint64_t offset;
      if (ofv > 3) {
        offset = ofv - 3;
        rep[2] = rep[1];
        rep[1] = rep[0];
        rep[0] = offset;
      } else {
        const uint64_t idx = ofv - 1 + (llv == 0);
        if (idx == 0) {
          offset = rep[0];
        } else {
          offset = idx < 3 ? rep[idx] : rep[0] - 1;
          if (idx > 1) rep[2] = rep[1];
          rep[1] = rep[0];
          rep[0] = offset;
        }
      }
      if (i + 1 < nseq) {  // states: literal length, match length, offset
        sll = el.base + uint32_t(br.read(el.nb));
        sml = em.base + uint32_t(br.read(em.nb));
        sof = eo.base + uint32_t(br.read(eo.nb));
      }
      if (llv > lit_end - lits)
        fail("a sequence takes more literals than its block holds");
      if (llv + mlv > block_end - op) past(block_end);
      if (llv <= 16 && lits + 16 <= lit_read && op + 16 <= cap) {
        memcpy(dst + op, lits, 16);  // the bytes past llv are written over
        op += llv;
      } else {
        literal_copy(lits, llv);
      }
      lits += llv;
      if (offset == 0 || offset > uint64_t(op - fstart))
        fail("a match offset of %llu with %lld bytes of the frame before it",
             (unsigned long long)offset, (long long)(op - fstart));
      if (mlv <= 16 && offset >= 16 && op + 16 <= cap) {
        memcpy(dst + op, dst + op - offset, 16);
        op += mlv;
      } else {
        match_copy(offset, mlv);
      }
    }
    if (br.pos != 0)
      fail("a sequences bitstream that its sequences do not consume exactly");
    const int64_t rest = lit_end - lits;
    if (rest > block_end - op) past(block_end);
    literal_copy(lits, rest);
  }

  // One frame from src (after its magic number); returns the bytes read.
  size_t frame(const uint8_t* src, size_t avail) {
    const uint8_t* ip = src;
    const uint8_t* end = src + avail;
    auto need = [&](size_t k, const char* what) {
      if (size_t(end - ip) < k) fail("the data end inside %s", what);
    };
    need(1, "a frame header");
    const int fhd = *ip++;
    const int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1;
    const bool checksum = (fhd >> 2) & 1;
    if (fhd & 8) fail("a frame header with its reserved bit set");
    uint64_t window = 0;
    if (!single) {
      need(1, "a frame header");
      const int wd = *ip++;
      const uint64_t base = uint64_t(1) << (10 + (wd >> 3));
      window = base + (base >> 3) * uint64_t(wd & 7);
    }
    static const int kDid[4] = {0, 1, 2, 4};
    const int did_size = kDid[fhd & 3];
    need(size_t(did_size), "a frame header");
    const uint32_t did = le(ip, did_size);
    ip += did_size;
    if (did != 0)
      refuse("the frame needs dictionary " + std::to_string(did) +
             "; dictionaries are not read");
    const int fcs_size = fcs_flag == 0 ? single : 1 << fcs_flag;
    need(size_t(fcs_size), "a frame header");
    uint64_t fcs = 0;
    for (int i = 0; i < fcs_size; ++i) fcs |= uint64_t(ip[i]) << (8 * i);
    if (fcs_size == 2) fcs += 256;
    ip += fcs_size;
    if (single) window = fcs;
    block_max = int64_t(window < uint64_t(kBlockMax) ? window : kBlockMax);
    fstart = op;
    fend = cap;
    if (fcs_size) {
      if (fcs > uint64_t(cap - op))
        fail("a frame of %llu bytes, past the strip's %lld",
             (unsigned long long)fcs, (long long)cap);
      fend = op + int64_t(fcs);
    }
    huf.maxbits = 0;  // tables and repeat offsets live within a frame
    ll.al = of.al = ml.al = -1;
    rep[0] = 1;
    rep[1] = 4;
    rep[2] = 8;
    for (;;) {
      need(3, "a block header");
      const uint32_t bh = le(ip, 3);
      ip += 3;
      const bool last = bh & 1;
      const int type = (bh >> 1) & 3;
      const int64_t bsize = bh >> 3;
      if (type == 3) fail("a block of the reserved type 3");
      if (bsize > block_max)
        fail("a block of %lld bytes, past the frame's maximum of %lld",
             (long long)bsize, (long long)block_max);
      const int64_t block_end = std::min(cap, fend);
      if (type == 0) {
        need(size_t(bsize), "a raw block");
        if (bsize > block_end - op) past(block_end);
        literal_copy(ip, bsize);
        ip += bsize;
      } else if (type == 1) {
        need(1, "an RLE block");
        if (bsize > block_end - op) past(block_end);
        memset(dst + op, *ip, size_t(bsize));
        op += bsize;
        ip += 1;
      } else {
        need(size_t(bsize), "a compressed block");
        compressed_block(ip, size_t(bsize));
        ip += bsize;
      }
      if (last) break;
    }
    if (fcs_size && op != fend)
      fail("a frame of %lld bytes whose header says %llu",
           (long long)(op - fstart), (unsigned long long)fcs);
    if (checksum) {
      need(4, "the content checksum");
      const uint32_t want = le(ip, 4);
      ip += 4;
      const uint32_t got =
          uint32_t(xxh64(dst + fstart, size_t(op - fstart)) & 0xFFFFFFFFu);
      if (got != want)
        fail("the content checksum does not match (%08x, %08x expected)", got,
             want);
    }
    return size_t(ip - src);
  }

  int64_t run(const uint8_t* src, size_t n) {
    size_t ip = 0;
    while (ip < n && op < cap) {
      if (n - ip < 4) fail("the data end inside a frame's magic number");
      const uint32_t magic = le(src + ip, 4);
      ip += 4;
      if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {  // skippable frame
        if (n - ip < 4) fail("the data end inside a skippable frame");
        const uint64_t size = le(src + ip, 4);
        ip += 4;
        if (size > n - ip) fail("a skippable frame runs past the data");
        ip += size_t(size);
        continue;
      }
      if (magic >= 0xFD2FB51Eu && magic < kMagic)
      {
        char m[96];
        snprintf(m, sizeof m, "a legacy (pre-1.0) frame, magic %08x; RFC 8878 "
                 "frames are read", magic);
        refuse(m);
      }
      if (magic != kMagic) fail("not a Zstandard frame (magic %08x)", magic);
      ip += frame(src + ip, n - ip);
    }
    return op;
  }
};

}  // namespace

extern "C" {

int zstd_abi_version() { return 1; }

// Decode the frames at src[0:n] into dst[0:cap]; returns the bytes written
// (fewer than cap when the data end first), -1 for malformed data and -2
// for what is not read (a dictionary, a legacy frame), with a message in
// err.
int64_t zstd_decode(const uint8_t* src, int64_t n, uint8_t* dst, int64_t cap,
                    char* err, int32_t errlen) {
  try {
    if (n < 0 || cap < 0) fail("negative sizes");
    std::unique_ptr<Decoder> d(new Decoder);  // no zeroing of its buffers
    d->dst = dst;
    d->cap = cap;
    return d->run(src, size_t(n));
  } catch (const ZstdError& e) {
    if (err && errlen > 0) snprintf(err, size_t(errlen), "%s", e.what());
    return e.unsupported ? -2 : -1;
  } catch (const std::exception& e) {
    if (err && errlen > 0) snprintf(err, size_t(errlen), "%s", e.what());
    return -1;
  }
}

}  // extern "C"
