// Zstandard encoder (RFC 8878), without libzstd: the compressor behind
// ZSTD_compress (native/zstd_api.cpp) for fastio's brick cache.  Its frames
// are what libzstd's ZSTD_compress writes: one frame a call, its content
// size in the header, no dictionary, no checksum; single-segment when the
// input fits the level's window, else a window descriptor.
//
// Blocks (128 KiB at most) are written in the smallest of three forms: RLE
// (every byte equal), compressed, raw.  A compressed block holds
//   literals: Huffman-coded (codes of 11 bits at most; 1 stream below 256
//     literals, 4 above; the weights 4-bit direct or FSE-compressed, the
//     smaller), or raw or RLE where Huffman does not pay;
//   sequences: LZ77 matches, their literal-length, match-length and offset
//     codes each in the smallest of the predefined table, RLE and an FSE
//     table built for the block; the three repeat offsets tracked as the
//     decoder tracks them.
// Match finders by level (clamped to [-5, 22]; 0 means 3): a hash of the
// next bytes, greedy, stepping faster at negative levels (levels <= 2); a
// long (8-byte) and a short hash as libzstd's "dfast" (3-4); a hash chain
// searched deeper and, from level 6, lazily one or two bytes ahead (5+).
// Matches reach back over the frame's earlier blocks within the window.
//
// Every write is checked against the caller's capacity; the output never
// exceeds libzstd's ZSTD_compressBound, since a block is never larger than
// raw.  There is no global mutable state: concurrent calls are safe.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <new>
#include <vector>

static_assert(__BYTE_ORDER__ == __ORDER_LITTLE_ENDIAN__,
              "zstd_enc.cpp writes little-endian words with memcpy");

namespace {

constexpr uint32_t kMagic = 0xFD2FB528u;
constexpr size_t kBlockMax = 128 * 1024;
constexpr int kHufMaxBits = 11;

inline uint32_t load32(const uint8_t* p) {
  uint32_t v;
  memcpy(&v, p, 4);
  return v;
}
inline uint64_t load64(const uint8_t* p) {
  uint64_t v;
  memcpy(&v, p, 8);
  return v;
}
inline int highbit(uint32_t v) { return 31 - __builtin_clz(v); }  // v > 0

// Bytes from a and b that are equal, a reading up to aend (b < a).
inline size_t count(const uint8_t* a, const uint8_t* b, const uint8_t* aend) {
  const uint8_t* const start = a;
  while (a + 8 <= aend) {
    const uint64_t d = load64(a) ^ load64(b);
    if (d) return size_t(a - start) + (__builtin_ctzll(d) >> 3);
    a += 8;
    b += 8;
  }
  while (a < aend && *a == *b) {
    ++a;
    ++b;
  }
  return size_t(a - start);
}

// ---------------------------------------------------------------- bits --

// LSB-first writer into out[0:cap]: a backward stream (Huffman, FSE) read
// from its end, or a table description read forward.  Writes past cap are
// dropped and flagged.
struct BitOut {
  uint8_t* out;
  size_t cap, pos = 0;
  uint64_t acc = 0;
  int n = 0;
  bool over = false;
  BitOut(uint8_t* o, size_t c) : out(o), cap(c) {}

  inline void add(uint64_t v, int k) {  // v < 2^k, k <= 32
    acc |= v << n;
    n += k;
    if (n >= 32) flush(n >> 3);
  }
  inline void flush(int bytes) {
    if (cap - std::min(cap, pos) >= 8) {
      memcpy(out + pos, &acc, 8);
    } else {
      for (int i = 0; i < bytes; ++i) {
        if (pos + i < cap)
          out[pos + i] = uint8_t(acc >> (8 * i));
        else
          over = true;
      }
    }
    pos += size_t(bytes);
    acc = bytes >= 8 ? 0 : acc >> (8 * bytes);
    n -= 8 * bytes;
  }
  // Pads to a whole byte; returns the bytes written, 0 when they overran.
  size_t finish() {
    if (n > 0) flush((n + 7) >> 3);
    n = 0;
    return over ? 0 : pos;
  }
  // A backward stream's closing 1 bit, then finish().
  size_t close() {
    add(1, 1);
    return finish();
  }
};

// ----------------------------------------------------------------- FSE --

// An FSE table as the decoder (zstd.cpp build_fse) spreads it, with the
// encoder's state transitions: cell[start[s] + x - n(s)] is the decoder
// cell of symbol s whose counter value is x.
struct Fse {
  int al = 0, nsym = 0;
  int16_t norm[64];
  uint16_t start[64];
  uint8_t hb[64];  // highbit(n(s))
  uint16_t cell[512];
};

inline int nslots(int16_t norm) { return norm < 0 ? 1 : norm; }

void fse_build(Fse& f, const int16_t* norm, int nsym, int al) {
  const int size = 1 << al;
  uint8_t symbols[512];
  int high = size;
  for (int s = 0; s < nsym; ++s)
    if (norm[s] == -1) symbols[--high] = uint8_t(s);
  const int step = (size >> 1) + (size >> 3) + 3, mask = size - 1;
  int pos = 0;
  for (int s = 0; s < nsym; ++s)
    for (int i = 0; i < norm[s]; ++i) {
      symbols[pos] = uint8_t(s);
      do pos = (pos + step) & mask;
      while (pos >= high);
    }
  uint16_t next[64];
  int acc = 0;
  for (int s = 0; s < nsym; ++s) {
    f.norm[s] = norm[s];
    const int n = norm[s] ? nslots(norm[s]) : 0;
    f.start[s] = uint16_t(acc);
    f.hb[s] = uint8_t(n ? highbit(uint32_t(n)) : 0);
    next[s] = uint16_t(n);
    acc += n;
  }
  for (int i = 0; i < size; ++i) {
    const int s = symbols[i];
    const int x = next[s]++;
    f.cell[f.start[s] + x - nslots(norm[s])] = uint16_t(i);
  }
  f.al = al;
  f.nsym = nsym;
}

// The state whose symbol is s, with the most bits to read after it.
inline uint32_t fse_init(const Fse& f, int s) { return f.cell[f.start[s]]; }

// Emits s: writes the low bits of the state that follows s in decoding
// order and moves to a cell of s.
inline void fse_encode(BitOut& bw, const Fse& f, uint32_t& state, int s) {
  const int n = nslots(f.norm[s]);
  const uint32_t x = state + (1u << f.al);
  int k = f.al - f.hb[s];
  if (int(x >> k) < n) --k;
  bw.add(x & ((1u << k) - 1), k);
  state = f.cell[f.start[s] + (x >> k) - n];
}

// Probabilities summing to 2^al for the counts, each present symbol at
// least 1: rounded shares, then slots moved one at a time where they cost
// the fewest bits.  Returns false when the symbols outnumber the slots.
bool fse_normalize(const uint32_t* cnt, int nsym, int al, int16_t* norm) {
  const int size = 1 << al;
  uint64_t total = 0;
  int present = 0;
  for (int s = 0; s < nsym; ++s) {
    total += cnt[s];
    present += cnt[s] > 0;
  }
  if (present > size || total == 0) return false;
  int used = 0;
  for (int s = 0; s < nsym; ++s) {
    if (!cnt[s]) {
      norm[s] = 0;
      continue;
    }
    const double share = double(cnt[s]) * size / double(total);
    norm[s] = int16_t(std::max(1.0, std::floor(share + 0.5)));
    used += norm[s];
  }
  while (used > size) {  // take a slot where it costs least
    int best = -1;
    double cost = 0;
    for (int s = 0; s < nsym; ++s) {
      if (norm[s] <= 1) continue;
      const double c = cnt[s] * std::log2(double(norm[s]) / (norm[s] - 1));
      if (best < 0 || c < cost) {
        best = s;
        cost = c;
      }
    }
    --norm[best];
    --used;
  }
  while (used < size) {  // give a slot where it gains most
    int best = -1;
    double gain = 0;
    for (int s = 0; s < nsym; ++s) {
      if (!cnt[s]) continue;
      const double g = cnt[s] * std::log2(double(norm[s] + 1) / norm[s]);
      if (best < 0 || g > gain) {
        best = s;
        gain = g;
      }
    }
    ++norm[best];
    ++used;
  }
  return true;
}

// The table description (RFC 8878 4.1.1) the decoder's read_fse reads.
void fse_write_header(BitOut& bw, const int16_t* norm, int nsym, int al) {
  bw.add(uint32_t(al - 5), 4);
  int remaining = 1 << al, s = 0;
  while (remaining > 0 && s < nsym) {
    const int v = norm[s] + 1;
    const int bits = highbit(uint32_t(remaining + 1)) + 1;
    const int low = (1 << (bits - 1)) - 1;
    const int threshold = (1 << bits) - 1 - (remaining + 1);
    if (v < threshold)
      bw.add(uint32_t(v), bits - 1);
    else if (v <= low)
      bw.add(uint32_t(v), bits);
    else
      bw.add(uint32_t(v + threshold), bits);
    remaining -= nslots(norm[s]);
    if (norm[s++] == 0) {
      int z = 0;
      while (s + z < nsym && norm[s + z] == 0) ++z;
      s += z;
      for (; z >= 3; z -= 3) bw.add(3, 2);
      bw.add(uint32_t(z), 2);
    }
  }
}

// Bits of the symbols under a table (fractional), from a log2 table.
double fse_cost(const uint32_t* cnt, int nsym, const int16_t* norm, int al,
                const double* log2n) {
  double bits = 0;
  for (int s = 0; s < nsym; ++s)
    if (cnt[s]) bits += cnt[s] * (al - log2n[nslots(norm[s])]);
  return bits;
}

// The accuracy log libzstd's FSE_optimalTableLog picks.
int fse_table_log(int max_al, size_t nsrc, int max_sym) {
  int al = max_al;
  const int src_bits = nsrc > 1 ? highbit(uint32_t(nsrc - 1)) : 0;
  if (src_bits - 2 < al) al = src_bits - 2;
  const int min_bits =
      std::min(src_bits + 1, highbit(uint32_t(std::max(max_sym, 1))) + 2);
  if (min_bits > al) al = min_bits;
  return std::max(5, std::min(al, max_al));
}

// ---------------------------------------------------- sequence codes --

const int16_t kLLNorm[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2,
                             2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2,
                             2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t kMLNorm[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1,  1,  1,  1,
                             1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,  1,  1,  1,
                             1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,  1,  1,  1,
                             1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t kOFNorm[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                             1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};
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

// A sequence: literals before the match, the match length and the offset
// field's value (1-3 a repeat offset, else the offset + 3).
struct Seq {
  uint32_t ll, ml, off;
};

// The offset field for a match at `offset` after `ll` literals, with the
// repeat offsets updated exactly as the decoder updates them.
inline uint32_t offset_field(uint32_t rep[3], uint32_t offset, uint32_t ll) {
  int idx = -1;  // the decoder's index: rep[0], rep[1], rep[2], rep[0] - 1
  if (ll > 0) {
    if (offset == rep[0]) return 1;
    if (offset == rep[1]) idx = 1;
    else if (offset == rep[2]) idx = 2;
  } else {
    if (offset == rep[1]) idx = 1;
    else if (offset == rep[2]) idx = 2;
    else if (offset + 1 == rep[0]) idx = 3;
  }
  if (idx < 0) {
    rep[2] = rep[1];
    rep[1] = rep[0];
    rep[0] = offset;
    return offset + 3;
  }
  if (idx > 1) rep[2] = rep[1];
  rep[1] = rep[0];
  rep[0] = offset;
  return uint32_t(idx + (ll > 0));
}

// ----------------------------------------------------------- levels --

enum Strategy { kFast, kDfast, kChain };

struct Params {
  int wlog, hlog, hlog2;  // window; hash (fast, dfast long, chain head);
                          // dfast's short hash or the chain's length
  int mml;                // hashed bytes (fast, chain) / short hash (dfast)
  Strategy strategy;
  int step;               // positions a miss skips at least (negative levels)
  int depth, lazy, nice;  // chain: candidates, look-ahead, good enough
};

Params params(int level) {
  if (level < 1) return {19, 14, 0, 6, kFast, 1 - level, 0, 0, 0};
  static const Params kTable[23] = {
      {},
      {19, 14, 0, 6, kFast, 1, 0, 0, 0},
      {20, 16, 0, 5, kFast, 1, 0, 0, 0},
      {21, 17, 16, 5, kDfast, 1, 0, 0, 0},
      {21, 18, 18, 5, kDfast, 1, 0, 0, 0},
      {21, 19, 18, 5, kChain, 1, 4, 0, 16},
      {21, 19, 18, 5, kChain, 1, 4, 1, 16},
      {21, 20, 19, 5, kChain, 1, 6, 1, 24},
      {21, 20, 19, 5, kChain, 1, 6, 2, 32},
      {22, 20, 20, 5, kChain, 1, 8, 2, 32},
      {22, 20, 20, 5, kChain, 1, 8, 2, 48},
      {22, 20, 20, 5, kChain, 1, 10, 2, 64},
      {22, 20, 20, 5, kChain, 1, 12, 2, 64},
      {22, 20, 20, 5, kChain, 1, 12, 2, 96},
      {22, 20, 20, 5, kChain, 1, 16, 2, 128},
      {22, 20, 20, 5, kChain, 1, 16, 2, 128},
      {22, 20, 20, 5, kChain, 1, 20, 2, 192},
      {23, 20, 20, 5, kChain, 1, 24, 2, 256},
      {23, 20, 20, 5, kChain, 1, 24, 2, 256},
      {23, 20, 20, 5, kChain, 1, 32, 2, 512},
      {25, 20, 20, 5, kChain, 1, 32, 2, 512},
      {26, 20, 20, 5, kChain, 1, 48, 2, 1024},
      {27, 20, 20, 5, kChain, 1, 48, 2, 1024},
  };
  return kTable[std::min(level, 22)];
}

// ----------------------------------------------------------- encoder --

struct HufCode {
  uint16_t code[256];
  uint8_t len[256];
  int maxbits = 0;
  int last = 0;  // the highest symbol present
};

class Encoder {
 public:
  Encoder(const uint8_t* src, size_t n, int level)
      : src_(src), n_(n), p_(params(level)) {
    for (int i = 1; i < 513; ++i) log2n_[i] = std::log2(double(i));
    log2n_[0] = 0;
    fse_build(pre_ll_, kLLNorm, 36, 6);
    fse_build(pre_ml_, kMLNorm, 53, 6);
    fse_build(pre_of_, kOFNorm, 29, 5);
    for (uint32_t v = 0; v < 64; ++v) {
      int c = 0;
      while (c + 1 < 36 && kLLBase[c + 1] <= v) ++c;
      ll_code_[v] = uint8_t(c);
    }
    for (uint32_t v = 0; v < 128; ++v) {
      int c = 0;
      while (c + 1 < 53 && kMLBase[c + 1] <= v + 3) ++c;
      ml_code_[v] = uint8_t(c);
    }
    // the window: the level's, or the input's when it fits (one segment)
    single_ = n <= (size_t(1) << p_.wlog);
    int wlog = p_.wlog;
    if (single_) {
      wlog = 10;
      while ((size_t(1) << wlog) < n) ++wlog;
    }
    window_ = single_ ? uint32_t(std::max<size_t>(n, 1)) : 1u << wlog;
    p_.hlog = std::min(p_.hlog, wlog + 1);
    p_.hlog2 = std::min(p_.hlog2, p_.strategy == kChain ? wlog : wlog + 1);
    wlog_ = wlog;
    head_.assign(size_t(1) << p_.hlog, 0);
    if (p_.strategy != kFast) chain_.assign(size_t(1) << p_.hlog2, 0);
    lits_.resize(kBlockMax + 8);
    seqs_.reserve(kBlockMax / 3 + 1);
    scratch_.resize(2 * kBlockMax + 4096);
  }

  // The frame into dst[0:cap]; its size, or -1 when cap is short.
  int64_t run(uint8_t* dst, size_t cap) {
    uint8_t head[18];
    size_t h = 0;
    memcpy(head, &kMagic, 4);
    h = 4;
    const int fcs_code = n_ >= 0xFFFFFFFFu ? 3 : n_ >= 65536 + 256 ? 2
                         : n_ >= 256      ? 1
                                          : 0;
    head[h++] = uint8_t(fcs_code << 6 | (single_ ? 1 << 5 : 0));
    if (!single_) head[h++] = uint8_t((wlog_ - 10) << 3);
    uint64_t fcs = n_;
    if (fcs_code == 1) fcs -= 256;
    const int fcs_size = fcs_code == 0 ? 1 : 1 << fcs_code;
    for (int i = 0; i < fcs_size; ++i) head[h++] = uint8_t(fcs >> (8 * i));
    if (h > cap) return -1;
    memcpy(dst, head, h);
    size_t op = h;
    size_t bs = 0;
    do {
      const size_t be = std::min(n_, bs + kBlockMax);
      const bool last = be == n_;
      const size_t got = block(bs, be, last, dst + op, cap - op);
      if (!got) return -1;
      op += got;
      bs = be;
    } while (bs < n_);
    return int64_t(op);
  }

 private:
  const uint8_t* src_;
  size_t n_;
  Params p_;
  bool single_;
  int wlog_;
  uint32_t window_;
  std::vector<uint32_t> head_, chain_;
  size_t next_insert_ = 0;  // the chain holds positions below this
  uint32_t rep_[3] = {1, 4, 8};
  std::vector<uint8_t> lits_, scratch_;
  size_t nlits_ = 0;
  std::vector<Seq> seqs_;
  Fse pre_ll_, pre_ml_, pre_of_, ll_, ml_, of_;
  double log2n_[513];
  uint8_t ll_code_[64], ml_code_[128];

  // One block of src[bs:be) into out[0:cap]; its bytes, 0 when cap is
  // short.
  size_t block(size_t bs, size_t be, bool last, uint8_t* out, size_t cap) {
    const size_t size = be - bs;
    const uint8_t* s = src_ + bs;
    const auto header = [&](int type, size_t bytes) {
      const uint32_t bh = uint32_t(last) | uint32_t(type) << 1 |
                          uint32_t(bytes) << 3;
      out[0] = uint8_t(bh);
      out[1] = uint8_t(bh >> 8);
      out[2] = uint8_t(bh >> 16);
    };
    if (size > 1 && count(s + 1, s, s + size) == size - 1) {
      if (cap < 4) return 0;
      header(1, size);
      out[3] = s[0];
      return 4;
    }
    uint32_t saved[3] = {rep_[0], rep_[1], rep_[2]};
    size_t csize = 0;
    if (size >= 16) {
      nlits_ = 0;
      seqs_.clear();
      parse(bs, be);
      csize = compress_block(scratch_.data(), scratch_.size());
    }
    if (csize && csize < size) {
      if (cap < 3 + csize) return 0;
      header(2, csize);
      memcpy(out + 3, scratch_.data(), csize);
      return 3 + csize;
    }
    memcpy(rep_, saved, sizeof saved);  // the decoder sees no sequences
    if (cap < 3 + size) return 0;
    header(0, size);
    if (size) memcpy(out + 3, s, size);
    return 3 + size;
  }

  // ----------------------------------------------------- match finding --

  inline size_t hash(size_t pos, int bits, int mls) const {
    if (mls == 4)
      return size_t(load32(src_ + pos) * 2654435761u) >> (32 - bits);
    const uint64_t v = load64(src_ + pos) << (64 - 8 * mls);
    return size_t((v * 0xCF1BBCDCB7A56463ull) >> (64 - bits));
  }

  // A position stored in a table, as a distance back from pos; 0 when it
  // lies outside the window or the frame (stored positions are 32 bits,
  // so a stale one only costs a comparison).
  inline uint32_t dist(size_t pos, uint32_t stored) const {
    const uint32_t d = uint32_t(pos) - stored;
    const size_t limit = std::min<size_t>(window_, pos);
    return d - 1 < limit ? d : 0;
  }

  inline void emit(size_t anchor, size_t pos, uint32_t offset, size_t len) {
    const size_t ll = pos - anchor;
    memcpy(lits_.data() + nlits_, src_ + anchor, ll);
    nlits_ += ll;
    seqs_.push_back(
        {uint32_t(ll), uint32_t(len), offset_field(rep_, offset, uint32_t(ll))});
  }

  // A match at pos with repeat offset r, or 0.
  inline size_t rep_match(size_t pos, uint32_t r, size_t be) const {
    if (r == 0 || r > pos || r > window_) return 0;
    if (load32(src_ + pos) != load32(src_ + pos - r)) return 0;
    return 4 + count(src_ + pos + 4, src_ + pos + 4 - r, src_ + be);
  }

  void parse(size_t bs, size_t be) {
    // positions searched and hashed: 8 bytes of the block from each
    const size_t ilimit = be - bs >= 8 ? be - 7 : bs;
    size_t anchor = bs;
    if (bs + 4 < ilimit) {
      if (p_.strategy == kFast)
        anchor = parse_fast(bs, be, ilimit);
      else if (p_.strategy == kDfast)
        anchor = parse_dfast(bs, be, ilimit);
      else
        anchor = parse_chain(bs, be, ilimit);
    }
    memcpy(lits_.data() + nlits_, src_ + anchor, be - anchor);
    nlits_ += be - anchor;
  }

  // Matches at pos against rep_[1] after a match (no literals between).
  inline size_t repeat_after(size_t pos, size_t be, size_t ilimit) {
    while (pos < ilimit) {
      const size_t len = rep_match(pos, rep_[1], be);
      if (len < 4) break;
      emit(pos, pos, rep_[1], len);
      pos += len;
    }
    return pos;
  }

  size_t parse_fast(size_t bs, size_t be, size_t ilimit) {
    const int hl = p_.hlog, mls = p_.mml;
    size_t ip = bs, anchor = bs;
    while (ip + 1 < ilimit) {
      const size_t h = hash(ip, hl, mls);
      const uint32_t d = dist(ip, head_[h]);
      head_[h] = uint32_t(ip);
      size_t len = rep_match(ip + 1, rep_[0], be);
      if (len >= 4) {
        ++ip;
        emit(anchor, ip, rep_[0], len);
      } else if (d && load32(src_ + ip) == load32(src_ + ip - d)) {
        size_t c = ip - d;
        len = 4 + count(src_ + ip + 4, src_ + c + 4, src_ + be);
        while (ip > anchor && c > 0 && src_[ip - 1] == src_[c - 1]) {
          --ip;
          --c;
          ++len;
        }
        emit(anchor, ip, d, len);
      } else {
        ip += p_.step + ((ip - anchor) >> 8);
        continue;
      }
      const size_t start = ip;
      ip += len;
      if (start + 2 < ilimit) head_[hash(start + 2, hl, mls)] = uint32_t(start + 2);
      if (ip - 2 < ilimit && ip - 2 > start)
        head_[hash(ip - 2, hl, mls)] = uint32_t(ip - 2);
      ip = repeat_after(ip, be, ilimit);
      anchor = ip;
    }
    return anchor;
  }

  size_t parse_dfast(size_t bs, size_t be, size_t ilimit) {
    const int hl = p_.hlog, hs = p_.hlog2, mls = p_.mml;
    uint32_t* lng = head_.data();
    uint32_t* sht = chain_.data();
    size_t ip = bs, anchor = bs;
    while (ip + 1 < ilimit) {
      const size_t h8 = hash(ip, hl, 8), h5 = hash(ip, hs, mls);
      const uint32_t dl = dist(ip, lng[h8]), ds = dist(ip, sht[h5]);
      lng[h8] = sht[h5] = uint32_t(ip);
      size_t len = rep_match(ip + 1, rep_[0], be);
      uint32_t offset = 0;
      const bool rep = len >= 4;
      if (rep) {
        ++ip;
        offset = rep_[0];
      } else if (dl && load64(src_ + ip) == load64(src_ + ip - dl)) {
        offset = dl;
        len = 8 + count(src_ + ip + 8, src_ + ip + 8 - dl, src_ + be);
      } else if (ds && load32(src_ + ip) == load32(src_ + ip - ds)) {
        const size_t h8b = hash(ip + 1, hl, 8);
        const uint32_t dl1 = dist(ip + 1, lng[h8b]);
        lng[h8b] = uint32_t(ip + 1);
        if (dl1 && load64(src_ + ip + 1) == load64(src_ + ip + 1 - dl1)) {
          ++ip;
          offset = dl1;
          len = 8 + count(src_ + ip + 8, src_ + ip + 8 - dl1, src_ + be);
        } else {
          offset = ds;
          len = 4 + count(src_ + ip + 4, src_ + ip + 4 - ds, src_ + be);
        }
      } else {
        ip += p_.step + ((ip - anchor) >> 8);
        continue;
      }
      if (!rep) {
        size_t c = ip - offset;
        while (ip > anchor && c > 0 && src_[ip - 1] == src_[c - 1]) {
          --ip;
          --c;
          ++len;
        }
      }
      emit(anchor, ip, offset, len);
      const size_t start = ip;
      ip += len;
      for (size_t q : {start + 2, ip - 2, ip - 1}) {
        if (q >= ilimit || q <= start) continue;
        lng[hash(q, hl, 8)] = uint32_t(q);
        sht[hash(q, hs, mls)] = uint32_t(q);
      }
      ip = repeat_after(ip, be, ilimit);
      anchor = ip;
    }
    return anchor;
  }

  // Chain positions [next_insert_, to) (to <= ilimit).
  inline void insert(size_t to) {
    const size_t cmask = chain_.size() - 1;
    for (size_t q = next_insert_; q < to; ++q) {
      const size_t h = hash(q, p_.hlog, p_.mml);
      chain_[q & cmask] = head_[h];
      head_[h] = uint32_t(q);
    }
    next_insert_ = std::max(next_insert_, to);
  }

  struct Match {
    size_t len = 0;
    uint32_t offset = 0;
    bool rep = false;
    int gain() const {  // bytes saved against the offset's bits
      return int(4 * len) - highbit(rep ? 1u : offset + 3);
    }
  };

  Match search(size_t ip, size_t be) {
    Match m;
    for (int r = 0; r < 3; ++r) {
      const size_t len = rep_match(ip, rep_[r], be);
      if (len > m.len) m = {len, rep_[r], true};
    }
    if (m.len >= size_t(p_.nice) || ip + m.len >= be) return m;
    insert(ip + 1);
    // the head reaches over the window, the chain over its own length
    const size_t cmask = chain_.size() - 1;
    const size_t limit = std::min<size_t>(window_, ip);
    uint32_t d = uint32_t(ip) - chain_[ip & cmask];
    size_t best = std::max<size_t>(m.len, 3);
    const uint32_t first = load32(src_ + ip);
    for (int k = p_.depth; k > 0 && d - 1 < limit; --k) {
      const size_t c = ip - d;
      if (src_[c + best] == src_[ip + best] && load32(src_ + c) == first) {
        const size_t len = 4 + count(src_ + ip + 4, src_ + c + 4, src_ + be);
        if (len > best) {
          best = len;
          if (len > m.len && (!m.rep || int(4 * len) - highbit(d + 3) >
                                            m.gain()))
            m = {len, d, false};
          if (len >= size_t(p_.nice) || ip + len >= be) break;
        }
      }
      if (d > cmask) break;
      const uint32_t next = uint32_t(ip) - chain_[c & cmask];
      if (next <= d) break;
      d = next;
    }
    return m;
  }

  size_t parse_chain(size_t bs, size_t be, size_t ilimit) {
    size_t ip = bs, anchor = bs;
    // positions an RLE block skipped, as far back as the window
    next_insert_ = std::max(next_insert_, bs > window_ ? bs - window_ : 0);
    while (ip + 1 < ilimit) {
      Match m = search(ip, be);
      if (m.len < 4) {
        ip += p_.step + ((ip - anchor) >> 8);
        continue;
      }
      // look one or two bytes ahead for a better match
      while (p_.lazy >= 1 && ip + 1 < ilimit) {
        const Match m1 = search(ip + 1, be);
        if (m1.len >= 4 && m1.gain() > m.gain() + 4) {
          ++ip;
          m = m1;
          continue;
        }
        if (p_.lazy < 2 || ip + 2 >= ilimit) break;
        const Match m2 = search(ip + 2, be);
        if (m2.len >= 4 && m2.gain() > m.gain() + 7) {
          ip += 2;
          m = m2;
          continue;
        }
        break;
      }
      if (!m.rep) {
        size_t c = ip - m.offset;
        while (ip > anchor && c > 0 && src_[ip - 1] == src_[c - 1]) {
          --ip;
          --c;
          ++m.len;
        }
      }
      emit(anchor, ip, m.offset, m.len);
      ip += m.len;
      ip = repeat_after(ip, be, ilimit);
      anchor = ip;
    }
    insert(std::min(ip, ilimit));
    return anchor;
  }

  // ------------------------------------------------------------ literals --

  static size_t literals_header(uint8_t* out, int type, size_t n) {
    if (n < 32) {
      out[0] = uint8_t(type | n << 3);
      return 1;
    }
    if (n < 4096) {
      out[0] = uint8_t(type | 1 << 2 | (n & 15) << 4);
      out[1] = uint8_t(n >> 4);
      return 2;
    }
    out[0] = uint8_t(type | 3 << 2 | (n & 15) << 4);
    out[1] = uint8_t(n >> 4);
    out[2] = uint8_t(n >> 12);
    return 3;
  }

  // Code lengths of at most 11 bits (Huffman's, then the longest cut and
  // the Kraft sum restored); false when fewer than 2 symbols are present.
  static bool huf_lengths(const uint32_t* cnt, HufCode& hc) {
    int sym[256], ns = 0;
    for (int s = 0; s < 256; ++s)
      if (cnt[s]) sym[ns++] = s;
    if (ns < 2) return false;
    std::stable_sort(sym, sym + ns,
                     [&](int a, int b) { return cnt[a] < cnt[b]; });
    // two queues: leaves by count, internal nodes in creation order
    uint64_t w[512];
    int parent[512];
    for (int i = 0; i < ns; ++i) w[i] = cnt[sym[i]];
    int leaf = 0, node = ns, made = ns;
    auto take = [&]() {
      if (leaf < ns && (node >= made || w[leaf] <= w[node])) return leaf++;
      return node++;
    };
    while (made < 2 * ns - 1) {
      const int a = take(), b = take();
      w[made] = w[a] + w[b];
      parent[a] = parent[b] = made;
      ++made;
    }
    int depth[512];
    depth[2 * ns - 2] = 0;
    for (int i = 2 * ns - 3; i >= 0; --i) depth[i] = depth[parent[i]] + 1;
    int len[256];
    for (int i = 0; i < ns; ++i) len[i] = std::min(depth[i], kHufMaxBits);
    // restore sum 2^-len = 1 at 11 bits: lengthen the longest codes
    // under 11, then shorten the most frequent while room is left
    const int64_t full = int64_t(1) << kHufMaxBits;
    int64_t kraft = 0;
    for (int i = 0; i < ns; ++i) kraft += int64_t(1) << (kHufMaxBits - len[i]);
    while (kraft > full) {
      int pick = -1;
      for (int i = 0; i < ns; ++i)  // ascending counts: the rarest first
        if (len[i] < kHufMaxBits && (pick < 0 || len[i] > len[pick]))
          pick = i;
      kraft -= int64_t(1) << (kHufMaxBits - len[pick] - 1);
      ++len[pick];
    }
    for (bool moved = true; kraft < full && moved;) {
      moved = false;
      for (int i = ns - 1; i >= 0 && kraft < full; --i) {
        const int64_t add = int64_t(1) << (kHufMaxBits - len[i]);
        if (len[i] > 1 && kraft + add <= full) {
          kraft += add;
          --len[i];
          moved = true;
        }
      }
    }
    memset(hc.len, 0, sizeof hc.len);
    hc.maxbits = 0;
    hc.last = 0;
    for (int i = 0; i < ns; ++i) {
      hc.len[sym[i]] = uint8_t(len[i]);
      hc.maxbits = std::max(hc.maxbits, len[i]);
      hc.last = std::max(hc.last, sym[i]);
    }
    // canonical codes as the decoder assigns them: longest first, by
    // symbol within a length
    const int mb = hc.maxbits;
    int nlen[kHufMaxBits + 2] = {0};
    for (int s = 0; s <= hc.last; ++s) nlen[hc.len[s]] += hc.len[s] > 0;
    uint32_t start[kHufMaxBits + 2];
    start[mb] = 0;
    for (int b = mb; b >= 1; --b)
      start[b - 1] = start[b] + (uint32_t(nlen[b]) << (mb - b));
    for (int s = 0; s <= hc.last; ++s) {
      const int b = hc.len[s];
      if (!b) continue;
      hc.code[s] = uint16_t(start[b] >> (mb - b));
      start[b] += 1u << (mb - b);
    }
    return true;
  }

  // The Huffman tree description (RFC 8878 4.2.1); its bytes, 0 when the
  // weights fit neither form.
  size_t huf_describe(const HufCode& hc, uint8_t* out, size_t cap) {
    const int n = hc.last;  // explicit weights: symbols 0 .. last - 1
    uint8_t wt[256];
    uint32_t wcnt[16] = {0};
    int maxw = 0;
    for (int s = 0; s < n; ++s) {
      wt[s] = uint8_t(hc.len[s] ? hc.maxbits + 1 - hc.len[s] : 0);
      ++wcnt[wt[s]];
      maxw = std::max<int>(maxw, wt[s]);
    }
    size_t best = 0;
    uint8_t tmp[160];
    int distinct = 0;
    for (int v = 0; v <= maxw; ++v) distinct += wcnt[v] > 0;
    if (n >= 2 && distinct >= 2) {  // FSE-compressed, two states
      Fse f;
      int16_t norm[16];
      const int al = fse_table_log(6, size_t(n), maxw);
      if (fse_normalize(wcnt, maxw + 1, al, norm)) {
        fse_build(f, norm, maxw + 1, al);
        BitOut hb(tmp + 1, sizeof tmp - 1);
        fse_write_header(hb, norm, maxw + 1, al);
        const size_t hsize = hb.finish();
        BitOut bw(tmp + 1 + hsize, sizeof tmp - 1 - hsize);
        uint32_t s1, s2;
        int i = n;
        if (n & 1) {
          s1 = fse_init(f, wt[n - 1]);
          s2 = fse_init(f, wt[n - 2]);
          fse_encode(bw, f, s1, wt[n - 3]);
          i = n - 3;
        } else {
          s2 = fse_init(f, wt[n - 1]);
          s1 = fse_init(f, wt[n - 2]);
          i = n - 2;
        }
        while (i > 0) {
          fse_encode(bw, f, s2, wt[--i]);
          fse_encode(bw, f, s1, wt[--i]);
        }
        bw.add(s2, al);
        bw.add(s1, al);
        const size_t ssize = bw.close();
        if (hsize && ssize && hsize + ssize < 128) {
          tmp[0] = uint8_t(hsize + ssize);
          best = 1 + hsize + ssize;
        }
      }
    }
    if (n <= 128 && (!best || 1 + size_t(n + 1) / 2 < best)) {
      tmp[0] = uint8_t(127 + n);
      for (int s = 0; s < n; s += 2)
        tmp[1 + s / 2] = uint8_t(wt[s] << 4 | (s + 1 < n ? wt[s + 1] : 0));
      best = 1 + size_t(n + 1) / 2;
    }
    if (!best || best > cap) return 0;
    memcpy(out, tmp, best);
    return best;
  }

  // One Huffman stream of lit[0:n), coded last to first.
  static size_t huf_stream(const HufCode& hc, const uint8_t* lit, size_t n,
                           uint8_t* out, size_t cap) {
    BitOut bw(out, cap);
    size_t i = n;
    for (; i >= 4; i -= 4) {  // 4 codes of 11 bits fit between flushes
      const uint8_t a = lit[i - 1], b = lit[i - 2], c = lit[i - 3],
                    d = lit[i - 4];
      bw.acc |= uint64_t(hc.code[a]) << bw.n;
      bw.n += hc.len[a];
      bw.acc |= uint64_t(hc.code[b]) << bw.n;
      bw.n += hc.len[b];
      bw.acc |= uint64_t(hc.code[c]) << bw.n;
      bw.n += hc.len[c];
      bw.acc |= uint64_t(hc.code[d]) << bw.n;
      bw.n += hc.len[d];
      bw.flush(bw.n >> 3);
      if (bw.over) return 0;
    }
    while (i > 0) {
      const uint8_t a = lit[--i];
      bw.add(hc.code[a], hc.len[a]);
    }
    return bw.close();
  }

  // The literals section of lit[0:n) into out[0:cap]; its bytes, 0 when
  // cap is short.
  size_t literals(const uint8_t* lit, size_t n, uint8_t* out, size_t cap) {
    const size_t raw = (n < 32 ? 1 : n < 4096 ? 2 : 3) + n;
    uint32_t cnt[256] = {0};
    for (size_t i = 0; i < n; ++i) ++cnt[lit[i]];
    int present = 0;
    for (int s = 0; s < 256; ++s) present += cnt[s] > 0;
    if (n > 0 && present == 1) {  // RLE
      if (cap < 4) return 0;
      const size_t h = literals_header(out, 1, n);
      out[h] = lit[0];
      return h + 1;
    }
    if (n >= 64) {
      HufCode hc;
      double bits = 0;
      if (huf_lengths(cnt, hc)) {
        for (int s = 0; s < 256; ++s) bits += double(cnt[s]) * hc.len[s];
      }
      if (bits > 0 && bits / 8 + 16 < double(n)) {
        const bool four = n >= 256;
        const size_t head = !four || n < 1024 ? 3 : n < 16384 ? 4 : 5;
        size_t at = head;
        const size_t tsize = cap > at ? huf_describe(hc, out + at, cap - at)
                                      : 0;
        at += tsize;
        bool ok = tsize > 0;
        if (ok && !four) {
          const size_t k = cap > at ? huf_stream(hc, lit, n, out + at,
                                                 cap - at)
                                    : 0;
          ok = k > 0;
          at += k;
        } else if (ok) {
          const size_t seg = (n + 3) / 4;
          const size_t jump = at;
          at += 6;
          for (int j = 0; j < 4 && ok; ++j) {
            const size_t len = j < 3 ? seg : n - 3 * seg;
            const size_t k = cap > at ? huf_stream(hc, lit + j * seg, len,
                                                   out + at, cap - at)
                                      : 0;
            ok = k > 0 && k < 65536;
            if (j < 3 && ok) {
              out[jump + 2 * j] = uint8_t(k);
              out[jump + 2 * j + 1] = uint8_t(k >> 8);
            }
            at += k;
          }
        }
        const size_t comp = at - head;
        const size_t lim = head == 3 ? 1023 : head == 4 ? 16383 : 262143;
        if (ok && at < raw && comp <= lim) {
          const int sf = !four ? 0 : head == 3 ? 1 : head == 4 ? 2 : 3;
          const int sbits = head == 3 ? 10 : head == 4 ? 14 : 18;
          const uint64_t h = 2 | uint64_t(sf) << 2 | uint64_t(n) << 4 |
                             uint64_t(comp) << (4 + sbits);
          for (size_t i = 0; i < head; ++i) out[i] = uint8_t(h >> (8 * i));
          return at;
        }
      }
    }
    if (cap < raw) return 0;
    const size_t h = literals_header(out, 0, n);
    memcpy(out + h, lit, n);
    return raw;
  }

  // ---------------------------------------------------------- sequences --

  // The mode (0 predefined, 1 RLE, 2 FSE) and table of one code stream,
  // its description written at out; returns the description's bytes, or
  // -1 when cap is short.
  int choose_table(const uint32_t* cnt, int nsym, size_t nseq, int max_al,
                   const Fse& pre, Fse& table, const Fse*& use, int& mode,
                   uint8_t* out, size_t cap) {
    int present = 0, last = 0, max_sym = 0;
    for (int s = 0; s < nsym; ++s)
      if (cnt[s]) {
        ++present;
        last = s;
        max_sym = s;
      }
    if (present == 1 && nseq > 2) {  // RLE
      if (cap < 1) return -1;
      out[0] = uint8_t(last);
      int16_t one[64] = {0};
      one[last] = 1;
      table.al = 0;
      table.nsym = last + 1;
      memcpy(table.norm, one, sizeof(int16_t) * (last + 1));
      table.start[last] = 0;
      table.hb[last] = 0;
      table.cell[0] = 0;
      use = &table;
      mode = 1;
      return 1;
    }
    double pre_bits = -1;
    if (max_sym < pre.nsym)
      pre_bits = fse_cost(cnt, max_sym + 1, pre.norm, pre.al, log2n_);
    int16_t norm[64];
    const int al = fse_table_log(max_al, nseq, max_sym);
    double fse_bits = -1;
    uint8_t desc[128];
    size_t dsize = 0;
    if (pre_bits < 0 || nseq > 8) {
      if (fse_normalize(cnt, max_sym + 1, al, norm)) {
        BitOut hb(desc, sizeof desc);
        fse_write_header(hb, norm, max_sym + 1, al);
        dsize = hb.finish();
        if (dsize)
          fse_bits = 8.0 * dsize + fse_cost(cnt, max_sym + 1, norm, al,
                                            log2n_);
      }
    }
    if (pre_bits >= 0 && (fse_bits < 0 || pre_bits <= fse_bits)) {
      use = &pre;
      mode = 0;
      return 0;
    }
    if (fse_bits < 0 || dsize > cap) return -1;
    fse_build(table, norm, max_sym + 1, al);
    memcpy(out, desc, dsize);
    use = &table;
    mode = 2;
    return int(dsize);
  }

  inline int ll_code(uint32_t ll) const {
    return ll < 64 ? ll_code_[ll] : highbit(ll) + 19;
  }
  inline int ml_code(uint32_t ml) const {  // ml >= 3
    const uint32_t b = ml - 3;
    return b < 128 ? ml_code_[b] : highbit(b) + 36;
  }

  // The block's literals and sequences into out[0:cap]; its bytes, 0 when
  // cap is short.
  size_t compress_block(uint8_t* out, size_t cap) {
    size_t at = literals(lits_.data(), nlits_, out, cap);
    if (!at) return 0;
    const size_t nseq = seqs_.size();
    if (cap - at < 4) return 0;
    if (nseq < 128) {
      out[at++] = uint8_t(nseq);
    } else if (nseq < 0x7F00) {
      out[at++] = uint8_t((nseq >> 8) + 128);
      out[at++] = uint8_t(nseq);
    } else {
      out[at++] = 255;
      out[at++] = uint8_t(nseq - 0x7F00);
      out[at++] = uint8_t((nseq - 0x7F00) >> 8);
    }
    if (nseq == 0) return at;
    std::vector<uint8_t>& codes = code_buf_;
    codes.resize(3 * nseq);
    uint8_t* llc = codes.data();
    uint8_t* mlc = llc + nseq;
    uint8_t* ofc = mlc + nseq;
    uint32_t cll[36] = {0}, cml[53] = {0}, cof[32] = {0};
    for (size_t i = 0; i < nseq; ++i) {
      const Seq& q = seqs_[i];
      llc[i] = uint8_t(ll_code(q.ll));
      mlc[i] = uint8_t(ml_code(q.ml));
      ofc[i] = uint8_t(highbit(q.off));
      ++cll[llc[i]];
      ++cml[mlc[i]];
      ++cof[ofc[i]];
    }
    const size_t modes_at = at++;
    const Fse *tll, *tof, *tml;
    int mll, mof, mml;
    int k = choose_table(cll, 36, nseq, 9, pre_ll_, ll_, tll, mll, out + at,
                         cap - at);
    if (k < 0) return 0;
    at += size_t(k);
    k = choose_table(cof, 32, nseq, 8, pre_of_, of_, tof, mof, out + at,
                     cap - at);
    if (k < 0) return 0;
    at += size_t(k);
    k = choose_table(cml, 53, nseq, 9, pre_ml_, ml_, tml, mml, out + at,
                     cap - at);
    if (k < 0) return 0;
    at += size_t(k);
    out[modes_at] = uint8_t(mll << 6 | mof << 4 | mml << 2);
    // the bitstream, last sequence first (libzstd's order)
    BitOut bw(out + at, cap - at);
    const size_t l = nseq - 1;
    uint32_t sll = fse_init(*tll, llc[l]), sml = fse_init(*tml, mlc[l]),
             sof = fse_init(*tof, ofc[l]);
    const auto extra = [&](size_t i) {
      const Seq& q = seqs_[i];
      bw.add(q.ll - kLLBase[llc[i]], kLLBits[llc[i]]);
      bw.add(q.ml - kMLBase[mlc[i]], kMLBits[mlc[i]]);
      bw.add(q.off - (1u << ofc[i]), ofc[i]);
    };
    extra(l);
    for (size_t i = l; i-- > 0;) {
      fse_encode(bw, *tof, sof, ofc[i]);
      fse_encode(bw, *tml, sml, mlc[i]);
      fse_encode(bw, *tll, sll, llc[i]);
      extra(i);
    }
    bw.add(sml, tml->al);
    bw.add(sof, tof->al);
    bw.add(sll, tll->al);
    const size_t bsize = bw.close();
    if (!bsize) return 0;
    return at + bsize;
  }

  std::vector<uint8_t> code_buf_;
};

}  // namespace

extern "C" {

// One Zstandard frame of src[0:n) at `level` into dst[0:cap]; returns its
// bytes, -1 when cap is short (nothing is written past it) and -2 when
// memory runs out.
int64_t zstd_encode(const uint8_t* src, int64_t n, uint8_t* dst, int64_t cap,
                    int32_t level) {
  if (n < 0 || cap < 0) return -1;
  if (level == 0) level = 3;
  level = std::max(-5, std::min(22, int(level)));
  try {
    Encoder enc(src, size_t(n), level);
    return enc.run(dst, size_t(cap));
  } catch (const std::bad_alloc&) {
    return -2;
  }
}

}  // extern "C"
