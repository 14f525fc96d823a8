// CCITT fax decoder for io/ccitt.py (loaded through ctypes; built with g++
// at first use into build/ipp_tpu_torch/).  It reads the bilevel TIFF
// strips and tiles that libtiff writes as compression 2 (Modified Huffman
// run lengths, every row starting on a byte), 3 (ITU-T T.4: every row after
// an EOL, with or without fill bits; one-dimensional rows, or, under
// Group3Options bit 0, a tag bit after each EOL choosing a one- or
// two-dimensional row) and 4 (ITU-T T.6: two-dimensional rows, no EOLs).
// There is no Python fallback: a read that needs this library raises when
// it does not build.
//
// A row comes out as libtiff hands it on: one bit a pixel, most significant
// first, padded to a byte, 1 where the code says black.  The reference row
// of a chunk's first two-dimensional row is all white.  Rows past the ones
// asked for (T.4's RTC, T.6's EOFB) are not read.
//
// Uncompressed mode (the extension codes) raises "not read" (return code
// -2): libtiff does not read it either.  Every malformed stream raises
// (return code -1): a code that is in no table, a row longer than the
// width, a change before the last one, an EOL inside a row, and data that
// end before the last row does.  Every read is bounded: bits past the end
// read as zeros and are caught as the end of the data.

#include <cstdarg>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <exception>
#include <string>
#include <vector>

namespace {

struct FaxError : std::exception {
  std::string msg;
  bool unsupported;
  FaxError(std::string m, bool u) : msg(std::move(m)), unsupported(u) {}
  const char* what() const noexcept override { return msg.c_str(); }
};

[[noreturn]] __attribute__((format(printf, 1, 2))) void fail(const char* fmt,
                                                             ...) {
  char buf[256];
  va_list ap;
  va_start(ap, fmt);
  vsnprintf(buf, sizeof buf, fmt, ap);
  va_end(ap);
  throw FaxError(buf, false);
}

[[noreturn]] void refuse(const char* m) { throw FaxError(m, true); }

// ---------------------------------------------------------------- codes --

// T.4 tables 2 and 3: code word (as a string of bits) -> run length
struct Code {
  const char* bits;
  int run;
};

const Code kWhite[] = {
    {"00110101", 0},    {"000111", 1},      {"0111", 2},
    {"1000", 3},        {"1011", 4},        {"1100", 5},
    {"1110", 6},        {"1111", 7},        {"10011", 8},
    {"10100", 9},       {"00111", 10},      {"01000", 11},
    {"001000", 12},     {"000011", 13},     {"110100", 14},
    {"110101", 15},     {"101010", 16},     {"101011", 17},
    {"0100111", 18},    {"0001100", 19},    {"0001000", 20},
    {"0010111", 21},    {"0000011", 22},    {"0000100", 23},
    {"0101000", 24},    {"0101011", 25},    {"0010011", 26},
    {"0100100", 27},    {"0011000", 28},    {"00000010", 29},
    {"00000011", 30},   {"00011010", 31},   {"00011011", 32},
    {"00010010", 33},   {"00010011", 34},   {"00010100", 35},
    {"00010101", 36},   {"00010110", 37},   {"00010111", 38},
    {"00101000", 39},   {"00101001", 40},   {"00101010", 41},
    {"00101011", 42},   {"00101100", 43},   {"00101101", 44},
    {"00000100", 45},   {"00000101", 46},   {"00001010", 47},
    {"00001011", 48},   {"01010010", 49},   {"01010011", 50},
    {"01010100", 51},   {"01010101", 52},   {"00100100", 53},
    {"00100101", 54},   {"01011000", 55},   {"01011001", 56},
    {"01011010", 57},   {"01011011", 58},   {"01001010", 59},
    {"01001011", 60},   {"00110010", 61},   {"00110011", 62},
    {"00110100", 63},   {"11011", 64},      {"10010", 128},
    {"010111", 192},    {"0110111", 256},   {"00110110", 320},
    {"00110111", 384},  {"01100100", 448},  {"01100101", 512},
    {"01101000", 576},  {"01100111", 640},  {"011001100", 704},
    {"011001101", 768}, {"011010010", 832}, {"011010011", 896},
    {"011010100", 960}, {"011010101", 1024}, {"011010110", 1088},
    {"011010111", 1152}, {"011011000", 1216}, {"011011001", 1280},
    {"011011010", 1344}, {"011011011", 1408}, {"010011000", 1472},
    {"010011001", 1536}, {"010011010", 1600}, {"011000", 1664},
    {"010011011", 1728},
};

const Code kBlack[] = {
    {"0000110111", 0},     {"010", 1},            {"11", 2},
    {"10", 3},             {"011", 4},            {"0011", 5},
    {"0010", 6},           {"00011", 7},          {"000101", 8},
    {"000100", 9},         {"0000100", 10},       {"0000101", 11},
    {"0000111", 12},       {"00000100", 13},      {"00000111", 14},
    {"000011000", 15},     {"0000010111", 16},    {"0000011000", 17},
    {"0000001000", 18},    {"00001100111", 19},   {"00001101000", 20},
    {"00001101100", 21},   {"00000110111", 22},   {"00000101000", 23},
    {"00000010111", 24},   {"00000011000", 25},   {"000011001010", 26},
    {"000011001011", 27},  {"000011001100", 28},  {"000011001101", 29},
    {"000001101000", 30},  {"000001101001", 31},  {"000001101010", 32},
    {"000001101011", 33},  {"000011010010", 34},  {"000011010011", 35},
    {"000011010100", 36},  {"000011010101", 37},  {"000011010110", 38},
    {"000011010111", 39},  {"000001101100", 40},  {"000001101101", 41},
    {"000011011010", 42},  {"000011011011", 43},  {"000001010100", 44},
    {"000001010101", 45},  {"000001010110", 46},  {"000001010111", 47},
    {"000001100100", 48},  {"000001100101", 49},  {"000001010010", 50},
    {"000001010011", 51},  {"000000100100", 52},  {"000000110111", 53},
    {"000000111000", 54},  {"000000100111", 55},  {"000000101000", 56},
    {"000001011000", 57},  {"000001011001", 58},  {"000000101011", 59},
    {"000000101100", 60},  {"000001011010", 61},  {"000001100110", 62},
    {"000001100111", 63},  {"0000001111", 64},    {"000011001000", 128},
    {"000011001001", 192}, {"000001011011", 256}, {"000000110011", 320},
    {"000000110100", 384}, {"000000110101", 448}, {"0000001101100", 512},
    {"0000001101101", 576}, {"0000001001010", 640}, {"0000001001011", 704},
    {"0000001001100", 768}, {"0000001001101", 832}, {"0000001110010", 896},
    {"0000001110011", 960}, {"0000001110100", 1024}, {"0000001110101", 1088},
    {"0000001110110", 1152}, {"0000001110111", 1216}, {"0000001010010", 1280},
    {"0000001010011", 1344}, {"0000001010100", 1408}, {"0000001010101", 1472},
    {"0000001011010", 1536}, {"0000001011011", 1600}, {"0000001100100", 1664},
    {"0000001100101", 1728},
};

// T.4 table 3's extended make-up codes, the same for both colours
const Code kExtended[] = {
    {"00000001000", 1792},  {"00000001100", 1856},  {"00000001101", 1920},
    {"000000010010", 1984}, {"000000010011", 2048}, {"000000010100", 2112},
    {"000000010101", 2176}, {"000000010110", 2240}, {"000000010111", 2304},
    {"000000011100", 2368}, {"000000011101", 2432}, {"000000011110", 2496},
    {"000000011111", 2560},
};

const char kEol[] = "000000000001";
const char kUncompressed1D[] = "000000001111";  // T.4 annex A's entry code

enum Kind : uint8_t { kInvalid, kTerm, kMakeup, kEolCode, kExtension };

struct Entry {
  uint8_t len = 0;
  Kind kind = kInvalid;
  uint16_t run = 0;
};

// A run-length table indexed by the next `bits` bits of the stream.
template <int bits>
struct RunTable {
  Entry e[1 << bits];
  void add(const char* code, Kind kind, int run) {
    int len = int(strlen(code));
    uint32_t v = 0;
    for (int i = 0; i < len; ++i) v = v << 1 | uint32_t(code[i] - '0');
    uint32_t lo = v << (bits - len), n = 1u << (bits - len);
    for (uint32_t i = 0; i < n; ++i) {
      if (e[lo + i].kind != kInvalid) fail("ccitt: overlapping codes");
      e[lo + i] = Entry{uint8_t(len), kind, uint16_t(run)};
    }
  }
  template <size_t n>
  void fill(const Code (&codes)[n]) {
    for (const Code& c : codes) add(c.bits, c.run < 64 ? kTerm : kMakeup,
                                    c.run);
    for (const Code& c : kExtended) add(c.bits, kMakeup, c.run);
    add(kEol, kEolCode, 0);
    add(kUncompressed1D, kExtension, 0);
  }
};

// The two-dimensional mode codes (T.4 table 4), by their first 7 bits.
enum Mode : uint8_t { kBad, kPass, kHoriz, kV, kExt, kZeros };
struct ModeEntry {
  uint8_t len = 0;
  Mode mode = kBad;
  int8_t dv = 0;  // a vertical mode's a1 - b1
};

struct Tables {
  RunTable<12> white;
  RunTable<13> black;
  ModeEntry mode[128];
  Tables() {
    white.fill(kWhite);
    black.fill(kBlack);
    const struct {
      const char* bits;
      Mode mode;
      int dv;
    } modes[] = {{"1", kV, 0},        {"011", kV, 1},      {"000011", kV, 2},
                 {"0000011", kV, 3},  {"010", kV, -1},     {"000010", kV, -2},
                 {"0000010", kV, -3}, {"001", kHoriz, 0},  {"0001", kPass, 0},
                 {"0000001", kExt, 0}, {"0000000", kZeros, 0}};
    for (const auto& m : modes) {
      int len = int(strlen(m.bits));
      uint32_t v = 0;
      for (int i = 0; i < len; ++i) v = v << 1 | uint32_t(m.bits[i] - '0');
      for (uint32_t i = 0; i < (1u << (7 - len)); ++i)
        mode[(v << (7 - len)) + i] = ModeEntry{uint8_t(len), m.mode,
                                               int8_t(m.dv)};
    }
  }
};

const Tables& tables() {
  static const Tables t;
  return t;
}

// ----------------------------------------------------------------- bits --

// MSB-first reader; bits past the end read as zeros, and `over` tells.
struct Bits {
  const uint8_t* p;
  uint64_t nbytes, nbits, pos = 0;
  Bits(const uint8_t* src, uint64_t n) : p(src), nbytes(n), nbits(8 * n) {}
  uint32_t peek(int k) const {  // 1 <= k <= 24
    uint64_t byte = pos >> 3;
    uint32_t v = 0;
    if (byte + 4 <= nbytes) {
      v = uint32_t(p[byte]) << 24 | uint32_t(p[byte + 1]) << 16 |
          uint32_t(p[byte + 2]) << 8 | p[byte + 3];
    } else {
      for (int i = 0; i < 4; ++i)
        v = v << 8 | (byte + i < nbytes ? p[byte + i] : 0u);
    }
    return (v << (pos & 7)) >> (32 - k);
  }
  void skip(int k) { pos += uint64_t(k); }
  bool over() const { return pos > nbits; }
};

// ------------------------------------------------------------- decoder --

struct Decoder {
  const Tables& t = tables();
  Bits in;
  int64_t width, row = 0;
  std::vector<int32_t> ref, cur;  // changing elements, then sentinels
  int32_t nref = 0, ncur = 0;

  Decoder(const uint8_t* src, int64_t n, int64_t w)
      : in(src, uint64_t(n)), width(w), ref(size_t(w) + 8),
        cur(size_t(w) + 8) {
    white_reference();
  }

  [[noreturn]] void bad(const char* what) {
    // a code cut by the end of the data reads as zeros past it
    if (in.pos + 13 > in.nbits)
      fail("ccitt: the data end inside row %lld", (long long)row);
    fail("ccitt: %s in row %lld (bit %llu)", what, (long long)row,
         (unsigned long long)in.pos);
  }

  void white_reference() {
    nref = 0;
    for (int i = 0; i < 4; ++i) ref[size_t(i)] = int32_t(width);
  }

  // a change of colour at x on the coding line; two at one place cancel
  void change(int64_t x) {
    if (x >= width) return;
    if (ncur && cur[size_t(ncur - 1)] == x) {
      --ncur;
      return;
    }
    if (ncur && cur[size_t(ncur - 1)] > x) bad("a change before the last");
    cur[size_t(ncur++)] = int32_t(x);
  }

  // one run: make-up codes, then a terminating code
  int64_t run(bool black) {
    int64_t total = 0;
    for (;;) {
      const Entry& e = black ? t.black.e[in.peek(13)] : t.white.e[in.peek(12)];
      if (e.kind == kExtension) refuse("ccitt: uncompressed mode is not read");
      if (e.kind == kEolCode) bad("an EOL inside a row");
      if (e.kind == kInvalid)
        bad(black ? "a bad black code" : "a bad white code");
      in.skip(e.len);
      if (in.over()) bad("");
      total += e.run;
      if (total > width) bad("a run past the row's end");
      if (e.kind == kTerm) return total;
    }
  }

  void row1d() {
    ncur = 0;
    int64_t a0 = 0;
    bool black = false;
    while (true) {
      a0 += run(black);
      if (a0 > width) bad("a row longer than the width");
      change(a0);
      black = !black;
      if (a0 >= width) return;
    }
  }

  void row2d() {
    ncur = 0;
    int64_t a0 = -1;
    int color = 0;  // a0's colour: 0 white, 1 black
    size_t bi = 0;
    while (a0 < width) {
      // b1: the first change on the reference line past a0 to the colour
      // opposite a0's (changes to black have even indices)
      while (ref[bi] <= a0) ++bi;
      if (int(bi & 1) != color) ++bi;
      int64_t b1 = ref[bi], b2 = ref[bi + 1];
      const ModeEntry& m = t.mode[in.peek(7)];
      switch (m.mode) {
        case kPass:
          in.skip(m.len);
          a0 = b2;
          break;
        case kHoriz: {
          in.skip(m.len);
          int64_t a1 = (a0 < 0 ? 0 : a0) + run(color);
          int64_t a2 = a1 + run(!color);
          if (a2 > width) bad("a row longer than the width");
          change(a1);
          change(a2);
          a0 = a2;
          break;
        }
        case kV: {
          in.skip(m.len);
          int64_t a1 = b1 + m.dv;
          if (a1 < a0 || a1 < 0 || a1 > width)
            bad("a vertical mode off the row");
          change(a1);
          a0 = a1;
          color ^= 1;
          if (bi) --bi;  // b1 may now lie left of this one
          break;
        }
        case kExt:
          refuse("ccitt: uncompressed mode is not read");
        case kZeros:
          bad(in.peek(12) == 1 ? "an EOL inside a row" : "a bad mode code");
        default:
          bad("a bad mode code");
      }
      if (in.over()) bad("");
    }
  }

  // T.4: skip to the end of the next EOL (11 zeros at least, then a 1)
  void eol() {
    while (in.peek(11) != 0) {
      in.skip(1);
      if (in.over()) bad("");
    }
    in.skip(11);
    while (in.peek(1) == 0) {
      in.skip(1);
      if (in.over()) bad("");
    }
    in.skip(1);
  }

  void emit(uint8_t* out) {
    int64_t rowbytes = (width + 7) / 8;
    memset(out, 0, size_t(rowbytes));
    for (int32_t i = 0; i < ncur; i += 2) {
      int64_t s = cur[size_t(i)];
      int64_t e = i + 1 < ncur ? cur[size_t(i + 1)] : width;
      for (; s < e && (s & 7); ++s) out[s >> 3] |= uint8_t(0x80 >> (s & 7));
      for (; s + 8 <= e; s += 8) out[s >> 3] = 0xFF;
      for (; s < e; ++s) out[s >> 3] |= uint8_t(0x80 >> (s & 7));
    }
    // this row is the next one's reference
    std::copy(cur.begin(), cur.begin() + ncur, ref.begin());
    nref = ncur;
    for (int i = 0; i < 4; ++i) ref[size_t(ncur + i)] = int32_t(width);
  }

  void decode(uint8_t* dst, int64_t rows, int scheme, int options) {
    int64_t rowbytes = (width + 7) / 8;
    for (row = 0; row < rows; ++row) {
      if (scheme == 2) {
        row1d();
        in.pos = (in.pos + 7) & ~uint64_t(7);  // the next row's first byte
      } else if (scheme == 3) {
        eol();
        bool one_d = true;
        if (options & 1) {
          one_d = in.peek(1) == 1;
          in.skip(1);
        }
        if (one_d) row1d(); else row2d();
      } else {
        row2d();
      }
      if (in.over()) bad("");
      emit(dst + row * rowbytes);
    }
  }
};

}  // namespace

extern "C" {

int ccitt_abi_version() { return 1; }

// Decode `rows` rows of `width` pixels from src[0:n] into dst (rows x
// ceil(width / 8) bytes) under TIFF compression `scheme` (2, 3 or 4) and,
// for 3, the Group3Options `options`; returns rows, or -1 for malformed
// data and -2 for what is not read (uncompressed mode), with a message in
// err.
int64_t ccitt_decode(const uint8_t* src, int64_t n, uint8_t* dst, int64_t rows,
                     int64_t width, int32_t scheme, int32_t options, char* err,
                     int32_t errlen) {
  try {
    if (n < 0 || rows < 0 || width <= 0 || width > (int64_t(1) << 30))
      fail("ccitt: bad sizes");
    if (scheme < 2 || scheme > 4) fail("ccitt: scheme %d", scheme);
    Decoder d(src, n, width);
    d.decode(dst, rows, scheme, options);
    return rows;
  } catch (const FaxError& e) {
    if (err && errlen > 0) snprintf(err, size_t(errlen), "%s", e.what());
    return e.unsupported ? -2 : -1;
  } catch (const std::exception& e) {
    if (err && errlen > 0) snprintf(err, size_t(errlen), "%s", e.what());
    return -1;
  }
}

}  // extern "C"
