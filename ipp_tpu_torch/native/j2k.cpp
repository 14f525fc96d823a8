// JPEG 2000 (ISO 15444-1) decode and encode, for io/jpeg2000.py (loaded
// through ctypes; built with g++ at first use into build/ipp_tpu_torch/).
// There is no Python fallback: a read or write that needs this library
// raises when it does not build.
//
// Decode covers what OpenJPEG writes at its options: JP2 boxes or a raw
// codestream; 1-4 components of 1-16 bits, unsigned, not subsampled; one
// tile or many, edge tiles, tile-parts; the five progression orders; user
// precincts and code-block sizes; any number of quality layers; markers
// PLT / PLM / TLM / COM / CRG skipped; the MQ decoder and the three
// EBCOT passes (code-block style 0); tag trees; the 5/3 reversible wavelet
// with RCT and the 9/7 irreversible one with ICT and expounded or derived
// scalar quantisation; DC level shift and clamp.  The arithmetic is
// OpenJPEG 2.5's, so the samples equal what it decodes bit for bit: the
// coefficients are kept at twice their value with the half bit of the
// mid-point reconstruction ((1 << p) | (1 << (p - 1))), the reversible ones
// halved by C division, the irreversible ones scaled by 0.5f * the step size
// (a float of the double (1 + mu / 2048) 2^(prec - eps)), the 9/7 lifting in
// float32 in OpenJPEG's order of operations (K and 2/K scaling first, its
// "two_invK"), the ICT in float32, lrintf, then the level shift and clamp.
// Everything else raises with a message naming it: other code-block styles,
// POC, PPM / PPT, RGN, SOP / EPH, subsampling, signed components, HTJ2K.
//
// Code-blocks are independent: after the packets are parsed, they decode on
// `nthreads` threads.
//
// Encode writes what PIL writes through OpenJPEG at its defaults, by its
// declared parameters: JP2 boxes, one tile, the 5/3
// wavelet, min(5, floor(log2(min side))) levels, 64 x 64 code-blocks of
// style 0, one layer, LRCP, no MCT (RGB included), two guard bits, the
// reversible QCD, no precincts.  All coding passes are kept (lossless).

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <exception>
#include <string>
#include <thread>
#include <vector>

namespace {

struct J2kError : std::exception {
  std::string msg;
  explicit J2kError(std::string m) : msg(std::move(m)) {}
  const char* what() const noexcept override { return msg.c_str(); }
};

[[noreturn]] void fail(const std::string& m) { throw J2kError(m); }

int64_t ceil_div(int64_t a, int64_t b) {  // b > 0, any sign of a
  return a >= 0 ? (a + b - 1) / b : -((-a) / b);
}
int64_t floor_div(int64_t a, int64_t b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}
int floor_log2(uint32_t v) {
  int l = -1;
  while (v) {
    v >>= 1;
    ++l;
  }
  return l;
}

// ------------------------------------------------------------ MQ coder

struct QeRow {
  uint16_t qe;
  uint8_t nmps, nlps, sw;
};
const QeRow kQe[47] = {
    {0x5601, 1, 1, 1},   {0x3401, 2, 6, 0},   {0x1801, 3, 9, 0},
    {0x0AC1, 4, 12, 0},  {0x0521, 5, 29, 0},  {0x0221, 38, 33, 0},
    {0x5601, 7, 6, 1},   {0x5401, 8, 14, 0},  {0x4801, 9, 14, 0},
    {0x3801, 10, 14, 0}, {0x3001, 11, 17, 0}, {0x2401, 12, 18, 0},
    {0x1C01, 13, 20, 0}, {0x1601, 29, 21, 0}, {0x5601, 15, 14, 1},
    {0x5401, 16, 14, 0}, {0x5101, 17, 15, 0}, {0x4801, 18, 16, 0},
    {0x3801, 19, 17, 0}, {0x3401, 20, 18, 0}, {0x3001, 21, 19, 0},
    {0x2801, 22, 19, 0}, {0x2401, 23, 20, 0}, {0x2201, 24, 21, 0},
    {0x1C01, 25, 22, 0}, {0x1801, 26, 23, 0}, {0x1601, 27, 24, 0},
    {0x1401, 28, 25, 0}, {0x1201, 29, 26, 0}, {0x1101, 30, 27, 0},
    {0x0AC1, 31, 28, 0}, {0x09C1, 32, 29, 0}, {0x08A1, 33, 30, 0},
    {0x0521, 34, 31, 0}, {0x0441, 35, 32, 0}, {0x02A1, 36, 33, 0},
    {0x0221, 37, 34, 0}, {0x0141, 38, 35, 0}, {0x0111, 39, 36, 0},
    {0x0085, 40, 37, 0}, {0x0049, 41, 38, 0}, {0x0025, 42, 39, 0},
    {0x0015, 43, 40, 0}, {0x0009, 44, 41, 0}, {0x0005, 45, 42, 0},
    {0x0001, 45, 43, 0}, {0x5601, 46, 46, 0}};

enum { CTX_ZC = 0, CTX_SC = 9, CTX_MR = 14, CTX_RL = 17, CTX_UNI = 18,
       NCTX = 19 };

struct Contexts {
  uint8_t state[NCTX];
  uint8_t mps[NCTX];
  void reset() {
    std::memset(state, 0, sizeof state);
    std::memset(mps, 0, sizeof mps);
    state[CTX_ZC] = 4;
    state[CTX_RL] = 3;
    state[CTX_UNI] = 46;
  }
};

// Annex C's decoder; the data is followed by two 0xFF bytes (as OpenJPEG
// appends them), so reading past the end feeds 1-bits as at a marker.
struct MqDecoder {
  const uint8_t* bp;
  uint32_t a, c;
  int ct;
  Contexts cx;

  void bytein() {
    if (bp[0] == 0xFF) {
      if (bp[1] > 0x8F) {
        c += 0xFF00;
        ct = 8;
      } else {
        ++bp;
        c += static_cast<uint32_t>(bp[0]) << 9;
        ct = 7;
      }
    } else {
      ++bp;
      c += static_cast<uint32_t>(bp[0]) << 8;
      ct = 8;
    }
  }
  void init(const uint8_t* data) {  // data[len], data[len + 1] == 0xFF
    bp = data;
    c = static_cast<uint32_t>(bp[0]) << 16;
    bytein();
    c <<= 7;
    ct -= 7;
    a = 0x8000;
    cx.reset();
  }
  void renorm() {
    do {
      if (ct == 0) bytein();
      a <<= 1;
      c <<= 1;
      --ct;
    } while ((a & 0x8000) == 0);
  }
  int decode(int ctx) {
    const QeRow& q = kQe[cx.state[ctx]];
    int d;
    a -= q.qe;
    if ((c >> 16) < q.qe) {
      if (a < q.qe) {
        d = cx.mps[ctx];
        cx.state[ctx] = q.nmps;
      } else {
        d = 1 - cx.mps[ctx];
        if (q.sw) cx.mps[ctx] ^= 1;
        cx.state[ctx] = q.nlps;
      }
      a = q.qe;
      renorm();
    } else {
      c -= static_cast<uint32_t>(q.qe) << 16;
      if ((a & 0x8000) == 0) {
        if (a < q.qe) {
          d = 1 - cx.mps[ctx];
          if (q.sw) cx.mps[ctx] ^= 1;
          cx.state[ctx] = q.nlps;
        } else {
          d = cx.mps[ctx];
          cx.state[ctx] = q.nmps;
        }
        renorm();
      } else {
        d = cx.mps[ctx];
      }
    }
    return d;
  }
};

struct MqEncoder {
  std::vector<uint8_t> out;  // out[0] is the byte before the first one
  uint32_t a, c;
  int ct;
  Contexts cx;

  void init() {
    out.assign(1, 0);
    a = 0x8000;
    c = 0;
    ct = 12;
    cx.reset();
  }
  void byteout() {
    uint8_t& b = out.back();
    if (b == 0xFF) {
      out.push_back(static_cast<uint8_t>(c >> 20));
      c &= 0xFFFFF;
      ct = 7;
    } else if (c < 0x8000000) {
      out.push_back(static_cast<uint8_t>(c >> 19));
      c &= 0x7FFFF;
      ct = 8;
    } else {
      ++b;
      if (b == 0xFF) {
        c &= 0x7FFFFFF;
        out.push_back(static_cast<uint8_t>(c >> 20));
        c &= 0xFFFFF;
        ct = 7;
      } else {
        out.push_back(static_cast<uint8_t>(c >> 19));
        c &= 0x7FFFF;
        ct = 8;
      }
    }
  }
  void renorm() {
    do {
      a <<= 1;
      c <<= 1;
      if (--ct == 0) byteout();
    } while ((a & 0x8000) == 0);
  }
  void encode(int ctx, int d) {
    const QeRow& q = kQe[cx.state[ctx]];
    a -= q.qe;
    if (d == cx.mps[ctx]) {
      if ((a & 0x8000) == 0) {
        if (a < q.qe)
          a = q.qe;
        else
          c += q.qe;
        cx.state[ctx] = q.nmps;
        renorm();
      } else {
        c += q.qe;
      }
    } else {
      if (a < q.qe)
        c += q.qe;
      else
        a = q.qe;
      if (q.sw) cx.mps[ctx] ^= 1;
      cx.state[ctx] = q.nlps;
      renorm();
    }
  }
  // FLUSH; returns the coded bytes (without the leading dummy byte and
  // without a final 0xFF).
  std::vector<uint8_t> flush() {
    uint32_t tempc = c + a;
    c |= 0xFFFF;
    if (c >= tempc) c -= 0x8000;
    c <<= ct;
    byteout();
    c <<= ct;
    byteout();
    if (out.back() == 0xFF) out.pop_back();
    return std::vector<uint8_t>(out.begin() + 1, out.end());
  }
};

// ------------------------------------------------------- EBCOT (tier 1)

// Per coefficient, in arrays padded by one on every side: flags (SIG, VISIT,
// REFINED, NEG) and the packed count of significant neighbours (h: bits 0-1,
// v: bits 2-3, d: bits 4-6).
enum { F_SIG = 1, F_VISIT = 2, F_REF = 4, F_NEG = 8 };

uint8_t g_zc[4][128];  // orientation (0 LL, 1 HL, 2 LH, 3 HH) x packed nb

void init_luts() {
  for (int o = 0; o < 4; ++o)
    for (int nb = 0; nb < 128; ++nb) {
      int h = nb & 3, v = (nb >> 2) & 3, d = nb >> 4;
      if (o == 1) std::swap(h, v);
      int ctx;
      if (o == 3) {
        int hv = h + v;
        if (d >= 3) ctx = 8;
        else if (d == 2) ctx = hv >= 1 ? 7 : 6;
        else if (d == 1) ctx = hv >= 2 ? 5 : hv == 1 ? 4 : 3;
        else ctx = hv >= 2 ? 2 : hv == 1 ? 1 : 0;
      } else {
        if (h == 2) ctx = 8;
        else if (h == 1) ctx = v >= 1 ? 7 : d >= 1 ? 6 : 5;
        else if (v == 2) ctx = 4;
        else if (v == 1) ctx = 3;
        else ctx = d >= 2 ? 2 : d == 1 ? 1 : 0;
      }
      g_zc[o][nb] = static_cast<uint8_t>(ctx);
    }
}

struct T1 {
  int w, h, stride;
  std::vector<uint8_t> flags, nb;
  std::vector<int32_t> data;  // w x h, unpadded

  void setup(int w_, int h_) {
    w = w_;
    h = h_;
    stride = w + 2;
    flags.assign(static_cast<size_t>(stride) * (h + 2), 0);
    nb.assign(flags.size(), 0);
    data.assign(static_cast<size_t>(w) * h, 0);
  }
  int at(int x, int y) const { return (y + 1) * stride + x + 1; }
  void make_significant(int i, bool neg) {
    flags[i] |= F_SIG | (neg ? F_NEG : 0);
    nb[i - 1] += 1;
    nb[i + 1] += 1;
    nb[i - stride] += 4;
    nb[i + stride] += 4;
    nb[i - stride - 1] += 16;
    nb[i - stride + 1] += 16;
    nb[i + stride - 1] += 16;
    nb[i + stride + 1] += 16;
  }
  // sign context and XOR bit (Table D.3)
  void sign_ctx(int i, int* ctx, int* xr) const {
    auto contrib = [&](int j) {
      uint8_t f = flags[j];
      return (f & F_SIG) ? ((f & F_NEG) ? -1 : 1) : 0;
    };
    int hc = contrib(i - 1) + contrib(i + 1);
    int vc = contrib(i - stride) + contrib(i + stride);
    hc = hc < -1 ? -1 : hc > 1 ? 1 : hc;
    vc = vc < -1 ? -1 : vc > 1 ? 1 : vc;
    static const int ctab[3][3] = {{13, 12, 11}, {10, 9, 10}, {11, 12, 13}};
    static const int xtab[3][3] = {{1, 1, 1}, {1, 0, 0}, {0, 0, 0}};
    *ctx = ctab[hc + 1][vc + 1];
    *xr = xtab[hc + 1][vc + 1];
  }
  int mr_ctx(int i) const {
    if (flags[i] & F_REF) return CTX_MR + 2;
    return nb[i] ? CTX_MR + 1 : CTX_MR;
  }
};

// The sign table above: hc = -1 row gives (vc -1, 0, 1) -> (13, 12, 11) with
// XOR 1; hc = 0 -> (10 xor 1, 9, 10); hc = 1 -> (11, 12, 13) xor 0.

void t1_decode(T1& t, const uint8_t* bytes, int npasses, int numbps,
               int orient) {
  MqDecoder mq;
  mq.init(bytes);
  const uint8_t* zc = g_zc[orient];
  int plane = numbps;  // OpenJPEG's bpno_plus_one
  int type = 2;
  for (int pass = 0; pass < npasses; ++pass) {
    int32_t one = 1 << plane, half = one >> 1, oph = one | half;
    for (int y0 = 0; y0 < t.h; y0 += 4) {
      int y1 = std::min(y0 + 4, t.h);
      for (int x = 0; x < t.w; ++x) {
        int ys = y0;
        if (type != 2 && y1 - y0 == 4) {  // nothing to code in the column
          int i0 = t.at(x, y0), s = t.stride;
          if (type == 0 && !(t.nb[i0] | t.nb[i0 + s] | t.nb[i0 + 2 * s] |
                             t.nb[i0 + 3 * s]))
            continue;
          if (type == 1 && !((t.flags[i0] | t.flags[i0 + s] |
                              t.flags[i0 + 2 * s] | t.flags[i0 + 3 * s]) & F_SIG))
            continue;
        }
        if (type == 2 && y1 - y0 == 4) {
          int i0 = t.at(x, y0), s = t.stride;
          if (!(t.flags[i0] | t.nb[i0] | t.flags[i0 + s] | t.nb[i0 + s] |
                t.flags[i0 + 2 * s] | t.nb[i0 + 2 * s] | t.flags[i0 + 3 * s] |
                t.nb[i0 + 3 * s])) {
            if (!mq.decode(CTX_RL)) continue;
            int r = mq.decode(CTX_UNI) << 1;
            r |= mq.decode(CTX_UNI);
            int i = i0 + r * s, ctx, xr;
            t.sign_ctx(i, &ctx, &xr);
            bool neg = (mq.decode(ctx) ^ xr) != 0;
            t.make_significant(i, neg);
            t.data[static_cast<size_t>(y0 + r) * t.w + x] = neg ? -oph : oph;
            ys = y0 + r + 1;
          }
        }
        for (int y = ys; y < y1; ++y) {
          int i = t.at(x, y);
          uint8_t f = t.flags[i];
          if (type == 0) {  // significance propagation
            if ((f & F_SIG) || !t.nb[i]) continue;
            t.flags[i] |= F_VISIT;
            if (mq.decode(zc[t.nb[i]])) {
              int ctx, xr;
              t.sign_ctx(i, &ctx, &xr);
              bool neg = (mq.decode(ctx) ^ xr) != 0;
              t.make_significant(i, neg);
              t.data[static_cast<size_t>(y) * t.w + x] = neg ? -oph : oph;
            }
          } else if (type == 1) {  // magnitude refinement
            if ((f & (F_SIG | F_VISIT)) != F_SIG) continue;
            int d = mq.decode(t.mr_ctx(i));
            int32_t& v = t.data[static_cast<size_t>(y) * t.w + x];
            int32_t step = d ? half : -half;
            v += v < 0 ? -step : step;
            t.flags[i] |= F_REF;
          } else {  // cleanup
            if (f & (F_SIG | F_VISIT)) continue;
            if (mq.decode(zc[t.nb[i]])) {
              int ctx, xr;
              t.sign_ctx(i, &ctx, &xr);
              bool neg = (mq.decode(ctx) ^ xr) != 0;
              t.make_significant(i, neg);
              t.data[static_cast<size_t>(y) * t.w + x] = neg ? -oph : oph;
            }
          }
        }
      }
    }
    if (type == 2) {
      for (size_t k = 0; k < t.flags.size(); ++k) t.flags[k] &= ~F_VISIT;
    }
    if (++type == 3) {
      type = 0;
      --plane;
    }
  }
}

// Encodes the integer coefficients `coef` (w x h) of one code-block with
// every pass; returns the bytes and sets *npasses and *numbps.
std::vector<uint8_t> t1_encode(T1& t, const int32_t* coef, int orient,
                               int* npasses, int* numbps) {
  uint32_t mx = 0;
  for (int k = 0; k < t.w * t.h; ++k)
    mx = std::max(mx, static_cast<uint32_t>(std::abs(coef[k])));
  int K = mx ? floor_log2(mx) + 1 : 0;
  *numbps = K;
  *npasses = K ? 3 * K - 2 : 0;
  if (!K) return {};
  MqEncoder mq;
  mq.init();
  const uint8_t* zc = g_zc[orient];
  auto mag = [&](int x, int y) {
    return static_cast<uint32_t>(std::abs(coef[y * t.w + x]));
  };
  auto code_sign = [&](int i, int x, int y) {
    int ctx, xr;
    t.sign_ctx(i, &ctx, &xr);
    bool neg = coef[y * t.w + x] < 0;
    mq.encode(ctx, (neg ? 1 : 0) ^ xr);
    t.make_significant(i, neg);
  };
  int type = 2;
  for (int plane = K - 1; plane >= 0;) {
    for (int y0 = 0; y0 < t.h; y0 += 4) {
      int y1 = std::min(y0 + 4, t.h);
      for (int x = 0; x < t.w; ++x) {
        int ys = y0;
        if (type != 2 && y1 - y0 == 4) {  // nothing to code in the column
          int i0 = t.at(x, y0), s = t.stride;
          if (type == 0 && !(t.nb[i0] | t.nb[i0 + s] | t.nb[i0 + 2 * s] |
                             t.nb[i0 + 3 * s]))
            continue;
          if (type == 1 && !((t.flags[i0] | t.flags[i0 + s] |
                              t.flags[i0 + 2 * s] | t.flags[i0 + 3 * s]) & F_SIG))
            continue;
        }
        if (type == 2 && y1 - y0 == 4) {
          int i0 = t.at(x, y0), s = t.stride;
          if (!(t.flags[i0] | t.nb[i0] | t.flags[i0 + s] | t.nb[i0 + s] |
                t.flags[i0 + 2 * s] | t.nb[i0 + 2 * s] | t.flags[i0 + 3 * s] |
                t.nb[i0 + 3 * s])) {
            int r = 0;
            while (r < 4 && !((mag(x, y0 + r) >> plane) & 1)) ++r;
            mq.encode(CTX_RL, r < 4);
            if (r == 4) continue;
            mq.encode(CTX_UNI, r >> 1);
            mq.encode(CTX_UNI, r & 1);
            code_sign(i0 + r * s, x, y0 + r);
            ys = y0 + r + 1;
          }
        }
        for (int y = ys; y < y1; ++y) {
          int i = t.at(x, y);
          uint8_t f = t.flags[i];
          int bit = (mag(x, y) >> plane) & 1;
          if (type == 0) {
            if ((f & F_SIG) || !t.nb[i]) continue;
            t.flags[i] |= F_VISIT;
            mq.encode(zc[t.nb[i]], bit);
            if (bit) code_sign(i, x, y);
          } else if (type == 1) {
            if ((f & (F_SIG | F_VISIT)) != F_SIG) continue;
            mq.encode(t.mr_ctx(i), bit);
            t.flags[i] |= F_REF;
          } else {
            if (f & (F_SIG | F_VISIT)) continue;
            mq.encode(zc[t.nb[i]], bit);
            if (bit) code_sign(i, x, y);
          }
        }
      }
    }
    if (type == 2)
      for (size_t k = 0; k < t.flags.size(); ++k) t.flags[k] &= ~F_VISIT;
    if (++type == 3) {
      type = 0;
      --plane;
    }
  }
  return mq.flush();
}

// --------------------------------------------------------------- tag trees

struct TagTree {
  struct Node {
    int parent, value, low;
    bool known;
  };
  std::vector<Node> nodes;
  void build(int w, int h) {
    nodes.clear();
    std::vector<std::pair<int, int>> dims;
    int lw = w, lh = h;
    if (w * h == 0) return;
    for (;;) {
      dims.push_back({lw, lh});
      if (lw == 1 && lh == 1) break;
      lw = (lw + 1) / 2;
      lh = (lh + 1) / 2;
    }
    std::vector<int> start;
    int total = 0;
    for (auto& d : dims) {
      start.push_back(total);
      total += d.first * d.second;
    }
    nodes.assign(total, Node{-1, 999, 0, false});
    for (size_t l = 0; l + 1 < dims.size(); ++l) {
      int dw = dims[l].first, pw = dims[l + 1].first;
      for (int j = 0; j < dims[l].second; ++j)
        for (int i = 0; i < dw; ++i)
          nodes[start[l] + j * dw + i].parent =
              start[l + 1] + (j / 2) * pw + i / 2;
    }
  }
  template <class Bits>
  bool decode(Bits& bio, int leaf, int threshold) {
    int stk[64], n = 0;
    int node = leaf;
    while (nodes[node].parent >= 0) {
      stk[n++] = node;
      node = nodes[node].parent;
    }
    int low = 0;
    for (;;) {
      Node& nd = nodes[node];
      if (low > nd.low)
        nd.low = low;
      else
        low = nd.low;
      while (low < threshold && low < nd.value) {
        if (bio.bit())
          nd.value = low;
        else
          ++low;
      }
      nd.low = low;
      if (!n) break;
      node = stk[--n];
    }
    return nodes[node].value < threshold;
  }
  void set(int leaf, int v) {  // encoder: leaf value, minima up the tree
    int node = leaf;
    while (node >= 0 && nodes[node].value > v) {
      nodes[node].value = v;
      node = nodes[node].parent;
    }
  }
  template <class Bits>
  void encode(Bits& bio, int leaf, int threshold) {
    int stk[64], n = 0;
    int node = leaf;
    while (nodes[node].parent >= 0) {
      stk[n++] = node;
      node = nodes[node].parent;
    }
    int low = 0;
    for (;;) {
      Node& nd = nodes[node];
      if (low > nd.low)
        nd.low = low;
      else
        low = nd.low;
      while (low < threshold) {
        if (low >= nd.value) {
          if (!nd.known) {
            bio.put(1);
            nd.known = true;
          }
          break;
        }
        bio.put(0);
        ++low;
      }
      nd.low = low;
      if (!n) break;
      node = stk[--n];
    }
  }
};

// Packet-header bits, with a 0 stuffed after every 0xFF byte.
struct BitReader {
  const uint8_t *p, *end;
  uint32_t buf = 0;
  int ct = 0;
  void bytein() {
    buf = (buf << 8) & 0xFFFF;
    ct = buf == 0xFF00 ? 7 : 8;
    if (p < end) buf |= *p++;
  }
  int bit() {
    if (ct == 0) bytein();
    --ct;
    return (buf >> ct) & 1;
  }
  uint32_t bits(int n) {
    uint32_t v = 0;
    while (n--) v = (v << 1) | bit();
    return v;
  }
  void align() {
    if ((buf & 0xFF) == 0xFF) bytein();
    ct = 0;
  }
};

struct BitWriter {
  std::vector<uint8_t> out;
  uint32_t acc = 0;
  int room = 8, used = 0;
  void put(int b) {
    acc = (acc << 1) | (b & 1);
    ++used;
    if (used == room) emit();
  }
  void bits(uint32_t v, int n) {
    while (n--) put((v >> n) & 1);
  }
  void emit() {
    uint8_t byte = static_cast<uint8_t>(acc << (room - used));
    out.push_back(byte);
    room = byte == 0xFF ? 7 : 8;
    acc = 0;
    used = 0;
  }
  std::vector<uint8_t> finish() {
    if (used) emit();
    if (!out.empty() && out.back() == 0xFF) out.push_back(0);
    return out;
  }
};

// ---------------------------------------------------------------- structure

struct CompParams {  // COD / COC and QCD / QCC of one component
  int levels = 0, xcb = 6, ycb = 6, style = 0, transform = 1;
  bool precincts = false;
  int ppx[33], ppy[33];
  int qstyle = 0, guard = 2;
  int expn[97], mant[97];
  CompParams() {
    for (int i = 0; i < 33; ++i) ppx[i] = ppy[i] = 15;
    std::memset(expn, 0, sizeof expn);
    std::memset(mant, 0, sizeof mant);
  }
};

struct Coding {  // COD's codestream-wide part
  int scod = 0, prog = 0, layers = 1, mct = 0;
};

struct Siz {
  int64_t xsiz = 0, ysiz = 0, xo = 0, yo = 0, xt = 0, yt = 0, xto = 0,
          yto = 0;
  int nc = 0;
  std::vector<int> prec, sgnd;
};

struct Segment {
  const uint8_t* p;
  uint32_t len;
};

struct Codeblock {
  int x0, y0, x1, y1;  // band coordinates
  bool included = false;
  int numbps = 0, npasses = 0, lblock = 3;
  std::vector<Segment> segs;  // one a layer it appears in
  std::vector<uint8_t> bytes;  // encoder
};

struct Band {
  int orient;  // 0 LL, 1 HL, 2 LH, 3 HH
  int64_t x0, y0, x1, y1;
  int Mb;
  float stepsize;
  int cbx, cby;  // code-block exponents
};

struct PrecBand {
  int cw = 0, ch = 0;  // code-blocks across and down
  std::vector<Codeblock> cblks;
  TagTree incl, zbp;
};

struct Precinct {
  std::vector<PrecBand> bands;  // one for each band of the resolution
};

struct Resolution {
  int64_t x0, y0, x1, y1;
  int ppx, ppy, pw = 0, ph = 0;
  std::vector<Band> bands;
  std::vector<Precinct> precs;
};

struct TileComp {
  int64_t x0, y0, x1, y1;
  CompParams cp;
  std::vector<Resolution> res;
  std::vector<int32_t> idata;
  std::vector<float> fdata;
  int64_t w() const { return x1 - x0; }
  int64_t h() const { return y1 - y0; }
};

struct Tile {
  int index = 0;
  int64_t x0, y0, x1, y1;
  Coding cod;
  std::vector<CompParams> cps;
  std::vector<uint8_t> bytes;  // the tile-parts' packet data
  std::vector<TileComp> comps;
  bool seen = false;
};

int band_gain(int orient) { return orient == 0 ? 0 : orient == 3 ? 2 : 1; }

// Resolutions, bands, precincts and code-blocks of one tile-component.
void build_tilecomp(TileComp& tc, int prec, bool decoding) {
  const CompParams& cp = tc.cp;
  int NL = cp.levels;
  tc.res.assign(NL + 1, Resolution());
  for (int r = 0; r <= NL; ++r) {
    Resolution& R = tc.res[r];
    int64_t s = int64_t(1) << (NL - r);
    R.x0 = ceil_div(tc.x0, s);
    R.y0 = ceil_div(tc.y0, s);
    R.x1 = ceil_div(tc.x1, s);
    R.y1 = ceil_div(tc.y1, s);
    R.ppx = cp.ppx[r];
    R.ppy = cp.ppy[r];
    if (R.x1 > R.x0 && R.y1 > R.y0) {
      R.pw = static_cast<int>(ceil_div(R.x1, int64_t(1) << R.ppx) -
                              floor_div(R.x0, int64_t(1) << R.ppx));
      R.ph = static_cast<int>(ceil_div(R.y1, int64_t(1) << R.ppy) -
                              floor_div(R.y0, int64_t(1) << R.ppy));
    }
    int nb = r == 0 ? NL : NL - r + 1;
    for (int o = (r == 0 ? 0 : 1); o <= (r == 0 ? 0 : 3); ++o) {
      Band b;
      b.orient = o;
      int64_t xob = (o == 1 || o == 3) ? 1 : 0, yob = (o == 2 || o == 3);
      int64_t sb = int64_t(1) << nb, hb = r == 0 ? 0 : sb >> 1;
      b.x0 = ceil_div(tc.x0 - xob * hb, sb);
      b.x1 = ceil_div(tc.x1 - xob * hb, sb);
      b.y0 = ceil_div(tc.y0 - yob * hb, sb);
      b.y1 = ceil_div(tc.y1 - yob * hb, sb);
      int bi = r == 0 ? 0 : 3 * (r - 1) + o;
      int expn, mant;
      if (cp.qstyle == 1) {  // derived from the LL's step
        expn = std::max(0, cp.expn[0] - (r == 0 ? 0 : r - 1));
        mant = cp.mant[0];
      } else {
        expn = cp.expn[bi];
        mant = cp.mant[bi];
      }
      b.Mb = expn + cp.guard - 1;
      // OpenJPEG decodes the 9/7 with 2/K for the high bands and takes
      // their gain out of the step (its BUG_WEIRD_TWO_INVK)
      int gain = (decoding && cp.transform == 0) ? 0 : band_gain(o);
      b.stepsize = static_cast<float>((1.0 + mant / 2048.0) *
                                      std::pow(2.0, prec + gain - expn));
      int pbx = r == 0 ? R.ppx : R.ppx - 1, pby = r == 0 ? R.ppy : R.ppy - 1;
      b.cbx = std::min(cp.xcb, pbx);
      b.cby = std::min(cp.ycb, pby);
      R.bands.push_back(b);
    }
    R.precs.assign(static_cast<size_t>(R.pw) * R.ph, Precinct());
    int64_t px0 = R.pw ? floor_div(R.x0, int64_t(1) << R.ppx) : 0;
    int64_t py0 = R.ph ? floor_div(R.y0, int64_t(1) << R.ppy) : 0;
    for (int pj = 0; pj < R.ph; ++pj)
      for (int pi = 0; pi < R.pw; ++pi) {
        Precinct& P = R.precs[static_cast<size_t>(pj) * R.pw + pi];
        for (const Band& b : R.bands) {
          PrecBand pb;
          int pbx = r == 0 ? R.ppx : R.ppx - 1;
          int pby = r == 0 ? R.ppy : R.ppy - 1;
          int64_t rx0 = std::max(b.x0, (px0 + pi) << pbx);
          int64_t rx1 = std::min(b.x1, (px0 + pi + 1) << pbx);
          int64_t ry0 = std::max(b.y0, (py0 + pj) << pby);
          int64_t ry1 = std::min(b.y1, (py0 + pj + 1) << pby);
          if (rx1 > rx0 && ry1 > ry0) {
            int64_t cx0 = floor_div(rx0, int64_t(1) << b.cbx);
            int64_t cx1 = ceil_div(rx1, int64_t(1) << b.cbx);
            int64_t cy0 = floor_div(ry0, int64_t(1) << b.cby);
            int64_t cy1 = ceil_div(ry1, int64_t(1) << b.cby);
            pb.cw = static_cast<int>(cx1 - cx0);
            pb.ch = static_cast<int>(cy1 - cy0);
            for (int64_t cy = cy0; cy < cy1; ++cy)
              for (int64_t cx = cx0; cx < cx1; ++cx) {
                Codeblock cb;
                cb.x0 = static_cast<int>(std::max(rx0, cx << b.cbx));
                cb.x1 = static_cast<int>(std::min(rx1, (cx + 1) << b.cbx));
                cb.y0 = static_cast<int>(std::max(ry0, cy << b.cby));
                cb.y1 = static_cast<int>(std::min(ry1, (cy + 1) << b.cby));
                pb.cblks.push_back(cb);
              }
            pb.incl.build(pb.cw, pb.ch);
            pb.zbp.build(pb.cw, pb.ch);
          }
          P.bands.push_back(std::move(pb));
        }
      }
  }
}

// Where band b's sample (x, y) (band coordinates) lies in the
// tile-component's buffer: the subbands of resolution r sit beside the
// lower resolution's extent, as OpenJPEG lays them out.
void band_origin(const TileComp& tc, int r, const Band& b, int64_t* ox,
                 int64_t* oy) {
  *ox = -b.x0;
  *oy = -b.y0;
  if (r > 0) {
    const Resolution& L = tc.res[r - 1];
    if (b.orient == 1 || b.orient == 3) *ox += L.x1 - L.x0;
    if (b.orient == 2 || b.orient == 3) *oy += L.y1 - L.y0;
  }
}

// --------------------------------------------------------------- packets

struct PacketId {
  int layer, res, comp, prec;
};

// The packets of a tile in its progression order.  The position orders
// (RPCL, PCRL, CPRL) visit a precinct at its top-left corner on the
// reference grid, clamped to the tile's origin, as OpenJPEG's iterator does.
std::vector<PacketId> packet_order(const Tile& t) {
  std::vector<PacketId> out;
  int L = t.cod.layers, nc = static_cast<int>(t.comps.size());
  int maxr = 0;
  for (auto& tc : t.comps) maxr = std::max(maxr, tc.cp.levels + 1);
  struct Pos {
    int64_t y, x;
    int res, comp, prec;
  };
  std::vector<Pos> pos;
  for (int c = 0; c < nc; ++c) {
    const TileComp& tc = t.comps[c];
    int NL = tc.cp.levels;
    for (int r = 0; r <= NL; ++r) {
      const Resolution& R = tc.res[r];
      int lev = NL - r;
      int64_t px0 = R.pw ? floor_div(R.x0, int64_t(1) << R.ppx) : 0;
      int64_t py0 = R.ph ? floor_div(R.y0, int64_t(1) << R.ppy) : 0;
      for (int pj = 0; pj < R.ph; ++pj)
        for (int pi = 0; pi < R.pw; ++pi) {
          int64_t x = std::max(t.x0, (px0 + pi) << (R.ppx + lev));
          int64_t y = std::max(t.y0, (py0 + pj) << (R.ppy + lev));
          pos.push_back({y, x, r, c, pj * R.pw + pi});
        }
    }
  }
  auto emit_layers = [&](const Pos& p) {
    for (int l = 0; l < L; ++l) out.push_back({l, p.res, p.comp, p.prec});
  };
  switch (t.cod.prog) {
    case 0:  // LRCP
    case 1:  // RLCP
      for (int a = 0; a < (t.cod.prog == 0 ? L : maxr); ++a)
        for (int b = 0; b < (t.cod.prog == 0 ? maxr : L); ++b) {
          int l = t.cod.prog == 0 ? a : b, r = t.cod.prog == 0 ? b : a;
          for (int c = 0; c < nc; ++c) {
            const TileComp& tc = t.comps[c];
            if (r > tc.cp.levels) continue;
            const Resolution& R = tc.res[r];
            for (int p = 0; p < R.pw * R.ph; ++p) out.push_back({l, r, c, p});
          }
        }
      break;
    case 2:  // RPCL
      std::stable_sort(pos.begin(), pos.end(), [](const Pos& a, const Pos& b) {
        if (a.res != b.res) return a.res < b.res;
        if (a.y != b.y) return a.y < b.y;
        if (a.x != b.x) return a.x < b.x;
        return a.comp < b.comp;
      });
      for (auto& p : pos) emit_layers(p);
      break;
    case 3:  // PCRL
      std::stable_sort(pos.begin(), pos.end(), [](const Pos& a, const Pos& b) {
        if (a.y != b.y) return a.y < b.y;
        if (a.x != b.x) return a.x < b.x;
        if (a.comp != b.comp) return a.comp < b.comp;
        return a.res < b.res;
      });
      for (auto& p : pos) emit_layers(p);
      break;
    case 4:  // CPRL
      std::stable_sort(pos.begin(), pos.end(), [](const Pos& a, const Pos& b) {
        if (a.comp != b.comp) return a.comp < b.comp;
        if (a.y != b.y) return a.y < b.y;
        if (a.x != b.x) return a.x < b.x;
        return a.res < b.res;
      });
      for (auto& p : pos) emit_layers(p);
      break;
    default:
      fail("progression order " + std::to_string(t.cod.prog));
  }
  return out;
}

uint32_t read_npasses(BitReader& b) {
  if (!b.bit()) return 1;
  if (!b.bit()) return 2;
  uint32_t v = b.bits(2);
  if (v != 3) return 3 + v;
  v = b.bits(5);
  if (v != 31) return 6 + v;
  return 37 + b.bits(7);
}

void write_npasses(BitWriter& b, int n) {
  if (n == 1) b.put(0);
  else if (n == 2) b.bits(2, 2);
  else if (n <= 5) b.bits((3u << 2) | (n - 3), 4);
  else if (n <= 36) b.bits((15u << 5) | (n - 6), 9);
  else b.bits((511u << 7) | (n - 37), 16);
}

void read_packets(Tile& t) {
  std::vector<PacketId> order = packet_order(t);
  const uint8_t* p = t.bytes.data();
  const uint8_t* end = p + t.bytes.size();
  for (const PacketId& id : order) {
    if (p >= end) break;  // a truncated tile: the rest are empty
    TileComp& tc = t.comps[id.comp];
    Resolution& R = tc.res[id.res];
    Precinct& P = R.precs[id.prec];
    BitReader br{p, end};
    std::vector<std::pair<Codeblock*, uint32_t>> got;
    if (br.bit()) {
      for (size_t bi = 0; bi < P.bands.size(); ++bi) {
        PrecBand& pb = P.bands[bi];
        const Band& band = R.bands[bi];
        for (size_t k = 0; k < pb.cblks.size(); ++k) {
          Codeblock& cb = pb.cblks[k];
          bool inc;
          if (!cb.included)
            inc = pb.incl.decode(br, static_cast<int>(k), id.layer + 1);
          else
            inc = br.bit() != 0;
          if (!inc) continue;
          if (!cb.included) {
            int i = 0;
            while (!pb.zbp.decode(br, static_cast<int>(k), i)) ++i;
            cb.numbps = band.Mb + 1 - i;
            cb.included = true;
          }
          uint32_t n = read_npasses(br);
          while (br.bit()) ++cb.lblock;
          uint32_t len = br.bits(cb.lblock + floor_log2(n));
          cb.npasses += static_cast<int>(n);
          got.push_back({&cb, len});
        }
      }
    }
    br.align();
    p = br.p;
    for (auto& g : got) {
      uint32_t len = g.second;
      if (len > static_cast<uint64_t>(end - p)) len = static_cast<uint32_t>(end - p);
      g.first->segs.push_back({p, len});
      p += len;
    }
  }
}

// ------------------------------------------------------------- wavelets

void idwt53_1d(int32_t* w, int n, int cas) {
  if (n == 1) {
    if (cas) w[0] /= 2;
    return;
  }
  // even absolute positions (low) first, then odd (high); w interleaved
  int sn = cas ? n / 2 : (n + 1) / 2, dn = n - sn;
  auto L = [&](int i) -> int32_t& { return w[2 * i + cas]; };
  auto H = [&](int i) -> int32_t& { return w[2 * i + 1 - cas]; };
  auto Hc = [&](int i) { return H(std::min(std::max(i, 0), dn - 1)); };
  auto Lc = [&](int i) { return L(std::min(std::max(i, 0), sn - 1)); };
  if (!cas) {
    for (int i = 0; i < sn; ++i) L(i) -= (Hc(i - 1) + Hc(i) + 2) >> 2;
    for (int i = 0; i < dn; ++i) H(i) += (Lc(i) + Lc(i + 1)) >> 1;
  } else {
    for (int i = 0; i < sn; ++i) L(i) -= (Hc(i) + Hc(i + 1) + 2) >> 2;
    for (int i = 0; i < dn; ++i) H(i) += (Lc(i - 1) + Lc(i)) >> 1;
  }
}

void fdwt53_1d(int32_t* w, int n, int cas) {  // inverse of the above
  if (n == 1) {
    if (cas) w[0] *= 2;
    return;
  }
  int sn = cas ? n / 2 : (n + 1) / 2, dn = n - sn;
  auto L = [&](int i) -> int32_t& { return w[2 * i + cas]; };
  auto H = [&](int i) -> int32_t& { return w[2 * i + 1 - cas]; };
  auto Hc = [&](int i) { return H(std::min(std::max(i, 0), dn - 1)); };
  auto Lc = [&](int i) { return L(std::min(std::max(i, 0), sn - 1)); };
  if (!cas) {
    for (int i = 0; i < dn; ++i) H(i) -= (Lc(i) + Lc(i + 1)) >> 1;
    for (int i = 0; i < sn; ++i) L(i) += (Hc(i - 1) + Hc(i) + 2) >> 2;
  } else {
    for (int i = 0; i < dn; ++i) H(i) -= (Lc(i - 1) + Lc(i)) >> 1;
    for (int i = 0; i < sn; ++i) L(i) += (Hc(i) + Hc(i + 1) + 2) >> 2;
  }
}

const float kAlpha = -1.586134342f, kBeta = -0.052980118f,
            kGamma = 0.882911075f, kDelta = 0.443506852f, kK = 1.230174105f,
            kTwoInvK = 1.625732422f;

// OpenJPEG's opj_v8dwt_decode on one line: w interleaved, cas = parity of
// the first sample.
void idwt97_1d(float* w, int n, int cas) {
  int sn = cas ? n / 2 : (n + 1) / 2, dn = n - sn;
  int a = cas, b = 1 - cas;
  if (!cas) {
    if (!(dn > 0 || sn > 1)) return;
  } else {
    if (!(sn > 0 || dn > 1)) return;
  }
  for (int i = 0; i < sn; ++i) w[a + 2 * i] *= kK;
  for (int i = 0; i < dn; ++i) w[b + 2 * i] *= kTwoInvK;
  // step2(l, w, m, c): w[-1] += (l + w) * c along the line, the last one
  // doubled at a boundary
  auto step2 = [&](int lo, int wo, int cnt, int m, float c) {
    float* fw = w + wo;
    const float* fl = w + lo;
    int imax = std::min(cnt, m);
    for (int i = 0; i < imax; ++i) {
      fw[-1] += (fl[0] + fw[0]) * c;
      fl = fw;
      fw += 2;
    }
    if (m < cnt) fw[-1] += fl[0] * (c + c);
  };
  step2(b, a + 1, sn, std::min(sn, dn - a), -kDelta);
  step2(a, b + 1, dn, std::min(dn, sn - b), -kGamma);
  step2(b, a + 1, sn, std::min(sn, dn - a), -kBeta);
  step2(a, b + 1, dn, std::min(dn, sn - b), -kAlpha);
}

template <class T, class F>
void transform_2d(TileComp& tc, std::vector<T>& buf, bool inverse, F line) {
  int64_t stride = tc.w();
  int NL = tc.cp.levels;
  std::vector<T> tmp;
  auto level = [&](int r) {
    const Resolution& R = tc.res[r];
    int rw = static_cast<int>(R.x1 - R.x0), rh = static_cast<int>(R.y1 - R.y0);
    const Resolution& Lo = tc.res[r - 1];
    int snw = static_cast<int>(Lo.x1 - Lo.x0), snh = static_cast<int>(Lo.y1 - Lo.y0);
    int casx = static_cast<int>(R.x0 & 1), casy = static_cast<int>(R.y0 & 1);
    tmp.resize(std::max(rw, rh));
    auto rows = [&]() {
      for (int y = 0; y < rh; ++y) {
        T* row = buf.data() + y * stride;
        if (inverse) {
          for (int i = 0; i < snw; ++i) tmp[2 * i + casx] = row[i];
          for (int i = 0; i < rw - snw; ++i) tmp[2 * i + 1 - casx] = row[snw + i];
          line(tmp.data(), rw, casx);
          std::copy(tmp.begin(), tmp.begin() + rw, row);
        } else {
          std::copy(row, row + rw, tmp.begin());
          line(tmp.data(), rw, casx);
          for (int i = 0; i < snw; ++i) row[i] = tmp[2 * i + casx];
          for (int i = 0; i < rw - snw; ++i) row[snw + i] = tmp[2 * i + 1 - casx];
        }
      }
    };
    auto cols = [&]() {
      for (int x = 0; x < rw; ++x) {
        T* col = buf.data() + x;
        if (inverse) {
          for (int i = 0; i < snh; ++i) tmp[2 * i + casy] = col[i * stride];
          for (int i = 0; i < rh - snh; ++i)
            tmp[2 * i + 1 - casy] = col[(snh + i) * stride];
          line(tmp.data(), rh, casy);
          for (int i = 0; i < rh; ++i) col[i * stride] = tmp[i];
        } else {
          for (int i = 0; i < rh; ++i) tmp[i] = col[i * stride];
          line(tmp.data(), rh, casy);
          for (int i = 0; i < snh; ++i) col[i * stride] = tmp[2 * i + casy];
          for (int i = 0; i < rh - snh; ++i)
            col[(snh + i) * stride] = tmp[2 * i + 1 - casy];
        }
      }
    };
    if (rw == 0 || rh == 0) return;
    if (inverse) {
      rows();
      cols();
    } else {
      cols();
      rows();
    }
  };
  if (inverse)
    for (int r = 1; r <= NL; ++r) level(r);
  else
    for (int r = NL; r >= 1; --r) level(r);
}

// ------------------------------------------------------------ the decoder

struct Image {
  Siz siz;
  Coding cod;
  std::vector<CompParams> cps;
  std::vector<Tile> tiles;
  int ntx = 0, nty = 0;
};

struct Stream {
  const uint8_t* d;
  size_t n, pos = 0;
  void need(size_t k) const {
    if (pos + k > n) fail("the codestream ends early");
  }
  uint8_t u8() { need(1); return d[pos++]; }
  uint16_t u16() { need(2); uint16_t v = (d[pos] << 8) | d[pos + 1]; pos += 2; return v; }
  uint32_t u32() { uint32_t v = static_cast<uint32_t>(u16()) << 16; return v | u16(); }
};

const char* marker_name(int m) {
  switch (m) {
    case 0xFF5F: return "POC (progression order change)";
    case 0xFF60: return "PPM (packed packet headers)";
    case 0xFF61: return "PPT (packed packet headers)";
    case 0xFF5E: return "RGN (region of interest)";
    case 0xFF50: return "CAP (HTJ2K capabilities)";
    default: return nullptr;
  }
}

void read_cod_params(Stream& s, CompParams& cp, bool precincts) {
  cp.levels = s.u8();
  cp.xcb = (s.u8() & 0xF) + 2;
  cp.ycb = (s.u8() & 0xF) + 2;
  cp.style = s.u8();
  cp.transform = s.u8();
  if (cp.levels > 32) fail("more than 32 decomposition levels");
  if (cp.xcb + cp.ycb > 12 || cp.xcb > 10 || cp.ycb > 10)
    fail("a code-block larger than 4096 samples");
  if (cp.style & 0x40) fail("HTJ2K code-blocks (code-block style 0x40)");
  if (cp.style) {
    std::string names;
    const char* nm[6] = {"selective arithmetic coding bypass",
                         "reset of context probabilities",
                         "termination on each coding pass",
                         "vertically causal context",
                         "predictable termination", "segmentation symbols"};
    for (int b = 0; b < 6; ++b)
      if (cp.style & (1 << b)) names += (names.empty() ? "" : ", ") + std::string(nm[b]);
    fail("code-block style " + std::to_string(cp.style) + " (" + names + ")");
  }
  if (cp.transform > 1) fail("wavelet transform " + std::to_string(cp.transform));
  cp.precincts = precincts;
  for (int r = 0; r <= cp.levels; ++r) {
    if (precincts) {
      int v = s.u8();
      cp.ppx[r] = v & 0xF;
      cp.ppy[r] = v >> 4;
      if (r > 0 && (cp.ppx[r] == 0 || cp.ppy[r] == 0))
        fail("a precinct of one sample above the lowest resolution");
    } else {
      cp.ppx[r] = cp.ppy[r] = 15;
    }
  }
}

void read_qcd_params(Stream& s, size_t end, CompParams& cp) {
  int sq = s.u8();
  cp.qstyle = sq & 0x1F;
  cp.guard = sq >> 5;
  int k = 0;
  if (cp.qstyle == 0) {
    while (s.pos < end && k < 97) {
      cp.expn[k] = s.u8() >> 3;
      cp.mant[k] = 0;
      ++k;
    }
  } else if (cp.qstyle == 1 || cp.qstyle == 2) {
    while (s.pos + 1 < end && k < 97) {
      int v = s.u16();
      cp.expn[k] = v >> 11;
      cp.mant[k] = v & 0x7FF;
      ++k;
    }
  } else {
    fail("quantisation style " + std::to_string(cp.qstyle));
  }
}

// Reads a marker segment that may stand in the main header or in a first
// tile-part header; returns false when the marker is not one of them.
bool read_param_segment(Stream& s, int m, size_t end, Coding& cod,
                        std::vector<CompParams>& cps, int nc) {
  if (m == 0xFF52) {  // COD
    cod.scod = s.u8();
    cod.prog = s.u8();
    cod.layers = s.u16();
    cod.mct = s.u8();
    if (cod.layers == 0) fail("COD with 0 layers");
    if (cod.scod & 6) fail("SOP / EPH markers in the packets");
    CompParams cp;
    read_cod_params(s, cp, cod.scod & 1);
    for (auto& c : cps) {  // COD sets the coding style, not quantisation
      c.levels = cp.levels; c.xcb = cp.xcb; c.ycb = cp.ycb; c.style = cp.style;
      c.transform = cp.transform; c.precincts = cp.precincts;
      std::copy(cp.ppx, cp.ppx + 33, c.ppx);
      std::copy(cp.ppy, cp.ppy + 33, c.ppy);
    }
  } else if (m == 0xFF53) {  // COC
    int c = nc < 257 ? s.u8() : s.u16();
    if (c >= nc) fail("COC for a component that does not exist");
    int scoc = s.u8();
    CompParams cp;
    read_cod_params(s, cp, scoc & 1);
    CompParams& d = cps[c];
    d.levels = cp.levels; d.xcb = cp.xcb; d.ycb = cp.ycb; d.style = cp.style;
    d.transform = cp.transform; d.precincts = cp.precincts;
    std::copy(cp.ppx, cp.ppx + 33, d.ppx);
    std::copy(cp.ppy, cp.ppy + 33, d.ppy);
  } else if (m == 0xFF5C) {  // QCD
    CompParams q;
    read_qcd_params(s, end, q);
    for (auto& c : cps) {
      c.qstyle = q.qstyle; c.guard = q.guard;
      std::copy(q.expn, q.expn + 97, c.expn);
      std::copy(q.mant, q.mant + 97, c.mant);
    }
  } else if (m == 0xFF5D) {  // QCC
    int c = nc < 257 ? s.u8() : s.u16();
    if (c >= nc) fail("QCC for a component that does not exist");
    read_qcd_params(s, end, cps[c]);
  } else {
    return false;
  }
  return true;
}

void parse_codestream(const uint8_t* d, size_t n, Image& im) {
  Stream s{d, n};
  if (s.u16() != 0xFF4F) fail("no SOC marker");
  bool siz_seen = false, cod_seen = false, qcd_seen = false;
  // main header
  for (;;) {
    int m = s.u16();
    if (m == 0xFF90) break;
    if (m == 0xFFD9) fail("no tile in the codestream");
    size_t lm = s.u16();
    if (lm < 2) fail("a marker segment shorter than its length field");
    size_t end = s.pos + lm - 2;
    s.need(lm - 2);
    if (m == 0xFF51) {
      s.u16();  // Rsiz
      Siz& z = im.siz;
      z.xsiz = s.u32(); z.ysiz = s.u32(); z.xo = s.u32(); z.yo = s.u32();
      z.xt = s.u32(); z.yt = s.u32(); z.xto = s.u32(); z.yto = s.u32();
      z.nc = s.u16();
      if (z.nc < 1 || z.nc > 16384) fail("SIZ with no components");
      if (z.xsiz <= z.xo || z.ysiz <= z.yo || z.xt == 0 || z.yt == 0)
        fail("SIZ with an empty image");
      if (z.xto > z.xo || z.yto > z.yo || z.xto + z.xt <= z.xo ||
          z.yto + z.yt <= z.yo)
        fail("SIZ with the first tile outside the image");
      for (int c = 0; c < z.nc; ++c) {
        int ss = s.u8();
        int xr = s.u8(), yr = s.u8();
        z.prec.push_back((ss & 0x7F) + 1);
        z.sgnd.push_back(ss >> 7);
        if (xr != 1 || yr != 1)
          fail("component subsampling (XRsiz " + std::to_string(xr) +
               ", YRsiz " + std::to_string(yr) + ")");
      }
      im.cps.assign(z.nc, CompParams());
      siz_seen = true;
    } else if (!siz_seen) {
      fail("SIZ is not the first marker segment");
    } else if (read_param_segment(s, m, end, im.cod, im.cps, im.siz.nc)) {
      if (m == 0xFF52) cod_seen = true;
      if (m == 0xFF5C) qcd_seen = true;
    } else if (m == 0xFF55 || m == 0xFF57 || m == 0xFF63 || m == 0xFF64) {
      // TLM, PLM, CRG, COM: nothing to decode
    } else if (const char* nm = marker_name(m)) {
      fail(std::string("the ") + nm + " marker");
    } else {
      char buf[64];
      std::snprintf(buf, sizeof buf, "an unknown marker 0x%04X", m);
      fail(buf);
    }
    s.pos = end;
  }
  if (!cod_seen || !qcd_seen) fail("no COD or QCD marker");
  const Siz& z = im.siz;
  im.ntx = static_cast<int>(ceil_div(z.xsiz - z.xto, z.xt));
  im.nty = static_cast<int>(ceil_div(z.ysiz - z.yto, z.yt));
  if (static_cast<int64_t>(im.ntx) * im.nty > 65535) fail("more than 65535 tiles");
  im.tiles.resize(static_cast<size_t>(im.ntx) * im.nty);
  s.pos -= 2;
  // tile-parts
  while (s.pos + 2 <= n) {
    int m = s.u16();
    if (m == 0xFFD9) break;
    if (m != 0xFF90) fail("a tile-part does not start with SOT");
    size_t sot = s.pos - 2;
    s.u16();  // Lsot
    int isot = s.u16();
    uint32_t psot = s.u32();
    int tpsot = s.u8();
    s.u8();  // TNsot
    if (isot >= static_cast<int>(im.tiles.size())) fail("SOT for a tile that does not exist");
    size_t tp_end = psot ? sot + psot : n;
    if (tp_end > n) tp_end = n;  // a truncated file: read what is there
    Tile& t = im.tiles[isot];
    if (!t.seen) {
      t.seen = true;
      t.index = isot;
      t.cod = im.cod;
      t.cps = im.cps;
    }
    for (;;) {
      int mm = s.u16();
      if (mm == 0xFF93) break;
      size_t lm = s.u16();
      size_t end = s.pos + lm - 2;
      s.need(lm - 2);
      if (tpsot == 0 && read_param_segment(s, mm, end, t.cod, t.cps, z.nc)) {
      } else if (mm == 0xFF58 || mm == 0xFF64) {
        // PLT, COM
      } else if (const char* nm = marker_name(mm)) {
        fail(std::string("the ") + nm + " marker");
      } else {
        char buf[64];
        std::snprintf(buf, sizeof buf, "an unknown marker 0x%04X in a tile-part header", mm);
        fail(buf);
      }
      s.pos = end;
    }
    if (s.pos > tp_end) fail("a tile-part shorter than its header");
    t.bytes.insert(t.bytes.end(), d + s.pos, d + tp_end);
    s.pos = tp_end;
  }
}

struct Job {
  TileComp* tc;
  int r;
  const Band* band;
  Codeblock* cb;
};

template <class F>
void parallel_for(size_t n, int nthreads, F f) {
  int nt = std::max(1, std::min<int>(nthreads, static_cast<int>(n)));
  if (nt <= 1) {
    for (size_t i = 0; i < n; ++i) f(i);
    return;
  }
  std::atomic<size_t> next{0};
  std::vector<std::thread> pool;
  std::exception_ptr err;
  std::atomic<bool> failed{false};
  for (int k = 0; k < nt; ++k)
    pool.emplace_back([&]() {
      for (;;) {
        size_t i = next.fetch_add(1);
        if (i >= n || failed) return;
        try {
          f(i);
        } catch (...) {
          if (!failed.exchange(true)) err = std::current_exception();
        }
      }
    });
  for (auto& th : pool) th.join();
  if (err) std::rethrow_exception(err);
}

void decode_tile(Image& im, Tile& t, int32_t* out, int nthreads) {
  const Siz& z = im.siz;
  int p = t.index % im.ntx, q = t.index / im.ntx;
  t.x0 = std::max(z.xto + p * z.xt, z.xo);
  t.y0 = std::max(z.yto + q * z.yt, z.yo);
  t.x1 = std::min(z.xto + (p + 1) * z.xt, z.xsiz);
  t.y1 = std::min(z.yto + (q + 1) * z.yt, z.ysiz);
  int nc = z.nc;
  t.comps.assign(nc, TileComp());
  for (int c = 0; c < nc; ++c) {
    TileComp& tc = t.comps[c];
    tc.x0 = t.x0; tc.y0 = t.y0; tc.x1 = t.x1; tc.y1 = t.y1;
    tc.cp = t.cps[c];
    build_tilecomp(tc, z.prec[c], true);
  }
  if (t.cod.mct && nc < 3) fail("a component transform on fewer than 3 components");
  if (t.cod.mct)
    for (int c = 1; c < 3; ++c)
      if (t.comps[c].cp.transform != t.comps[0].cp.transform)
        fail("a component transform over components with different wavelets");
  read_packets(t);
  std::vector<Job> jobs;
  for (auto& tc : t.comps) {
    size_t area = static_cast<size_t>(tc.w()) * tc.h();
    if (tc.cp.transform == 1) tc.idata.assign(area, 0);
    else tc.fdata.assign(area, 0.f);
    for (int r = 0; r <= tc.cp.levels; ++r)
      for (auto& P : tc.res[r].precs)
        for (size_t bi = 0; bi < P.bands.size(); ++bi)
          for (auto& cb : P.bands[bi].cblks)
            if (cb.npasses > 0) jobs.push_back({&tc, r, &tc.res[r].bands[bi], &cb});
  }
  parallel_for(jobs.size(), nthreads, [&](size_t k) {
    thread_local T1 t1;
    const Job& j = jobs[k];
    Codeblock& cb = *j.cb;
    int w = cb.x1 - cb.x0, h = cb.y1 - cb.y0;
    if (cb.numbps <= 0 || cb.numbps >= 31) return;  // as OpenJPEG: nothing
    size_t total = 0;
    for (auto& sg : cb.segs) total += sg.len;
    std::vector<uint8_t> buf(total + 2);
    size_t o = 0;
    for (auto& sg : cb.segs) {
      std::memcpy(buf.data() + o, sg.p, sg.len);
      o += sg.len;
    }
    buf[total] = buf[total + 1] = 0xFF;
    int npasses = std::min(cb.npasses, 3 * cb.numbps - 2);
    t1.setup(w, h);
    t1_decode(t1, buf.data(), npasses, cb.numbps, j.band->orient);
    int64_t ox, oy;
    band_origin(*j.tc, j.r, *j.band, &ox, &oy);
    int64_t stride = j.tc->w();
    for (int y = 0; y < h; ++y) {
      const int32_t* src = t1.data.data() + static_cast<size_t>(y) * w;
      size_t row = static_cast<size_t>(cb.y0 + y + oy) * stride + cb.x0 + ox;
      if (j.tc->cp.transform == 1) {
        int32_t* dst = j.tc->idata.data() + row;
        for (int x = 0; x < w; ++x) dst[x] = src[x] / 2;
      } else {
        float* dst = j.tc->fdata.data() + row;
        const float step = 0.5f * j.band->stepsize;
        for (int x = 0; x < w; ++x) dst[x] = static_cast<float>(src[x]) * step;
      }
    }
  });
  parallel_for(t.comps.size(), nthreads, [&](size_t c) {
    TileComp& tc = t.comps[c];
    if (tc.cp.transform == 1)
      transform_2d(tc, tc.idata, true, idwt53_1d);
    else
      transform_2d(tc, tc.fdata, true, idwt97_1d);
  });
  size_t area = static_cast<size_t>(t.x1 - t.x0) * (t.y1 - t.y0);
  if (t.cod.mct) {
    if (t.comps[0].cp.transform == 1) {
      int32_t *c0 = t.comps[0].idata.data(), *c1 = t.comps[1].idata.data(),
              *c2 = t.comps[2].idata.data();
      for (size_t i = 0; i < area; ++i) {
        int32_t y = c0[i], u = c1[i], v = c2[i];
        int32_t g = y - ((u + v) >> 2);
        c0[i] = v + g;
        c1[i] = g;
        c2[i] = u + g;
      }
    } else {
      float *c0 = t.comps[0].fdata.data(), *c1 = t.comps[1].fdata.data(),
            *c2 = t.comps[2].fdata.data();
      for (size_t i = 0; i < area; ++i) {
        float y = c0[i], u = c1[i], v = c2[i];
        float r = y + (v * 1.402f);
        float g = y - (u * 0.34413f) - (v * 0.71414f);
        float b = y + (u * 1.772f);
        c0[i] = r;
        c1[i] = g;
        c2[i] = b;
      }
    }
  }
  int64_t W = z.xsiz - z.xo;
  for (int c = 0; c < nc; ++c) {
    TileComp& tc = t.comps[c];
    int prec = z.prec[c];
    int32_t shift = z.sgnd[c] ? 0 : 1 << (prec - 1);
    int32_t lo = z.sgnd[c] ? -(1 << (prec - 1)) : 0;
    int32_t hi = z.sgnd[c] ? (1 << (prec - 1)) - 1 : (1 << prec) - 1;
    for (int64_t y = 0; y < tc.h(); ++y) {
      int32_t* dst = out + ((tc.y0 - z.yo + y) * W + (tc.x0 - z.xo)) * nc + c;
      for (int64_t x = 0; x < tc.w(); ++x) {
        size_t i = static_cast<size_t>(y * tc.w() + x);
        int64_t v;
        if (tc.cp.transform == 1) {
          v = static_cast<int64_t>(tc.idata[i]) + shift;
        } else {
          float f = tc.fdata[i];
          if (f > static_cast<float>(INT32_MAX)) v = hi;
          else if (f < static_cast<float>(INT32_MIN)) v = lo;
          else v = static_cast<int64_t>(std::lrintf(f)) + shift;
        }
        dst[x * nc] = static_cast<int32_t>(std::min<int64_t>(std::max<int64_t>(v, lo), hi));
      }
    }
    tc.idata.clear();
    tc.idata.shrink_to_fit();
    tc.fdata.clear();
    tc.fdata.shrink_to_fit();
  }
  t.comps.clear();
  t.bytes.clear();
}

// ------------------------------------------------------------- JP2 boxes

struct Jp2Info {
  bool jp2 = false;
  int ihdr_nc = 0, ihdr_bpc = 0, enumcs = 0;
  const uint8_t* cs = nullptr;
  size_t cs_len = 0;
};

uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) | (uint32_t(p[2]) << 8) | p[3];
}

void read_boxes(const uint8_t* d, size_t n, Jp2Info& info, bool in_header) {
  size_t pos = 0;
  while (pos + 8 <= n) {
    uint64_t len = be32(d + pos);
    uint32_t type = be32(d + pos + 4);
    size_t hdr = 8;
    if (len == 1) {
      if (pos + 16 > n) fail("a JP2 box header cut short");
      len = (uint64_t(be32(d + pos + 8)) << 32) | be32(d + pos + 12);
      hdr = 16;
    } else if (len == 0) {
      len = n - pos;
    }
    if (len < hdr || pos + len > n) {
      if (type == 0x6A703263 && len >= hdr) len = n - pos;  // jp2c cut short
      else fail("a JP2 box longer than the file");
    }
    const uint8_t* b = d + pos + hdr;
    size_t bl = len - hdr;
    switch (type) {
      case 0x6A703268:  // jp2h
        read_boxes(b, bl, info, true);
        break;
      case 0x69686472:  // ihdr
        if (bl < 14) fail("a short ihdr box");
        info.ihdr_nc = (b[8] << 8) | b[9];
        info.ihdr_bpc = b[10];
        break;
      case 0x636F6C72:  // colr
        if (bl >= 7 && b[0] == 1 && !info.enumcs) info.enumcs = static_cast<int>(be32(b + 3));
        break;
      case 0x70636C72:  // pclr
        fail("a palette (pclr box)");
      case 0x636D6170:  // cmap
        fail("a component mapping (cmap box)");
      case 0x63646566: {  // cdef: only the identity (alpha last) is read
        if (bl < 2) fail("a short cdef box");
        int nd = (b[0] << 8) | b[1];
        for (int i = 0; i < nd && 2 + 6 * i + 6 <= static_cast<int>(bl); ++i) {
          const uint8_t* e = b + 2 + 6 * i;
          int cn = (e[0] << 8) | e[1], typ = (e[2] << 8) | e[3], asoc = (e[4] << 8) | e[5];
          bool ok = (typ == 0 && asoc == cn + 1) || (typ == 1 && asoc == 0) ||
                    (typ == 0 && asoc == 0);
          if (!ok) fail("channel definitions (cdef) that reorder the channels");
        }
        break;
      }
      case 0x6A703263:  // jp2c
        if (!in_header && !info.cs) {
          info.cs = b;
          info.cs_len = bl;
        }
        break;
      default:
        break;
    }
    pos += len;
  }
}

int decode_impl(const uint8_t* data, int64_t n, int32_t* out, int64_t cap,
                int32_t* info, int nthreads) {
  Jp2Info jp;
  const uint8_t* cs = data;
  size_t cs_len = static_cast<size_t>(n);
  static const uint8_t sig[12] = {0, 0, 0, 0x0C, 0x6A, 0x50, 0x20, 0x20, 0x0D, 0x0A, 0x87, 0x0A};
  if (n >= 12 && !std::memcmp(data, sig, 12)) {
    jp.jp2 = true;
    read_boxes(data, static_cast<size_t>(n), jp, false);
    if (!jp.cs) fail("a JP2 file without a codestream (jp2c box)");
    cs = jp.cs;
    cs_len = jp.cs_len;
  }
  Image im;
  parse_codestream(cs, cs_len, im);
  const Siz& z = im.siz;
  int64_t W = z.xsiz - z.xo, H = z.ysiz - z.yo;
  info[0] = static_cast<int32_t>(W);
  info[1] = static_cast<int32_t>(H);
  info[2] = z.nc;
  info[3] = jp.jp2;
  info[4] = jp.ihdr_nc;
  info[5] = jp.ihdr_bpc;
  info[6] = jp.enumcs;
  for (int c = 0; c < std::min(z.nc, 4); ++c) {
    info[7 + c] = z.prec[c];
    info[11 + c] = z.sgnd[c];
  }
  if (!out) return 0;
  if (W * H * z.nc > (int64_t(1) << 32)) fail("a plane of more than 2^32 samples");
  for (int c = 0; c < z.nc; ++c) {
    if (z.sgnd[c]) fail("signed components");
    if (z.prec[c] > 16) fail("components of more than 16 bits");
  }
  if (cap < W * H * z.nc * 4) fail("the output buffer is too small");
  std::memset(out, 0, static_cast<size_t>(W * H * z.nc) * 4);
  for (auto& t : im.tiles)
    if (t.seen) decode_tile(im, t, out, nthreads);
  return 0;
}

// ------------------------------------------------------------- the encoder

void put16(std::vector<uint8_t>& o, uint32_t v) {
  o.push_back(static_cast<uint8_t>(v >> 8));
  o.push_back(static_cast<uint8_t>(v));
}
void put32(std::vector<uint8_t>& o, uint32_t v) {
  put16(o, v >> 16);
  put16(o, v & 0xFFFF);
}
void put_box(std::vector<uint8_t>& o, const char* type, const std::vector<uint8_t>& body) {
  put32(o, static_cast<uint32_t>(body.size() + 8));
  o.insert(o.end(), type, type + 4);
  o.insert(o.end(), body.begin(), body.end());
}

std::vector<uint8_t> encode_impl(const uint8_t* img, int w, int h, int nc,
                                 int prec, int nthreads) {
  if (w < 1 || h < 1) fail("an empty plane");
  if (nc < 1 || nc > 4) fail("1-4 components are written");
  if (prec != 8 && prec != 16) fail("8- or 16-bit samples are written");
  int levels = 5;
  while (levels > 0 && std::min(w, h) < (1 << levels)) --levels;
  Tile t;
  t.x0 = 0; t.y0 = 0; t.x1 = w; t.y1 = h;
  t.cod.layers = 1;
  t.comps.assign(nc, TileComp());
  for (int c = 0; c < nc; ++c) {
    TileComp& tc = t.comps[c];
    tc.x0 = 0; tc.y0 = 0; tc.x1 = w; tc.y1 = h;
    CompParams& cp = tc.cp;
    cp.levels = levels;
    cp.xcb = cp.ycb = 6;
    cp.transform = 1;
    cp.qstyle = 0;
    cp.guard = 2;
    cp.expn[0] = prec;
    for (int r = 1; r <= levels; ++r) {
      cp.expn[3 * (r - 1) + 1] = prec + 1;
      cp.expn[3 * (r - 1) + 2] = prec + 1;
      cp.expn[3 * (r - 1) + 3] = prec + 2;
    }
    build_tilecomp(tc, prec, false);
    tc.idata.resize(static_cast<size_t>(w) * h);
    int32_t shift = 1 << (prec - 1);
    for (size_t i = 0; i < tc.idata.size(); ++i) {
      int32_t v = prec == 8 ? img[i * nc + c]
                            : reinterpret_cast<const uint16_t*>(img)[i * nc + c];
      tc.idata[i] = v - shift;
    }
    transform_2d(tc, tc.idata, false, fdwt53_1d);
  }
  std::vector<Job> jobs;
  for (auto& tc : t.comps)
    for (int r = 0; r <= tc.cp.levels; ++r)
      for (auto& P : tc.res[r].precs)
        for (size_t bi = 0; bi < P.bands.size(); ++bi)
          for (auto& cb : P.bands[bi].cblks)
            jobs.push_back({&tc, r, &tc.res[r].bands[bi], &cb});
  parallel_for(jobs.size(), nthreads, [&](size_t k) {
    thread_local T1 t1;
    const Job& j = jobs[k];
    Codeblock& cb = *j.cb;
    int cw = cb.x1 - cb.x0, ch = cb.y1 - cb.y0;
    std::vector<int32_t> coef(static_cast<size_t>(cw) * ch);
    int64_t ox, oy;
    band_origin(*j.tc, j.r, *j.band, &ox, &oy);
    int64_t stride = j.tc->w();
    for (int y = 0; y < ch; ++y)
      for (int x = 0; x < cw; ++x)
        coef[static_cast<size_t>(y) * cw + x] =
            j.tc->idata[static_cast<size_t>(cb.y0 + y + oy) * stride + cb.x0 + ox + x];
    t1.setup(cw, ch);
    cb.bytes = t1_encode(t1, coef.data(), j.band->orient, &cb.npasses, &cb.numbps);
    if (cb.numbps > j.band->Mb) fail("a coefficient past the band's bit depth");
  });
  // packets: one layer, LRCP
  std::vector<uint8_t> body;
  for (int r = 0; r <= levels; ++r)
    for (int c = 0; c < nc; ++c) {
      Resolution& R = t.comps[c].res[r];
      for (auto& P : R.precs) {
        BitWriter bw;
        bool any = false;
        for (auto& pb : P.bands)
          for (auto& cb : pb.cblks) any |= cb.npasses > 0;
        bw.put(any);
        if (any) {
          for (size_t bi = 0; bi < P.bands.size(); ++bi) {
            PrecBand& pb = P.bands[bi];
            const Band& band = R.bands[bi];
            for (size_t k = 0; k < pb.cblks.size(); ++k) {
              pb.incl.set(static_cast<int>(k), pb.cblks[k].npasses > 0 ? 0 : 1);
              pb.zbp.set(static_cast<int>(k), band.Mb - pb.cblks[k].numbps);
            }
            for (size_t k = 0; k < pb.cblks.size(); ++k) {
              Codeblock& cb = pb.cblks[k];
              pb.incl.encode(bw, static_cast<int>(k), 1);
              if (!cb.npasses) continue;
              pb.zbp.encode(bw, static_cast<int>(k), 999);
              write_npasses(bw, cb.npasses);
              uint32_t len = static_cast<uint32_t>(cb.bytes.size());
              int need = len ? floor_log2(len) + 1 : 1;
              int have = cb.lblock + floor_log2(static_cast<uint32_t>(cb.npasses));
              int inc = std::max(0, need - have);
              for (int i = 0; i < inc; ++i) bw.put(1);
              bw.put(0);
              cb.lblock += inc;
              bw.bits(len, cb.lblock + floor_log2(static_cast<uint32_t>(cb.npasses)));
            }
          }
        }
        std::vector<uint8_t> head = bw.finish();
        body.insert(body.end(), head.begin(), head.end());
        if (any)
          for (auto& pb : P.bands)
            for (auto& cb : pb.cblks)
              body.insert(body.end(), cb.bytes.begin(), cb.bytes.end());
      }
    }
  std::vector<uint8_t> cs;
  put16(cs, 0xFF4F);
  put16(cs, 0xFF51);  // SIZ
  put16(cs, 38 + 3 * nc);
  put16(cs, 0);
  put32(cs, w); put32(cs, h); put32(cs, 0); put32(cs, 0);
  put32(cs, w); put32(cs, h); put32(cs, 0); put32(cs, 0);
  put16(cs, nc);
  for (int c = 0; c < nc; ++c) {
    cs.push_back(static_cast<uint8_t>(prec - 1));
    cs.push_back(1);
    cs.push_back(1);
  }
  put16(cs, 0xFF52);  // COD
  put16(cs, 12);
  cs.push_back(0);     // Scod: no precincts, SOP or EPH
  cs.push_back(0);     // LRCP
  put16(cs, 1);        // one layer
  cs.push_back(0);     // no MCT
  cs.push_back(static_cast<uint8_t>(levels));
  cs.push_back(4);     // 64 x 64 code-blocks
  cs.push_back(4);
  cs.push_back(0);     // style 0
  cs.push_back(1);     // 5/3
  put16(cs, 0xFF5C);   // QCD: reversible, two guard bits
  put16(cs, 3 + 3 * levels + 1);
  cs.push_back(0x40);
  cs.push_back(static_cast<uint8_t>(prec << 3));
  for (int r = 1; r <= levels; ++r) {
    cs.push_back(static_cast<uint8_t>((prec + 1) << 3));
    cs.push_back(static_cast<uint8_t>((prec + 1) << 3));
    cs.push_back(static_cast<uint8_t>((prec + 2) << 3));
  }
  put16(cs, 0xFF90);   // SOT
  put16(cs, 10);
  put16(cs, 0);
  put32(cs, static_cast<uint32_t>(12 + 2 + body.size()));
  cs.push_back(0);
  cs.push_back(1);
  put16(cs, 0xFF93);   // SOD
  cs.insert(cs.end(), body.begin(), body.end());
  put16(cs, 0xFFD9);
  std::vector<uint8_t> o, b;
  static const uint8_t sig[12] = {0, 0, 0, 0x0C, 0x6A, 0x50, 0x20, 0x20, 0x0D, 0x0A, 0x87, 0x0A};
  o.insert(o.end(), sig, sig + 12);
  b = {'j', 'p', '2', ' ', 0, 0, 0, 0, 'j', 'p', '2', ' '};
  put_box(o, "ftyp", b);
  std::vector<uint8_t> hdr, ih;
  put32(ih, h); put32(ih, w); put16(ih, nc);
  ih.push_back(static_cast<uint8_t>(prec - 1));
  ih.push_back(7);  // C: wavelet
  ih.push_back(0);  // UnkC
  ih.push_back(0);  // IPR
  put_box(hdr, "ihdr", ih);
  std::vector<uint8_t> colr = {1, 0, 0};
  put32(colr, nc >= 3 ? 16 : 17);  // sRGB or greyscale
  put_box(hdr, "colr", colr);
  if (nc == 2 || nc == 4) {
    std::vector<uint8_t> cd;
    put16(cd, nc);
    for (int c = 0; c < nc; ++c) {
      bool alpha = c == nc - 1;
      put16(cd, c);
      put16(cd, alpha ? 1 : 0);
      put16(cd, alpha ? 0 : c + 1);
    }
    put_box(hdr, "cdef", cd);
  }
  put_box(o, "jp2h", hdr);
  put_box(o, "jp2c", cs);
  return o;
}

struct LutInit {
  LutInit() { init_luts(); }
} g_lut_init;

void set_err(char* err, int32_t cap, const char* msg) {
  if (err && cap > 0) {
    std::strncpy(err, msg, static_cast<size_t>(cap) - 1);
    err[cap - 1] = 0;
  }
}

}  // namespace

extern "C" {

int j2k_abi_version() { return 2; }

// Two calls: with out NULL, fills info (width, height, components, JP2 or
// not, ihdr's components and bpc, colr's enumerated colour space, then the
// first four components' precision and signedness); with out, decodes
// (height, width, components) int32 samples after the level shift.
// Returns 0, or -1 with the reason in err.
int32_t j2k_decode(const uint8_t* data, int64_t n, int32_t* out, int64_t cap,
                   int32_t* info, char* err, int32_t errcap, int32_t nthreads) {
  try {
    return decode_impl(data, n, out, cap, info, nthreads);
  } catch (const J2kError& e) {
    set_err(err, errcap, e.what());
  } catch (const std::bad_alloc&) {
    set_err(err, errcap, "out of memory");
  } catch (const std::exception& e) {
    set_err(err, errcap, e.what());
  }
  return -1;
}

// Encodes a (h, w, nc) plane of uint8 (prec 8) or uint16 (prec 16)
// samples as a JP2 file; returns its length, or -(the length) when cap is
// too small, or 0 with the reason in err.
int64_t j2k_encode(const uint8_t* img, int32_t w, int32_t h, int32_t nc,
                   int32_t prec, uint8_t* out, int64_t cap, char* err,
                   int32_t errcap, int32_t nthreads) {
  try {
    std::vector<uint8_t> o = encode_impl(img, w, h, nc, prec, nthreads);
    int64_t len = static_cast<int64_t>(o.size());
    if (len > cap) return -len;
    std::memcpy(out, o.data(), o.size());
    return len;
  } catch (const J2kError& e) {
    set_err(err, errcap, e.what());
  } catch (const std::bad_alloc&) {
    set_err(err, errcap, "out of memory");
  } catch (const std::exception& e) {
    set_err(err, errcap, e.what());
  }
  return 0;
}

}  // extern "C"
