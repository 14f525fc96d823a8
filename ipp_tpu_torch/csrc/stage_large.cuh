// The radix-2 stage (K3, K4, K4b, K6) above 12288 and the dense-axis DFT of
// K7 above 12288 as FFT kernels with a run-time plan.
//
// The function: the n-point complex DFT along axis 1 of (P, n, X) or along
// the last axis of (R, n) planes re, im.  The stage's forward stores the
// walk's permuted spectrum, X[f] at (f & 1) * n/2 + (f >> 1); its inverse
// loads that order and scales by 1/n; K4 first multiplies by the OTF, data
// row r by OTF row r % orows (conjugated on request).  K7's DFT (NATURAL)
// loads and stores natural order, last axis only.  Every value crosses
// device memory once each way at the bound, 5 n log2 n FLOPs a transform:
// bound by bytes.  The TPU kernels it replaces (pallas_fft.py
// `_v2_stage_call` :550, `_fused_stage_call` :252, `_fused_stage_otf_call`
// :301, `_fused_call` :66) multiply by dense (n/2)^2 matrices: O(n) FMAs a
// value, which the dense forms of fft_walk.cu repeat on CUDA cores at
// 385x the bound at n = 12416.  stage_mixed.cuh and dft_fft.cuh stop at
// 12288, where K7's two ping-pong rows fill the 227 KB of shared memory.
//
// Above it, one radix-2 step splits the transform into two of m = n/2,
// both with the butterfly at the first load:
//   forward  c0[i] = x[i] + x[i+m], c1[i] = (x[i] - x[i+m]) w^i,
//            X[2k + h] = DFT_m(c_h)[k]                 (frequency halves)
//   inverse  c_u[f] = (X[f] +- X[f+m]) w^-uf,
//            x[2t + u] = IDFT_m(c_u)[t] / n            (time halves)
// with w = exp(-2 pi i / n); the inverse splits the output by parity, so
// it too needs its two inputs at the first load and nothing at the store
// (X[f] and X[f+m] lie n/4 apart in the permuted order).  The two
// m-point transforms run on dft_fft.cuh's butterflies and generic odd pass
// and stage_mixed.cuh's in-place passes (`dit_pass`: decimation in time,
// digit-reversed first loads, one buffer).  Two forms, chosen by the plan
// (ops/dft_mats.stage_large_plan: by n and the layout alone):
//
//   Form A (last axis, n <= A_MAX_N = 24576): one row a block, both
//     halves of it in one (n) float2 buffer (at most 196 KB).  The first
//     pass runs its butterflies in source order, so a warp loads
//     consecutive addresses, and writes each group to its digit-reversed
//     place in shared memory (`dit_group`); the later passes run in place
//     over both halves; the last stores straight to device memory.  One
//     read and one write of the data: the bound's traffic.
//
//   Form B (the middle axis, and the last axis above 24576): the
//     four-step (Bailey) FFT of each half, m = m1 * m2, i = i1 m2 + i2,
//     k = k1 + m1 k2, m1 a power of two up to 512:
//       pass 1  the m1-point DFTs down the columns i2 (both halves of a
//               column in one block, the radix-2 butterfly at the load),
//               then the twiddle w_m^(k1 i2) and a store to scratch;
//       pass 2  the m2-point DFTs over i2 (stage_mixed.cuh's middle-axis
//               form on its own geometry) and the final store.
//     Scratch (a float2 per value, allocated by the wrapper) keeps the
//     input's layout on the middle axis, (p, h, k1, i2, x); on the last
//     axis it is transposed, (p, h, i2, k1), so that pass 2 again reads
//     columns that lie side by side: pass 1 then stores along k1, a
//     shared-memory sweep whose slots are swizzled (`slot1`) for lanes
//     along either index.  Two reads and two writes of the data (the
//     second pair mostly in the 50 MB L2 at the walk's shapes).
//     The middle axis needs it: a block of stage_mixed.cuh's middle form
//     holds COLS columns of the whole axis, one column (4-byte runs)
//     above 12288; here pass 1 holds 16 or more and pass 2 16 (m2 <= 1792).
//
// A column's arithmetic depends on n and the plan alone, never on its block
// or batch, so a batch gives the results of its single calls.

#pragma once

#include <cuda_runtime.h>

#include "stage_mixed.cuh"

namespace ipplarge {

using namespace ippsmix;

constexpr int A_MAX_N = 24576;    // ops/dft_mats.LARGE_A_MAX_N
constexpr int M1_MAX = 512;       // pass 1: a power of two, both halves

// -- plans ---------------------------------------------------------------------

// Pass 1 of Form B: m1 a power of two from 4 to M1_MAX, radices 4, 8 or 16
// first, then 2, 4, 8 or 16 (ops/dft_mats.stage_large_plan).
inline bool pass1_ok(const Plan& pl) {
  if (pl.npass < 1 || pl.npass > MAX_PASSES || pl.generic) return false;
  if (pl.n < 4 || pl.n > M1_MAX || (pl.n & (pl.n - 1))) return false;
  const int r0 = pl.radix[0];
  if (r0 != 4 && r0 != 8 && r0 != 16) return false;
  long long prod = 1;
  for (int p = 0; p < pl.npass; ++p) {
    const int r = pl.radix[p];
    if (r != 2 && r != 4 && r != 8 && r != 16) return false;
    prod *= r;
  }
  return prod == pl.n;
}

// A plan this kernel takes for an n-point transform: Form A when p2.npass is
// 0 (p1 the plan of m = n/2, K7's rule), else Form B (p1 of m1, p2 of m2).
inline bool large_plan_ok(int n, const Plan& p1, const Plan& p2,
                          bool last_axis) {
  if (n <= 0 || n % 64) return false;
  if (p2.npass == 0)
    return last_axis && n <= A_MAX_N && 2 * p1.n == n && plan_ok(p1) &&
           p1.n <= MAX_N;
  return pass1_ok(p1) && plan_ok(p2) && p2.n <= MAX_N &&
         2LL * p1.n * p2.n == n;
}

// The group g of the in-place first pass whose inputs are s + k n / R0:
// the inverse of stage_mixed.cuh's `dit_source` (s < n / R0).
__host__ __device__ inline int dit_group(const Plan& pl, int s) {
  int g = 0, w = 1, rest = pl.n / pl.radix[0];
  for (int p = 1; p < pl.npass; ++p) {
    rest /= pl.radix[p];
    const int d = s / rest;
    s -= d * rest;
    g += d * w;
    w *= pl.radix[p];
  }
  return g;
}

// -- geometry -------------------------------------------------------------------

// Form A: T threads a row: 256 where two rows' buffers fit on an SM (~110
// registers a thread allow two blocks of 256, not of 512), else 512, so
// that one block alone hides the loads' latency (the forward on an H100,
// scripts/stage_large_bench.py --sweep: 0.189 against 0.204 ms at (512,
// 12416), 0.497 against 0.425 at (1024, 24576)); `tpr` > 0 overrides it.
struct GeoA {
  int T, smem;
};

inline GeoA geometry_a(const Plan& p1, int tpr) {
  GeoA g;
  g.smem = 2 * p1.n * (int)sizeof(float2);
  g.T = tpr > 0 ? tpr : 2 * g.smem <= SMEM_LIMIT - 4096 ? 256 : MAX_THREADS;
  if (g.T > MAX_THREADS) g.T = 0;
  return g;
}

// Form A's slot of element e of half h: two halves of m slots, e's low four
// bits XOR-ed with all of e >> sh folded into four bits, and half 1's bit 3
// flipped (a paired last pass reads element e of both halves in
// neighbouring lanes: 8 banks apart).
__host__ __device__ inline int slot_a(int h, int e, int m, int sh) {
  const int g = e >> sh;
  return h * m + (e ^ ((g ^ (g >> 4) ^ (g >> 8) ^ (g >> 12)) & 15) ^ (h << 3));
}

// Pass 1: T1 threads a column (K7's n / 8, n / 16 from 512 on) and COLS1
// columns, a multiple of 16, for ~256 threads a block; `tpr`, `cols` > 0
// override them (cols rounded down to a multiple of 16).
struct Geo1 {
  int T, cols, s, smem;   // s: the swizzle's shift (`slot1`)
};

inline Geo1 geometry_1(const Plan& p1, int tpr, int cols) {
  Geo1 g;
  const int m1 = p1.n;
  g.T = tpr > 0 ? tpr : m1 >= 512 ? m1 / 16 : m1 / 8;
  if (g.T < 1) g.T = 1;
  g.cols = cols > 0 ? cols / 16 * 16 : 256 / g.T / 16 * 16;
  if (g.cols < 16) g.cols = 16;
  while (g.cols > 16 && (g.T * g.cols > MAX_THREADS ||
                         2 * m1 * g.cols * (int)sizeof(float2) > SMEM_LIMIT))
    g.cols -= 16;
  g.s = m1 >= 16 ? 0 : m1 == 8 ? 1 : 2;
  g.smem = 2 * m1 * g.cols * (int)sizeof(float2) +
           g.cols * (int)(sizeof(i64) + sizeof(int));
  if (g.T * g.cols > MAX_THREADS || g.cols % 16) g.T = 0;
  return g;
}

// Pass 1's slot of element e of half h in column c: columns side by side,
// c XOR-ed with (e << s) & 15 so that 16 lanes along c (the passes) and 16
// lanes along e (the transposing sweep; along e and c when m1 < 16) both
// meet 16 banks.
__host__ __device__ inline int slot1(int h, int e, int c, int m1, int cols,
                                     int s) {
  return (h * m1 + e) * cols + (c ^ ((e << s) & 15));
}

// -- the first pass of a pair of halves -------------------------------------------

// The first in-place pass (radix R, no twiddle) of both halves at once:
// load2(i, c0, c1) gives input i of half 0 and of half 1 (both from the
// same two device-memory values: the radix-2 butterfly), put(h, e, v)
// takes element e of half h's buffer.  SRC: butterflies run in source
// order (consecutive threads read consecutive inputs) and find their group
// by `dit_group`; else in group order, inputs at `dit_source`.  Each
// thread issues the 2R device-memory loads of a butterfly before any of
// its arithmetic.
template <int R, bool INV, bool SRC, class Load2, class Put>
__device__ __forceinline__ void first_pair(const Plan& pl, int j, int T,
                                           Load2 load2, Put put) {
  const int nb = pl.n / R;
  for (int it = j; it < nb; it += T) {
    const int g = SRC ? dit_group(pl, it) : it;
    const int s = SRC ? it : dit_source(pl, it);
    float2 a[R], b[R];
    load2.template fetch<R>(s, nb, a, b);
    dft<R, INV>(a);
    dft<R, INV>(b);
#pragma unroll
    for (int k = 0; k < R; ++k) {
      put(0, g * R + k, a[k]);
      put(1, g * R + k, b[k]);
    }
  }
}

template <bool INV, bool SRC, class Load2, class Put>
__device__ __forceinline__ void first_pair_any(const Plan& pl, int j, int T,
                                               Load2 load2, Put put) {
  switch (pl.radix[0]) {
    case 4: first_pair<4, INV, SRC>(pl, j, T, load2, put); break;
    case 8: first_pair<8, INV, SRC>(pl, j, T, load2, put); break;
    case 16: first_pair<16, INV, SRC>(pl, j, T, load2, put); break;
  }
}

// -- the generic pass, blocked -------------------------------------------------------

constexpr int GENERIC_KB = 8;   // outputs k a work item of `generic_blocked`

// dft_fft.cuh's generic last pass of odd radix r (stride S = n / r), with
// KB values of k a work item: item (kb, q) computes outputs k and r - k
// for k = kb KB ... kb KB + KB - 1 (up to r / 2), reading each input pair
// once for all of them and keeping KB independent sums in flight; items
// run with q fastest.  Each output's arithmetic is `generic_pass`'s, in the
// same order.  At r = 97 one output a work item read 48 shared-memory
// values an output: K6 at (512, 12416) took 0.370 ms on an H100, 0.18
// with KB = 8 (scripts/stage_large_bench.py), against 0.097 ms at (512,
// 13312) with no generic pass.
template <bool INV, int KB, class Src, class Dst>
__device__ __forceinline__ void generic_blocked(
    int j, int T, int r, int S, const float2* __restrict__ tw, Src src,
    Dst dst) {
  const int h = r / 2;
  const int items = (h + KB) / KB * S;   // k = 0 ... h in blocks of KB
  for (int o = j; o < items; o += T) {
    const int kb = o / S, q = o - kb * S;
    const float2 x0 = src(q);
    float2 a[KB], b[KB];
    int e[KB], kk[KB];
#pragma unroll
    for (int t = 0; t < KB; ++t) {
      a[t] = x0;
      b[t] = make_float2(0.f, 0.f);
      const int k = kb * KB + t;
      kk[t] = k < h ? k : h;   // past h: a copy of k = h, not stored
      e[t] = 0;                      // (jj * k) % r
    }
    for (int jj = 1; jj <= h; ++jj) {
      const float2 x1 = src(q + jj * S), x2 = src(q + (r - jj) * S);
      const float2 sp = cadd(x1, x2), sm = csub(x1, x2);
#pragma unroll
      for (int t = 0; t < KB; ++t) {
        e[t] += kk[t];
        if (e[t] >= r) e[t] -= r;
        const float2 w = __ldg(&tw[e[t] * S]);   // (cos, -sin) of 2 pi e / r
        a[t].x = fmaf(sp.x, w.x, a[t].x);
        a[t].y = fmaf(sp.y, w.x, a[t].y);
        b[t].x = fmaf(sm.x, -w.y, b[t].x);
        b[t].y = fmaf(sm.y, -w.y, b[t].y);
      }
    }
#pragma unroll
    for (int t = 0; t < KB; ++t) {
      const int k = kb * KB + t;
      if (k > h) break;
      const float2 lo = make_float2(a[t].x + b[t].y, a[t].y - b[t].x);
      const float2 hi = make_float2(a[t].x - b[t].y, a[t].y + b[t].x);
      dst(q + S * k, INV ? hi : lo);
      if (k != 0) dst(q + S * (r - k), INV ? lo : hi);
    }
  }
}

// -- device-memory maps -------------------------------------------------------------

// The butterfly at the first load.  Element i (< m) of the two halves of
// the column at `base` (stride `ld` along the axis): forward from x[i] and
// x[i + m]; the inverse from X[f] and X[f + m], f = i, at their permuted
// places (or natural with NATURAL), each times its OTF value first
// (INV_OTF: OTF row at `obase`, conjugated when osign < 0).
template <int MODE, bool NATURAL>
struct Load2 {
  const float* __restrict__ xr;
  const float* __restrict__ xi;
  const float* __restrict__ otr;
  const float* __restrict__ oti;
  const float2* __restrict__ twn;   // exp(-2 pi i j / n), j < n
  i64 base, ld, obase;
  int m, stride;   // input i of a butterfly's k-th value: (s + k nb) * stride + off
  int off;
  float osign;
  bool ok;

  __device__ __forceinline__ void at(int i, int& p0, int& p1) const {
    if (MODE == FWD || NATURAL) {
      p0 = i;
      p1 = i + m;
    } else {
      p0 = permuted(i, 2 * m);
      p1 = p0 + m / 2;
    }
  }
  template <int R>
  __device__ __forceinline__ void fetch(int s, int nb, float2 (&a)[R],
                                        float2 (&b)[R]) const {
    if (!ok) {
#pragma unroll
      for (int k = 0; k < R; ++k) a[k] = b[k] = make_float2(0.f, 0.f);
      return;
    }
    float2 y0[R], y1[R];
#pragma unroll
    for (int k = 0; k < R; ++k) {   // the loads first, all of them
      int p0, p1;
      at((s + k * nb) * stride + off, p0, p1);
      y0[k] = make_float2(xr[base + p0 * ld], xi[base + p0 * ld]);
      y1[k] = make_float2(xr[base + p1 * ld], xi[base + p1 * ld]);
    }
    if (MODE == INV_OTF) {
      float2 o0[R], o1[R];
#pragma unroll
      for (int k = 0; k < R; ++k) {
        int p0, p1;
        at((s + k * nb) * stride + off, p0, p1);
        o0[k] = make_float2(__ldg(&otr[obase + p0]),
                            osign * __ldg(&oti[obase + p0]));
        o1[k] = make_float2(__ldg(&otr[obase + p1]),
                            osign * __ldg(&oti[obase + p1]));
      }
#pragma unroll
      for (int k = 0; k < R; ++k) {
        y0[k] = cmul(y0[k], o0[k]);
        y1[k] = cmul(y1[k], o1[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const int i = (s + k * nb) * stride + off;
      float2 w = __ldg(&twn[i]);
      if (MODE != FWD) w.y = -w.y;
      a[k] = cadd(y0[k], y1[k]);
      b[k] = cmul(csub(y0[k], y1[k]), w);
    }
  }
};

// Position along the axis of output k of half h: the permuted spectrum of
// the stage's forward (h m + k), else natural order (2 k + h).
template <int MODE, bool NATURAL>
__device__ __forceinline__ int out_pos(int h, int k, int m) {
  return MODE == FWD && !NATURAL ? h * m + k : 2 * k + h;
}

#ifdef __CUDACC__

// The in-place passes after the first, H halves each, one barrier after
// every pass but the last; the last takes store(h, e, v) (device memory,
// or the buffer itself when the plan has no generic pass).  PAIR (H = 2):
// the last pass runs both halves at once, thread j on half j & 1, so that
// neighbouring lanes store outputs e of both halves side by side (the
// natural order's 2 e + h: a warp's stores one run instead of two strided
// ones; K6 at (4096, 12544) 0.768 -> 0.678 ms on an H100, scripts/
// stage_large_bench.py).  `tw` is the n-point table of this plan's
// length.  Every thread of the block calls it.
template <bool INV, int H, bool PAIR = false, class Get, class Put,
          class Store>
__device__ __forceinline__ void rest_passes(const Plan& pl, int j, int T,
                                            const float2* __restrict__ tw,
                                            Get get, Put put, Store store) {
  const int n = pl.n, last = pl.npass - 1;
  if (last == 0) return;
  int Lp = pl.radix[0];
  for (int p = 1; p < last; ++p) {
    const int gnext = p + 1 == last && pl.generic ? pl.radix[last] : 0;
#pragma unroll
    for (int h = 0; h < H; ++h)
      dit_any<INV>(pl.radix[p], j, T, n, Lp, gnext, tw,
                   [&](int e) { return get(h, e); },
                   [&](int e, float2 v) { put(h, e, v); });
    Lp *= pl.radix[p];
    __syncthreads();
  }
  constexpr int HL = PAIR ? 1 : H;   // halves a thread runs in the last pass
  const int jl = PAIR ? j >> 1 : j, TL = PAIR ? T >> 1 : T;
#pragma unroll
  for (int hl = 0; hl < HL; ++hl) {
    const int h = PAIR ? j & 1 : hl;
    auto g = [&](int e) { return get(h, e); };
    auto s = [&](int e, float2 v) { store(h, e, v); };
    if (pl.generic)
      generic_blocked<INV, GENERIC_KB>(jl, TL, pl.radix[last], Lp, tw, g, s);
    else
      dit_any<INV>(pl.radix[last], jl, TL, n, Lp, 0, tw, g, s);
  }
}

// -- Form A ------------------------------------------------------------------------

// One row of (rows, n) a block; p1 is the plan of m = n / 2; twm the m-point
// table, twn the n-point one.
template <int MODE, bool NATURAL>
__global__ void __launch_bounds__(MAX_THREADS)
large_a(const float* __restrict__ xr, const float* __restrict__ xi,
        const float* __restrict__ otr, const float* __restrict__ oti,
        const float2* __restrict__ twn, const float2* __restrict__ twm,
        float* __restrict__ rr, float* __restrict__ ii, Plan p1, int orows,
        float osign, float scale) {
  extern __shared__ float2 smem[];
  constexpr bool INVERSE = MODE != FWD;
  const int m = p1.n, n = 2 * m, T = blockDim.x, j = threadIdx.x;
  const int sh = p1.radix[0] == 16 ? 4 : 3;
  const i64 row = blockIdx.x, base = row * n;
  // rows < 2^31 (`launch_large`): a 32-bit modulo
  const i64 obase =
      MODE == INV_OTF ? (i64)((unsigned)row % (unsigned)orows) * n : 0;
  const Load2<MODE, NATURAL> load2{xr, xi, otr, oti, twn, base, 1, obase,
                                   m, 1, 0, osign, true};
  auto put = [&](int h, int e, float2 v) { smem[slot_a(h, e, m, sh)] = v; };
  auto get = [&](int h, int e) { return smem[slot_a(h, e, m, sh)]; };
  auto store = [&](int h, int e, float2 v) {
    const i64 a = base + out_pos<MODE, NATURAL>(h, e, m);
    rr[a] = INVERSE ? v.x * scale : v.x;
    ii[a] = INVERSE ? v.y * scale : v.y;
  };
  first_pair_any<INVERSE, true>(p1, j, T, load2, put);
  __syncthreads();
  rest_passes<INVERSE, 2, INVERSE || NATURAL>(p1, j, T, twm, get, put, store);
}

// -- Form B ------------------------------------------------------------------------

// Pass 1: columns col = (p m2 + i2) X + x, COLS1 a block; element i1 of
// half h at (p n + h m + i1 m2 + i2) X + x (the butterfly's two inputs).
// Scratch: (p n + h m + k1 sk + i2 se) X + x with (sk, se) = (m2, 1), or
// (1, m1) on the last axis (X = 1, `last`).
template <int MODE, bool NATURAL>
__global__ void __launch_bounds__(MAX_THREADS)
large_b1(const float* __restrict__ xr, const float* __restrict__ xi,
         const float* __restrict__ otr, const float* __restrict__ oti,
         const float2* __restrict__ twn, const float2* __restrict__ tw1,
         float2* __restrict__ scratch, i64 ncols, Plan p1, int m2, int X,
         int last, int T, int cols, int s, int orows, float osign) {
  extern __shared__ float2 smem[];
  constexpr bool INVERSE = MODE != FWD;
  const int m1 = p1.n, m = m1 * m2, n = 2 * m;
  float2* buf = smem;
  i64* colbase = (i64*)(smem + 2 * m1 * cols);
  int* coli2 = (int*)(colbase + cols);

  const int c = threadIdx.x % cols, j = threadIdx.x / cols;
  const i64 col = (i64)blockIdx.x * cols + c;
  const bool ok = col < ncols;
  const i64 t = ok ? col / X : 0;
  const int x = ok ? (int)(col - t * X) : 0;
  const int i2 = (int)(t % m2);
  const i64 p = t / m2;
  const i64 base = p * n * X + x;
  if (j == 0) {   // this column's scratch base and i2, for the sweep
    colbase[c] = base + (last ? (i64)i2 * m1 : (i64)i2 * X);
    coli2[c] = ok ? i2 : -1;
  }
  // ncols / m2 < 2^31 rows on the last axis (`launch_large`)
  const i64 obase =
      MODE == INV_OTF && ok ? (i64)((unsigned)p % (unsigned)orows) * n : 0;
  const Load2<MODE, NATURAL> load2{xr, xi, otr, oti, twn, base, X, obase,
                                   m, m2, i2, osign, ok};
  auto put = [&](int h, int e, float2 v) {
    buf[slot1(h, e, c, m1, cols, s)] = v;
  };
  auto get = [&](int h, int e) { return buf[slot1(h, e, c, m1, cols, s)]; };
  first_pair_any<INVERSE, false>(p1, j, T, load2, put);
  __syncthreads();
  rest_passes<INVERSE, 2>(p1, j, T, tw1, get, put, put);
  __syncthreads();

  // the sweep: every (h, k1, column) of the block, times w_m^(k1 i2), to
  // scratch; lanes along k1 on the last axis (scratch runs along k1 there),
  // along the columns elsewhere
  const i64 hs = (i64)m * X, ks = last ? 1 : (i64)m2 * X;
  const int total = 2 * m1 * cols;
  for (int w = threadIdx.x; w < total; w += blockDim.x) {
    int h, k1, cc;
    if (last) {
      k1 = w % m1;
      cc = (w / m1) % cols;
    } else {
      cc = w % cols;
      k1 = (w / cols) % m1;
    }
    h = w / (m1 * cols);
    const int ci2 = coli2[cc];
    if (ci2 < 0) continue;
    float2 tw = __ldg(&twn[2 * k1 * ci2]);
    if (INVERSE) tw.y = -tw.y;
    scratch[colbase[cc] + h * hs + k1 * ks] =
        cmul(buf[slot1(h, k1, cc, m1, cols, s)], tw);
  }
}

// Pass 2: columns col = ((p 2 + h) m1 + k1) X + x, the middle form's
// geometry (col_geometry of p2: T, cols, G, sh); element i2 of a column in
// scratch, output k = k1 + m1 k2 of half h to out_pos(h, k) along the axis.
template <int MODE, bool NATURAL>
__global__ void __launch_bounds__(MAX_THREADS)
large_b2(const float2* __restrict__ scratch, const float2* __restrict__ tw2,
         float* __restrict__ rr, float* __restrict__ ii, i64 ncols, Plan p2,
         int m1, int X, int last, int T, int cols, int G, int sh,
         float scale) {
  extern __shared__ float2 smem[];
  constexpr bool INVERSE = MODE != FWD;
  const int m2 = p2.n, m = m1 * m2, n = 2 * m;
  const int c = threadIdx.x % cols, j = threadIdx.x / cols;
  const i64 col = (i64)blockIdx.x * cols + c;
  const bool ok = col < ncols;
  const i64 t = ok ? col / X : 0;
  const int x = ok ? (int)(col - t * X) : 0;
  const int k1 = (int)(t % m1);
  const i64 q = t / m1;   // p 2 + h
  const int h = (int)(q & 1);
  const i64 p = q >> 1;
  const i64 sbase = p * n * X + (i64)h * m * X + x +
                    (last ? (i64)k1 : (i64)k1 * m2 * X);
  const i64 se = last ? m1 : X;
  const i64 obase = p * n * X + x;
  float2* buf = smem + c;

  auto load = [=](int e) -> float2 {
    if (!ok) return make_float2(0.f, 0.f);
    return scratch[sbase + e * se];
  };
  auto get = [=](int, int e) { return buf[col_slot(e, G, sh) * cols]; };
  auto put = [=](int, int e, float2 v) { buf[col_slot(e, G, sh) * cols] = v; };
  auto store = [=](int, int e, float2 v) {
    if (!ok) return;
    const i64 a = obase + (i64)out_pos<MODE, NATURAL>(h, k1 + m1 * e, m) * X;
    rr[a] = INVERSE ? v.x * scale : v.x;
    ii[a] = INVERSE ? v.y * scale : v.y;
  };
  if (p2.npass == 1) {   // one pass: its output is the natural order
    dit_first_any<INVERSE>(p2.radix[0], p2, j, T, load,
                           [&](int e, float2 v) { store(0, e, v); });
    return;
  }
  // a plan (R0, r) with r generic: the first pass applies r's twiddles
  dit_first_any<INVERSE>(p2.radix[0], p2, j, T, load,
                         [&](int e, float2 v) { put(0, e, v); },
                         p2.npass == 2 && p2.generic ? p2.radix[1] : 0, tw2);
  __syncthreads();
  rest_passes<INVERSE, 1>(p2, j, T, tw2, get, put, store);
}

// -- launch ------------------------------------------------------------------------

template <class K>
inline cudaError_t allow_smem(K kernel, int smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  // per device, so set on every launch: it costs no device time
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem);
}

// batch planes of (batch, n, ncols), or ncols rows of (ncols, n) with
// `last` (batch 1).  tw1: the table of p1.n points (Form A: m), tw2 of
// p2.n; scratch: n * batch * ncols float2 (Form B), else unused.  tpr1,
// cols1, tpr2, cols2 <= 0 keep the kernel's own geometry (Form A reads
// tpr2 as its threads a row); a bench passes others.
template <int MODE, bool NATURAL>
inline cudaError_t launch_large(const float* xr, const float* xi,
                                const float* otr, const float* oti,
                                const float2* twn, const float2* tw1,
                                const float2* tw2, float2* scratch, float* rr,
                                float* ii, bool last, int batch, i64 ncols,
                                int n, const Plan& p1, const Plan& p2,
                                int orows, float osign, int tpr1, int cols1,
                                int tpr2, int cols2, cudaStream_t st) {
  if (!large_plan_ok(n, p1, p2, last) || ncols < 1 || batch < 1 ||
      (last && batch != 1) || (MODE == INV_OTF && (orows < 1 || !last)) ||
      (NATURAL && !last))
    return cudaErrorInvalidValue;
  const float scale = 1.f / (float)n;
  const i64 P = last ? ncols : batch, X = last ? 1 : ncols;
  if (P > 2147483647LL || X > 2147483647LL) return cudaErrorInvalidValue;
  if (p2.npass == 0) {   // Form A
    const GeoA g = geometry_a(p1, tpr2);
    if (g.T < 1 || g.smem > SMEM_LIMIT) return cudaErrorInvalidValue;
    auto kernel = large_a<MODE, NATURAL>;
    cudaError_t e = allow_smem(kernel, g.smem);
    if (e != cudaSuccess) return e;
    kernel<<<(unsigned)P, g.T, g.smem, st>>>(xr, xi, otr, oti, twn, tw1, rr,
                                             ii, p1, orows, osign, scale);
    return cudaGetLastError();
  }
  if (scratch == nullptr) return cudaErrorInvalidValue;
  const int m1 = p1.n, m2 = p2.n;
  const Geo1 g1 = geometry_1(p1, tpr1, cols1);
  const ColGeo g2 = col_geometry(p2, tpr2, cols2);
  if (g1.T < 1 || g1.smem > SMEM_LIMIT || g2.T < 1 ||
      g2.smem > SMEM_LIMIT || g2.T * g2.cols > MAX_THREADS)
    return cudaErrorInvalidValue;
  const i64 n1 = P * m2 * X, n2 = P * 2 * m1 * X;
  const i64 b1 = (n1 + g1.cols - 1) / g1.cols, b2 = (n2 + g2.cols - 1) / g2.cols;
  if (b1 > 2147483647LL || b2 > 2147483647LL) return cudaErrorInvalidValue;
  auto k1 = large_b1<MODE, NATURAL>;
  auto k2 = large_b2<MODE, NATURAL>;
  cudaError_t e = allow_smem(k1, g1.smem);
  if (e == cudaSuccess) e = allow_smem(k2, g2.smem);
  if (e != cudaSuccess) return e;
  k1<<<(unsigned)b1, g1.T * g1.cols, g1.smem, st>>>(
      xr, xi, otr, oti, twn, tw1, scratch, n1, p1, m2, (int)X, (int)last,
      g1.T, g1.cols, g1.s, orows, osign);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  k2<<<(unsigned)b2, g2.T * g2.cols, g2.smem, st>>>(
      scratch, tw2, rr, ii, n2, p2, m1, (int)X, (int)last, g2.T, g2.cols,
      g2.G, g2.sh, scale);
  return cudaGetLastError();
}

// The launches by mode, each compiled in a source of its own so that nvcc
// builds them side by side (stage_large_fwd.cu, stage_large_inv.cu,
// stage_large_otf.cu); arguments as `launch_large`.
#define IPP_LARGE_LAUNCH_ARGS                                                \
  const float *xr, const float *xi, const float *otr, const float *oti,      \
      const float2 *twn, const float2 *tw1, const float2 *tw2,               \
      float2 *scratch, float *rr, float *ii, bool last, int batch,           \
      i64 ncols, int n, const Plan &p1, const Plan &p2, int orows,           \
      float osign, int tpr1, int cols1, int tpr2, int cols2, cudaStream_t st
#define IPP_LARGE_PASS_ARGS                                                  \
  xr, xi, otr, oti, twn, tw1, tw2, scratch, rr, ii, last, batch, ncols, n,   \
      p1, p2, orows, osign, tpr1, cols1, tpr2, cols2, st

cudaError_t launch_fwd(bool natural, IPP_LARGE_LAUNCH_ARGS);
cudaError_t launch_inv(bool natural, IPP_LARGE_LAUNCH_ARGS);
cudaError_t launch_inv_otf(IPP_LARGE_LAUNCH_ARGS);

#endif  // __CUDACC__

}  // namespace ipplarge
