// K5 — one level of circular DWT analysis along one axis, for Hopper.
//
// Replaces ipp_tpu/ops/pallas_dwt.py `dwt_analysis_pallas` (kernel
// `_dwt_kernel`, the last axis) and scripts/dwt_ykernel_exp.py
// `dwt_y_pallas` (kernel `_ykernel`, axis -2).  With the input viewed as
// (B, n, S) — S = 1 for the last axis, S = w for axis -2 of (..., h, w):
//
//   cA[b, i, s] = sum_k lo[k] * x[b, (2i + k) mod n, s]
//   cD[b, i, s] = sum_k hi[k] * x[b, (2i + k) mod n, s],      i < m = n/2
//
// lo = rec_lo, hi = rec_hi: the raw phase of wavelets._dwt_last.  Both
// outputs come from one read of the input.  Polyphase: with e[p] = x[2p],
// o[p] = x[2p + 1] (p mod m) and H = L/2 tap pairs,
//
//   cA[i] = sum_{j < H} lo[2j] e[i + j] + lo[2j + 1] o[i + j]
//
// and likewise cD.  Any even n >= 2 (rows shorter than the filter wrap as
// often as they need) and any even L <= 128.
//
// What bounds it on the card.  Per input element the function moves 8
// bytes (4 in, 2 x 2 out) and does L FMAs: bytes bound it up to L ~ 40
// (db3, db9), the FMA rate above (coif15, L = 90).  The kernel it replaced
// read four shared-memory words for every four FMAs and ran at the
// shared-load issue rate.  The design:
// - register tiling: a thread computes R consecutive outputs of both
//   subbands from a sliding window of R (e, o) pairs in registers.  Per tap
//   pair it reads one new pair and one float4 of taps (a warp-uniform
//   broadcast) for 4R FMAs.  The window turns over by renaming: step j uses
//   slot (r + j) mod R for output r and then refills slot j mod R, so no
//   value moves between registers;
// - the taps live in shared memory as float4 (lo[2j], lo[2j+1], hi[2j],
//   hi[2j+1]).  For H = 3, 9, 45 (db3, db9, coif15: the destripe CLI's
//   default, the stage-1 settings, ProcessConfig's default) the tap loop is
//   unrolled at compile time; every other H runs chunks of R steps;
// - every output is the same sum in the same order, whatever the tile, the
//   batch or the loop form, so a batch gives bit for bit its single calls;
// - persistent blocks (as many as fit the card at once) walk the work
//   items; the next item's input lands by cp.async (no registers) while
//   this item computes, so a block never waits on device memory with
//   nothing to do;
// - last axis (`dwt_rows`): an item is `rows` rows x one segment of
//   seg = tpr * R outputs: whole rows at every level of the destripe CLI,
//   several rows an item at the deep levels.  Its seg + H - 1 pairs (mod
//   m) are copied as they lie, 16 bytes a lane (8-byte copies of single
//   pairs read at ~1.3 TB/s on an H100 80GB HBM3 at 700 W, by
//   scripts/dwt_bench.py --variants), then laid out as one float2
//   (e, o) a pair, padded by one slot every R pairs (pair p at p + p / R),
//   so a half-warp's R-strided 8-byte reads hit 16 different bank pairs.
//   A thread stores its R outputs of each subband from registers, 32
//   bytes side by side with its neighbours';
// - axis -2 (`dwt_cols`): an item is TI = warps * R output rows x 32
//   columns, lanes along w, each warp R rows, so its copies and stores are
//   128-byte rows and no transpose is needed.  Its window (TI + H - 1 pair
//   rows, e rows and o rows) is copied 16 bytes a lane when S % 4 == 0 (4
//   bytes on a ragged width); TI is up to 128 at R = 8, chosen so the items
//   split m evenly; the halo, read again from L2, is (H - 1) / TI of it;
// - indices are reduced mod m only in items that wrap;
// - at most 64 registers at 512 threads (`__launch_bounds__`), two blocks
//   an SM.
//
// K5s, the synthesis (the inverse level, `dwt_syn_rows` / `dwt_syn_cols`),
// replaces no Pallas kernel: the reference synthesises with an XLA
// convolution (wavelets._idwt_last; `mxu_dwt.idwt_last_mm` on the TPU, a
// lever).  It takes the place of cuDNN's transposed convolution, whose
// algorithm may change with the batch and from run to run, so that the
// destripe chain gives the same bits on every run and at every batch size.
// With ca, cd viewed as (B, m, S) and y as (B, n = 2m, S):
//
//   y[b, t, s] = sum_{k < L} up(ca)[(t - k) mod n] lo[k] + up(cd)[...] hi[k]
//
// (up: zeros at odd positions; the transpose of K5).  Polyphase: output
// pair j, (y[2j], y[2j + 1]), takes the pairs (ca, cd)[(j - r) mod m], r <
// H, with taps lo[2r + p], hi[2r + p] for y[2j + p].  With the window of an
// item starting at pair j0 - (H - 1) and s = H - 1 - r, output pair q reads
// window slot q + s: K5's tap loop (`polyphase`) as it is, on the taps
// (lo[2r], hi[2r], lo[2r + 1], hi[2r + 1]) in reverse order, the window's
// pairs (ca, cd), `a` the even outputs and `d` the odd.  Every output is one
// FMA chain in an order fixed by L alone, written by one thread; no atomics,
// no output split across threads or blocks.  The geometry is K5's: rows
// items of whole rows (or segments); column items of TI pair rows x 32
// columns, the ca and cd rows copied 16 bytes a lane into two windows, so
// the next item's copy runs under this one's compute.  The rows window
// starts at any pair, (i0 - (H - 1)) mod m, so it is copied as K5's rows
// are: the 16-byte chunks of each row that cover it, as they lie (m % 4 ==
// 0 and aligned rows: a chunk never straddles the wrap), into a copy
// buffer, then laid out from its offset q0 mod 4 into the padded slots (pair
// p at p + p / R, one float2 (ca, cd) a pair, as K5's (e, o) window) while
// the next item's chunks land in the copy; 4 bytes a lane where m % 4 != 0
// (the deepest levels' m = 42, 21).  Copied 4 bytes a lane straight into
// the slots, the rows form took 0.448 ms along x at (8, 2688, 2688) db9,
// 3.2x its bound; this way 0.255 (scripts/dwt_bench.py --root, an H100 80GB
// HBM3 at 700 W).
// Bounded by bytes (8 an output: 4 in, 4 out) up to L ~ 40, by the FMA
// rate above, as K5.
//
// The geometry and the copy, tap-loop and store steps are functions of
// (item, thread) that a host compiler also takes (cp.async becomes a plain
// copy there), so tests/torch_dwt_host/ runs the same code thread by thread
// on the host; the kernels (CUDA only) run them between barriers.

#pragma once

#include <cuda_runtime.h>

#include <cstring>
#ifdef __CUDACC__
#include <mutex>
#include <vector>
#endif

namespace ippdwt {

typedef long long i64;

constexpr int MAXL = 128;         // longest filter taken (even lengths only)
constexpr int HMAX = MAXL / 2;    // its polyphase depth
constexpr int TS = 32;            // axis -2: columns an item, one a lane
constexpr int TAP_BYTES = HMAX * 16;   // the float4 taps at shared offset 0
constexpr int SMEM_LIMIT = 227 * 1024;
constexpr int R_DEFAULT = 8;
constexpr int COLS_THREADS = 512;   // the most a block takes by default
// for timing only (scripts/dwt_bench.py --variants; wrong results): 1 skips
// the tap loop and the stores, 2 the copies
#ifndef IPP_DWT_DIAG
#define IPP_DWT_DIAG 0
#endif

__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// slot of pair (or output) p in a padded row window
__host__ __device__ inline int padded(int p, int R) { return p + p / R; }

// the most threads a block takes at R outputs a thread: 64 registers at 512
inline int max_threads(int R) { return R <= 8 ? 512 : 256; }

// R outputs a thread by default: 8, and 16 along axis -2 for filters longer
// than 64 taps, where a tap load serving 64 FMAs outweighs the compile-time
// loop: coif15 0.168 -> 0.160 ms, coif17 0.216 -> 0.175 at (8, 2688, 1344),
// scripts/dwt_bench.py --sweep on an H100 80GB HBM3 at 700 W (K5; K5s takes
// the same rule and no other R).
inline int default_r(i64 inner, int L) {
  return inner > 1 && L > 64 ? 16 : R_DEFAULT;
}

// -- geometry -----------------------------------------------------------------

// Last axis: x (nrows, n) -> ca, cd (nrows, m).
struct RowsGeo {
  int R, H, m;
  int tpr;      // threads a row segment
  int seg;      // outputs a segment, tpr * R
  int tiles;    // segments a row
  int rows;     // rows an item
  int Rq;       // float2 slots of a row's copy: seg + H - 1 pairs, even
  int Wq;       // float2 slots of a row's window: the same pairs, padded
  int threads;  // rows * tpr, rounded up to whole warps
  int smem;     // bytes: the taps, the copies, the windows
  int vec4;     // 16-byte copies (m even and an aligned input)
  i64 nrows, nwork;
};

// threads: the most a block takes; 0: 512 for filters longer than 32 taps,
// which lean on the FMA rate and gain from three rows an item (coif15 0.458
// -> 0.402 ms, coif17 0.548 -> 0.460 at (21504, 2688)), else 256 (db3 0.195
// -> 0.180): scripts/dwt_bench.py --sweep on an H100 80GB HBM3 at 700 W.
// At most max_threads(R).  A segment is the whole row up to m = threads *
// R; short rows share an item.
inline bool rows_geometry(i64 nrows, int n, int L, int R, int threads,
                          bool aligned16, RowsGeo& g) {
  if (threads <= 0) threads = imin(L > 32 ? 512 : 256, max_threads(R));
  if (threads > max_threads(R) || threads < 32) return false;
  g.R = R;
  g.H = L / 2;
  g.m = n / 2;
  g.nrows = nrows;
  g.tpr = imin(cdiv(g.m, R), threads);
  g.seg = g.tpr * R;
  g.tiles = cdiv(g.m, g.seg);
  g.Rq = cdiv(g.seg + g.H - 1, 2) * 2;
  g.Wq = padded(g.Rq, R) + 1;
  const i64 most = threads / g.tpr;
  g.rows = (int)(nrows < most ? nrows : most);
  auto bytes = [&]() { return TAP_BYTES + g.rows * (g.Rq + g.Wq) * 8; };
  while (g.rows > 1 && bytes() > SMEM_LIMIT) --g.rows;
  g.smem = bytes();
  g.threads = cdiv(g.rows * g.tpr, 32) * 32;
  g.vec4 = aligned16 && g.m % 2 == 0;
  g.nwork = ((nrows + g.rows - 1) / g.rows) * g.tiles;
  return g.smem <= SMEM_LIMIT;
}

// Axis -2: x (B, n, S) -> ca, cd (B, m, S).
struct ColsGeo {
  int R, H, m, S;
  int TI;        // output rows an item, warps * R
  int warps;
  int tiles_i, tiles_s;
  int W;         // window pair rows, TI + H - 1
  int threads;   // 32 * warps
  int smem;      // bytes: the taps, two windows of (2 W, 32) floats
  int vec4;      // 16-byte copies (S % 4 == 0 and an aligned input)
  i64 B, nwork;
};

// TI: up to (threads / 32) * R output rows (threads 0: COLS_THREADS, at
// most max_threads(R)), the least multiple of R that covers m in as few
// items as that allows, so the items split m evenly.
inline bool cols_geometry(i64 B, int n, i64 S, int L, int R, int threads,
                          bool aligned16, ColsGeo& g) {
  if (threads <= 0) threads = imin(COLS_THREADS, max_threads(R));
  if (threads > max_threads(R) || threads < TS || S > 2147483647LL)
    return false;
  g.R = R;
  g.H = L / 2;
  g.m = n / 2;
  g.S = (int)S;
  g.B = B;
  const int most = (threads / TS) * R;
  g.tiles_i = cdiv(g.m, most);
  g.TI = cdiv(cdiv(g.m, g.tiles_i), R) * R;
  g.warps = g.TI / R;
  g.tiles_s = cdiv(g.S, TS);
  g.W = g.TI + g.H - 1;
  g.threads = TS * g.warps;
  g.smem = TAP_BYTES + 2 * 2 * g.W * TS * 4;
  g.vec4 = aligned16 && g.S % 4 == 0;
  g.nwork = B * g.tiles_i * (i64)g.tiles_s;
  return g.smem <= SMEM_LIMIT;
}

// Synthesis, last axis: ca, cd (nrows, m) -> y (nrows, n).  The segments
// and rows an item of `rows_geometry` at its defaults (R = 8 output pairs a
// thread); shared memory holds the taps, the copy (`rows` rows x two
// subbands x Sq floats: the 16-byte chunks that cover a window) and the
// window (`rows` rows x Wp float2 (ca, cd) slots: seg + H - 1 pairs,
// padded).
struct SynRowsGeo {
  int R, H, m;
  int tpr;      // threads a row segment
  int seg;      // output pairs a segment, tpr * R
  int tiles;    // segments a row
  int rows;     // rows an item
  int Sq;       // floats of a row's copy of one subband, a multiple of 4
  int Wp;       // float2 slots of a row's window
  int threads;  // rows * tpr, rounded up to whole warps
  int smem;     // bytes: the taps, the copies, the windows
  int vec4;     // 16-byte stores (m even and an aligned output)
  int copy16;   // 16-byte copies (m % 4 == 0 and aligned subbands)
  i64 nrows, nwork;
};

// aligned16: y is 16-byte aligned; copy16: ca and cd are.
inline bool syn_rows_geometry(i64 nrows, int n, int L, bool aligned16,
                              bool copy16, SynRowsGeo& g) {
  const int R = R_DEFAULT, threads = L > 32 ? 512 : 256;
  g.R = R;
  g.H = L / 2;
  g.m = n / 2;
  g.nrows = nrows;
  g.tpr = imin(cdiv(g.m, R), threads);
  g.seg = g.tpr * R;
  g.tiles = cdiv(g.m, g.seg);
  g.Sq = cdiv(g.seg + g.H - 1 + 3, 4) * 4;   // up to 3 floats before the window
  g.Wp = padded(g.seg + g.H - 1, R);
  const i64 most = threads / g.tpr;
  g.rows = (int)(nrows < most ? nrows : most);
  auto bytes = [&]() { return TAP_BYTES + g.rows * 2 * (g.Sq + g.Wp) * 4; };
  while (g.rows > 1 && bytes() > SMEM_LIMIT) --g.rows;
  g.smem = bytes();
  g.threads = cdiv(g.rows * g.tpr, 32) * 32;
  g.vec4 = aligned16 && g.m % 2 == 0;
  g.copy16 = copy16 && g.m % 4 == 0;
  g.nwork = ((nrows + g.rows - 1) / g.rows) * g.tiles;
  return g.smem <= SMEM_LIMIT;
}

// -- asynchronous copies ----------------------------------------------------------

// BYTES (4, 8 or 16) from device memory to shared memory by cp.async, or
// zeros where !valid (src is then not read).  On the host: a plain copy.
template <int BYTES>
__device__ __forceinline__ void copy_async(void* dst, const void* src,
                                           bool valid) {
#ifdef __CUDA_ARCH__
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  const int n = valid ? BYTES : 0;
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(n)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d),
                 "l"(src), "n"(BYTES), "r"(n)
                 : "memory");
#else
  if (valid)
    memcpy(dst, src, BYTES);
  else
    memset(dst, 0, BYTES);
#endif
}

__device__ __forceinline__ void copy_commit() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;\n" ::: "memory");
#endif
}

// wait until at most N of this thread's copy groups are in flight
template <int N>
__device__ __forceinline__ void copy_wait() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
#endif
}

// -- the taps -------------------------------------------------------------------

// taps = [lo (L), hi (L)] -> tap[j] = (lo[2j], lo[2j+1], hi[2j], hi[2j+1])
__device__ __forceinline__ void stage_taps(const float* __restrict__ taps,
                                           float4* tap, int H, int tid,
                                           int nthreads) {
  const int L = 2 * H;
  for (int j = tid; j < H; j += nthreads)
    tap[j] = make_float4(__ldg(taps + 2 * j), __ldg(taps + 2 * j + 1),
                         __ldg(taps + L + 2 * j), __ldg(taps + L + 2 * j + 1));
}

// K5s: tap[s] = (lo[2r], hi[2r], lo[2r + 1], hi[2r + 1]), r = H - 1 - s
__device__ __forceinline__ void stage_syn_taps(const float* __restrict__ taps,
                                               float4* tap, int H, int tid,
                                               int nthreads) {
  const int L = 2 * H;
  for (int j = tid; j < H; j += nthreads) {
    const int k = 2 * (H - 1 - j);
    tap[j] = make_float4(__ldg(taps + k), __ldg(taps + L + k),
                         __ldg(taps + k + 1), __ldg(taps + L + k + 1));
  }
}

// -- the tap loop ---------------------------------------------------------------

// A thread's window of (e, o) pairs in shared memory, pair c by `at`:
// rows: float2 slots, padded by one every R pairs; columns: separate e and
// o rows of TS floats.
struct PairsRows {
  const float2* w;
  template <int R>
  __device__ __forceinline__ float2 at(int c) const {
    return w[c + c / R];
  }
  template <int R>   // the window from pair j0 on, j0 a multiple of R
  __device__ __forceinline__ PairsRows from(int j0) const {
    return PairsRows{w + j0 + j0 / R};
  }
};

struct PairsCols {
  const float* e;
  const float* o;
  template <int R>
  __device__ __forceinline__ float2 at(int c) const {
    return make_float2(e[c * TS], o[c * TS]);
  }
  template <int R>
  __device__ __forceinline__ PairsCols from(int j0) const {
    return PairsCols{e + j0 * TS, o + j0 * TS};
  }
};

// One tap pair on the window: output r reads slot (r + jj) mod R.
template <int R>
__device__ __forceinline__ void tap_step(const float4 t, const int jj,
                                         const float2 (&w)[R], float (&a)[R],
                                         float (&d)[R]) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float2 v = w[(r + jj) % R];
    a[r] = fmaf(t.x, v.x, a[r]);
    a[r] = fmaf(t.y, v.y, a[r]);
    d[r] = fmaf(t.z, v.x, d[r]);
    d[r] = fmaf(t.w, v.y, d[r]);
  }
}

// a[r], d[r] = sum_{j < h} tap[j] . (e, o)[pair r + j], r < R; reads pairs
// 0 .. h + R - 2 of the window.  HT > 0: h == HT, unrolled at compile time.
// HT == 0: any h, in whole chunks of R steps and a guarded last one.  Both
// take the same sum in the same order.
template <int R, int HT, class Pairs>
__device__ __forceinline__ void polyphase(const float4* tap, int h,
                                          const Pairs win, float (&a)[R],
                                          float (&d)[R]) {
  float2 w[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    w[r] = win.template at<R>(r);
    a[r] = 0.f;
    d[r] = 0.f;
  }
  if constexpr (HT > 0) {
#pragma unroll
    for (int j = 0; j < HT; ++j) {
      tap_step<R>(tap[j], j % R, w, a, d);
      if (j + 1 < HT) w[j % R] = win.template at<R>(j + R);
    }
  } else {
    int j0 = 0;
    for (; j0 + R <= h; j0 += R) {
      const Pairs c = win.template from<R>(j0);
      const bool more = j0 + R < h;
#pragma unroll
      for (int jj = 0; jj < R; ++jj) {
        tap_step<R>(tap[j0 + jj], jj, w, a, d);
        if (jj + 1 < R || more) w[jj] = c.template at<R>(jj + R);
      }
    }
    const int rem = h - j0;   // 0 .. R - 1 steps left
    const Pairs c = win.template from<R>(j0);
#pragma unroll
    for (int jj = 0; jj < R - 1; ++jj) {
      if (jj < rem) {
        tap_step<R>(tap[j0 + jj], jj, w, a, d);
        if (jj + 1 < rem) w[jj] = c.template at<R>(jj + R);
      }
    }
  }
}

// -- last axis ------------------------------------------------------------------

// Shared memory of a rows block: the taps, the copy (`rows` rows of Rq
// float2 (e, o) slots, as they lie in device memory), the window (`rows`
// rows of Wq slots, padded).
__device__ __forceinline__ float2* rows_copy_buf(float* smem) {
  return reinterpret_cast<float2*>(smem + TAP_BYTES / 4);
}
__device__ __forceinline__ float2* rows_window(float* smem, const RowsGeo& g) {
  return rows_copy_buf(smem) + g.rows * g.Rq;
}

// An item's first row, its segment's first output and output count, and
// its rows that exist (the last item may hold fewer).
struct RowsItem {
  i64 row0;
  int i0, cnt, nr;
};
template <class Geo>   // RowsGeo or SynRowsGeo
__device__ __forceinline__ RowsItem rows_item(const Geo& g, i64 k) {
  RowsItem it;
  it.row0 = (k / g.tiles) * g.rows;
  it.i0 = (int)(k % g.tiles) * g.seg;
  it.cnt = imin(g.seg, g.m - it.i0);
  const i64 left = g.nrows - it.row0;
  it.nr = left < g.rows ? (int)left : g.rows;
  return it;
}

// Step 1: item k's pairs [i0, i0 + cnt + H - 1) mod m of each row into the
// copy, slot p of a row = pair (i0 + p) mod m, by cp.async: 16 bytes (two
// pairs; m even, so a chunk starts at an even pair and never straddles the
// wrap) or 8.  The warps take runs of 32 lanes in turn.
template <int V>
__device__ __forceinline__ void rows_copy_runs(const float* __restrict__ x,
                                               float2* buf, const RowsGeo& g,
                                               i64 k, int tid) {
  constexpr int PL = V / 8;   // pairs a lane
  const RowsItem it = rows_item(g, k);
  const int lane = tid & 31, warp = tid >> 5, nwarps = g.threads >> 5;
  const int need = it.cnt + g.H - 1;
  const bool wraps = it.i0 + need > g.m;
  const int runs = cdiv(need, 32 * PL);
  for (int u = warp; u < it.nr * runs; u += nwarps) {
    const int rl = u / runs, p = ((u - rl * runs) * 32 + lane) * PL;
    if (p < need) {
      int q = it.i0 + p;
      if (wraps)
        while (q >= g.m) q -= g.m;
      copy_async<V>(buf + rl * g.Rq + p,
                    x + (it.row0 + rl) * 2 * g.m + 2 * q, true);
    }
  }
}

__device__ __forceinline__ void rows_copy(const float* __restrict__ x,
                                          float2* buf, const RowsGeo& g,
                                          i64 k, int tid) {
  if (IPP_DWT_DIAG == 2) return;
  if (g.vec4)
    rows_copy_runs<16>(x, buf, g, k, tid);
  else
    rows_copy_runs<8>(x, buf, g, k, tid);
}

// Step 2: the copy into the padded window, two pairs a lane (slot Rq is
// even, so pair p + 1 of an odd count is a slot of the copy, never read).
__device__ __forceinline__ void rows_relayout(const float2* buf, float2* win,
                                              const RowsGeo& g, i64 k,
                                              int tid) {
  if (IPP_DWT_DIAG == 2) return;
  const RowsItem it = rows_item(g, k);
  const int lane = tid & 31, warp = tid >> 5, nwarps = g.threads >> 5;
  const int need = it.cnt + g.H - 1, runs = cdiv(need, 64);
  for (int u = warp; u < it.nr * runs; u += nwarps) {
    const int rl = u / runs, p = ((u - rl * runs) * 32 + lane) * 2;
    if (p < need) {
      const float4 v = *reinterpret_cast<const float4*>(buf + rl * g.Rq + p);
      float2* w = win + rl * g.Wq;
      w[padded(p, g.R)] = make_float2(v.x, v.y);
      w[padded(p + 1, g.R)] = make_float2(v.z, v.w);
    }
  }
}

// Step 3: thread t of a row computes outputs tR .. tR + R - 1 of the
// segment and stores them: 32 bytes a lane side by side, a warp's 1 KB of
// a row in two 16-byte stores (4-byte stores where the row is not aligned
// or the segment ends).
template <int R, int HT>
__device__ __forceinline__ void rows_compute(float* __restrict__ ca,
                                             float* __restrict__ cd,
                                             const float4* tap,
                                             const float2* win,
                                             const RowsGeo& g, i64 k,
                                             int tid) {
  if (IPP_DWT_DIAG == 1) return;
  const RowsItem it = rows_item(g, k);
  const int rl = tid / g.tpr, t = tid - rl * g.tpr;
  if (rl >= it.nr || t * R >= it.cnt) return;
  float a[R], d[R];
  polyphase<R, HT>(tap, g.H, PairsRows{win + rl * g.Wq + t * (R + 1)}, a, d);
  const i64 off = (it.row0 + rl) * g.m + it.i0 + t * R;
  if (R % 4 == 0 && g.m % 4 == 0 && (t + 1) * R <= it.cnt) {
#pragma unroll
    for (int j = 0; j < R; j += 4) {
      *reinterpret_cast<float4*>(ca + off + j) =
          make_float4(a[j], a[j + 1], a[j + 2], a[j + 3]);
      *reinterpret_cast<float4*>(cd + off + j) =
          make_float4(d[j], d[j + 1], d[j + 2], d[j + 3]);
    }
  } else {
#pragma unroll
    for (int j = 0; j < R; ++j)
      if (t * R + j < it.cnt) {
        ca[off + j] = a[j];
        cd[off + j] = d[j];
      }
  }
}

// -- axis -2 --------------------------------------------------------------------

struct ColsItem {
  i64 b;
  int i0, cnt, s0;
};
__device__ __forceinline__ ColsItem cols_item(const ColsGeo& g, i64 k) {
  ColsItem it;
  const int ts = (int)(k % g.tiles_s);
  k /= g.tiles_s;
  const int ti = (int)(k % g.tiles_i);
  it.b = k / g.tiles_i;
  it.s0 = ts * TS;
  it.i0 = ti * g.TI;
  it.cnt = imin(g.TI, g.m - it.i0);
  return it;
}

// Shared memory of a columns block: the taps, two windows of W e rows then
// W o rows of TS floats.
__device__ __forceinline__ float* cols_window(float* smem, const ColsGeo& g,
                                              int buf) {
  return smem + TAP_BYTES / 4 + buf * 2 * g.W * TS;
}

// Step 1: item k's window, pair rows [i0, i0 + cnt + H - 1) mod m of its 32
// columns (input row rr: pair row rr / 2, e or o by rr % 2), V = 16 bytes (4
// columns a lane, 8 lanes a row) or 4; columns past S as 0.
template <int V>
__device__ __forceinline__ void cols_copy_rows(const float* __restrict__ x,
                                               float* win, const ColsGeo& g,
                                               i64 k, int tid) {
  constexpr int C = V / 4, LPR = TS / C;   // columns a lane, lanes a row
  const ColsItem it = cols_item(g, k);
  const int need = 2 * (it.cnt + g.H - 1);
  const bool wraps = it.i0 + it.cnt + g.H - 1 > g.m;
  const float* xb = x + it.b * 2 * g.m * (i64)g.S + it.s0;
  for (int u = tid; u < need * LPR; u += g.threads) {
    const int rr = u / LPR, c = (u % LPR) * C;
    int q = it.i0 + (rr >> 1);
    if (wraps)
      while (q >= g.m) q -= g.m;
    const bool valid = it.s0 + c < g.S;
    copy_async<V>(win + ((rr & 1) * g.W + (rr >> 1)) * TS + c,
                  valid ? xb + (i64)(2 * q + (rr & 1)) * g.S + c : xb, valid);
  }
}

__device__ __forceinline__ void cols_copy(const float* __restrict__ x,
                                          float* win, const ColsGeo& g, i64 k,
                                          int tid) {
  if (IPP_DWT_DIAG == 2) return;
  if (g.vec4)
    cols_copy_rows<16>(x, win, g, k, tid);
  else
    cols_copy_rows<4>(x, win, g, k, tid);
}

// Step 2: lane c of warp w computes output rows wR .. wR + R - 1 of column
// s0 + c and stores them.
template <int R, int HT>
__device__ __forceinline__ void cols_compute(float* __restrict__ ca,
                                             float* __restrict__ cd,
                                             const float4* tap,
                                             const float* win,
                                             const ColsGeo& g, i64 k,
                                             int tid) {
  const ColsItem it = cols_item(g, k);
  const int c = tid % TS, base = (tid / TS) * R;
  const int s = it.s0 + c;
  if (s >= g.S || base >= it.cnt) return;
  float a[R], d[R];
  const float* e = win + base * TS + c;
  polyphase<R, HT>(tap, g.H, PairsCols{e, e + g.W * TS}, a, d);
  i64 off = (it.b * g.m + it.i0 + base) * (i64)g.S + s;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (base + r < it.cnt) {
      ca[off] = a[r];
      cd[off] = d[r];
    }
    off += g.S;
  }
}

// -- synthesis (K5s), last axis ---------------------------------------------------

// Shared memory of a synthesis rows block: the taps, the copy (`rows` rows
// of the ca copy then the cd copy, Sq floats each), the window (`rows` rows
// of Wp float2 (ca, cd) slots, as K5's window of (e, o) pairs).
__device__ __forceinline__ float* syn_rows_copy_buf(float* smem) {
  return smem + TAP_BYTES / 4;
}
__device__ __forceinline__ float2* syn_rows_window(float* smem,
                                                   const SynRowsGeo& g) {
  return reinterpret_cast<float2*>(syn_rows_copy_buf(smem) +
                                   g.rows * 2 * g.Sq);
}

// Item k's window: its first pair q0 = (i0 - (H - 1)) mod m, its `need` =
// cnt + H - 1 pairs, whether they run past the row's end (a row shorter
// than the filter wraps several times), and the window's first float in
// the copy: q0 mod 4 with 16-byte copies, else 0.
struct SynWindow {
  int q0, need, off;
  bool wraps;
};
__device__ __forceinline__ SynWindow syn_window(const SynRowsGeo& g,
                                                const RowsItem& it) {
  SynWindow w;
  w.need = it.cnt + g.H - 1;
  w.q0 = (it.i0 - (g.H - 1)) % g.m;
  if (w.q0 < 0) w.q0 += g.m;
  w.wraps = w.q0 + w.need > g.m;
  w.off = g.copy16 ? (w.q0 & 3) : 0;
  return w;
}

// Step 1: item k's window of each row's ca and cd into the copy, by
// cp.async.  16 bytes a lane: chunk u of a row's copy is the row's chunk
// (q0 / 4 + u) mod (m / 4), for u < (off + need) / 4 rounded up, so the
// window's pair p lies at off + p.  4 bytes a lane (m % 4 != 0): float p
// is pair (q0 + p) mod m.  The warps take runs of 32 lanes of one row's
// subband in turn.
__device__ __forceinline__ void syn_rows_copy(const float* __restrict__ ca,
                                              const float* __restrict__ cd,
                                              float* buf,
                                              const SynRowsGeo& g, i64 k,
                                              int tid) {
  if (IPP_DWT_DIAG == 2) return;
  const RowsItem it = rows_item(g, k);
  const SynWindow w = syn_window(g, it);
  const int lane = tid & 31, warp = tid >> 5, nwarps = g.threads >> 5;
  if (g.copy16) {
    const int c0 = w.q0 >> 2, mc = g.m >> 2, nch = cdiv(w.off + w.need, 4);
    const int runs = cdiv(nch, 32);
    for (int u = warp; u < it.nr * 2 * runs; u += nwarps) {
      const int rb = u / runs, ch = (u - rb * runs) * 32 + lane;
      if (ch < nch) {
        int c = c0 + ch;
        if (w.wraps) c %= mc;
        const float* src = (rb & 1) ? cd : ca;
        copy_async<16>(buf + rb * g.Sq + 4 * ch,
                       src + (it.row0 + (rb >> 1)) * g.m + 4 * c, true);
      }
    }
    return;
  }
  const int runs = cdiv(w.need, 32);
  for (int u = warp; u < it.nr * 2 * runs; u += nwarps) {
    const int rb = u / runs, p = (u - rb * runs) * 32 + lane;
    if (p < w.need) {
      int q = w.q0 + p;
      if (w.wraps) q %= g.m;
      const float* src = (rb & 1) ? cd : ca;
      copy_async<4>(buf + rb * g.Sq + p,
                    src + (it.row0 + (rb >> 1)) * g.m + q, true);
    }
  }
}

// Step 2: the copy into the window, pair p of a row from float off + p of
// its ca and cd copies to the float2 slot padded(p); two pairs a lane.
__device__ __forceinline__ void syn_rows_relayout(const float* buf,
                                                  float2* win,
                                                  const SynRowsGeo& g, i64 k,
                                                  int tid) {
  if (IPP_DWT_DIAG == 2) return;
  const RowsItem it = rows_item(g, k);
  const SynWindow w = syn_window(g, it);
  const int lane = tid & 31, warp = tid >> 5, nwarps = g.threads >> 5;
  const int runs = cdiv(w.need, 64);
  for (int u = warp; u < it.nr * runs; u += nwarps) {
    const int rl = u / runs, p = ((u - rl * runs) * 32 + lane) * 2;
    if (p < w.need) {
      const float* a = buf + 2 * rl * g.Sq + w.off + p;
      float2* row = win + rl * g.Wp;
      row[padded(p, g.R)] = make_float2(a[0], a[g.Sq]);
      if (p + 1 < w.need)
        row[padded(p + 1, g.R)] = make_float2(a[1], a[g.Sq + 1]);
    }
  }
}

// Step 3: thread t of a row computes output pairs tR .. tR + R - 1 of the
// segment and stores them interleaved, y[2j] = a, y[2j + 1] = d: 32 bytes
// a lane in two 16-byte stores where the row allows (else 4-byte stores).
template <int R, int HT>
__device__ __forceinline__ void syn_rows_compute(float* __restrict__ y,
                                                 const float4* tap,
                                                 const float2* win,
                                                 const SynRowsGeo& g, i64 k,
                                                 int tid) {
  if (IPP_DWT_DIAG == 1) return;
  const RowsItem it = rows_item(g, k);
  const int rl = tid / g.tpr, t = tid - rl * g.tpr;
  if (rl >= it.nr || t * R >= it.cnt) return;
  float a[R], d[R];
  polyphase<R, HT>(tap, g.H, PairsRows{win + rl * g.Wp + t * (R + 1)}, a,
                   d);
  const i64 off = (it.row0 + rl) * 2 * g.m + 2 * (it.i0 + t * R);
  if (g.vec4 && (t + 1) * R <= it.cnt) {
#pragma unroll
    for (int j = 0; j < R; j += 2)
      *reinterpret_cast<float4*>(y + off + 2 * j) =
          make_float4(a[j], d[j], a[j + 1], d[j + 1]);
  } else {
#pragma unroll
    for (int j = 0; j < R; ++j)
      if (t * R + j < it.cnt) {
        y[off + 2 * j] = a[j];
        y[off + 2 * j + 1] = d[j];
      }
  }
}

// -- synthesis (K5s), axis -2 -----------------------------------------------------

// Pair p of a window that starts at pair q0 = i0 - (H - 1), reduced mod m
// only where the item wraps (q0 < 0; a column shorter than the filter wraps
// several times).
__device__ __forceinline__ int syn_pair(int q0, int p, int m, bool wraps) {
  int q = q0 + p;
  if (wraps) {
    q %= m;
    if (q < 0) q += m;
  }
  return q;
}

// Step 1: item k's window, pair rows [i0 - (H - 1), i0 + cnt) mod m of its
// 32 columns of ca (window rows 0 .. W - 1) and cd (W .. 2W - 1), window row
// rr: pair row rr / 2, ca or cd by rr % 2; V = 16 bytes (4 columns a lane,
// 8 lanes a row) or 4; columns past S as 0.
template <int V>
__device__ __forceinline__ void syn_cols_copy_rows(
    const float* __restrict__ ca, const float* __restrict__ cd, float* win,
    const ColsGeo& g, i64 k, int tid) {
  constexpr int C = V / 4, LPR = TS / C;   // columns a lane, lanes a row
  const ColsItem it = cols_item(g, k);
  const int need = 2 * (it.cnt + g.H - 1), q0 = it.i0 - (g.H - 1);
  const bool wraps = q0 < 0;
  const i64 base = it.b * g.m * (i64)g.S + it.s0;
  for (int u = tid; u < need * LPR; u += g.threads) {
    const int rr = u / LPR, c = (u % LPR) * C;
    const float* src = ((rr & 1) ? cd : ca) + base;
    const bool valid = it.s0 + c < g.S;
    copy_async<V>(
        win + ((rr & 1) * g.W + (rr >> 1)) * TS + c,
        valid ? src + (i64)syn_pair(q0, rr >> 1, g.m, wraps) * g.S + c : src,
        valid);
  }
}

__device__ __forceinline__ void syn_cols_copy(const float* __restrict__ ca,
                                              const float* __restrict__ cd,
                                              float* win, const ColsGeo& g,
                                              i64 k, int tid) {
  if (IPP_DWT_DIAG == 2) return;
  if (g.vec4)
    syn_cols_copy_rows<16>(ca, cd, win, g, k, tid);
  else
    syn_cols_copy_rows<4>(ca, cd, win, g, k, tid);
}

// Step 2: lane c of warp w computes output pairs wR .. wR + R - 1 of column
// s0 + c and stores them, rows 2j and 2j + 1.
template <int R, int HT>
__device__ __forceinline__ void syn_cols_compute(float* __restrict__ y,
                                                 const float4* tap,
                                                 const float* win,
                                                 const ColsGeo& g, i64 k,
                                                 int tid) {
  if (IPP_DWT_DIAG == 1) return;
  const ColsItem it = cols_item(g, k);
  const int c = tid % TS, base = (tid / TS) * R;
  const int s = it.s0 + c;
  if (s >= g.S || base >= it.cnt) return;
  float a[R], d[R];
  const float* e = win + base * TS + c;
  polyphase<R, HT>(tap, g.H, PairsCols{e, e + g.W * TS}, a, d);
  i64 off = (it.b * 2 * g.m + 2 * (it.i0 + base)) * (i64)g.S + s;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (base + r < it.cnt) {
      y[off] = a[r];
      y[off + g.S] = d[r];
    }
    off += 2 * (i64)g.S;
  }
}

#ifdef __CUDACC__

// -- kernels --------------------------------------------------------------------

// Block b takes items b, b + grid, ...: it copies the next item while this
// one computes and stores (columns: into the other of two windows).
template <int R, int HT>
__global__ void __launch_bounds__(R <= 8 ? 512 : 256, 2)
dwt_rows(const float* __restrict__ x, const float* __restrict__ taps,
         float* __restrict__ ca, float* __restrict__ cd, const RowsGeo g) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float2* buf = rows_copy_buf(smem);
  float2* win = rows_window(smem, g);
  const int tid = threadIdx.x;
  stage_taps(taps, smem4, g.H, tid, g.threads);
  i64 k = blockIdx.x;
  if (k < g.nwork) rows_copy(x, buf, g, k, tid);
  copy_commit();
  for (; k < g.nwork; k += gridDim.x) {
    copy_wait<0>();
    __syncthreads();   // the copy landed; the last item's window is free
    rows_relayout(buf, win, g, k, tid);
    __syncthreads();   // the window is whole; the copy is free
    if (k + gridDim.x < g.nwork) rows_copy(x, buf, g, k + gridDim.x, tid);
    copy_commit();
    rows_compute<R, HT>(ca, cd, smem4, win, g, k, tid);
  }
}

template <int R, int HT>
__global__ void __launch_bounds__(R <= 8 ? 512 : 256, 2)
dwt_cols(const float* __restrict__ x, const float* __restrict__ taps,
         float* __restrict__ ca, float* __restrict__ cd, const ColsGeo g) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x;
  stage_taps(taps, smem4, g.H, tid, g.threads);
  i64 k = blockIdx.x;
  if (k < g.nwork) cols_copy(x, cols_window(smem, g, 0), g, k, tid);
  copy_commit();
  for (int n = 0; k < g.nwork; ++n, k += gridDim.x) {
    if (k + gridDim.x < g.nwork)
      cols_copy(x, cols_window(smem, g, (n + 1) & 1), g, k + gridDim.x, tid);
    copy_commit();
    copy_wait<1>();
    __syncthreads();   // item k's window landed
    if (IPP_DWT_DIAG != 1)
      cols_compute<R, HT>(ca, cd, smem4, cols_window(smem, g, n & 1), g, k,
                          tid);
    __syncthreads();   // its window is free for item k + 2 grid
  }
}

// K5s: the rows form walks as `dwt_rows` (the copy of the next item lands
// while this one computes from the window), the columns form as `dwt_cols`
template <int R, int HT>
__global__ void __launch_bounds__(R <= 8 ? 512 : 256, 2)
dwt_syn_rows(const float* __restrict__ ca, const float* __restrict__ cd,
             const float* __restrict__ taps, float* __restrict__ y,
             const SynRowsGeo g) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* buf = syn_rows_copy_buf(smem);
  float2* win = syn_rows_window(smem, g);
  const int tid = threadIdx.x;
  stage_syn_taps(taps, smem4, g.H, tid, g.threads);
  i64 k = blockIdx.x;
  if (k < g.nwork) syn_rows_copy(ca, cd, buf, g, k, tid);
  copy_commit();
  for (; k < g.nwork; k += gridDim.x) {
    copy_wait<0>();
    __syncthreads();   // the copy landed; the last item's window is free
    syn_rows_relayout(buf, win, g, k, tid);
    __syncthreads();   // the window is whole; the copy is free
    if (k + gridDim.x < g.nwork)
      syn_rows_copy(ca, cd, buf, g, k + gridDim.x, tid);
    copy_commit();
    syn_rows_compute<R, HT>(y, smem4, win, g, k, tid);
  }
}

template <int R, int HT>
__global__ void __launch_bounds__(R <= 8 ? 512 : 256, 2)
dwt_syn_cols(const float* __restrict__ ca, const float* __restrict__ cd,
             const float* __restrict__ taps, float* __restrict__ y,
             const ColsGeo g) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x;
  stage_syn_taps(taps, smem4, g.H, tid, g.threads);
  i64 k = blockIdx.x;
  if (k < g.nwork) syn_cols_copy(ca, cd, cols_window(smem, g, 0), g, k, tid);
  copy_commit();
  for (int n = 0; k < g.nwork; ++n, k += gridDim.x) {
    if (k + gridDim.x < g.nwork)
      syn_cols_copy(ca, cd, cols_window(smem, g, (n + 1) & 1), g,
                    k + gridDim.x, tid);
    copy_commit();
    copy_wait<1>();
    __syncthreads();   // item k's window landed
    syn_cols_compute<R, HT>(y, smem4, cols_window(smem, g, n & 1), g, k, tid);
    __syncthreads();   // its window is free for item k + 2 grid
  }
}

// -- launch ---------------------------------------------------------------------

// SMs of the current device, read once a device
inline int sm_count() {
  static int cache[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (dev >= 0 && dev < 64 && cache[dev] > 0) return cache[dev];
  int n = 0;
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  if (dev >= 0 && dev < 64) cache[dev] = n;
  return n;
}

// Blocks of `kernel` an SM holds at (threads, smem) on the current device,
// asked of the runtime once (the deep levels' calls are host-bound); the
// kernel's shared-memory limit is raised to SMEM_LIMIT at the first ask.
template <class Kernel>
inline cudaError_t blocks_per_sm(Kernel kernel, int threads, int smem,
                                 int& per_sm) {
  struct Fit {
    int dev;
    const void* kernel;
    int threads, smem, per_sm;
  };
  static std::mutex mu;
  static std::vector<Fit> fits;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const void* key = reinterpret_cast<const void*>(kernel);
  bool raised = false;
  {
    std::lock_guard<std::mutex> lock(mu);
    for (const Fit& f : fits) {
      if (f.dev != dev || f.kernel != key) continue;
      raised = true;
      if (f.threads == threads && f.smem == smem) {
        per_sm = f.per_sm;
        return cudaSuccess;
      }
    }
  }
  if (!raised) {
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
    if (e != cudaSuccess) return e;
  }
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                    smem);
  if (e != cudaSuccess) return e;
  std::lock_guard<std::mutex> lock(mu);
  fits.push_back(Fit{dev, key, threads, smem, per_sm});
  return cudaSuccess;
}

// As many blocks as fit the card at once, at most one an item.
template <class Kernel, class Geo, class... Args>
inline cudaError_t launch_one(Kernel kernel, const Geo& g, cudaStream_t st,
                              Args... args) {
  int per_sm = 0;
  const cudaError_t e = blocks_per_sm(kernel, g.threads, g.smem, per_sm);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const i64 fit = (i64)per_sm * sm_count();
  const unsigned grid = (unsigned)(g.nwork < fit ? g.nwork : fit);
  kernel<<<grid, g.threads, g.smem, st>>>(args..., g);
  return cudaGetLastError();
}

// K5's kernel at (R, HT) for the geometry's axis
template <int R, int HT>
inline cudaError_t launch_k(const RowsGeo& g, cudaStream_t st, const float* x,
                            const float* taps, float* ca, float* cd) {
  return launch_one(dwt_rows<R, HT>, g, st, x, taps, ca, cd);
}

template <int R, int HT>
inline cudaError_t launch_k(const ColsGeo& g, cudaStream_t st, const float* x,
                            const float* taps, float* ca, float* cd) {
  return launch_one(dwt_cols<R, HT>, g, st, x, taps, ca, cd);
}

// The kernel instance for (R, H): compile-time tap loops for H = 3, 9, 45 at
// R = 8 unless `generic`; R = 4 and 16 (the sweep's) run the chunked loop.
template <int R, class Geo>
inline cudaError_t launch_r(const Geo& g, bool generic, cudaStream_t st,
                            const float* x, const float* taps, float* ca,
                            float* cd) {
  if constexpr (R == 8) {
    if (!generic && g.H == 3) return launch_k<R, 3>(g, st, x, taps, ca, cd);
    if (!generic && g.H == 9) return launch_k<R, 9>(g, st, x, taps, ca, cd);
    if (!generic && g.H == 45) return launch_k<R, 45>(g, st, x, taps, ca, cd);
  }
  return launch_k<R, 0>(g, st, x, taps, ca, cd);
}

template <class Geo>
inline cudaError_t launch_geo(const Geo& g, bool generic, cudaStream_t st,
                              const float* x, const float* taps, float* ca,
                              float* cd) {
  if (g.R == 4) return launch_r<4>(g, generic, st, x, taps, ca, cd);
  if (g.R == 8) return launch_r<8>(g, generic, st, x, taps, ca, cd);
  return launch_r<16>(g, generic, st, x, taps, ca, cd);
}

inline bool args_ok(int L, i64 batch, i64 inner) {
  return L >= 2 && !(L & 1) && L <= MAXL && batch >= 1 && inner >= 1;
}

inline bool aligned(const void* p, unsigned bytes) {
  return (reinterpret_cast<unsigned long long>(p) & (bytes - 1)) == 0;
}

// K5: x (batch, n, inner) -> ca, cd (batch, n/2, inner); inner == 1 is the
// last axis.  x 8-byte aligned.  R: outputs a thread (0: `default_r`; else
// 4, 8 or 16); threads: the most a block takes (0: the axis' default);
// generic: the chunked tap loop at every H.
inline cudaError_t launch(const float* x, const float* taps, float* ca,
                          float* cd, i64 batch, int n, i64 inner, int L, int R,
                          int threads, bool generic, cudaStream_t st) {
  if (R == 0) R = default_r(inner, L);
  if (n < 2 || (n & 1) || !args_ok(L, batch, inner) ||
      (R != 4 && R != 8 && R != 16) || !aligned(x, 8))
    return cudaErrorInvalidValue;
  if (inner == 1) {
    RowsGeo g;
    if (!rows_geometry(batch, n, L, R, threads, aligned(x, 16), g))
      return cudaErrorInvalidValue;
    return launch_geo(g, generic, st, x, taps, ca, cd);
  }
  ColsGeo g;
  if (!cols_geometry(batch, n, inner, L, R, threads, aligned(x, 16), g))
    return cudaErrorInvalidValue;
  return launch_geo(g, generic, st, x, taps, ca, cd);
}

// K5s: ca, cd (batch, m, inner) -> y (batch, 2m, inner); inner == 1 is the
// last axis.  Only the instances `default_r` picks: R = 8 with compile-time
// tap loops for H = 3, 9 and 45 (rows) or 3 and 9 (columns), the chunked
// loop at every other H, and R = 16's chunked loop for columns with filters
// longer than 64 taps.  The rows form stores 16 bytes where y is 16-byte
// aligned; both forms copy 16 bytes where ca and cd are (rows: and m % 4
// == 0).
inline cudaError_t launch_syn(const float* ca, const float* cd,
                              const float* taps, float* y, i64 batch, int m,
                              i64 inner, int L, cudaStream_t st) {
  if (m < 1 || m > (1 << 29) || !args_ok(L, batch, inner))
    return cudaErrorInvalidValue;
  if (inner == 1) {
    SynRowsGeo g;
    if (!syn_rows_geometry(batch, 2 * m, L, aligned(y, 16),
                           aligned(ca, 16) && aligned(cd, 16), g))
      return cudaErrorInvalidValue;
    switch (g.H) {
      case 3: return launch_one(dwt_syn_rows<8, 3>, g, st, ca, cd, taps, y);
      case 9: return launch_one(dwt_syn_rows<8, 9>, g, st, ca, cd, taps, y);
      case 45: return launch_one(dwt_syn_rows<8, 45>, g, st, ca, cd, taps, y);
      default: return launch_one(dwt_syn_rows<8, 0>, g, st, ca, cd, taps, y);
    }
  }
  const int R = default_r(inner, L);
  ColsGeo g;
  if (!cols_geometry(batch, 2 * m, inner, L, R, 0,
                     aligned(ca, 16) && aligned(cd, 16), g))
    return cudaErrorInvalidValue;
  if (R == 16) return launch_one(dwt_syn_cols<16, 0>, g, st, ca, cd, taps, y);
  switch (g.H) {
    case 3: return launch_one(dwt_syn_cols<8, 3>, g, st, ca, cd, taps, y);
    case 9: return launch_one(dwt_syn_cols<8, 9>, g, st, ca, cd, taps, y);
    default: return launch_one(dwt_syn_cols<8, 0>, g, st, ca, cd, taps, y);
  }
}

#endif  // __CUDACC__

}  // namespace ippdwt
