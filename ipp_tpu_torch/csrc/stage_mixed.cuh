// The radix-2 stage of the FFT walks as a mixed-radix FFT kernel with a
// run-time plan (K3, K4, K4b, K6 at every multiple of 128 up to 12288 that
// stage_fft.cuh does not cover).
//
// The function (fft_walk.cu): the n-point complex DFT along one axis, the
// spectrum stored in the walk's permuted order, X[f] at (f & 1) * n/2 +
// (f >> 1); the inverse takes that order and scales by 1/n.  It moves
// every value once in and once out and does 5 n log2 n FLOPs per transform,
// so on this card it is bound by bytes.  The TPU kernels it replaces
// (pallas_fft.py `_v2_stage_call` :550 and `_fused_stage_call` :252, both
// directions, and `_fused_stage_otf_call` :301) run a butterfly and two
// (n/2)^2 complex products on the matrix unit: O(n) multiply-adds per
// value, which on CUDA cores is bound by the FMA rate, 15x the bytes' time
// at n = 384 and 87x at n = 2560 (the dense form in fft_walk.cu, kept for
// lengths without an FFT plan; above 12288 stage_large.cuh runs on this
// file's in-place passes).  This kernel does O(log n) work per value.
//
// It is stage_fft.cuh's function on dft_fft.cuh's engine: the plan is
// ops/dft_mats.dft_fft_plan(n), passed at run time (2^a with a >= 7 first,
// in 8s and 16s, then 9, 3, 5, 7, 11, 13 and one generic odd pass for
// what is left: every multiple of 128 has one); twiddles and the generic
// pass's roots come from stage_twiddles(n); the butterflies and the
// generic pass are dft_fft.cuh's own, and so are, for the last axis, the
// passes, the two ping-pong buffers and the pass sequence (`run_passes`).
// This file adds only what makes it the stage: the permuted store of the
// forward transform and the permuted load of the inverse (two contiguous
// runs per row of a warp: frequencies 2k and 2k+1 lie n/2 apart), the OTF
// product after that load (K4, the first pass's `pre` hook: data row r
// takes OTF row r % orows, one modulo per thread, so one block's OTF
// serves a batch), the 1/n, and the middle-axis layout with its in-place
// passes.
//
// Two layouts:
//   LAST    (R, n), the transform along the contiguous axis (K3 forward
//           over x, K6, K4, K4b): K7's row geometry (`geometry`): n / 8
//           or n / 16 threads a row, rows for ~160 threads a block, rows
//           padded in shared memory (`slot`, pitch odd).
//   !LAST   (P, n, X), x contiguous (K3 forward and inverse over z): a
//           block holds all n values of COLS neighbouring x columns of one
//           plane; lanes run along x first, so each row of the tile is one
//           contiguous run of COLS floats per plane (re, im).  The run's
//           length decides the form's speed (COLS 1 -> 2 -> 4 took 0.54 ->
//           0.31 -> 0.22 ms at (16, 2560, 256) on an H100 with two
//           buffers), so this form keeps ONE buffer and runs its passes in
//           place (decimation in time, `dit_pass` below, on dft_fft.cuh's
//           butterflies and generic pass): COLS is the largest power of two
//           up to 16 whose (n, COLS) float2 buffer fits in the 227 KB of
//           dynamic shared memory: 16 up to n = 1792, 8 to 3584, 4 to 7168,
//           2 to 12288, twice what K7's two ping-pong buffers allow.  The
//           cost where COLS is small: a run is COLS * 4 bytes, so at 8
//           columns a warp's load is four 32-byte pieces, at 2 columns
//           sixteen 8-byte ones (a quarter sector each, the rest fetched by
//           the neighbouring blocks); and a block of 139-221 KB leaves one
//           block on an SM, so its loads, passes and stores do not overlap
//           with another block's.  `col_geometry` takes COLS and the
//           threads a column as knobs (scripts/stage_mixed_bench.py
//           --sweep).  Element e of column c sits at slot col_slot(e) *
//           COLS + c, with col_slot(e) = e ^ ((e >> log2 R0) & (16 / COLS -
//           1)): the 16 lanes of a half-warp (one 8-byte access each) cover
//           16 / COLS consecutive butterflies, so a conflict needs two of
//           their elements on one slot modulo 16 / COLS.  Every access of
//           the in-place passes is a run of consecutive elements (g L + j +
//           k Lp over consecutive j, Lp >= 8; the generic pass's q + j S),
//           which a swizzle constant over aligned runs keeps apart, except
//           the first pass's stores, R0 (8 or 16) apart, which the XOR of
//           e >> log2 R0 spreads.  tests/torch_stage_mixed_host/check.cpp
//           counts the conflicts of every pass on the host: none.
// A column's arithmetic depends on n alone, never on its tile or batch, so
// a batch gives the results of its single calls.

#pragma once

#include <cuda_runtime.h>

#include "dft_fft.cuh"

namespace ippsmix {

using namespace ippdft;

enum Mode { FWD = 0, INV = 1, INV_OTF = 2 };

// Position of frequency f in the walk's permuted order.
__host__ __device__ inline int permuted(int f, int n) {
  return (f & 1) * (n >> 1) + (f >> 1);
}

// A stage length and plan this kernel takes: a multiple of 128 up to MAX_N
// whose plan `plan_ok` accepts.
inline bool stage_plan_ok(const Plan& pl) {
  return pl.n % 128 == 0 && pl.n <= MAX_N && plan_ok(pl);
}

// -- the middle-axis geometry --------------------------------------------------

struct ColGeo {
  int T;      // threads per column
  int cols;   // columns per block (COLS)
  int G;      // 16 / COLS: consecutive butterflies in a half-warp
  int sh;     // log2 of the first radix
  int smem;   // bytes: one (n, COLS) float2 buffer
};

__host__ __device__ inline int col_slot(int e, int G, int sh) {
  return e ^ ((e >> sh) & (G - 1));
}

inline int col_bytes(int n, int cols) {
  return n * cols * (int)sizeof(float2);
}

// cols <= 0: the largest power of two up to 16 whose buffer fits; tpr <= 0:
// K7's threads a row (n / 8, n / 16 from n = 512 on), at most MAX_THREADS /
// COLS threads a block, or half of that where two tiles fit on an SM (the
// kernel's ~100 registers a thread then allow two blocks: 0.067 against
// 0.085 ms at (64, 384, 256) on an H100), rounded down to a multiple of G
// (the half-warp's runs of butterflies start aligned).  A knob outside
// what the kernel takes gives T = 0 (refused).
inline ColGeo col_geometry(const Plan& pl, int tpr, int cols) {
  ColGeo g;
  const int n = pl.n;
  g.cols = cols;
  if (g.cols <= 0)
    for (g.cols = 16; g.cols > 1 && col_bytes(n, g.cols) > SMEM_LIMIT;)
      g.cols /= 2;
  g.G = g.cols >= 16 ? 1 : 16 / g.cols;
  g.sh = pl.radix[0] == 16 ? 4 : 3;
  g.smem = col_bytes(n, g.cols);
  g.T = tpr > 0 ? tpr : n / (n >= 512 ? 16 : 8);
  if (g.T * g.cols > MAX_THREADS) g.T = MAX_THREADS / g.cols;
  if (tpr <= 0) {
    const int budget = 2 * g.smem <= SMEM_LIMIT ? MAX_THREADS / 2 : MAX_THREADS;
    if (g.T * g.cols > budget) g.T = budget / g.cols;
    g.T -= g.T % g.G;
  }
  if (g.cols < 1 || (g.cols & (g.cols - 1)) || g.T < 1 || g.T % g.G)
    g.T = 0;
  return g;
}

// -- the middle-axis passes: in place, decimation in time -----------------------
//
// One buffer holds a column: pass p of radix R = radix[p] combines R
// transforms of length Lp = radix[0] ... radix[p-1] into one of length L =
// Lp R.  Butterfly i < n / R (j = i % Lp, g = i / Lp) reads elements
// g L + j + k Lp, k < R, turns element k by w^(j k n / L) (table `tw`),
// transforms them with dft<R> and writes them back where they were: no
// element is read by another thread in the same pass, so no second buffer
// and no barrier inside a pass.  The first pass reads its inputs in
// digit-reversed order (`dit_source`), straight from device memory; the
// last writes the spectrum in natural order, q + k n / R for butterfly q,
// which is K7's generic_pass's layout: a generic odd radix runs as
// `generic_pass`, its twiddles applied by the pass before it.

// The input index of element g R0 + k0 of the first pass: g = sum over
// passes p >= 1 of k_p R_1 ... R_{p-1}; the input is sum k_p n / (R_0 ...
// R_p) + k0 n / R0.
__host__ __device__ inline int dit_source(const Plan& pl, int g) {
  int idx = 0, rest = pl.n / pl.radix[0];
  for (int p = 1; p < pl.npass; ++p) {
    const int R = pl.radix[p];
    rest /= R;
    idx += (g % R) * rest;
    g /= R;
  }
  return idx;
}

// The first pass (radix R, no twiddle): load(e) gives input e, put(e, v)
// takes element e of the buffer.  gnext > 0: the next pass is the generic
// one (a plan R, r), whose twiddles (element q + jj R times w^(q jj)) this
// pass applies to its outputs, as `dit_pass` does: q = k, jj = g.
template <int R, bool INV, class Load, class Put>
__device__ __forceinline__ void dit_first(const Plan& pl, int j, int T,
                                          Load load, Put put, int gnext = 0,
                                          const float2* __restrict__ tw =
                                              nullptr) {
  const int nb = pl.n / R;
  for (int g = j; g < nb; g += T) {
    const int src = dit_source(pl, g);
    float2 v[R];
#pragma unroll
    for (int k = 0; k < R; ++k) v[k] = load(src + k * nb);
    dft<R, INV>(v);
    if (gnext > 0 && g != 0) {
#pragma unroll
      for (int k = 1; k < R; ++k) {
        float2 w = __ldg(&tw[k * g]);
        if (INV) w.y = -w.y;
        v[k] = cmul(v[k], w);
      }
    }
#pragma unroll
    for (int k = 0; k < R; ++k) put(g * R + k, v[k]);
  }
}

// A later pass of radix R on transforms of length Lp (log2 Lp in `shift`,
// or -1): get / put read and write the buffer; the last pass puts to
// device memory.  gnext > 0: the next pass is the generic one, whose
// twiddles (element q + jj S times w^(q jj), S = n / gnext = L) this pass
// applies to its outputs: q = j + k Lp, jj = g.
template <int R, bool INV, class Get, class Put>
__device__ __forceinline__ void dit_pass(int j0, int T, int n, int Lp,
                                         int shift, int gnext,
                                         const float2* __restrict__ tw,
                                         Get get, Put put) {
  const int nb = n / R, L = Lp * R, step = n / L;
  for (int i = j0; i < nb; i += T) {
    int j, g;
    if (shift >= 0) {
      j = i & (Lp - 1);
      g = i >> shift;
    } else {
      g = i / Lp;
      j = i - g * Lp;
    }
    const int base = g * L + j;
    float2 v[R];
#pragma unroll
    for (int k = 0; k < R; ++k) v[k] = get(base + k * Lp);
    if (j != 0) {
#pragma unroll
      for (int k = 1; k < R; ++k) {
        float2 w = __ldg(&tw[step * j * k]);
        if (INV) w.y = -w.y;
        v[k] = cmul(v[k], w);
      }
    }
    dft<R, INV>(v);
    if (gnext > 0 && g != 0) {
#pragma unroll
      for (int k = 0; k < R; ++k) {
        float2 w = __ldg(&tw[(j + k * Lp) * g]);
        if (INV) w.y = -w.y;
        v[k] = cmul(v[k], w);
      }
    }
#pragma unroll
    for (int k = 0; k < R; ++k) put(base + k * Lp, v[k]);
  }
}

template <bool INV, class Load, class Put>
__device__ __forceinline__ void dit_first_any(int R, const Plan& pl, int j,
                                              int T, Load load, Put put,
                                              int gnext = 0,
                                              const float2* tw = nullptr) {
  if (R == 16)
    dit_first<16, INV>(pl, j, T, load, put, gnext, tw);
  else
    dit_first<8, INV>(pl, j, T, load, put, gnext, tw);
}

template <bool INV, class Get, class Put>
__device__ __forceinline__ void dit_any(int R, int j, int T, int n, int Lp,
                                        int gnext, const float2* tw, Get get,
                                        Put put) {
  const int shift = pass_args(n, R, Lp).shift;
  switch (R) {
    case 2:
      dit_pass<2, INV>(j, T, n, Lp, shift, gnext, tw, get, put);
      break;
    case 3:
      dit_pass<3, INV>(j, T, n, Lp, shift, gnext, tw, get, put);
      break;
    case 4:
      dit_pass<4, INV>(j, T, n, Lp, shift, gnext, tw, get, put);
      break;
    case 5:
      dit_pass<5, INV>(j, T, n, Lp, shift, gnext, tw, get, put);
      break;
    case 7:
      dit_pass<7, INV>(j, T, n, Lp, shift, gnext, tw, get, put);
      break;
    case 8:
      dit_pass<8, INV>(j, T, n, Lp, shift, gnext, tw, get, put);
      break;
    case 9:
      dit_pass<9, INV>(j, T, n, Lp, shift, gnext, tw, get, put);
      break;
    case 11:
      dit_pass<11, INV>(j, T, n, Lp, shift, gnext, tw, get, put);
      break;
    case 13:
      dit_pass<13, INV>(j, T, n, Lp, shift, gnext, tw, get, put);
      break;
    case 16:
      dit_pass<16, INV>(j, T, n, Lp, shift, gnext, tw, get, put);
      break;
  }
}

#ifdef __CUDACC__

// -- the kernel ----------------------------------------------------------------

// K4's OTF product as the first pass's `pre` hook: the R OTF values of a
// butterfly (its inputs i + k NB, at their permuted positions in OTF row
// `obase / n`) loaded together, then multiplied in.  Issued in the data
// load instead, element by element, the product doubled K4's time over
// K6's (scripts/stage_mixed_bench.py on an H100).
struct OtfPre {
  const float* __restrict__ otr;
  const float* __restrict__ oti;
  i64 obase;
  int n;
  float osign;
  bool ok;
  template <int R>
  __device__ __forceinline__ void operator()(int i, int NB,
                                             float2 (&v)[R]) const {
    if (!ok) return;
    float2 w[R];
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const i64 o = obase + permuted(i + k * NB, n);
      w[k] = make_float2(__ldg(&otr[o]), osign * __ldg(&oti[o]));
    }
#pragma unroll
    for (int k = 0; k < R; ++k) v[k] = cmul(v[k], w[k]);
  }
};

// LAST: xr, xi, rr, ii are (ncols, n), ncols counting rows; otherwise
// (gridDim.y, n, ncols).  FWD: natural in, permuted out.  INV: permuted in,
// natural out, times `scale` (1/n).  INV_OTF (LAST only): the input is
// first multiplied by otr + osign * i * oti, data row r taking OTF row r %
// orows.  LAST: geometry `geometry(pl, pad, ...)` (pitch, pad); otherwise
// `col_geometry` (G, sh in the same two arguments).
template <bool LAST, int MODE>
__global__ void __launch_bounds__(MAX_THREADS)
stage_mixed(const float* __restrict__ xr, const float* __restrict__ xi,
            const float* __restrict__ otr, const float* __restrict__ oti,
            const float2* __restrict__ tw, float* __restrict__ rr,
            float* __restrict__ ii, i64 ncols, Plan pl, int T, int cols,
            int pitch_or_g, int pad_or_sh, int orows, float osign,
            float scale) {
  extern __shared__ float2 smem[];
  constexpr bool INVERSE = MODE != FWD;
  const int n = pl.n;

  // this thread's column (a row for LAST), its index j among the column's T
  const int c = LAST ? threadIdx.x / T : threadIdx.x % cols;
  const int j = LAST ? threadIdx.x - c * T : threadIdx.x / cols;
  const i64 col = (i64)blockIdx.x * cols + c;
  const bool ok = col < ncols;
  const i64 ld = LAST ? 1 : ncols;
  const i64 base = LAST ? col * n : (i64)blockIdx.y * n * ncols + col;
  // ncols < 2^31 (`launch_stage`): a 32-bit modulo, no 64-bit division call
  const OtfPre otf{otr, oti,
                   MODE == INV_OTF && ok
                       ? (i64)((unsigned)col % (unsigned)orows) * n : 0,
                   n, osign, ok};

  auto load = [=](int e) -> float2 {
    if (!ok) return make_float2(0.f, 0.f);
    const i64 a = base + (i64)(INVERSE ? permuted(e, n) : e) * ld;
    return make_float2(xr[a], xi[a]);
  };
  auto store = [=](int e, float2 v) {
    if (!ok) return;
    const int pos = INVERSE ? e : permuted(e, n);
    const i64 a = base + (i64)pos * ld;
    rr[a] = INVERSE ? v.x * scale : v.x;
    ii[a] = INVERSE ? v.y * scale : v.y;
  };
  if (LAST) {
    const int pitch = pitch_or_g, pad = pad_or_sh;
    float2* cur = smem + c * pitch;
    auto at = [=](int e) { return slot(e, pad); };
    if constexpr (MODE == INV_OTF)
      run_passes<true>(pl, j, T, tw, cur, cur + cols * pitch, load, store, at,
                       otf);
    else
      run_passes<INVERSE>(pl, j, T, tw, cur, cur + cols * pitch, load, store,
                          at);
  } else {
    const int G = pitch_or_g, sh = pad_or_sh;
    float2* buf = smem + c;
    auto get = [=](int e) { return buf[col_slot(e, G, sh) * cols]; };
    auto put = [=](int e, float2 v) { buf[col_slot(e, G, sh) * cols] = v; };
    const int last = pl.npass - 1;
    dit_first_any<INVERSE>(pl.radix[0], pl, j, T, load, put);
    __syncthreads();
    int Lp = pl.radix[0];
    for (int p = 1; p < last; ++p) {
      dit_any<INVERSE>(pl.radix[p], j, T, n, Lp,
                       p + 1 == last && pl.generic ? pl.radix[last] : 0, tw,
                       get, put);
      Lp *= pl.radix[p];
      __syncthreads();
    }
    if (pl.generic)
      generic_pass<INVERSE>(j, T, pl.radix[last], Lp, tw, get, store);
    else
      dit_any<INVERSE>(pl.radix[last], j, T, n, Lp, 0, tw, get, store);
  }
}

// -- launch --------------------------------------------------------------------

// batch: planes of (batch, n, ncols) (1 for LAST).  tpr, cols <= 0 keep the
// kernel's own geometry; a bench passes others.
template <bool LAST, int MODE>
inline cudaError_t launch_stage(const float* xr, const float* xi,
                                const float* otr, const float* oti,
                                const float2* tw, float* rr, float* ii,
                                int batch, i64 ncols, const Plan& pl,
                                int orows, float osign, int tpr, int cols,
                                cudaStream_t st) {
  if (!stage_plan_ok(pl) || ncols < 1 || ncols > 2147483647LL || batch < 1 ||
      batch > 65535 || (MODE == INV_OTF && orows < 1))
    return cudaErrorInvalidValue;
  int T, ncol, a, b, smem;
  if (LAST) {
    const Geo g = geometry(pl, DEFAULT_PAD, tpr, cols);
    T = g.T, ncol = g.cols, a = g.pitch, b = DEFAULT_PAD, smem = g.smem;
  } else {
    const ColGeo g = col_geometry(pl, tpr, cols);
    T = g.T, ncol = g.cols, a = g.G, b = g.sh, smem = g.smem;
  }
  if (smem > SMEM_LIMIT || T < 1 || T * ncol > MAX_THREADS)
    return cudaErrorInvalidValue;
  auto kernel = stage_mixed<LAST, MODE>;
  if (smem > 48 * 1024) {
    // per device, so set on every launch: it costs no device time
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  const i64 blocks = (ncols + ncol - 1) / ncol;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks, (unsigned)batch, 1);
  kernel<<<grid, T * ncol, smem, st>>>(xr, xi, otr, oti, tw, rr, ii, ncols,
                                       pl, T, ncol, a, b, orows, osign,
                                       1.f / (float)pl.n);
  return cudaGetLastError();
}

#endif  // __CUDACC__

}  // namespace ippsmix
