// The y-axis real DFT of the v2 walk and its inverse as real-FFT kernels
// (K1, K2, and their batched forms K1b, K2b).
//
// The functions (fft_walk.cu has the dense forms):
//   K1  for each plane a = b * nz + z and each x, the ny-point real DFT along
//       y of x[a, :, c] (with `den`: of num / max(den, FLT_EPSILON), a true
//       division formed in the load), rows 0..kx-1 (kx = ny/2 + 1) to
//       re[b, k, z, c] and im[b, k, z, c], kp-major; rows kx..kp-1 exactly 0;
//       im at k = 0 and k = ny/2 exactly 0.
//   K2  the inverse with 1/ny from kp-major half spectra, Hermitian weights:
//       im at k = 0 and k = ny/2 is ignored, rows kx..kp-1 are never read;
//       with `mul` the output is |mul * y|, formed at the store.
// The TPU kernels they replace (pallas_fft.py `_v2_rfft_kernel_t`,
// `_v2_rfft_ratio_kernel_t`, `_v2_irfft_kernel_t`, `_v2_irfft_mul_kernel_t`
// and the four batched ones) multiply by the dense fold matrix: O(ny)
// multiply-adds per value, cheap on a matrix unit, bound by the FMA rate on
// CUDA cores.  The function reads each value once, writes each once and
// needs 2.5 ny log2 ny FLOPs a column, so on this card it is bound by bytes.
//
// The real transform: two real columns in one complex transform.  Columns c
// and c + 1 (c even; nx is even on this route) are the real and imaginary
// part of one ny-point complex sequence z = a + i b.  Forward: Z = FFT(z),
// then for k = 0..ny/2
//     A[k] = (Z[k] + conj Z[ny-k]) / 2,   B[k] = (Z[k] - conj Z[ny-k]) / 2i
// are the two columns' half spectra (`untangle`).  Inverse: Z[k] = A[k] +
// i B[k], Z[ny-k] = conj A[k] + i conj B[k] (`tangle`), z = IFFT(Z), a = re z,
// b = im z.  No extra twiddle, every plan of ops/dft_mats.dft_fft_plan
// serves, and the work is that of a half-length transform per column.  A
// pair is always (2j, 2j + 1) and its arithmetic depends on ny alone, never
// on its tile, plane or batch, so a batch gives each block bit for bit what
// the single call gives it.  A column's rounding error scales with the
// larger of the pair's two columns.
//
// The complex transform is dft_fft.cuh's: Stockham autosort passes from a
// run-time plan (radix 16 / 8 / 4 / 2, 9 / 3 / 5 / 7 / 11 / 13, one generic
// odd pass last), twiddles from ops/dft_mats.stage_twiddles(ny).  Its pass
// templates are used as they are (that header is included, nothing is
// copied); what is new here is the layout and the real-input fold.
//
// Layout: y is the middle axis, x is contiguous.  One block takes one plane
// and P neighbouring column pairs (2P columns) at all ny; lanes run along
// the pairs first, so every row of the tile is one run of 8 P bytes in
// device memory (32 bytes at P = 4, 64 at P = 8: whole sectors), loaded and
// stored as float2.  Shared memory holds two buffers of (ny, P) float2:
// element e of pair pc at e * P + pc.  K1: the first pass loads from
// device memory into registers, every pass writes shared memory, and the
// untangle step reads k and ny - k and stores the kp rows of re and im.  K2:
// the tangle step loads each of the kx rows once and writes Z[k] and
// Z[ny-k] to shared memory, and the last pass stores from registers through
// 1/ny and |mul * y|.  So each value crosses device memory once each way.
// The fused streams are loaded a butterfly at a time, all of its rows before
// any is used: the ratio's den in a hook after the first pass's loads, the
// update's mul in a hook before the last pass's stores (dft_fft.cuh
// `fft_pass`).  Loaded row by row they waited for one another, behind a
// division's slow-path call or a store: K1 with the ratio 0.67 -> 0.47 ms and
// K2 with mul 0.55 -> 0.48 ms at (256, 1056, 256), 0.87 -> 0.55 ms at (128,
// 2048, 256) on an H100.
//
// Bank conflicts: a half-warp's 16 lanes are 16 / P butterflies of P pairs,
// and every pass reads consecutive elements, so reads are free of conflicts;
// only the first pass writes at stride 8 or 16.  An XOR swizzle of the low
// bits of e that spreads those writes changed no time at any shape on an
// H100 (scripts/rdft_y_bench.py --sweep had the knob) and is not kept.
//
// Geometry by ny and its plan at the launch (`geometry`): P = 8 pairs up to
// ny = 768 and 4 above, T threads a pair so that a block has about 384.

#pragma once

#include <cfloat>

#include <cuda_runtime.h>

#include "dft_fft.cuh"

namespace ipprdft {

using ippdft::any_pass;
using ippdft::fft_pass;
using ippdft::generic_pass;
using ippdft::i64;
using ippdft::pass_args;
using ippdft::Plan;
using ippdft::plan_ok;

constexpr int MAX_NY = 2048;   // ops/cuda_fft.RDFT_FFT_MAX_NY: the v2 domain
constexpr int MAX_THREADS = 384;   // a block; two fit an SM at 80 registers
constexpr int MAX_PAIRS = 32;
constexpr int TANGLE_ROWS = 4;   // rows of K2's load step in flight a thread

// -- geometry -----------------------------------------------------------------

struct Geo {
  int T;      // threads per column pair
  int P;      // column pairs per block, a power of two
  int lp;     // log2 P
  int smem;   // bytes: two buffers of (ny, P) float2
};

// The work items of pass p: its butterflies, each about R long; for the
// generic pass its (k, q) items, each about r / 2 long.
inline void pass_items(const Plan& pl, int p, int& items, int& weight) {
  const int r = pl.radix[p];
  const bool generic = pl.generic && p == pl.npass - 1;
  items = generic ? (r / 2 + 1) * (pl.n / r) : pl.n / r;
  weight = generic ? r / 2 + 1 : r;
}

// P: 8 pairs up to ny = 768, 4 above.  T: a thread runs its pair's items of
// a pass in rounds, one after the other, so T is the count up to
// MAX_THREADS / P with the least sum over the passes of rounds x item
// length, the smallest such.  Measured on an H100 (scripts/rdft_y_bench.py
// --sweep): at ny = 1056 that T = 96 beats 66 by 10%, at 768 T = 48 beats 43
// by 10-15%, at 512 T = 32 beats 42 and 64 by 15-40%.  Blocks stay at 384
// threads and the kernels at 80 registers (the launch bounds), so two blocks
// fit an SM: at 95 registers one did, and both kernels lost 40-50%.  Short
// columns take more pairs until a block has 128 threads.  `tpp`, `pairs` > 0
// override T and P (pairs: a power of two up to 32).
inline Geo geometry(const Plan& pl, int tpp, int pairs) {
  const int ny = pl.n;
  Geo g;
  g.P = pairs > 0 ? pairs : (ny <= 768 ? 8 : 4);
  auto bytes = [&]() { return 2 * ny * g.P * (int)sizeof(float2); };
  const int most = MAX_THREADS / g.P;
  g.T = 1;
  long best = -1;
  for (int t = 1; t <= most && tpp <= 0; ++t) {
    long cost = 0;
    for (int p = 0; p < pl.npass; ++p) {
      int items, weight;
      pass_items(pl, p, items, weight);
      cost += (long)((items + t - 1) / t) * weight;
    }
    if (best < 0 || cost < best) {
      best = cost;
      g.T = t;
    }
  }
  if (tpp > 0) g.T = tpp;
  if (g.T > MAX_THREADS) g.T = MAX_THREADS;
  if (pairs <= 0)
    while (g.T * g.P < 128 && g.P < MAX_PAIRS) g.P *= 2;
  while (g.P > 1 && (g.T * g.P > MAX_THREADS || bytes() > ippdft::SMEM_LIMIT))
    g.P /= 2;
  g.lp = 0;
  while ((1 << g.lp) < g.P) ++g.lp;
  g.smem = bytes();
  return g;
}

// -- the real-input fold --------------------------------------------------------

// z = Z[k], y = Z[ny-k] (y = z at k = 0 and k = ny/2) of the packed pair ->
// re = (re A[k], re B[k]), im = (im A[k], im B[k]): the two columns' values
// as they lie side by side in a row of re and of im.
__host__ __device__ inline void untangle(float2 z, float2 y, float2& re,
                                         float2& im) {
  re = make_float2(0.5f * (z.x + y.x), 0.5f * (z.y + y.y));
  im = make_float2(0.5f * (z.y - y.y), 0.5f * (y.x - z.x));
}

// re = (re A[k], re B[k]), im = (im A[k], im B[k]) -> zk = Z[k], zm = Z[ny-k].
// At k = 0 and k = ny/2 (`edge`) the imaginary parts are dropped, as the
// Hermitian fold of ops/dft_mats.irdft_mats drops them, and zm == zk.
__host__ __device__ inline void tangle(float2 re, float2 im, bool edge,
                                       float2& zk, float2& zm) {
  if (edge) im = make_float2(0.f, 0.f);
  zk = make_float2(re.x - im.y, im.x + re.y);
  zm = make_float2(re.x + im.y, re.y - im.x);
}

#ifdef __CUDACC__

// -- K1 -------------------------------------------------------------------------

// num, den: (planes, ny, nx), den read with RATIO only.  re, im: (nb, kp, nz,
// nx), planes = nb * nz.  tw: (ny) float2, exp(-2 pi i j / ny).  Block b of
// the grid is tile b % tiles of plane b / tiles.  RATIO is a template
// argument, not a test of `den`: with a run-time branch in the load the
// compiler orders the loads of a butterfly one behind the other.
template <bool RATIO>
__global__ void __launch_bounds__(MAX_THREADS, 2)
rdft_y_fwd_fft(const float* __restrict__ num, const float* __restrict__ den,
               const float2* __restrict__ tw, float* __restrict__ re,
               float* __restrict__ im, int nz, int nx, int kp, int tiles,
               Plan pl, int T, int lp) {
  extern __shared__ float2 smem[];
  const int n = pl.n, P = 1 << lp;
  const int pc = threadIdx.x & (P - 1), j = threadIdx.x >> lp;
  const int a = blockIdx.x / tiles, tile = blockIdx.x - a * tiles;
  const int b = a / nz, z = a - b * nz;
  const int c = (tile * P + pc) * 2;   // this thread's pair: columns c, c + 1
  const bool ok = c < nx;
  const i64 in0 = (i64)a * n * nx + c;
  // the buffer the next pass reads (cur) and the one it writes (nxt)
  float2* cur = smem + pc;
  float2* nxt = cur + (n << lp);

  auto from_global = [&](int e) -> float2 {
    if (!ok) return make_float2(0.f, 0.f);
    return __ldg(reinterpret_cast<const float2*>(num + in0 + (i64)e * nx));
  };
  // The ratio of a butterfly's inputs: every den after every num, and only
  // then the divisions.  A true division may call its slow path, and no load
  // moves across a call: formed load by load, the R loads of a butterfly
  // went out one behind the other.
  auto ratio = [&](int i, int NB, auto& v) {
    constexpr int R = sizeof(v) / sizeof(v[0]);
    if (!RATIO || !ok) return;
    float2 d[R];
#pragma unroll
    for (int k = 0; k < R; ++k)
      d[k] = __ldg(reinterpret_cast<const float2*>(
          den + in0 + (i64)(i + k * NB) * nx));
#pragma unroll
    for (int k = 0; k < R; ++k) {
      v[k].x = v[k].x / fmaxf(d[k].x, FLT_EPSILON);
      v[k].y = v[k].y / fmaxf(d[k].y, FLT_EPSILON);
    }
  };
  auto from_smem = [&](int e) -> float2 { return cur[e << lp]; };
  auto to_smem = [&](int e, float2 v) { nxt[e << lp] = v; };
  auto flip = [&]() {   // what was written becomes what is read
    float2* t = cur;
    cur = nxt;
    nxt = t;
    __syncthreads();
  };

  const int R0 = pl.radix[0];   // 8 or 16 (`plan_ok`)
  if (R0 == 16)
    fft_pass<16, false>(j, T, pass_args(n, 16, 1), tw, from_global, to_smem,
                        ratio);
  else
    fft_pass<8, false>(j, T, pass_args(n, 8, 1), tw, from_global, to_smem,
                       ratio);
  int S = R0;
  flip();
  for (int p = 1; p < pl.npass; ++p) {
    const int R = pl.radix[p];
    if (pl.generic && p == pl.npass - 1)
      generic_pass<false>(j, T, R, S, tw, from_smem, to_smem);
    else
      any_pass<false>(R, j, T, pass_args(n, R, S), tw, from_smem, to_smem);
    S *= R;
    flip();
  }

  // untangle: item (k, pc), pc fastest; rows kx..kp-1 are zeros
  const int half = n >> 1;
  const i64 out0 = ((i64)b * kp * nz + z) * nx + c;
  for (int k = j; k < kp; k += T) {
    float2 vr = make_float2(0.f, 0.f), vi = vr;
    if (k <= half)
      untangle(from_smem(k), from_smem(k == 0 ? 0 : n - k), vr, vi);
    if (ok) {
      const i64 o = out0 + (i64)k * nz * nx;
      *reinterpret_cast<float2*>(re + o) = vr;
      *reinterpret_cast<float2*>(im + o) = vi;
    }
  }
}

// -- K2 -------------------------------------------------------------------------

// re, im: (nb, kp, nz, nx).  mul (read with MUL only), out: (planes, ny, nx).
template <bool MUL>
__global__ void __launch_bounds__(MAX_THREADS, 2)
rdft_y_inv_fft(const float* __restrict__ re, const float* __restrict__ im,
               const float2* __restrict__ tw, const float* __restrict__ mul,
               float* __restrict__ out, int nz, int nx, int kp, int tiles,
               Plan pl, int T, int lp, float scale) {
  extern __shared__ float2 smem[];
  const int n = pl.n, P = 1 << lp;
  const int pc = threadIdx.x & (P - 1), j = threadIdx.x >> lp;
  const int a = blockIdx.x / tiles, tile = blockIdx.x - a * tiles;
  const int b = a / nz, z = a - b * nz;
  const int c = (tile * P + pc) * 2;
  const bool ok = c < nx;
  const i64 out0 = (i64)a * n * nx + c;
  float2* cur = smem + pc;
  float2* nxt = cur + (n << lp);

  auto from_smem = [&](int e) -> float2 { return cur[e << lp]; };
  auto to_smem = [&](int e, float2 v) { nxt[e << lp] = v; };
  auto finish = [&](float2 v, i64 o) -> float2 {   // 1/ny and |mul * y|
    v.x *= scale;
    v.y *= scale;
    if (MUL) {
      const float2 m = __ldg(reinterpret_cast<const float2*>(mul + o));
      v.x = fabsf(m.x * v.x);
      v.y = fabsf(m.y * v.y);
    }
    return v;
  };
  auto store = [&](int e, float2 v) {
    if (ok) *reinterpret_cast<float2*>(out + out0 + (i64)e * nx) = v;
  };
  auto to_global = [&](int e, float2 v) {   // the generic pass: row by row
    if (ok) store(e, finish(v, out0 + (i64)e * nx));
  };
  // A butterfly's outputs finished together, every mul loaded before the
  // first store: stored row by row, each load waited behind the store before
  // it.
  auto finish_all = [&](int base, int S, auto& v) {
    constexpr int R = sizeof(v) / sizeof(v[0]);
    if (!ok) return;
#pragma unroll
    for (int k = 0; k < R; ++k)
      v[k] = finish(v[k], out0 + (i64)(base + S * k) * nx);
  };
  auto flip = [&]() {
    float2* t = cur;
    cur = nxt;
    nxt = t;
    __syncthreads();
  };

  // tangle: each of the kx rows read once, Z[k] and Z[ny-k] written
  const int half = n >> 1;
  const i64 in0 = ((i64)b * kp * nz + z) * nx + c;
  // (TANGLE_ROWS rows a thread at a time, all their loads before any use)
  for (int k0 = j; k0 <= half; k0 += TANGLE_ROWS * T) {
    float2 vr[TANGLE_ROWS], vi[TANGLE_ROWS];
#pragma unroll
    for (int u = 0; u < TANGLE_ROWS; ++u) {
      const int k = k0 + u * T;
      vr[u] = vi[u] = make_float2(0.f, 0.f);
      if (ok && k <= half) {
        const i64 o = in0 + (i64)k * nz * nx;
        vr[u] = __ldg(reinterpret_cast<const float2*>(re + o));
        vi[u] = __ldg(reinterpret_cast<const float2*>(im + o));
      }
    }
#pragma unroll
    for (int u = 0; u < TANGLE_ROWS; ++u) {
      const int k = k0 + u * T;
      if (k > half) break;
      const bool edge = k == 0 || k == half;
      float2 zk, zm;
      tangle(vr[u], vi[u], edge, zk, zm);
      to_smem(k, zk);
      if (!edge) to_smem(n - k, zm);
    }
  }
  flip();

  const int last = pl.npass - 1;
  int S = 1;
  for (int p = 0; p < last; ++p) {
    const int R = pl.radix[p];
    any_pass<true>(R, j, T, pass_args(n, R, S), tw, from_smem, to_smem);
    S *= R;
    flip();
  }
  const int R = pl.radix[last];
  if (pl.generic)
    generic_pass<true>(j, T, R, S, tw, from_smem, to_global);
  else
    any_pass<true>(R, j, T, pass_args(n, R, S), tw, from_smem, store,
                   finish_all);
}

// -- launch ---------------------------------------------------------------------

// What both launches check; fills the geometry and the grid.
inline cudaError_t prepare(const Plan& pl, int nb, int nz, int nx, int kp,
                           int tpp, int pairs, Geo& g, int& tiles,
                           unsigned& blocks) {
  const int ny = pl.n;
  if (!plan_ok(pl) || ny > MAX_NY || ny % 8 || nx < 2 || nx % 2 || nb < 1 ||
      nz < 1 || kp < ny / 2 + 1)
    return cudaErrorInvalidValue;
  if (pairs > 0 && (pairs > MAX_PAIRS || (pairs & (pairs - 1))))
    return cudaErrorInvalidValue;
  g = geometry(pl, tpp, pairs);
  if (g.smem > ippdft::SMEM_LIMIT || g.T * g.P > MAX_THREADS)
    return cudaErrorInvalidValue;
  tiles = (nx / 2 + g.P - 1) / g.P;
  const i64 total = (i64)nb * nz * tiles;
  if (total > 2147483647LL) return cudaErrorInvalidValue;
  blocks = (unsigned)total;
  return cudaSuccess;
}

template <class Kernel>
inline cudaError_t allow_smem(Kernel kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  // per device, so set on every launch: it costs no device time
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

inline cudaError_t launch_fwd(const float* num, const float* den,
                              const float2* tw, float* re, float* im, int nb,
                              int nz, int nx, int kp, const Plan& pl, int tpp,
                              int pairs, cudaStream_t st) {
  Geo g;
  int tiles;
  unsigned blocks;
  cudaError_t e = prepare(pl, nb, nz, nx, kp, tpp, pairs, g, tiles, blocks);
  if (e != cudaSuccess) return e;
  auto kernel = den != nullptr ? rdft_y_fwd_fft<true> : rdft_y_fwd_fft<false>;
  e = allow_smem(kernel, g.smem);
  if (e != cudaSuccess) return e;
  kernel<<<blocks, g.T * g.P, g.smem, st>>>(num, den, tw, re, im, nz, nx, kp,
                                            tiles, pl, g.T, g.lp);
  return cudaGetLastError();
}

inline cudaError_t launch_inv(const float* re, const float* im,
                              const float2* tw, const float* mul, float* out,
                              int nb, int nz, int nx, int kp, const Plan& pl,
                              int tpp, int pairs, cudaStream_t st) {
  Geo g;
  int tiles;
  unsigned blocks;
  cudaError_t e = prepare(pl, nb, nz, nx, kp, tpp, pairs, g, tiles, blocks);
  if (e != cudaSuccess) return e;
  auto kernel = mul != nullptr ? rdft_y_inv_fft<true> : rdft_y_inv_fft<false>;
  e = allow_smem(kernel, g.smem);
  if (e != cudaSuccess) return e;
  kernel<<<blocks, g.T * g.P, g.smem, st>>>(re, im, tw, mul, out, nz, nx, kp,
                                            tiles, pl, g.T, g.lp,
                                            1.f / (float)pl.n);
  return cudaGetLastError();
}

#endif  // __CUDACC__

}  // namespace ipprdft
