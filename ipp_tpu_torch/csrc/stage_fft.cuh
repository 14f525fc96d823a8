// The radix-2 stage of the FFT walks as a real FFT kernel (K3, K4, K6).
//
// The function (fft_walk.cu): the n-point complex DFT along one axis, the
// spectrum stored in the walk's permuted order, X[f] at (f & 1) * n/2 +
// (f >> 1).  It moves every value once in and once out and does
// 5 n log2 n FLOPs per transform, so on this card it is bound by bytes.
// The TPU kernels it replaces (pallas_fft.py `_v2_stage_fwd_kernel`,
// `_v2_stage_inv_kernel`, `_stage_fwd_kernel`, `_stage_inv_kernel`,
// `_make_stage_inv_otf_kernel`) spend O(n) multiply-adds per value on the
// matrix unit; on CUDA cores that is bound by the FMA rate, 8-10x above the
// bytes.  This kernel does O(log n): one block holds whole transforms in
// shared memory, reads each value from device memory once, runs every pass
// in registers and shared memory, and writes each value once.
//
// Algorithm: Stockham autosort, decimation in frequency, mixed radix.  Pass
// P with radix R and stride S (the product of the earlier radices), on
// butterfly i of n/R (q = i % S, p = i / S):
//     a_k = x[i + k * n/R]                                   k = 0..R-1
//     y[q + S * (R * p + k)] = w^(p * k * S) * sum_j a_j * wR^(j * k)
// with w = exp(-+2 pi i / n) from a table (float64, rounded to f32;
// ops/dft_mats.stage_twiddles) and wR = w^(n/R).  After the last pass the
// spectrum is in natural order; the walk's permutation is an index map on
// the global store (forward) or load (inverse), two contiguous runs per
// row.  The plan is 8, 8, then 4 or 8, then the rest (3, 4, 5, 7): the odd
// factor comes last, so every S is a power of two and q, p are shifts.
//
// The first pass loads from device memory straight into registers (with
// the OTF product for K4: the product never reaches memory) and the last
// stores straight from registers, so shared memory sees only the
// exchanges between passes.  A thread holds G = 8 (or 16) values; one
// column takes n/G threads.
//
// Two layouts, as the dense kernels:
//   K_FAST  (R, n), the transform along the contiguous axis: a block takes
//           a few rows; lanes run along the butterfly index, so loads and
//           stores are coalesced along n; shared memory holds row-major
//           rows with an XOR swizzle of the low 5 index bits that makes
//           the stride-8 writes of the first pass and the 8-runs at stride
//           64 of the second free of bank conflicts.
//   !K_FAST (P, n, X), x contiguous: a block takes all n of COLS (8 or 16)
//           neighbouring x; lanes run along x first, so each row of the
//           tile is a 32 or 64 byte run; shared memory is (n, COLS) with
//           the low index bits XORed by bits 3.. so that the 32 / COLS
//           butterflies of a warp fall in different banks.
// A column's arithmetic depends on n alone, never on its tile or batch.

#pragma once

#include <cuda_runtime.h>

namespace ippsfft {

typedef long long i64;

enum Mode { FWD = 0, INV = 1, INV_OTF = 2 };

// -- the plan ----------------------------------------------------------------

__host__ __device__ constexpr int radix(int n, int p) {
  if (p < 2) return 8;
  const int rest = n / 64;  // 4, 8, 12, 16, 20, 24, 28, 32
  const int third = (rest == 8 || rest == 24 || rest == 32) ? 8 : 4;
  if (p == 2) return third;
  return p == 3 ? rest / third : 1;
}

__host__ __device__ constexpr int npass(int n) {
  return radix(n, 3) > 1 ? 4 : 3;
}

__host__ __device__ constexpr int stride(int n, int p) {
  return p == 0 ? 1 : stride(n, p - 1) * radix(n, p - 1);
}

template <int N, bool K_FAST>
struct Geo {
  static constexpr int G = K_FAST ? 8 : (N >= 512 ? 16 : 8);
  static constexpr int T = N / G;  // threads per column
  static constexpr int COLS =
      K_FAST ? (T >= 256 ? 1 : 256 / T) : (N <= 768 ? 16 : 8);
  static constexpr int NT = T * COLS;
  static constexpr int SMEM = 2 * N * COLS * (int)sizeof(float);
};

// -- complex helpers ---------------------------------------------------------

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ float2 cmul(float2 a, float2 w) {
  return make_float2(fmaf(a.x, w.x, -a.y * w.y), fmaf(a.x, w.y, a.y * w.x));
}
// a * (-i) forward, a * (+i) inverse: a quarter turn in the transform's sense
template <bool INV>
__device__ __forceinline__ float2 quarter(float2 a) {
  return INV ? make_float2(-a.y, a.x) : make_float2(a.y, -a.x);
}

template <bool INV>
__device__ __forceinline__ void dft4(float2& a0, float2& a1, float2& a2,
                                     float2& a3) {
  const float2 t0 = cadd(a0, a2), t1 = csub(a0, a2);
  const float2 t2 = cadd(a1, a3), t3 = quarter<INV>(csub(a1, a3));
  a0 = cadd(t0, t2);
  a1 = cadd(t1, t3);
  a2 = csub(t0, t2);
  a3 = csub(t1, t3);
}

// In-place R-point DFT of v (sign of the exponent: - forward, + inverse).
template <int R, bool INV, int N>
__device__ __forceinline__ void dft(float2 (&v)[R],
                                    const float2* __restrict__ tw) {
  if constexpr (R == 4) {
    dft4<INV>(v[0], v[1], v[2], v[3]);
  } else if constexpr (R == 8) {
    constexpr float H = 0.70710678118654752440f;
    float2 e[4], o[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      e[j] = cadd(v[j], v[j + 4]);
      o[j] = csub(v[j], v[j + 4]);
    }
    // o[j] *= w8^j: 1, (1 -+ i)/sqrt2, -+i, (-1 -+ i)/sqrt2
    const float2 q1 = quarter<INV>(o[1]), q3 = quarter<INV>(o[3]);
    o[1] = make_float2((o[1].x + q1.x) * H, (o[1].y + q1.y) * H);
    o[2] = quarter<INV>(o[2]);
    o[3] = make_float2((q3.x - o[3].x) * H, (q3.y - o[3].y) * H);
    dft4<INV>(e[0], e[1], e[2], e[3]);
    dft4<INV>(o[0], o[1], o[2], o[3]);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[2 * j] = e[j];
      v[2 * j + 1] = o[j];
    }
  } else {  // 3, 5, 7: the dense R x R product, roots from the table
    float2 a[R];
#pragma unroll
    for (int j = 0; j < R; ++j) a[j] = v[j];
#pragma unroll
    for (int k = 0; k < R; ++k) {
      float2 acc = a[0];
#pragma unroll
      for (int j = 1; j < R; ++j) {
        if (k == 0) {
          acc = cadd(acc, a[j]);
        } else {
          float2 w = __ldg(&tw[((j * k) % R) * (N / R)]);
          if (INV) w.y = -w.y;
          acc = cadd(acc, cmul(a[j], w));
        }
      }
      v[k] = acc;
    }
  }
}

// -- one pass ----------------------------------------------------------------

// Thread j of its column's T runs butterflies j, j + T, ...: src(e) gives
// element e of the pass input, dst(e, value) takes element e of its output.
// A pass between two shared-memory buffers holds its results in registers
// across a barrier, so one buffer serves; every pass but the last ends
// with a barrier.
template <int N, int P, bool INV, int T, class Src, class Dst>
__device__ __forceinline__ void fft_pass(int j, const float2* __restrict__ tw,
                                         Src src, Dst dst) {
  constexpr int R = radix(N, P), S = stride(N, P), NB = N / R;
  constexpr int L = (NB + T - 1) / T;
  constexpr bool LAST = S * R == N;
  float2 v[L][R];
#pragma unroll
  for (int l = 0; l < L; ++l) {
    const int i = j + l * T;
    if (NB % T == 0 || i < NB) {
#pragma unroll
      for (int k = 0; k < R; ++k) v[l][k] = src(i + k * NB);
      dft<R, INV, N>(v[l], tw);
      if (!LAST) {
        const int p = i / S;
#pragma unroll
        for (int k = 1; k < R; ++k) {
          float2 w = __ldg(&tw[p * k * S]);
          if (INV) w.y = -w.y;
          v[l][k] = cmul(v[l][k], w);
        }
      }
    }
  }
  if (P > 0 && !LAST) __syncthreads();
#pragma unroll
  for (int l = 0; l < L; ++l) {
    const int i = j + l * T;
    if (NB % T == 0 || i < NB) {
      const int q = i % S, p = i / S;
#pragma unroll
      for (int k = 0; k < R; ++k) dst(q + S * (R * p + k), v[l][k]);
    }
  }
  if (!LAST) __syncthreads();
}

// -- the kernel --------------------------------------------------------------

// Position of frequency f in the walk's permuted order.
template <int N>
__device__ __forceinline__ int permuted(int f) {
  return (f & 1) * (N / 2) + (f >> 1);
}

// K_FAST: xr, xi, rr, ii are (ncols, N) and `ncols` counts rows; otherwise
// (gridDim.y, N, ncols).  MODE FWD: natural in, permuted out.  INV:
// permuted in, natural out, times 1/N.  INV_OTF (K_FAST only): the input is
// first multiplied by otr + osign * i * oti, row r of the data taking row
// r % orows of the OTF (one modulo per row a block owns).
template <int N, bool K_FAST, int MODE>
__global__ void __launch_bounds__(Geo<N, K_FAST>::NT)
stage_fft(const float* __restrict__ xr, const float* __restrict__ xi,
          const float* __restrict__ otr, const float* __restrict__ oti,
          const float2* __restrict__ tw, float* __restrict__ rr,
          float* __restrict__ ii, i64 ncols, int orows, float osign) {
  typedef Geo<N, K_FAST> G;
  constexpr bool INV = MODE != FWD;
  constexpr int T = G::T, COLS = G::COLS, NP = npass(N);
  extern __shared__ float smem[];
  float* sr = smem;
  float* si = smem + N * COLS;

  // this thread's column, its index j among the column's threads
  const int c = K_FAST ? threadIdx.x / T : threadIdx.x % COLS;
  const int j = K_FAST ? threadIdx.x % T : threadIdx.x / COLS;
  const i64 col = (i64)blockIdx.x * COLS + c;
  const bool ok = col < ncols;
  const i64 ld = K_FAST ? 1 : ncols;
  const i64 base = K_FAST ? col * N : (i64)blockIdx.y * N * ncols + col;
  const i64 obase = MODE == INV_OTF ? (col % orows) * N : 0;

  auto at = [&](int e) -> int {  // shared-memory slot of element e
    if (K_FAST) {
      const int b = e >> 5;
      return c * N + (e ^ ((b & 7) ^ (((b >> 1) & 3) << 3)));
    }
    return (e ^ ((e >> 3) & (32 / COLS - 1))) * COLS + c;
  };
  auto from_smem = [&](int e) -> float2 {
    const int a = at(e);
    return make_float2(sr[a], si[a]);
  };
  auto to_smem = [&](int e, float2 v) {
    const int a = at(e);
    sr[a] = v.x;
    si[a] = v.y;
  };
  auto from_global = [&](int e) -> float2 {
    if (!ok) return make_float2(0.f, 0.f);
    const int pos = INV ? permuted<N>(e) : e;
    const i64 a = base + (i64)pos * ld;
    float2 v = make_float2(xr[a], xi[a]);
    if (MODE == INV_OTF) {
      const i64 o = obase + pos;
      v = cmul(v, make_float2(otr[o], osign * oti[o]));
    }
    return v;
  };
  auto to_global = [&](int e, float2 v) {
    if (!ok) return;
    const int pos = INV ? e : permuted<N>(e);
    const i64 a = base + (i64)pos * ld;
    constexpr float scale = INV ? 1.f / N : 1.f;
    rr[a] = v.x * scale;
    ii[a] = v.y * scale;
  };

  fft_pass<N, 0, INV, T>(j, tw, from_global, to_smem);
  fft_pass<N, 1, INV, T>(j, tw, from_smem, to_smem);
  if constexpr (NP == 3) {
    fft_pass<N, 2, INV, T>(j, tw, from_smem, to_global);
  } else {
    fft_pass<N, 2, INV, T>(j, tw, from_smem, to_smem);
    fft_pass<N, 3, INV, T>(j, tw, from_smem, to_global);
  }
}

// -- launch ------------------------------------------------------------------

template <int N, bool K_FAST, int MODE>
inline cudaError_t launch(const float* xr, const float* xi, const float* otr,
                          const float* oti, const float2* tw, float* rr,
                          float* ii, i64 batch, i64 ncols, int orows,
                          float osign, cudaStream_t st) {
  typedef Geo<N, K_FAST> G;
  auto kernel = stage_fft<N, K_FAST, MODE>;
  if (G::SMEM > 48 * 1024) {
    // per device, so set on every launch: it costs no device time
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((unsigned)((ncols + G::COLS - 1) / G::COLS), (unsigned)batch,
                  1);
  kernel<<<grid, G::NT, G::SMEM, st>>>(xr, xi, otr, oti, tw, rr, ii, ncols,
                                       orows, osign);
  return cudaGetLastError();
}

// Dispatch on the axis length: the eight lengths 256 * j the walks admit.
template <bool K_FAST, int MODE>
inline cudaError_t launch_n(int n, const float* xr, const float* xi,
                            const float* otr, const float* oti,
                            const float2* tw, float* rr, float* ii, i64 batch,
                            i64 ncols, int orows, float osign,
                            cudaStream_t st) {
#define IPP_STAGE_N(len)                                                     \
  case len:                                                                  \
    return launch<len, K_FAST, MODE>(xr, xi, otr, oti, tw, rr, ii, batch,    \
                                     ncols, orows, osign, st);
  switch (n) {
    IPP_STAGE_N(256)
    IPP_STAGE_N(512)
    IPP_STAGE_N(768)
    IPP_STAGE_N(1024)
    IPP_STAGE_N(1280)
    IPP_STAGE_N(1536)
    IPP_STAGE_N(1792)
    IPP_STAGE_N(2048)
  }
#undef IPP_STAGE_N
  return cudaErrorInvalidValue;
}

}  // namespace ippsfft
