// The four kernels of the FFT convolve walk (v2-t layout), for Hopper.
//
// The walk of one circular convolution of a (nz, ny, nx) f32 volume:
//   (nz, ny, nx)  --K1 y real DFT (optionally of num / max(den, eps))-->
//   (kp, nz, nx)  --K3 radix-2 stage over z (middle axis)-->
//   (kp, Z, nx)   --K3 radix-2 stage over x (last axis)-->     spectrum
//   spectrum      --K4 OTF product + inverse radix-2 stage over x-->
//   (kp, Z, nx)   --K3 inverse radix-2 stage over z-->
//   (kp, nz, nx)  --K2 inverse y real DFT (optionally |mul * y|)--> volume
// kp = round8(ny/2 + 1).  Spectra along z and x stay in the radix-2
// permuted order (X[2k+s] at s*m + k); the OTF comes from the same walk.
//
// Each kernel is one GEMM against a constant DFT matrix (fft_walk.cuh)
// with its prologue/epilogue fused, so the ratio, the butterflies and the
// spectral product never reach device memory.  What bounds them on the
// card: the contraction depth is K = ny (K1), 2kp (K2) or m = n/2 (K3,
// K4), at least 128, so every kernel does >= 32 FMAs per byte it moves and
// is bound by f32 FMA issue and shared-memory reads, not HBM.  The design
// answers with 4x4 register tiles (4 FMAs per shared load); wgmma, TMA and
// 3xTF32 splits are later work.
//
// Plain C interface for ctypes: each entry launches on the given stream
// and returns cudaGetLastError() of its launch.

#include "fft_walk.cuh"

using namespace ippfft;

// ---------------------------------------------------------------------------
// K1 — replaces ipp_tpu/ops/pallas_fft.py `_v2_rfft_call_t` (kernel
// `_v2_rfft_kernel_t`) and, with RATIO, `_v2_rfft_ratio_call_t`
// (`_v2_rfft_ratio_kernel_t`).  Per z: C (2kp x nx) = fwd (2kp x ny) @ x[z]
// (ny x nx), rows [0, kp) to re[:, z, :], rows [kp, 2kp) to im[:, z, :].
// fwd's rows kx..kp-1 are zero, so those outputs are exactly 0.  With
// RATIO the input is num / max(den, FLT_EPSILON), formed in the load.
// Bound: FMA issue (2kp * ny * nz * nx FMAs); the x tile is read once per
// 64 output rows, from L2 after the first row block.
template <bool RATIO>
__global__ void __launch_bounds__(NT)
rdft_y_fwd(const float* __restrict__ num, const float* __restrict__ den,
           const float* __restrict__ fwd, float* __restrict__ re,
           float* __restrict__ im, int nz, int ny, int nx, int kp) {
  __shared__ float sa[BK * BMP];
  __shared__ float sb[BK * BNP];
  const int c0 = blockIdx.x * BN, r0 = blockIdx.y * BM, z = blockIdx.z;
  const int tx = threadIdx.x % (BN / TN), ty = threadIdx.x / (BN / TN);
  const int M = 2 * kp;
  const i64 zoff = (i64)z * ny * nx;
  float acc[TM][TN];
  zero(acc);
  for (int k0 = 0; k0 < ny; k0 += BK) {
    load_a_tile(sa, fwd, M, ny, r0, k0);
    load_b_tile(sb, k0, c0, [&](int k, int c) -> float {
      if (k >= ny || c >= nx) return 0.f;
      const i64 off = zoff + (i64)k * nx + c;
      float v = num[off];
      if (RATIO) v = v / fmaxf(den[off], FLT_EPSILON);
      return v;
    });
    __syncthreads();
    mma_real(acc, sa, sb, ty, tx);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = r0 + ty * TM + i;
    if (r >= M) continue;
    float* dst = r < kp ? re + ((i64)r * nz + z) * nx
                        : im + ((i64)(r - kp) * nz + z) * nx;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = c0 + tx * TN + j;
      if (c < nx) dst[c] = acc[i][j];
    }
  }
}

// ---------------------------------------------------------------------------
// K2 — replaces `_v2_irfft_call_t` (`_v2_irfft_kernel_t`) and, with MUL,
// `_v2_irfft_mul_call_t` (`_v2_irfft_mul_kernel_t`).  Per z: y (ny x nx) =
// inv (ny x 2kp) @ [re[:, z, :]; im[:, z, :]] (Hermitian fold, 1/ny in
// inv); with MUL the output is |mul[z] * y| (the RL update, decon.m:171).
// Bound: FMA issue (ny * 2kp * nz * nx FMAs).
template <bool MUL>
__global__ void __launch_bounds__(NT)
rdft_y_inv(const float* __restrict__ re, const float* __restrict__ im,
           const float* __restrict__ inv, const float* __restrict__ mul,
           float* __restrict__ out, int nz, int ny, int nx, int kp) {
  __shared__ float sa[BK * BMP];
  __shared__ float sb[BK * BNP];
  const int c0 = blockIdx.x * BN, r0 = blockIdx.y * BM, z = blockIdx.z;
  const int tx = threadIdx.x % (BN / TN), ty = threadIdx.x / (BN / TN);
  const int K = 2 * kp;
  float acc[TM][TN];
  zero(acc);
  for (int k0 = 0; k0 < K; k0 += BK) {
    load_a_tile(sa, inv, ny, K, r0, k0);
    load_b_tile(sb, k0, c0, [&](int k, int c) -> float {
      if (k >= K || c >= nx) return 0.f;
      return k < kp ? re[((i64)k * nz + z) * nx + c]
                    : im[((i64)(k - kp) * nz + z) * nx + c];
    });
    __syncthreads();
    mma_real(acc, sa, sb, ty, tx);
    __syncthreads();
  }
  const i64 zoff = (i64)z * ny * nx;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = r0 + ty * TM + i;
    if (r >= ny) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = c0 + tx * TN + j;
      if (c >= nx) continue;
      const i64 off = zoff + (i64)r * nx + c;
      out[off] = MUL ? fabsf(mul[off] * acc[i][j]) : acc[i][j];
    }
  }
}

// ---------------------------------------------------------------------------
// K3 forward — replaces `_v2_stage_call(forward=True)` (kernel
// `_v2_stage_fwd_kernel`, z: the middle axis of (kp, nz, nx)) and
// `fused_stage(forward=True)` -> `_fused_stage_call` (`_stage_fwd_kernel`,
// x: the last axis of (kp*nz, nx)).  Radix-2 decimation in frequency:
// u_s[t] = x[t] +/- x[t+m] (the butterfly, formed in the load), then
// out[s*m + k] = sum_t M_s[t, k] u_s[t] with the twiddle-folded m x m
// matrices (mr, mi hold M_s^T, stacked (2, m, m)).  A block owns one s and
// 64 values of k.  m = n/2 need only be a multiple of 64 (768 -> 384).
// Element (t, c) of batch b sits at b*bs + t*ldk + c*ldc; K_FAST marks the
// last-axis form (ldk == 1).  Bound: FMA issue (2 m^2 complex terms per
// column); the last-axis form also pays strided stores.
template <bool K_FAST>
__global__ void __launch_bounds__(NT)
radix2_fwd(const float* __restrict__ xr, const float* __restrict__ xi,
           const float* __restrict__ mr, const float* __restrict__ mi,
           float* __restrict__ rr, float* __restrict__ ii, int n, int ncols,
           i64 bs, i64 ldk, i64 ldc) {
  __shared__ float sar[BK * BMP], sai[BK * BMP];
  __shared__ float sbr[BK * BNP], sbi[BK * BNP];
  const int m = n / 2, tiles = m / BM;
  const int s = blockIdx.y / tiles, r0 = (blockIdx.y % tiles) * BM;
  const int c0 = blockIdx.x * BN;
  const int tx = threadIdx.x % (BN / TN), ty = threadIdx.x / (BN / TN);
  const i64 base = (i64)blockIdx.z * bs;
  const float* Ar = mr + (i64)s * m * m;
  const float* Ai = mi + (i64)s * m * m;
  const float sgn = s ? -1.f : 1.f;
  float accr[TM][TN], acci[TM][TN];
  zero(accr);
  zero(acci);
  for (int k0 = 0; k0 < m; k0 += BK) {
    load_a_tile(sar, Ar, m, m, r0, k0);
    load_a_tile(sai, Ai, m, m, r0, k0);
    load_b_tile2<K_FAST>(sbr, sbi, k0, c0, [&](int t, int c) -> float2 {
      if (t >= m || c >= ncols) return make_float2(0.f, 0.f);
      const i64 a = base + (i64)t * ldk + (i64)c * ldc;
      const i64 b = a + (i64)m * ldk;
      return make_float2(xr[a] + sgn * xr[b], xi[a] + sgn * xi[b]);
    });
    __syncthreads();
    mma_cplx(accr, acci, sar, sai, sbr, sbi, ty, tx);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int k = r0 + ty * TM + i;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = c0 + tx * TN + j;
      if (k >= m || c >= ncols) continue;
      const i64 o = base + (i64)(s * m + k) * ldk + (i64)c * ldc;
      rr[o] = accr[i][j];
      ii[o] = acci[i][j];
    }
  }
}

// ---------------------------------------------------------------------------
// K3 inverse — replaces `_v2_stage_call(forward=False)` (kernel
// `_v2_stage_inv_kernel`, z: the middle axis).  K4 (OTF = true) replaces
// `fused_stage_inv_otf` -> `_fused_stage_otf_call` (kernel
// `_make_stage_inv_otf_kernel(conj)`): the input is first multiplied by
// otf_re +/- i*otf_im (conj for the RL adjoint), in the load, so the
// spectral product never reaches device memory.
// v_s[k] = sum_t Minv_s[k, t] x[s*m + t] for both s in one block, then
// out[k] = (v0 + v1)/2, out[m+k] = (v0 - v1)/2 (1/m lives in Minv).
// Bound: FMA issue (2 m^2 complex terms per column); K4 also reads the
// OTF (two more f32 streams) once per column tile.
template <bool K_FAST, bool OTF, bool CONJ>
__global__ void __launch_bounds__(NT)
radix2_inv(const float* __restrict__ xr, const float* __restrict__ xi,
           const float* __restrict__ otr, const float* __restrict__ oti,
           const float* __restrict__ mr, const float* __restrict__ mi,
           float* __restrict__ rr, float* __restrict__ ii, int n, int ncols,
           i64 bs, i64 ldk, i64 ldc) {
  __shared__ float sa[4][BK * BMP];   // Mr0, Mi0, Mr1, Mi1
  __shared__ float sb[4][BK * BNP];   // x0 re, x0 im, x1 re, x1 im
  const int m = n / 2;
  const int r0 = blockIdx.y * BM, c0 = blockIdx.x * BN;
  const int tx = threadIdx.x % (BN / TN), ty = threadIdx.x / (BN / TN);
  const i64 base = (i64)blockIdx.z * bs;
  float a0r[TM][TN], a0i[TM][TN], a1r[TM][TN], a1i[TM][TN];
  zero(a0r);
  zero(a0i);
  zero(a1r);
  zero(a1i);
  for (int k0 = 0; k0 < m; k0 += BK) {
    load_a_tile(sa[0], mr, m, m, r0, k0);
    load_a_tile(sa[1], mi, m, m, r0, k0);
    load_a_tile(sa[2], mr + (i64)m * m, m, m, r0, k0);
    load_a_tile(sa[3], mi + (i64)m * m, m, m, r0, k0);
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      load_b_tile2<K_FAST>(sb[2 * s], sb[2 * s + 1], k0, c0,
                           [&](int t, int c) -> float2 {
        if (t >= m || c >= ncols) return make_float2(0.f, 0.f);
        const i64 a = base + (i64)(s * m + t) * ldk + (i64)c * ldc;
        const float vr = xr[a], vi = xi[a];
        if (!OTF) return make_float2(vr, vi);
        const float o_r = otr[a];
        const float o_i = CONJ ? -oti[a] : oti[a];
        return make_float2(vr * o_r - vi * o_i, vr * o_i + vi * o_r);
      });
    }
    __syncthreads();
    mma_cplx(a0r, a0i, sa[0], sa[1], sb[0], sb[1], ty, tx);
    mma_cplx(a1r, a1i, sa[2], sa[3], sb[2], sb[3], ty, tx);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int k = r0 + ty * TM + i;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = c0 + tx * TN + j;
      if (k >= m || c >= ncols) continue;
      const i64 lo = base + (i64)k * ldk + (i64)c * ldc;
      const i64 hi = lo + (i64)m * ldk;
      rr[lo] = (a0r[i][j] + a1r[i][j]) * 0.5f;
      rr[hi] = (a0r[i][j] - a1r[i][j]) * 0.5f;
      ii[lo] = (a0i[i][j] + a1i[i][j]) * 0.5f;
      ii[hi] = (a0i[i][j] - a1i[i][j]) * 0.5f;
    }
  }
}

// ---------------------------------------------------------------------------
// C interface.

static inline unsigned cdiv(long long a, long long b) {
  return (unsigned)((a + b - 1) / b);
}

extern "C" {

// den == nullptr: plain y DFT of num; otherwise of num / max(den, eps).
int ipp_rdft_y_fwd(const float* num, const float* den, const float* fwd,
                   float* re, float* im, int nz, int ny, int nx, int kp,
                   void* stream) {
  const dim3 grid(cdiv(nx, BN), cdiv(2 * kp, BM), nz);
  cudaStream_t st = (cudaStream_t)stream;
  if (den) {
    rdft_y_fwd<true><<<grid, NT, 0, st>>>(num, den, fwd, re, im, nz, ny, nx, kp);
  } else {
    rdft_y_fwd<false><<<grid, NT, 0, st>>>(num, den, fwd, re, im, nz, ny, nx, kp);
  }
  return (int)cudaGetLastError();
}

// mul == nullptr: plain inverse y DFT; otherwise |mul * y|.
int ipp_rdft_y_inv(const float* re, const float* im, const float* inv,
                   const float* mul, float* out, int nz, int ny, int nx, int kp,
                   void* stream) {
  const dim3 grid(cdiv(nx, BN), cdiv(ny, BM), nz);
  cudaStream_t st = (cudaStream_t)stream;
  if (mul) {
    rdft_y_inv<true><<<grid, NT, 0, st>>>(re, im, inv, mul, out, nz, ny, nx, kp);
  } else {
    rdft_y_inv<false><<<grid, NT, 0, st>>>(re, im, inv, mul, out, nz, ny, nx, kp);
  }
  return (int)cudaGetLastError();
}

// Radix-2 stage along an axis of length n (n/2 a multiple of 64) over
// `batch` x `ncols` columns.  ldk == 1 is the last-axis form (forward
// only: the walk's inverse stages over x carry the OTF, K4).
int ipp_radix2_stage(const float* xr, const float* xi, const float* mr,
                     const float* mi, float* rr, float* ii, int forward,
                     int batch, int n, int ncols, long long bs, long long ldk,
                     long long ldc, void* stream) {
  const int m = n / 2;
  cudaStream_t st = (cudaStream_t)stream;
  if (forward) {
    const dim3 grid(cdiv(ncols, BN), 2 * (m / BM), batch);
    if (ldk == 1) {
      radix2_fwd<true><<<grid, NT, 0, st>>>(xr, xi, mr, mi, rr, ii, n, ncols, bs, ldk, ldc);
    } else {
      radix2_fwd<false><<<grid, NT, 0, st>>>(xr, xi, mr, mi, rr, ii, n, ncols, bs, ldk, ldc);
    }
  } else {
    if (ldk == 1) return (int)cudaErrorNotSupported;
    const dim3 grid(cdiv(ncols, BN), m / BM, batch);
    radix2_inv<false, false, false><<<grid, NT, 0, st>>>(
        xr, xi, nullptr, nullptr, mr, mi, rr, ii, n, ncols, bs, ldk, ldc);
  }
  return (int)cudaGetLastError();
}

// OTF product + inverse radix-2 stage along the last axis of (rows, n).
int ipp_radix2_stage_inv_otf(const float* xr, const float* xi, const float* otr,
                             const float* oti, const float* mr, const float* mi,
                             float* rr, float* ii, int conj, int rows, int n,
                             void* stream) {
  const int m = n / 2;
  const dim3 grid(cdiv(rows, BN), m / BM, 1);
  cudaStream_t st = (cudaStream_t)stream;
  if (conj) {
    radix2_inv<true, true, true><<<grid, NT, 0, st>>>(
        xr, xi, otr, oti, mr, mi, rr, ii, n, rows, 0, 1, n);
  } else {
    radix2_inv<true, true, false><<<grid, NT, 0, st>>>(
        xr, xi, otr, oti, mr, mi, rr, ii, n, rows, 0, 1, n);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
