// The dense forms of the radix-2 stages of the FFT convolve walks (K3,
// K4, K6), for Hopper.
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
// A batch of nb volumes (nb, nz, ny, nx) runs the same walk with each
// block's spectrum kp-major, (nb, kp, nz, nx): K1 stores and K2 loads
// with a batch stride, K3 sees nb*kp planes, and K4 wraps its OTF rows
// modulo one block's kp*nz, so one unbatched OTF serves every block.  The
// TPU's batched kernels wrote plane-major (nb*nz, kp, nx) instead, which
// Mosaic's block rule forced (pallas_fft.py:563-575), and paid an XLA
// transpose on each side of the z stage; a CUDA store has no such rule.
// For nb = 1 the layout is the unbatched (kp, nz, nx).
//
// Shapes outside the v2 walk's domain take the v1 walk (matmul_fft.py):
// the x axis as a plain f32 matmul, then one complex DFT stage per axis
// along the last axis of a layout that cycles (y, kxp, z) -> (Z, kxp, y).
// A stage on an axis of a 256-multiple length (with a 512-multiple row
// count) is a radix-2 stage: K3 forward, K6 inverse, or K4 where the OTF
// product precedes the inverse y stage; any other axis takes the dense
// DFT, K7: the FFT kernels of dft_fft.cuh and stage_large.cuh for the
// lengths with a plan, and for any other length or matrix the complex
// matmul of cplx_dense.cu (K7d, on the tensor cores, 3xTF32 wgmma).
//
// K1 and K2 compute a real DFT along y and its inverse: the volume and the
// half spectrum cross device memory once, 2.5 ny log2 ny FLOPs a column, so
// the function is bound by bytes.  For every shape the v2 walk admits (ny a
// multiple of 8 up to 2048, nx even) they are the real-FFT kernels of
// rdft_y.cuh (entries in rdft_y.cu), chosen by the wrappers when the caller
// states that its matrix is the real-DFT fold (ops/cuda_fft.rdft_route).
// Their dense form, one GEMM against the (2kp, ny) or (ny, 2kp) matrix as
// the TPU's matrix unit ran it, serves any other matrix and any other
// shape: rdft_dense.cu, on the tensor cores (3xTF32 wgmma).
//
// The radix-2 stages (K3, K4, K6) compute a whole n-point DFT per column:
// one read and one write of the spectrum, 5 n log2 n FLOPs, so the function
// is bound by bytes.  They are FFT kernels that move each value once: for
// n = 256 * j up to 2048 those of stage_fft.cuh (plans fixed at compile
// time; entries in stage_fft_fwd.cu, stage_fft_inv.cu, stage_fft_otf.cu),
// for every other multiple of 128 up to 12288 the mixed-radix kernel of
// stage_mixed.cuh (plan at run time; entry in stage_mixed.cu), above it
// the large-axis kernel of stage_large.cuh (every multiple of 128 up to
// 196608).  The stage kernels in this file are the dense form, a butterfly
// and two m x m complex products (m = n/2) as the TPU's matrix unit ran
// them: O(n) FMAs per value, bound by the FMA rate at 15-385x the bytes'
// time.  They serve the stage lengths without an FFT plan; the wrappers
// choose by n alone (ops/cuda_fft.stage_route).
//
// Plain C interface for ctypes: each entry launches on the given stream
// and returns cudaGetLastError() of its launch.

#include "fft_walk.cuh"

using namespace ippfft;

// ---------------------------------------------------------------------------
// K3 forward, dense form (stage lengths without an FFT plan; the FFT forms
// are stage_fft_fwd.cu, stage_mixed.cu and stage_large.cu) — replaces `_v2_stage_call(forward=True)` (kernel
// `_v2_stage_fwd_kernel`, z: the middle axis of (kp, nz, nx)) and
// `fused_stage(forward=True)` -> `_fused_stage_call` (`_stage_fwd_kernel`,
// x: the last axis of (kp*nz, nx)).  Radix-2 decimation in frequency:
// u_s[t] = x[t] +/- x[t+m] (the butterfly, formed in the load), then
// out[s*m + k] = sum_t M_s[t, k] u_s[t] with the twiddle-folded m x m
// matrices (mr, mi hold M_s^T, stacked (2, m, m)).  A block owns one s and
// 64 values of k.  m = n/2 need only be a multiple of 64 (768 -> 384).
// Element (t, c) of batch b sits at b*bs + t*ldk + c*ldc; K_FAST marks the
// last-axis form (ldk == 1).  The function is bound by bytes (the spectrum
// read and written once); this form is bound by the FMA rate (2 m^2 complex
// terms per column), and its last-axis form also pays strided stores.
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
// K3 inverse, K4 and K6, dense form (stage lengths without an FFT plan;
// the FFT forms are stage_fft_inv.cu, stage_fft_otf.cu, stage_mixed.cu and
// stage_large.cu).  K3 inverse
// replaces `_v2_stage_call(forward=False)` (kernel
// `_v2_stage_inv_kernel`, z: the middle axis).  K6 (K_FAST, OTF = false)
// replaces `_fused_stage_call(forward=False)` (kernel `_stage_inv_kernel`,
// pallas_fft.py:191): the v1 walk's inverse stage over the last axis of
// (R, n), K4 without its OTF prologue.  K4 (OTF = true) replaces
// `fused_stage_inv_otf` -> `_fused_stage_otf_call` (kernel
// `_make_stage_inv_otf_kernel(conj)`): the input is first multiplied by
// otf_re +/- i*otf_im (conj for the RL adjoint), in the load, so the
// spectral product never reaches device memory.  Data column c (a row of
// the (rows, n) operand) takes OTF row c % orows, as
// `_fused_stage_otf_call` wraps its OTF blocks (pallas_fft.py:296-300):
// a batch of blocks shares one block's OTF without a broadcast copy.
// orows is the data's row count or a multiple of BN, so a column tile
// lies in one OTF period and the wrap is one offset per thread block,
// not a modulo per loaded element.
// v_s[k] = sum_t Minv_s[k, t] x[s*m + t] for both s in one block, then
// out[k] = (v0 + v1)/2, out[m+k] = (v0 - v1)/2 (1/m lives in Minv).
// The function is bound by bytes (the spectrum read and written once; K4
// also reads the OTF, two more f32 streams); this form is bound by the FMA
// rate (2 m^2 complex terms per column), and its last-axis forms (K4, K6)
// load along the contiguous axis and pay strided stores.
template <bool K_FAST, bool OTF, bool CONJ>
__global__ void __launch_bounds__(NT)
radix2_inv(const float* __restrict__ xr, const float* __restrict__ xi,
           const float* __restrict__ otr, const float* __restrict__ oti,
           const float* __restrict__ mr, const float* __restrict__ mi,
           float* __restrict__ rr, float* __restrict__ ii, int n, int ncols,
           i64 bs, i64 ldk, i64 ldc, int orows) {
  __shared__ float sa[4][BK * BMP];   // Mr0, Mi0, Mr1, Mi1
  __shared__ float sb[4][BK * BNP];   // x0 re, x0 im, x1 re, x1 im
  const int m = n / 2;
  const int r0 = blockIdx.y * BM, c0 = blockIdx.x * BN;
  const int tx = threadIdx.x % (BN / TN), ty = threadIdx.x / (BN / TN);
  const i64 base = (i64)blockIdx.z * bs;
  const i64 owrap = base + (i64)(c0 / orows) * orows * ldc;
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
        const i64 o = a - owrap;
        const float o_r = otr[o];
        const float o_i = CONJ ? -oti[o] : oti[o];
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

// Radix-2 stage along an axis of length n (n/2 a multiple of 64) over
// `batch` x `ncols` columns.  ldk == 1 is the last-axis form: K3 forward,
// K6 inverse.
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
    const dim3 grid(cdiv(ncols, BN), m / BM, batch);
    if (ldk == 1) {
      radix2_inv<true, false, false><<<grid, NT, 0, st>>>(
          xr, xi, nullptr, nullptr, mr, mi, rr, ii, n, ncols, bs, ldk, ldc, 1);
    } else {
      radix2_inv<false, false, false><<<grid, NT, 0, st>>>(
          xr, xi, nullptr, nullptr, mr, mi, rr, ii, n, ncols, bs, ldk, ldc, 1);
    }
  }
  return (int)cudaGetLastError();
}

// OTF product + inverse radix-2 stage along the last axis of (rows, n);
// the OTF is (orows, n), rows a multiple of orows, and orows == rows or
// a multiple of BN (64).
int ipp_radix2_stage_inv_otf(const float* xr, const float* xi, const float* otr,
                             const float* oti, const float* mr, const float* mi,
                             float* rr, float* ii, int conj, int rows,
                             int orows, int n, void* stream) {
  const int m = n / 2;
  const dim3 grid(cdiv(rows, BN), m / BM, 1);
  cudaStream_t st = (cudaStream_t)stream;
  if (conj) {
    radix2_inv<true, true, true><<<grid, NT, 0, st>>>(
        xr, xi, otr, oti, mr, mi, rr, ii, n, rows, 0, 1, n, orows);
  } else {
    radix2_inv<true, true, false><<<grid, NT, 0, st>>>(
        xr, xi, otr, oti, mr, mi, rr, ii, n, rows, 0, 1, n, orows);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
