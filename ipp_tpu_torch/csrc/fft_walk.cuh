// Tiled f32 GEMM core of the FFT walk kernels (fft_walk.cu).
//
// Every kernel of the walk is a product C = A @ B of a constant DFT matrix
// A (M x K, row-major, in device memory) against a batch of data columns
// B (K x N), with a prologue that forms B from the inputs while loading it
// (RL ratio, radix-2 butterfly, OTF product) and an epilogue that places C
// (kp-major layout, inverse butterfly, |mul * y|).  The data operand is
// addressed through strides, so one core serves a contraction over the
// middle axis of (P, K, X) (x contiguous: element (k, c) at k*X + c) and
// over the last axis of (R, K) (element (k, c) at c*K + k).
//
// Arithmetic is plain f32 FMA on the CUDA cores: no TF32, no tensor cores.
// A block computes a BM x BN tile of C, 256 threads as a 16 x 16 grid
// each holding a TM x TN register tile; A and B stream through shared
// memory BK deep.  Each value read from shared memory feeds 4 FMAs.

#pragma once

#include <cfloat>
#include <cuda_runtime.h>

namespace ippfft {

typedef long long i64;

constexpr int BM = 64;         // rows of C (rows of A) per block
constexpr int BN = 64;         // columns of C per block
constexpr int BK = 16;         // contraction depth per shared-memory stage
constexpr int TM = 4;          // rows per thread
constexpr int TN = 4;          // columns per thread
constexpr int NT = 256;        // threads per block: (BM/TM) * (BN/TN)
constexpr int BMP = BM + 4;    // padded smem row of the A tile (bank spread)
constexpr int BNP = BN + 4;    // padded smem row of the B tile

// A[r0:r0+BM, k0:k0+BK] of a row-major M x K matrix into smem, transposed
// (s[kk * BMP + r]); out-of-range entries are zero so ragged M and K need
// no special case in the product loop.
__device__ __forceinline__ void load_a_tile(float* s, const float* __restrict__ A,
                                            int M, int K, int r0, int k0) {
  for (int e = threadIdx.x; e < BM * BK; e += NT) {
    const int kk = e % BK;  // consecutive threads read consecutive k
    const int r = e / BK;
    const int gr = r0 + r, gk = k0 + kk;
    s[kk * BMP + r] = (gr < M && gk < K) ? A[(i64)gr * K + gk] : 0.f;
  }
}

// A complex data tile (BK x BN) into two smem tiles (re, im); f(k, c)
// returns float2(re, im) for global row k and column c, and zero outside
// the operand.  K_FAST orders the threads along k: the coalesced order
// when k is the contiguous axis (the last-axis stage), otherwise along c.
template <bool K_FAST, class F>
__device__ __forceinline__ void load_b_tile2(float* sr, float* si, int k0, int c0,
                                             F f) {
  for (int e = threadIdx.x; e < BK * BN; e += NT) {
    const int kk = K_FAST ? e % BK : e / BN;
    const int c = K_FAST ? e / BK : e % BN;
    const float2 v = f(k0 + kk, c0 + c);
    sr[kk * BNP + c] = v.x;
    si[kk * BNP + c] = v.y;
  }
}

// Real data tile: as load_b_tile2 with one output; c is the fast axis.
template <class F>
__device__ __forceinline__ void load_b_tile(float* s, int k0, int c0, F f) {
  for (int e = threadIdx.x; e < BK * BN; e += NT) {
    const int kk = e / BN;
    const int c = e % BN;
    s[kk * BNP + c] = f(k0 + kk, c0 + c);
  }
}

// acc += A_tile @ B_tile for this thread's TM x TN sub-tile.
__device__ __forceinline__ void mma_real(float (&acc)[TM][TN], const float* a,
                                         const float* b, int ty, int tx) {
#pragma unroll
  for (int kk = 0; kk < BK; ++kk) {
    float av[TM], bv[TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) av[i] = a[kk * BMP + ty * TM + i];
#pragma unroll
    for (int j = 0; j < TN; ++j) bv[j] = b[kk * BNP + tx * TN + j];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// Complex (accr + i*acci) += (Ar + i*Ai) @ (Br + i*Bi), four real FMAs per
// complex term (the MXU's 3-matmul Karatsuba saved passes of a systolic
// array; on CUDA cores it would only add cancellation).
__device__ __forceinline__ void mma_cplx(float (&accr)[TM][TN], float (&acci)[TM][TN],
                                         const float* ar, const float* ai,
                                         const float* br, const float* bi,
                                         int ty, int tx) {
#pragma unroll
  for (int kk = 0; kk < BK; ++kk) {
    float avr[TM], avi[TM], bvr[TN], bvi[TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      avr[i] = ar[kk * BMP + ty * TM + i];
      avi[i] = ai[kk * BMP + ty * TM + i];
    }
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      bvr[j] = br[kk * BNP + tx * TN + j];
      bvi[j] = bi[kk * BNP + tx * TN + j];
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        accr[i][j] = fmaf(avr[i], bvr[j], accr[i][j]);
        accr[i][j] = fmaf(-avi[i], bvi[j], accr[i][j]);
        acci[i][j] = fmaf(avr[i], bvi[j], acci[i][j]);
        acci[i][j] = fmaf(avi[i], bvr[j], acci[i][j]);
      }
  }
}

__device__ __forceinline__ void zero(float (&acc)[TM][TN]) {
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
}

}  // namespace ippfft
