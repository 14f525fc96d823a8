// K5 — one level of circular DWT analysis along one axis, for Hopper.
//
// Replaces ipp_tpu/ops/pallas_dwt.py `dwt_analysis_pallas` (kernel
// `_dwt_kernel`, the last axis) and scripts/dwt_ykernel_exp.py
// `dwt_y_pallas` (kernel `_ykernel`, axis -2).  With the input viewed as
// (B, n, S) — S = 1 for the last axis, S = w for axis -2 of (..., h, w):
//
//   cA[b, i, s] = sum_k lo[k] * x[b, (2i + k) mod n, s]
//   cD[b, i, s] = sum_k hi[k] * x[b, (2i + k) mod n, s],      i < n/2
//
// lo = rec_lo, hi = rec_hi: the raw phase of wavelets._dwt_last.  Both
// outputs come from one read of the input.
//
// What bounds it on the card: device memory.  Per input element the
// kernel moves 8 bytes (4 in, 2 x 2 out) and does L FMAs; L is 18 for db9
// and at most 102 (coif17), so up to L ~ 80 it sits below the f32
// FMA-per-byte ridge of the H100 (67 TFLOP/s over 3.35 TB/s).  The design
// reads each input element from device memory once per block and keeps
// the L/2-deep tap loop in shared memory:
// - a block stages the circular input window of its output tile in shared
//   memory, split into even and odd phases (the polyphase form of the
//   Pallas kernel), so the tap loop reads consecutive shared words with no
//   bank conflicts;
// - the last-axis form (S = 1) takes 256 outputs of one row per block;
//   the axis -2 form takes 64 output rows x 32 columns, its threads running
//   along w, so every global load and store is coalesced and no transpose
//   is needed;
// - the taps live in shared memory and are read as broadcasts;
// - input rows are indexed mod n, which covers deep levels where the row
//   is shorter than the filter (one wrap is not assumed).
//
// Plain C interface for ctypes: the entry launches on the given stream and
// returns cudaGetLastError() of its launch (or cudaErrorInvalidValue for
// arguments the kernel does not take).

#include <cuda_runtime.h>

namespace {

typedef long long i64;

constexpr int MAXL = 128;       // longest filter taken (even lengths only)
constexpr int HMAX = MAXL / 2;  // its polyphase depth
constexpr int RT = 256;         // last-axis form: outputs = threads per block
constexpr int CS = 32;          // axis -2 form: columns per block
constexpr int CI = 64;          // axis -2 form: output rows per block
constexpr int CY = 8;           // axis -2 form: thread rows (32 x 8 threads)

__device__ __forceinline__ void load_taps(const float* __restrict__ taps,
                                          float* s_lo, float* s_hi, int L,
                                          int tid, int nthreads) {
  for (int t = tid; t < L; t += nthreads) {
    s_lo[t] = taps[t];
    s_hi[t] = taps[L + t];
  }
}

// Last axis: x (rows, n) -> ca, cd (rows, n/2).  Block = (row, tile of RT
// outputs); thread i computes output i0 + i.
__global__ void __launch_bounds__(RT)
dwt_rows(const float* __restrict__ x, const float* __restrict__ taps,
         float* __restrict__ ca, float* __restrict__ cd, int n, int L,
         int tiles) {
  __shared__ float s_lo[MAXL], s_hi[MAXL];
  __shared__ float ev[RT + HMAX], od[RT + HMAX];
  const i64 row = blockIdx.x / tiles;
  const int i0 = (int)(blockIdx.x % tiles) * RT;
  const int m = n >> 1, hl = L >> 1;
  const int cnt = min(RT, m - i0);
  const float* xr = x + row * (i64)n;
  load_taps(taps, s_lo, s_hi, L, threadIdx.x, RT);
  // input window [2 i0, 2 i0 + need), circular; ev[j] = x[2(i0 + j)],
  // od[j] = x[2(i0 + j) + 1]
  const int need = 2 * (cnt + hl);
  for (int t = threadIdx.x; t < need; t += RT) {
    const float v = xr[(2 * i0 + t) % n];
    if (t & 1) od[t >> 1] = v; else ev[t >> 1] = v;
  }
  __syncthreads();
  const int i = threadIdx.x;
  if (i < cnt) {
    float a = 0.f, d = 0.f;
    for (int j = 0; j < hl; ++j) {
      const float e = ev[i + j], o = od[i + j];
      a = fmaf(s_lo[2 * j], e, a);
      a = fmaf(s_lo[2 * j + 1], o, a);
      d = fmaf(s_hi[2 * j], e, d);
      d = fmaf(s_hi[2 * j + 1], o, d);
    }
    const i64 off = row * m + i0 + i;
    ca[off] = a;
    cd[off] = d;
  }
}

// Axis -2: x (B, n, S) -> ca, cd (B, n/2, S).  Block = (b, tile of CI
// output rows, tile of CS columns); thread (tx, ty) computes column
// s0 + tx of output rows i0 + ty, i0 + ty + CY, ...
__global__ void __launch_bounds__(CS * CY)
dwt_cols(const float* __restrict__ x, const float* __restrict__ taps,
         float* __restrict__ ca, float* __restrict__ cd, int n, int S,
         int L, int tiles_i, int tiles_s) {
  __shared__ float s_lo[MAXL], s_hi[MAXL];
  __shared__ float ev[CI + HMAX][CS], od[CI + HMAX][CS];
  i64 blk = blockIdx.x;
  const int ts = (int)(blk % tiles_s);
  blk /= tiles_s;
  const int ti = (int)(blk % tiles_i);
  const i64 b = blk / tiles_i;
  const int s0 = ts * CS, i0 = ti * CI;
  const int m = n >> 1, hl = L >> 1;
  const int cnt = min(CI, m - i0);
  const int tx = threadIdx.x % CS, ty = threadIdx.x / CS;
  const int s = s0 + tx;
  const float* xb = x + b * (i64)n * S;
  load_taps(taps, s_lo, s_hi, L, threadIdx.x, CS * CY);
  const int need = 2 * (cnt + hl);
  for (int t = ty; t < need; t += CY) {
    const float v = s < S ? xb[(i64)((2 * i0 + t) % n) * S + s] : 0.f;
    if (t & 1) od[t >> 1][tx] = v; else ev[t >> 1][tx] = v;
  }
  __syncthreads();
  if (s >= S) return;
  for (int il = ty; il < cnt; il += CY) {
    float a = 0.f, d = 0.f;
    for (int j = 0; j < hl; ++j) {
      const float e = ev[il + j][tx], o = od[il + j][tx];
      a = fmaf(s_lo[2 * j], e, a);
      a = fmaf(s_lo[2 * j + 1], o, a);
      d = fmaf(s_hi[2 * j], e, d);
      d = fmaf(s_hi[2 * j + 1], o, d);
    }
    const i64 off = (b * m + i0 + il) * (i64)S + s;
    ca[off] = a;
    cd[off] = d;
  }
}

}  // namespace

extern "C" {

// x (batch, n, inner) f32, contiguous; taps = [lo (L), hi (L)] f32 on the
// device; ca, cd (batch, n/2, inner).  inner == 1 is the last-axis form.
int ipp_dwt_analysis(const float* x, const float* taps, float* ca, float* cd,
                     i64 batch, int n, i64 inner, int L, void* stream) {
  if (n < 2 || (n & 1) || L < 2 || (L & 1) || L > MAXL || batch < 1 ||
      inner < 1 || inner > 0x7fffffff) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  const int m = n / 2;
  if (inner == 1) {
    const int tiles = (m + RT - 1) / RT;
    const i64 blocks = batch * tiles;
    if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
    dwt_rows<<<(unsigned)blocks, RT, 0, st>>>(x, taps, ca, cd, n, L, tiles);
  } else {
    const int S = (int)inner;
    const int tiles_i = (m + CI - 1) / CI, tiles_s = (S + CS - 1) / CS;
    const i64 blocks = batch * tiles_i * (i64)tiles_s;
    if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
    dwt_cols<<<(unsigned)blocks, CS * CY, 0, st>>>(x, taps, ca, cd, n, S, L,
                                                   tiles_i, tiles_s);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
