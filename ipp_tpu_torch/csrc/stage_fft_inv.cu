// K3 inverse and K6 on the FFT route: the inverse radix-2 stage as an FFT
// kernel (stage_fft.cuh), the eight lengths 256 * j.  The middle-axis form
// replaces `_v2_stage_call(forward=False)` (kernel `_v2_stage_inv_kernel`),
// the last-axis form (K6) `_fused_stage_call(forward=False)` (kernel
// `_stage_inv_kernel`, ipp_tpu/ops/pallas_fft.py:191).  Bound by bytes.
//
// Plain C interface for ctypes, as stage_fft_fwd.cu.

#include "stage_fft.cuh"

using namespace ippsfft;

extern "C" {

int ipp_stage_fft_inv(const float* xr, const float* xi, const float* tw,
                      float* rr, float* ii, int last_axis, int batch, int n,
                      long long ncols, void* stream) {
  const float2* w = (const float2*)tw;
  cudaStream_t st = (cudaStream_t)stream;
  if (last_axis)
    return (int)launch_n<true, INV>(n, xr, xi, nullptr, nullptr, w, rr, ii, 1,
                                    ncols, 1, 1.f, st);
  return (int)launch_n<false, INV>(n, xr, xi, nullptr, nullptr, w, rr, ii,
                                   batch, ncols, 1, 1.f, st);
}

}  // extern "C"
