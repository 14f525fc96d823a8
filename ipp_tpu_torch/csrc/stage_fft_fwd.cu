// K3 forward on the FFT route: the forward radix-2 stage as an FFT kernel
// (stage_fft.cuh), both layouts, the eight lengths 256 * j.  Replaces
// `_v2_stage_call(forward=True)` (kernel `_v2_stage_fwd_kernel`) and
// `fused_stage(forward=True)` -> `_fused_stage_call` (`_stage_fwd_kernel`)
// of ipp_tpu/ops/pallas_fft.py.  Bound by bytes: one read and one write of
// the spectrum.
//
// Plain C interface for ctypes: launches on the given stream and returns
// cudaGetLastError() of the launch (cudaErrorInvalidValue for a length the
// FFT route does not cover).

#include "stage_fft.cuh"

using namespace ippsfft;

extern "C" {

// last_axis: xr, xi, rr, ii are (ncols, n), batch is 1; otherwise
// (batch, n, ncols).  tw: (n, 2) f32, exp(-2 pi i j / n).
int ipp_stage_fft_fwd(const float* xr, const float* xi, const float* tw,
                      float* rr, float* ii, int last_axis, int batch, int n,
                      long long ncols, void* stream) {
  const float2* w = (const float2*)tw;
  cudaStream_t st = (cudaStream_t)stream;
  if (last_axis)
    return (int)launch_n<true, FWD>(n, xr, xi, nullptr, nullptr, w, rr, ii, 1,
                                    ncols, 1, 1.f, st);
  return (int)launch_n<false, FWD>(n, xr, xi, nullptr, nullptr, w, rr, ii,
                                   batch, ncols, 1, 1.f, st);
}

}  // extern "C"
