// K4 on the FFT route: the OTF product and the inverse radix-2 stage along
// the last axis of (rows, n) as one FFT kernel (stage_fft.cuh), the eight
// lengths 256 * j.  Replaces `fused_stage_inv_otf` ->
// `_fused_stage_otf_call` (kernel `_make_stage_inv_otf_kernel(conj)`) of
// ipp_tpu/ops/pallas_fft.py: each value is multiplied by otf_re +/-
// i*otf_im as it is loaded, so the product never reaches device memory.
// Data row r takes OTF row r % orows (one modulo per row a block owns), so
// one block's OTF serves a batch (K4b).  Bound by bytes: the spectrum read
// and written once, the OTF read once.  A batch reads the OTF once per block
// of the batch: holding it in registers across a loop over the batch costs
// more occupancy than the bytes it saves.
//
// Plain C interface for ctypes, as stage_fft_fwd.cu.

#include "stage_fft.cuh"

using namespace ippsfft;

extern "C" {

// xr, xi, rr, ii: (rows, n); otr, oti: (orows, n), orows >= 1.
int ipp_stage_fft_inv_otf(const float* xr, const float* xi, const float* otr,
                          const float* oti, const float* tw, float* rr,
                          float* ii, int conj, long long rows, int orows, int n,
                          void* stream) {
  if (orows < 1) return (int)cudaErrorInvalidValue;
  return (int)launch_n<true, INV_OTF>(n, xr, xi, otr, oti, (const float2*)tw,
                                      rr, ii, 1, rows, orows,
                                      conj ? -1.f : 1.f, (cudaStream_t)stream);
}

}  // extern "C"
