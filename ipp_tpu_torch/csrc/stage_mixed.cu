// K3, K4, K4b and K6 at the stage lengths off stage_fft.cuh's eight (every
// other multiple of 128 up to 12288): the radix-2 stage as a mixed-radix FFT
// kernel with a run-time plan (stage_mixed.cuh).  Replaces, at those
// lengths, `_v2_stage_call` (kernels `_v2_stage_fwd_kernel`,
// `_v2_stage_inv_kernel`; z), `_fused_stage_call` (`_stage_fwd_kernel`,
// `_stage_inv_kernel`; x) and `_fused_stage_otf_call`
// (`_make_stage_inv_otf_kernel(conj)`) of ipp_tpu/ops/pallas_fft.py.  Bound
// by bytes: one read and one write of the spectrum (and one read of the
// OTF).
//
// Plain C interface for ctypes: launches on the given stream and returns
// cudaGetLastError() of the launch (cudaErrorInvalidValue for a length,
// plan or geometry the kernel does not take).

#include "stage_mixed.cuh"

using namespace ippsmix;

extern "C" {

// mode: 0 forward, 1 inverse, 2 inverse with the OTF product (last axis
// only).  last_axis: xr, xi, rr, ii are (ncols, n) and batch is 1;
// otherwise (batch, n, ncols).  otr, oti: (orows, n), or null.  tw: (n, 2)
// f32, exp(-2 pi i j / n).  radices: `npass` host ints whose product is n
// (ops/dft_mats.dft_fft_plan); generic: the last of them is the generic
// odd radix.  tpr, cols: 0 and 0 for the kernel's own threads per column
// (row) and columns (rows) per block.
int ipp_stage_mixed(const float* xr, const float* xi, const float* otr,
                    const float* oti, const float* tw, float* rr, float* ii,
                    int mode, int last_axis, int batch, long long ncols, int n,
                    int npass, const int* radices, int generic, int orows,
                    int conj, int tpr, int cols, void* stream) {
  if (npass < 1 || npass > MAX_PASSES) return (int)cudaErrorInvalidValue;
  Plan pl;
  pl.n = n;
  pl.npass = npass;
  pl.generic = generic;
  for (int p = 0; p < MAX_PASSES; ++p) pl.radix[p] = p < npass ? radices[p] : 1;
  const float2* w = (const float2*)tw;
  const float osign = conj ? -1.f : 1.f;
  cudaStream_t st = (cudaStream_t)stream;
  if (last_axis && batch != 1) return (int)cudaErrorInvalidValue;
#define IPP_STAGE_MIXED(LAST, MODE)                                        \
  return (int)launch_stage<LAST, MODE>(xr, xi, otr, oti, w, rr, ii, batch, \
                                       ncols, pl, orows, osign, tpr, cols, st)
  if (last_axis && mode == FWD) IPP_STAGE_MIXED(true, FWD);
  if (last_axis && mode == INV) IPP_STAGE_MIXED(true, INV);
  if (last_axis && mode == INV_OTF) IPP_STAGE_MIXED(true, INV_OTF);
  if (!last_axis && mode == FWD) IPP_STAGE_MIXED(false, FWD);
  if (!last_axis && mode == INV) IPP_STAGE_MIXED(false, INV);
#undef IPP_STAGE_MIXED
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
