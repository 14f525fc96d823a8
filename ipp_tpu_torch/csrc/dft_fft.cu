// K7 on the FFT route: the n-point complex DFT or inverse DFT along the last
// axis of (rows, n) planes as a mixed-radix FFT kernel (dft_fft.cuh), for
// any n = 2^a * m with a >= 3 up to the shared-memory limit.  Replaces
// `fused_cplx_matmul` -> `_fused_call` (ipp_tpu/ops/pallas_fft.py:66) where
// its matrix is the dense DFT of a v1-walk axis, which is every call the
// walks make.  Bound by bytes: one read and one write of the planes.
//
// Plain C interface for ctypes: launches on the given stream and returns
// cudaGetLastError() of the launch (cudaErrorInvalidValue for a plan the
// kernel does not take).

#include "dft_fft.cuh"

using namespace ippdft;

extern "C" {

// xr, xi, rr, ii: (rows, n).  tw: (n, 2) f32, exp(-2 pi i j / n).  radices:
// `npass` host ints whose product is n (ops/dft_mats.dft_fft_plan); generic:
// the last of them is the generic odd radix.  pad, tpr, cols: -1, 0 and 0
// for the kernel's own shared-memory pad, threads per row and rows per
// block.
int ipp_dft_last(const float* xr, const float* xi, const float* tw, float* rr,
                 float* ii, int inverse, long long rows, int n, int npass,
                 const int* radices, int generic, int pad, int tpr,
                 int cols, void* stream) {
  Plan pl;
  pl.n = n;
  pl.npass = npass;
  pl.generic = generic;
  if (npass < 1 || npass > MAX_PASSES) return (int)cudaErrorInvalidValue;
  for (int p = 0; p < MAX_PASSES; ++p) pl.radix[p] = p < npass ? radices[p] : 1;
  const float2* w = (const float2*)tw;
  cudaStream_t st = (cudaStream_t)stream;
  if (inverse)
    return (int)launch<true>(xr, xi, w, rr, ii, rows, pl, pad, tpr, cols, st);
  return (int)launch<false>(xr, xi, w, rr, ii, rows, pl, pad, tpr, cols, st);
}

}  // extern "C"
