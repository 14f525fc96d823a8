// K3, K4, K4b and K6 at the stage lengths above 12288 (multiples of 128),
// and K7's dense-axis DFT above 12288 (multiples of 64): the n-point DFT as
// one radix-2 step and two m = n/2-point FFTs, in one pass over the data
// (Form A) or two (Form B, the four-step FFT), on a run-time plan
// (stage_large.cuh).  Replaces, at those lengths, `_v2_stage_call` (z),
// `_fused_stage_call` (x, both directions), `_fused_stage_otf_call` and
// `_fused_call` (`fused_cplx_matmul`, the dense DFT of an axis) of
// ipp_tpu/ops/pallas_fft.py.  Bound by bytes: one read and one write of
// the data (and one read of the OTF).
//
// Plain C interface for ctypes: launches on the given stream and returns
// cudaGetLastError() of the last launch (cudaErrorInvalidValue for a
// length, plan or geometry the kernel does not take).  The kernels of each
// mode compile in their own source (stage_large_fwd.cu, _inv.cu, _otf.cu).

#include "stage_large.cuh"

using namespace ipplarge;

static bool read_plan(Plan& pl, int npass, const int* radices, int generic) {
  if (npass < 0 || npass > MAX_PASSES || (npass > 0 && radices == nullptr))
    return false;
  pl.npass = npass;
  pl.generic = generic;
  pl.n = 1;
  for (int p = 0; p < MAX_PASSES; ++p) {
    pl.radix[p] = p < npass ? radices[p] : 1;
    if (p < npass) pl.n *= pl.radix[p];
  }
  return true;
}

extern "C" {

// mode: 0 forward, 1 inverse, 2 inverse with the OTF product (last axis
// only); natural: K7's natural order in and out (last axis only).
// last_axis: xr, xi, rr, ii are (ncols, n) and batch is 1; otherwise
// (batch, n, ncols).  otr, oti: (orows, n), or null.  twn: (n, 2) f32,
// exp(-2 pi i j / n); tw1, tw2: the same for the two plans' lengths.
// radices1 / radices2 (npass1 / npass2 host ints, ops/dft_mats.
// stage_large_plan): Form A when npass2 is 0 (plan 1 of n / 2), else
// Form B (plan 1 of m1, plan 2 of m2); generic2: plan 2's last pass is the
// generic odd one (Form A: generic1).  scratch: n * batch * ncols float2
// for Form B.  tpr1, cols1, tpr2, cols2: 0 for the kernel's own geometry.
int ipp_stage_large(const float* xr, const float* xi, const float* otr,
                    const float* oti, const float* tw_n, const float* tw_1,
                    const float* tw_2, void* scratch_, float* rr, float* ii,
                    int mode, int natural, int last_axis, int batch,
                    long long ncols, int n, int npass1, const int* radices1,
                    int generic1, int npass2, const int* radices2,
                    int generic2, int orows, int conj, int tpr1, int cols1,
                    int tpr2, int cols2, void* stream) {
  Plan p1, p2;
  if (!read_plan(p1, npass1, radices1, generic1) ||
      !read_plan(p2, npass2, radices2, generic2) || npass1 < 1)
    return (int)cudaErrorInvalidValue;
  if (npass2 == 0) p2.n = 0;
  // the names IPP_LARGE_PASS_ARGS passes on
  const float2 *twn = (const float2*)tw_n, *tw1 = (const float2*)tw_1,
               *tw2 = (const float2*)tw_2;
  float2* scratch = (float2*)scratch_;
  const float osign = conj ? -1.f : 1.f;
  const bool last = last_axis != 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (mode == FWD) return (int)launch_fwd(natural, IPP_LARGE_PASS_ARGS);
  if (mode == INV) return (int)launch_inv(natural, IPP_LARGE_PASS_ARGS);
  if (mode == INV_OTF && !natural)
    return (int)launch_inv_otf(IPP_LARGE_PASS_ARGS);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
