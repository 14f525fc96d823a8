// K1 and K2 on the FFT route: the y-axis real DFT of (nb, nz, ny, nx) volumes
// to kp-major half spectra (nb, kp, nz, nx) and its inverse, as real-FFT
// kernels (rdft_y.cuh), for any ny = 8 * j up to 2048 and even nx.  They
// replace `_v2_rfft_call_t`, `_v2_rfft_ratio_call_t`, `_v2_irfft_call_t`,
// `_v2_irfft_mul_call_t` (ipp_tpu/ops/pallas_fft.py:646-726) and, with nb >
// 1, `_v2_rfft_call`, `_v2_rfft_ratio_call`, `_v2_irfft_call`,
// `_v2_irfft_mul_call` (:498, :772, :524, :811) wherever their matrix is the
// real-DFT fold of the axis, which is every call the walk makes.  Bound by
// bytes: the volume and the two half spectra cross device memory once.
//
// Plain C interface for ctypes: each entry launches on the given stream and
// returns cudaGetLastError() of the launch (cudaErrorInvalidValue for a
// shape or plan the kernel does not take).

#include "rdft_y.cuh"

using namespace ipprdft;

namespace {

bool make_plan(int ny, int npass, const int* radices, int generic, Plan& pl) {
  if (npass < 1 || npass > ippdft::MAX_PASSES) return false;
  pl.n = ny;
  pl.npass = npass;
  pl.generic = generic;
  for (int p = 0; p < ippdft::MAX_PASSES; ++p)
    pl.radix[p] = p < npass ? radices[p] : 1;
  return true;
}

}  // namespace

extern "C" {

// num, den (or null): (nb * nz, ny, nx).  re, im: (nb, kp, nz, nx).  tw: (ny,
// 2) f32, exp(-2 pi i j / ny).  radices: `npass` host ints whose product is
// ny (ops/dft_mats.dft_fft_plan); generic: the last of them is the generic
// odd radix.  tpp, pairs: 0 and 0 for the kernel's own threads per column
// pair and pairs per block.
int ipp_rdft_y_fwd_fft(const float* num, const float* den, const float* tw,
                       float* re, float* im, int nb, int nz, int ny, int nx,
                       int kp, int npass, const int* radices, int generic,
                       int tpp, int pairs, void* stream) {
  Plan pl;
  if (!make_plan(ny, npass, radices, generic, pl))
    return (int)cudaErrorInvalidValue;
  return (int)launch_fwd(num, den, (const float2*)tw, re, im, nb, nz, nx, kp,
                         pl, tpp, pairs, (cudaStream_t)stream);
}

// re, im: (nb, kp, nz, nx).  mul (or null), out: (nb * nz, ny, nx).
int ipp_rdft_y_inv_fft(const float* re, const float* im, const float* tw,
                       const float* mul, float* out, int nb, int nz, int ny,
                       int nx, int kp, int npass, const int* radices,
                       int generic, int tpp, int pairs, void* stream) {
  Plan pl;
  if (!make_plan(ny, npass, radices, generic, pl))
    return (int)cudaErrorInvalidValue;
  return (int)launch_inv(re, im, (const float2*)tw, mul, out, nb, nz, nx, kp,
                         pl, tpp, pairs, (cudaStream_t)stream);
}

}  // extern "C"
