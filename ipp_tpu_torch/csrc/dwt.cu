// K5, one level of circular DWT analysis along axis -1 or -2, and K5s, its
// synthesis: the C entries of the register-tiled polyphase kernels of
// dwt.cuh.  K5 replaces ipp_tpu/ops/pallas_dwt.py `dwt_analysis_pallas` and
// scripts/dwt_ykernel_exp.py `dwt_y_pallas`; K5s replaces no Pallas kernel
// (the reference's synthesis is an XLA convolution) but cuDNN's transposed
// convolution, so that a level's output never depends on the batch or the
// run.
//
// Plain C interface for ctypes: each entry launches on the given stream and
// returns cudaGetLastError() of its launch (or cudaErrorInvalidValue for
// arguments the kernel does not take).

#include "dwt.cuh"

extern "C" {

// x (batch, n, inner) f32, contiguous, 8-byte aligned; taps = [lo (L), hi
// (L)] f32 on the device; ca, cd (batch, n/2, inner).  inner == 1 is the
// last-axis form.
int ipp_dwt_analysis(const float* x, const float* taps, float* ca, float* cd,
                     long long batch, int n, long long inner, int L,
                     void* stream) {
  return (int)ippdwt::launch(x, taps, ca, cd, batch, n, inner, L, 0, 0, false,
                             (cudaStream_t)stream);
}

// The same with the kernel's knobs, for scripts/dwt_bench.py --sweep: R
// outputs a thread (0: 8; else 4, 8, 16), the most threads a block takes
// (0: 512; at most 256 at R = 16), and generic != 0 for the run-time tap
// loop at every filter length.
int ipp_dwt_analysis_knobs(const float* x, const float* taps, float* ca,
                           float* cd, long long batch, int n, long long inner,
                           int L, int R, int threads, int generic,
                           void* stream) {
  return (int)ippdwt::launch(x, taps, ca, cd, batch, n, inner, L, R, threads,
                             generic != 0, (cudaStream_t)stream);
}

// ca, cd (batch, m, inner) f32, contiguous; taps as above; y (batch, 2m,
// inner): y[t] = sum_k up(ca)[(t - k) mod 2m] lo[k] + up(cd)[...] hi[k].
int ipp_dwt_synthesis(const float* ca, const float* cd, const float* taps,
                      float* y, long long batch, int m, long long inner,
                      int L, void* stream) {
  return (int)ippdwt::launch_syn(ca, cd, taps, y, batch, m, inner, L,
                                 (cudaStream_t)stream);
}

}  // extern "C"
