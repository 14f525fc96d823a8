// K8, the destripe notch along either axis of (B, H, W) f32 tiles
// (notch.cuh): y = irfft(rfft(x) * g, n) for every line, two lines of one
// tile a complex transform on dft_fft.cuh's passes.  Replaces no Pallas
// kernel (the reference notches with the XLA FFT, ipp_tpu/ops/destripe.py:
// 168-172) but cuFFT, whose algorithm changes with the batch count, so that
// a destriped tile never depends on its batch.  Bound by bytes.
//
// Plain C interface for ctypes: launches on the given stream and returns
// cudaGetLastError() of the launch (cudaErrorInvalidValue for a shape or
// plan the kernel does not take).

#include "notch.cuh"

extern "C" {

// x, y: (batch, h, w) f32, contiguous; cols != 0: along axis -2 (n = h),
// else along axis -1 (n = w).  tw: (n, 2) f32, exp(-2 pi i j / n); gs: (n)
// f32, g[min(k, n - k)] / n.  radices: `npass` host ints whose product is n
// (ops/cuda_notch.notch_plan); generic: the last of them is the generic
// odd pass.  scratch: two buffers of `ops/cuda_notch.notch_geometry`'s
// `buf` float2 slots for each of `nscratch` blocks, or null where the
// geometry fits shared memory.
int ipp_notch(const float* x, float* y, const float* tw, const float* gs,
              long long batch, int h, int w, int cols, int npass,
              const int* radices, int generic, float* scratch,
              long long nscratch, void* stream) {
  ippnotch::Plan pl;
  if (npass < 1 || npass > ippdft::MAX_PASSES)
    return (int)cudaErrorInvalidValue;
  pl.n = cols ? h : w;
  pl.npass = npass;
  pl.generic = generic;
  for (int p = 0; p < ippdft::MAX_PASSES; ++p)
    pl.radix[p] = p < npass ? radices[p] : 1;
  return (int)ippnotch::launch(x, y, (const float2*)tw, gs, batch, h, w,
                               cols != 0, pl, (float2*)scratch, nscratch,
                               (cudaStream_t)stream);
}

}  // extern "C"
