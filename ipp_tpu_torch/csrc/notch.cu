// K8, the destripe notch along either axis of (B, H, W) f32 tiles
// (notch.cuh): y = irfft(rfft(x) * g, n) for every line, two lines of one
// tile a complex transform on in-place mixed-radix passes, the forward and
// inverse passes of the spectrum fused in registers around the gain; every
// notch of a wavelet decomposition in one launch; lines whose buffers pass
// shared memory (up to 2^20 values, a large odd factor through Bluestein's
// chirp-z transform) in a device-memory scratch.  Replaces no Pallas
// kernel (the reference notches with the XLA FFT, ipp_tpu/ops/destripe.py:
// 168-172) but cuFFT, whose algorithm changes with the batch count, so that
// a destriped tile never depends on its batch.  Bound by bytes.
//
// Plain C interface for ctypes: launches on the given stream and returns
// cudaGetLastError() of the launch (cudaErrorInvalidValue for a table the
// kernel does not take).

#include "notch.cuh"

extern "C" {

// desc: `count` (<= 16) rows of 24 int64 words, one a subband: x, y (its
// (batch, h, w) f32 input and output, contiguous), tw ((m, 2) f32, exp(-2
// pi i j / m), m the transform length), gp ((n) f32,
// ops/cuda_notch.notch_gains), batch, h, w, cols (!= 0: along axis -2, n =
// h; else axis -1, n = w), npass, generic (the last radix is the generic
// odd pass), 12 radices whose first npass multiply to m
// (ops/cuda_notch.notch_plan), then chirp and hm (the chirp route's (n, 2)
// and (m, 2) f32 tables, ops/cuda_notch.chirp_tables; both null on the
// mixed-radix route, where m = n).  scratch: a lone subband's buffers for
// each of `nscratch` blocks (nbuf * buf float2 of
// ops/cuda_notch.notch_geometry), or null where the buffers fit shared
// memory.
int ipp_notch_group(const long long* desc, int count, float* scratch,
                    long long nscratch, void* stream) {
  return (int)ippnotch::launch_group(desc, count, (float2*)scratch, nscratch,
                                     (cudaStream_t)stream);
}

}  // extern "C"
