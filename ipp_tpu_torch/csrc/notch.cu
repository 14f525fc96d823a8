// K8, the destripe notch along either axis of (B, H, W) f32 tiles
// (notch.cuh): y = irfft(rfft(x) * g, n) for every line, two lines of one
// tile a complex transform on in-place mixed-radix passes, the forward and
// inverse passes of the spectrum fused in registers around the gain; every
// notch of a wavelet decomposition in one launch; lines whose buffers pass
// shared memory (up to 2^20 values) in the long form K8l, the four-step
// split over three kernels, many blocks a line pair (a large odd factor
// inside its row: Rader's algorithm for a prime whose p - 1 has a
// specialised plan, else Bluestein's chirp-z transform; a line with no
// split on the whole line's chirp-z transform).  Replaces no Pallas kernel
// (the reference notches with the XLA FFT, ipp_tpu/ops/destripe.py:
// 168-172) but cuFFT, whose algorithm changes with the batch count, so
// that a destriped tile never depends on its batch.  Bound by bytes.
//
// Plain C interface for ctypes: launches on the given stream and returns
// cudaGetLastError() of the launch (cudaErrorInvalidValue for a table the
// kernel does not take).

#include "notch.cuh"

extern "C" {

// desc: `count` (<= 16) rows of 22 int64 words, one a subband: x, y (its
// (batch, h, w) f32 input and output, contiguous), tw ((n, 2) f32, exp(-2
// pi i j / n)), gp ((n) f32, ops/cuda_notch.notch_gains), batch, h, w, cols
// (!= 0: along axis -2, n = h; else axis -1, n = w), npass, generic (the
// last radix is the generic odd pass), 12 radices whose first npass
// multiply to n (ops/cuda_notch.notch_plan).  Every subband's buffers fit
// shared memory (ops/cuda_notch.notch_is_long false).
int ipp_notch_group(const long long* desc, int count, void* stream) {
  return (int)ippnotch::launch_group(desc, count, (cudaStream_t)stream);
}

// The long form K8l on one subband: its kernels a (the strided forward
// passes), b (the rows), c (the strided inverse passes), on the chirp
// route twice; desc a row of 47 int64 words (ops/cuda_notch._long_row:
// x, y, the scratch or null, the tables, the shape, the split and its two
// plans; notch.cuh make_long).
int ipp_notch_long(const long long* desc, void* stream) {
  return (int)ippnotch::launch_long(desc, (cudaStream_t)stream);
}

}  // extern "C"
