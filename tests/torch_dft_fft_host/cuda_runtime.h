// A stand-in for the CUDA runtime header, for compiling the device
// templates of ipp_tpu_torch/csrc/dft_fft.cuh with a host compiler: the
// qualifiers vanish, float2 and __ldg are plain C++.
#pragma once

#include <cmath>

#define __host__
#define __device__
#define __global__
#define __forceinline__ inline

struct float2 {
  float x, y;
};
inline float2 make_float2(float x, float y) { return float2{x, y}; }
template <class T>
inline T __ldg(const T* p) {
  return *p;
}
