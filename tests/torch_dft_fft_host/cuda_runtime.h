// A stand-in for the CUDA runtime header, for compiling the device
// templates of ipp_tpu_torch/csrc/dft_fft.cuh (and rdft_y.cuh, dwt.cuh)
// with a host compiler: the qualifiers vanish, float2, float4 and __ldg are
// plain C++.
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
struct alignas(16) float4 {
  float x, y, z, w;
};
inline float4 make_float4(float x, float y, float z, float w) {
  return float4{x, y, z, w};
}
template <class T>
inline T __ldg(const T* p) {
  return *p;
}
