// Hopper primitives the tensor-core GEMM kernels share (rdft_dense.cu,
// cplx_dense.cu): wgmma's fences, groups and the descriptor of a K-major
// tile with the 128-byte swizzle; mbarriers; named barriers of one
// warpgroup; groups of cp.async copies.  Device code only (sm_90a); the
// host-compilable halves of those kernels (their .cuh) do not include it.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace ippsm90 {

// wgmma descriptor of a K-major tile with the 128-byte swizzle: start
// address, leading offset 16 B (unused for this layout), stride 1024 B
// between 8-row core blocks, layout type 1 (SWIZZLE_128B).
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// until at most N of this thread's copy groups are pending
template <int N>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// the 128 threads of one warpgroup, at named barrier `id`
__device__ __forceinline__ void wg_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(128) : "memory");
}
// st.shared (generic proxy) before wgmma reads (async proxy)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// keep the compiler from moving registers that a wgmma reads or writes
// across it
template <int R>
__device__ __forceinline__ void pin(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// until the phase of parity `parity` of the barrier has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

}  // namespace ippsm90
