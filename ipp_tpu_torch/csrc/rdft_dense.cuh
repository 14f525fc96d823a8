// Index maps and arithmetic of the dense K1 / K2 kernels (rdft_dense.cu):
// the y real DFT (and its inverse) as one f32-grade product against a
// constant matrix, on Hopper's tensor cores as three TF32 products.
//
// Everything here is plain C++ that the host compiler also builds
// (tests/torch_rdft_dense_host/check.cpp): the operands' addressing, the
// masks, the split, the producer's matrix loads and stores and each
// consumer thread's data copies and fragment reads are checked without a
// card; the kernel's roles (wgmma, descriptors, barriers) and its launch
// are rdft_dense.cu.
//
// The product of one plane, seen by the kernel: C^T (nx x R) = D^T (nx x K)
// . W^T (K x R), with
//   D (K x nx): the data plane, row k at a stride of its own (x contiguous),
//   W (R x K):  the constant matrix, row-major (k contiguous),
// so wgmma's M runs over data columns (BM = 128 a block, 64 a consumer
// warpgroup), its N over matrix rows (NT = 136 a block) and its K over the
// contraction.  D^T is wgmma's A operand, in registers: each consumer
// warpgroup stages its columns of the data tile in shared memory, and each
// thread reads its own fragment elements from there and splits them.  W^T
// is the B operand, K-major in shared memory as TF32 wgmma requires, which
// is W's own layout.
//
// B tile layout: NT rows of BK = 32 floats, one 128-byte line a row, with
// the 128-byte swizzle: the 16-byte chunk q of row r sits at chunk
// q ^ (r % 8).  Eight rows make one 1024-byte core block (the descriptor's
// stride byte offset); a k8 step starts 32 bytes further.

#pragma once

#include <cfloat>
#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

namespace ippdense {

typedef long long i64;

constexpr int BM = 128;        // data columns (wgmma M) per block
constexpr int NT = 136;        // matrix rows (wgmma N) per block: 1072 and
                               // 1056 rows, the CLI block's, pad to 1088
constexpr int BK = 32;         // contraction depth per stage: one 128-byte row
constexpr int WG = 128;        // threads of a warpgroup
constexpr int PRODUCERS = 1;   // warpgroups that load and split the matrix
constexpr int CONSUMERS = 2;   // warpgroups that run wgmma, 64 columns each
constexpr int NTHREADS = WG * (PRODUCERS + CONSUMERS);
constexpr int FLUSH = 8;       // stages between flushes of the tensor-core
                               // accumulator into the f32 sum
constexpr int RP = 72;         // floats a row of a staged data tile (64 + 8:
                               // fragment reads hit 32 banks)
constexpr int NACC = NT / 2;   // accumulator registers of a consumer thread
constexpr int KSTEPS = BK / 8; // wgmma k8 steps per stage
constexpr int MAT_CHUNKS = (NT * BK / 4 + WG - 1) / WG;   // 9, the last for
                                                         // half the threads

// Float offset of element (row, k) of a swizzled K-major tile.
__host__ __device__ __forceinline__ int swz(int row, int k) {
  return row * BK + ((((k >> 2) ^ (row & 7)) << 2) | (k & 3));
}

// Floats of one matrix slot: [hi | lo].
constexpr int SLOT_FLOATS = 2 * NT * BK;
// Floats of the f32 sums: NACC per consumer thread, [v][consumer thread].
constexpr int SUM_FLOATS = NACC * CONSUMERS * WG;
// Floats of one staged data tile of a consumer: BK rows of its 64 columns.
constexpr int RAW_FLOATS = BK * RP;

// Element i (< 4) of a consumer thread's A fragment of a k8 step: column c
// (of its warpgroup's 64) and k (of the step's 8), as wgmma's TF32 A
// register fragment lays them (per warp 16 columns; a0 (g, t), a1 (g + 8,
// t), a2 (g, t + 4), a3 (g + 8, t + 4), g = lane / 4, t = lane % 4).  With
// the staged tile's row pitch RP = 8 mod 32, a warp's read of element i
// hits 32 banks.
struct AFrag {
  int c, k;
};
__host__ __device__ __forceinline__ AFrag a_frag(int wg_tid, int i) {
  const int warp = wg_tid >> 5, lane = wg_tid & 31;
  return AFrag{16 * warp + (lane >> 2) + 8 * (i & 1),
               (lane & 3) + 4 * (i >> 1)};
}

// Chunk i of the producer thread's matrix tile: k..k+3 of row r; a warp
// reads four rows' 128 bytes, a quarter-warp stores one row's eight chunks.
// Valid while r < NT (the ninth chunk: the first half of the threads).
struct MatChunk {
  int r, k;
};
__host__ __device__ __forceinline__ MatChunk mat_chunk(int ptid, int i) {
  const int e = ptid + WG * i;
  return MatChunk{e >> 3, 4 * (e & 7)};
}

// Accumulator element v of a consumer thread (wgmma's f32 D fragment):
// column c (of its warpgroup's 64) and matrix row r (of the block's NT).
struct AccSlot {
  int c, r;
};
__host__ __device__ __forceinline__ AccSlot acc_slot(int wg_tid, int v) {
  const int warp = wg_tid >> 5, lane = wg_tid & 31;
  return AccSlot{16 * warp + (lane >> 2) + 8 * ((v >> 1) & 1),
                 8 * (v >> 2) + 2 * (lane & 3) + (v & 1)};
}

// Does consumer warpgroup cw flush its accumulator after stage kt?  Every
// FLUSH stages, the two warpgroups half a period apart so that one keeps
// the tensor cores busy while the other flushes; and after the last stage.
__host__ __device__ __forceinline__ bool flush_after(int kt, int cw,
                                                     int ntiles) {
  return kt % FLUSH == (cw ? FLUSH - 1 : FLUSH / 2 - 1) || kt == ntiles - 1;
}

__host__ __device__ __forceinline__ uint32_t bits_of(float f) {
#ifdef __CUDA_ARCH__
  return __float_as_uint(f);
#else
  uint32_t u;
  memcpy(&u, &f, 4);
  return u;
#endif
}

__host__ __device__ __forceinline__ float float_of(uint32_t u) {
#ifdef __CUDA_ARCH__
  return __uint_as_float(u);
#else
  float f;
  memcpy(&f, &u, 4);
  return f;
#endif
}

// f32 -> TF32 (10 fraction bits), round to nearest even, low 13 bits zero:
// the tensor core reads the top 19 bits of the word.
__host__ __device__ __forceinline__ float tf32_rne(float v) {
#ifdef __CUDA_ARCH__
  uint32_t u;
  asm("cvt.rn.tf32.f32 %0, %1;" : "=r"(u) : "f"(v));
  return float_of(u & 0xFFFFE000u);
#else
  const uint32_t u = bits_of(v);
  return float_of((u + 0x0FFFu + ((u >> 13) & 1u)) & 0xFFFFE000u);
#endif
}

// v = hi + lo + O(2^-21 |v|): hi = tf32(v) rounded to nearest even, lo =
// v - hi (exact in f32) cut to TF32 toward zero.  The product then keeps
// hi.hi + lo.hi + hi.lo and drops lo.lo and the cut, ~2^-21 relative per
// term.
__host__ __device__ __forceinline__ void split_tf32(float v, float& hi,
                                                    float& lo) {
  hi = tf32_rne(v);
  lo = float_of(bits_of(v - hi) & 0xFFFFE000u);
}
__host__ __device__ __forceinline__ void split_tf32(float4 v, float4& hi,
                                                    float4& lo) {
  split_tf32(v.x, hi.x, lo.x);
  split_tf32(v.y, hi.y, lo.y);
  split_tf32(v.z, hi.z, lo.z);
  split_tf32(v.w, hi.w, lo.w);
}

enum Mode { FWD = 0, FWD_RATIO = 1, INV = 2, INV_MUL = 3 };

// The rings of a mode: matrix slots, and data stages a consumer keeps (the
// ratio's den doubles the data, so it keeps two of each).
template <int MODE>
struct Ring {
  static constexpr int SLOTS = MODE == FWD_RATIO ? 2 : 3;
  static constexpr int RAW = MODE == FWD_RATIO ? 2 : 3;
  static constexpr int STREAMS = MODE == FWD_RATIO ? 2 : 1;
  // Dynamic shared memory of a block: [matrix slots | sums | staged data
  // [consumer][stage][stream] | mbarriers], and room to align the base to
  // the 1024-byte swizzle period.
  static constexpr int RAW_OFFSET = SLOTS * SLOT_FLOATS + SUM_FLOATS;
  static constexpr int BAR_OFFSET =
      RAW_OFFSET + CONSUMERS * RAW * STREAMS * RAW_FLOATS;
  static constexpr int SMEM_BYTES = BAR_OFFSET * 4 + 16 * SLOTS + 1024;
};

// The operands of one plane a = b*nz + z.  K1d (FWD, FWD_RATIO): data row
// k is row k of num[a] (and den[a]), the matrix is fwd (2kp x ny), output
// row r goes to re[b, r, z, :] (r < kp) or im[b, r - kp, z, :].  K2d (INV,
// INV_MUL): data row k is re[b, k, z, :] (k < kp) or im[b, k - kp, z, :],
// the matrix is inv (ny x 2kp), output row r is row r of out[a].
template <int MODE>
struct Plane {
  static constexpr bool FWDK = MODE <= FWD_RATIO;
  const float* s0;   // num, or re
  const float* s1;   // den, or im
  int nz, ny, nx, kp, b, z, a;

  __device__ __forceinline__ int rows() const { return FWDK ? 2 * kp : ny; }
  __device__ __forceinline__ int depth() const { return FWDK ? ny : 2 * kp; }
  // offset of row k of this plane in a (nb, kp, nz, nx) spectrum
  __device__ __forceinline__ i64 spec_row(int k) const {
    return (((i64)b * kp + k) * nz + z) * nx;
  }
  // data row k (0 <= k < depth()), and the ratio's den row
  __device__ __forceinline__ const float* row(int k) const {
    if (FWDK) return s0 + ((i64)a * ny + k) * nx;
    return k < kp ? s0 + spec_row(k) : s1 + spec_row(k - kp);
  }
  __device__ __forceinline__ const float* den_row(int k) const {
    return s1 + ((i64)a * ny + k) * nx;
  }
  // the epilogue: output row r, column c of C (K1d: d0 = re, d1 = im;
  // K2d: d0 = out, with INV_MUL |mul * v|)
  __device__ __forceinline__ void store(float* d0, float* d1,
                                        const float* mul, int r, int c,
                                        float v) const {
    if (FWDK) {
      (r < kp ? d0 + spec_row(r) : d1 + spec_row(r - kp))[c] = v;
    } else {
      const i64 off = ((i64)a * ny + r) * nx + c;
      d0[off] = MODE == INV_MUL ? fabsf(mul[off] * v) : v;
    }
  }
};

// Copy i of a consumer thread's share of staging a data tile (BK rows x
// its warpgroup's 64 columns): 16 bytes (VEC: columns c..c+3, i < 4) or 4
// bytes (i < 16) of row k.  A warp copies 128 contiguous bytes of a row
// (VEC: two rows' 256), and its stores are contiguous.
struct Copy {
  int k, c;
};
template <bool VEC>
__host__ __device__ __forceinline__ Copy data_copy(int wg_tid, int i) {
  const int e = wg_tid + WG * i;
  return VEC ? Copy{e >> 4, 4 * (e & 15)} : Copy{e >> 6, e & 63};
}
template <bool VEC>
__host__ __device__ constexpr int copies() {
  return VEC ? BK * 64 / 4 / WG : BK * 64 / WG;
}

// the shared-memory address of p (0 in the host build)
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
#ifdef __CUDA_ARCH__
  return (uint32_t)__cvta_generic_to_shared(p);
#else
  (void)p;
  return 0u;
#endif
}

// An asynchronous copy of 4 or 16 bytes (BYTES) into shared memory, zeros
// where `ok` is false (the source is then not read).  The host build
// copies at once.
template <int BYTES>
__device__ __forceinline__ void copy_async(float* dst, const float* src,
                                           bool ok) {
#ifdef __CUDA_ARCH__
  if (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "r"(ok ? 16 : 0)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "r"(ok ? 4 : 0)
                 : "memory");
#else
  for (int j = 0; j < BYTES / 4; ++j) dst[j] = ok ? src[j] : 0.f;
#endif
}

// Consumer thread wg_tid's copies of stage kt's data tile (its warpgroup's
// columns from c0) into raw (and the ratio's den into raw_den), zeros
// outside the plane.  VEC: nx a multiple of 4, the data 16-byte aligned.
template <int MODE, bool VEC>
__device__ __forceinline__ void stage_data(const Plane<MODE>& p, int kt,
                                           int c0, int wg_tid, float* raw,
                                           float* raw_den) {
  const int K = p.depth();
#pragma unroll
  for (int i = 0; i < copies<VEC>(); ++i) {
    const Copy cp = data_copy<VEC>(wg_tid, i);
    const int k = kt * BK + cp.k, c = c0 + cp.c;
    const bool ok = k < K && c < p.nx;
    const int o = cp.k * RP + cp.c;
    copy_async<VEC ? 16 : 4>(raw + o, ok ? p.row(k) + c : p.s0, ok);
    if (MODE == FWD_RATIO)
      copy_async<VEC ? 16 : 4>(raw_den + o, ok ? p.den_row(k) + c : p.s1, ok);
  }
}

// The A fragments of k8 step kk from a staged data tile, split into TF32
// hi and lo words (the ratio formed first).
template <int MODE>
__device__ __forceinline__ void split_data(const float* raw,
                                           const float* raw_den, int wg_tid,
                                           int kk, uint32_t (&hi)[4],
                                           uint32_t (&lo)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const AFrag f = a_frag(wg_tid, i);
    const int o = (8 * kk + f.k) * RP + f.c;
    float x = raw[o];
    // an IEEE division, as the plain version's x / clamp(den, min=eps)
    if (MODE == FWD_RATIO) x = x / fmaxf(raw_den[o], FLT_EPSILON);
    float h, l;
    split_tf32(x, h, l);
    hi[i] = bits_of(h);
    lo[i] = bits_of(l);
  }
}

// Four floats at p[0..3], those at index >= n zero.  VEC: one 16-byte
// load (p 16-byte aligned, n >= 4 or n <= 0 by the caller's shape).
template <bool VEC>
__device__ __forceinline__ float4 load4(const float* p, int n) {
  if (VEC) return n > 0 ? __ldg((const float4*)p) : make_float4(0, 0, 0, 0);
  return make_float4(n > 0 ? __ldg(p) : 0.f, n > 1 ? __ldg(p + 1) : 0.f,
                     n > 2 ? __ldg(p + 2) : 0.f, n > 3 ? __ldg(p + 3) : 0.f);
}

// Global loads of stage kt's matrix tile into the producer thread's
// registers, zero outside the matrix.  VEC: the matrix's row length a
// multiple of 4 and the matrix 16-byte aligned (the host's choice).
template <bool VEC>
__device__ __forceinline__ void load_mat(const float* mat, int R, int K,
                                         int kt, int r0, int ptid,
                                         float4 (&w)[MAT_CHUNKS]) {
#pragma unroll
  for (int i = 0; i < MAT_CHUNKS; ++i) {
    const MatChunk ch = mat_chunk(ptid, i);
    if (ch.r >= NT) break;
    const int r = r0 + ch.r, k = kt * BK + ch.k;
    w[i] = load4<VEC>(mat + (i64)r * K + k, r < R ? K - k : 0);
  }
}

// The producer thread's matrix registers of one stage, split into TF32
// hi/lo, into the slot at st ([hi | lo]), one 16-byte store a half.
__device__ __forceinline__ void store_mat(float* st, int ptid,
                                          const float4 (&w)[MAT_CHUNKS]) {
#pragma unroll
  for (int i = 0; i < MAT_CHUNKS; ++i) {
    const MatChunk ch = mat_chunk(ptid, i);
    if (ch.r >= NT) break;
    float4 h, l;
    split_tf32(w[i], h, l);
    const int o = swz(ch.r, ch.k);
    *(float4*)(st + o) = h;
    *(float4*)(st + NT * BK + o) = l;
  }
}

}  // namespace ippdense
