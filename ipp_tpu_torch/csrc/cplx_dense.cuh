// Index maps and arithmetic of K7d (cplx_dense.cu): the complex product
// (rr + i*ii) = (re + i*im) @ (mr + i*mi) of (M, K) data and (K, N)
// matrices, all row-major f32, as one f32-grade GEMM on Hopper's tensor
// cores: Karatsuba's three real products t1 = re.mr, t2 = im.mi, t3 =
// (re + im).mri (mri = mr + mi, passed in), each as three TF32 products.
//
// Everything here is plain C++ that the host compiler also builds
// (tests/torch_cplx_dense_host/check.cpp): the operands' addressing, the
// masks of ragged M, K and N, the split, the producer's matrix loads and
// its transposed swizzled stores, each consumer thread's data copies and
// fragment reads, the fold of the three products and the map from
// accumulator fragments to outputs are checked without a card; the
// kernel's roles (wgmma, descriptors, barriers) and its launch are
// cplx_dense.cu.  The split, the swizzle, the fragment layouts, the flush
// schedule and the asynchronous copies are rdft_dense.cuh's.
//
// Seen by the kernel: wgmma's M runs over data rows (BM = 128 a block, 64
// a consumer warpgroup), its N over matrix columns (NT = 64 a block) and
// its K over the contraction.  The data is wgmma's A operand, in
// registers: each consumer warpgroup stages its 64 rows of re and im
// (k contiguous) in shared memory, and each thread reads its own fragment
// elements from there, forms re + im and splits all three.  The matrices
// are the B operand, which TF32 wgmma takes K-major only, and they are N
// contiguous: the producer loads rows k (coalesced along n), splits them
// and stores them transposed into the 128-byte-swizzled K-major tile
// (`swz`), thread (n, q) holding k = 4q..4q+3 of column n as one 16-byte
// chunk.  The data tiles use the same swizzle (64 rows of BK floats), so
// a warp's fragment reads hit 32 banks.

#pragma once

#include "rdft_dense.cuh"

namespace ippcplx {

using ippdense::bits_of;
using ippdense::copy_async;
using ippdense::float_of;
using ippdense::i64;
using ippdense::split_tf32;
using ippdense::swz;

constexpr int BM = 128;          // data rows (wgmma M) per block
constexpr int NT = 64;           // matrix columns (wgmma N) per block
constexpr int BK = ippdense::BK; // contraction depth per stage (32: the
                                 // swizzled tile's 128-byte row)
constexpr int WG = ippdense::WG; // threads of a warpgroup
constexpr int PRODUCERS = 1;     // warpgroups that load and split the matrices
constexpr int CONSUMERS = 2;     // warpgroups that run wgmma, 64 rows each
constexpr int NTHREADS = WG * (PRODUCERS + CONSUMERS);
constexpr int ROWS = BM / CONSUMERS;  // data rows of a consumer warpgroup
constexpr int NACC = NT / 2;     // registers of one accumulator a thread
constexpr int KSTEPS = BK / 8;   // wgmma k8 steps per stage
constexpr int MATS = 3;          // mr, mi, mri
constexpr int PRODUCTS = 3;      // t1, t2, t3
constexpr int SLOTS = 2;         // matrix slots of the ring
constexpr int RAW = 2;           // data stages a consumer keeps: copies run
                                 // one stage ahead
constexpr int TILE = NT * BK;    // floats of one swizzled matrix tile
// Floats of one matrix slot: [mr hi | mr lo | mi hi | mi lo | mri hi |
// mri lo], each tile NT rows (n) of BK floats (k).
constexpr int SLOT_FLOATS = 2 * MATS * TILE;
// Floats of the f32 sums: rr then ii, NACC of each a consumer thread,
// [v][consumer thread].
constexpr int CW = CONSUMERS * WG;
constexpr int SUM_FLOATS = 2 * NACC * CW;
// Floats of one staged data tile: ROWS rows of BK floats, swizzled.
constexpr int RAW_FLOATS = ROWS * BK;
// Dynamic shared memory of a block: [matrix slots | sums | staged data
// [consumer][stage][re, im] | mbarriers], and room to align the base to
// the 1024-byte swizzle period.
constexpr int RAW_OFFSET = SLOTS * SLOT_FLOATS + SUM_FLOATS;
constexpr int BAR_OFFSET = RAW_OFFSET + CONSUMERS * RAW * 2 * RAW_FLOATS;
constexpr int SMEM_BYTES = BAR_OFFSET * 4 + 16 * SLOTS + 1024;
static_assert(SMEM_BYTES <= 232448, "one block's shared memory");
// chunks of 4 floats a producer thread loads of each matrix per stage
constexpr int MAT_CHUNKS = TILE / 4 / WG;

// The operands of one call.
struct Operands {
  const float* re;   // (M, K)
  const float* im;
  const float* mr;   // (K, N)
  const float* mi;
  const float* mri;
  float* rr;         // (M, N)
  float* ii;
  i64 M;
  int K, N;
};

// Chunk i of a producer thread's share of a matrix tile: column n (of the
// block's NT) and k..k+3 (of the stage's BK).  A warp loads 32 consecutive
// columns of one matrix row (128 bytes) per k, and a quarter-warp stores
// eight columns' chunks, which the swizzle puts in eight distinct 16-byte
// bank groups.
struct MatChunk {
  int n, k;
};
__host__ __device__ __forceinline__ MatChunk mat_chunk(int ptid, int i) {
  return MatChunk{ptid % NT, 4 * ((WG / NT) * i + ptid / NT)};
}

__host__ __device__ __forceinline__ const float* mat_of(const Operands& op,
                                                        int m) {
  return m == 0 ? op.mr : m == 1 ? op.mi : op.mri;
}

// Global loads of stage kt's tiles of the three matrices (columns n0 ..
// n0 + NT) into the producer thread's registers, zero outside them.
__device__ __forceinline__ void load_mats(const Operands& op, int kt, int n0,
                                          int ptid,
                                          float4 (&w)[MATS][MAT_CHUNKS]) {
#pragma unroll
  for (int m = 0; m < MATS; ++m) {
    const float* mat = mat_of(op, m);
#pragma unroll
    for (int i = 0; i < MAT_CHUNKS; ++i) {
      const MatChunk ch = mat_chunk(ptid, i);
      const int n = n0 + ch.n, k = kt * BK + ch.k;
      const bool col = n < op.N;
      const float* p = mat + (i64)k * op.N + n;
      w[m][i] = make_float4(
          col && k < op.K ? __ldg(p) : 0.f,
          col && k + 1 < op.K ? __ldg(p + op.N) : 0.f,
          col && k + 2 < op.K ? __ldg(p + 2 * op.N) : 0.f,
          col && k + 3 < op.K ? __ldg(p + 3 * op.N) : 0.f);
    }
  }
}

// The producer thread's registers of one stage, split into TF32 hi / lo,
// stored transposed into the slot at st: chunk k..k+3 of column n at
// swz(n, k) of each matrix's hi and lo tiles, one 16-byte store each.
__device__ __forceinline__ void store_mats(float* st, int ptid,
                                           const float4 (&w)[MATS][MAT_CHUNKS]) {
#pragma unroll
  for (int m = 0; m < MATS; ++m)
#pragma unroll
    for (int i = 0; i < MAT_CHUNKS; ++i) {
      const MatChunk ch = mat_chunk(ptid, i);
      float4 h, l;
      split_tf32(w[m][i], h, l);
      const int o = swz(ch.n, ch.k);
      *(float4*)(st + 2 * m * TILE + o) = h;
      *(float4*)(st + (2 * m + 1) * TILE + o) = l;
    }
}

// Copy i of a consumer thread's share of staging a data tile (its 64 rows
// x BK): 16 bytes (VEC: k..k+3 of row m, i < 4) or 4 bytes (i < 16).  A
// warp copies 128 contiguous bytes of a row (VEC: four rows' 512).
struct Copy {
  int m, k;
};
template <bool VEC>
__host__ __device__ __forceinline__ Copy data_copy(int wtid, int i) {
  const int e = wtid + WG * i;
  return VEC ? Copy{e >> 3, 4 * (e & 7)} : Copy{e >> 5, e & 31};
}
template <bool VEC>
__host__ __device__ constexpr int copies() {
  return VEC ? ROWS * BK / 4 / WG : ROWS * BK / WG;
}

// Consumer thread wtid's copies of stage kt's data tile (rows row0 ..
// row0 + 63) of re and im into raw_re and raw_im, swizzled, zeros outside
// the data.  VEC: K a multiple of 4 and re, im 16-byte aligned.
template <bool VEC>
__device__ __forceinline__ void stage_data(const Operands& op, i64 row0,
                                           int kt, int wtid, float* raw_re,
                                           float* raw_im) {
#pragma unroll
  for (int i = 0; i < copies<VEC>(); ++i) {
    const Copy cp = data_copy<VEC>(wtid, i);
    const i64 row = row0 + cp.m;
    const int k = kt * BK + cp.k;
    const bool ok = row < op.M && k < op.K;
    const i64 off = ok ? row * op.K + k : 0;
    const int o = swz(cp.m, cp.k);
    copy_async<VEC ? 16 : 4>(raw_re + o, op.re + off, ok);
    copy_async<VEC ? 16 : 4>(raw_im + o, op.im + off, ok);
  }
}

// The A fragments of k8 step kk from a staged data tile, split into TF32
// hi and lo words: a[p][0] hi, a[p][1] lo of product p's operand (re, im,
// re + im, the sum formed in f32 before its split).
__device__ __forceinline__ void split_data(const float* raw_re,
                                           const float* raw_im, int wtid,
                                           int kk,
                                           uint32_t (&a)[PRODUCTS][2][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const ippdense::AFrag f = ippdense::a_frag(wtid, i);
    const int o = swz(f.c, 8 * kk + f.k);
    const float x = raw_re[o], y = raw_im[o];
    const float v[PRODUCTS] = {x, y, x + y};
#pragma unroll
    for (int p = 0; p < PRODUCTS; ++p) {
      float h, l;
      split_tf32(v[p], h, l);
      a[p][0][i] = bits_of(h);
      a[p][1][i] = bits_of(l);
    }
  }
}

// The three TF32 terms of a product, in the order the kernel issues them
// per k8 step: (A word, B tile) = (hi, hi), (lo, hi), (hi, lo).
__host__ __device__ __forceinline__ int term_a(int term) { return term == 1; }
__host__ __device__ __forceinline__ int term_b(int term) { return term == 2; }

// Karatsuba's fold of one flush, in f32: rr += t1 - t2, ii += t3 - t1 - t2.
__host__ __device__ __forceinline__ void fold(float t1, float t2, float t3,
                                              float& rr, float& ii) {
  rr += t1 - t2;
  ii += (t3 - t1) - t2;
}

// Outputs v and v + 1 of a consumer thread (an even v: columns n, n + 1 of
// row `row`, ippdense::acc_slot), masked; one 8-byte store each of rr and
// ii where N is even (the row's start then 8-byte aligned).
__device__ __forceinline__ void store_pair(const Operands& op, i64 row, int n,
                                           float r0, float r1, float i0,
                                           float i1) {
  if (row >= op.M || n >= op.N) return;
  const i64 o = row * op.N + n;
  if (op.N % 2 == 0) {
    *(float2*)(op.rr + o) = make_float2(r0, r1);
    *(float2*)(op.ii + o) = make_float2(i0, i1);
    return;
  }
  op.rr[o] = r0;
  op.ii[o] = i0;
  if (n + 1 < op.N) {
    op.rr[o + 1] = r1;
    op.ii[o + 1] = i1;
  }
}

}  // namespace ippcplx
