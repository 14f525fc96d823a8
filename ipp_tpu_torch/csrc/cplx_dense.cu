// K7d: the dense complex product (rr + i*ii) = (re + i*im) @ (mr + i*mi)
// of (M, K) data and (K, N) matrices, f32-grade on Hopper's tensor cores
// (3xTF32 on wgmma).
//
// Replaces ipp_tpu/ops/pallas_fft.py `_fused_call` (its inline kernel,
// :54-62; reached through `fused_cplx_matmul`, :94-115) for an arbitrary
// matrix and for DFT lengths without an FFT plan: Karatsuba's three real
// products t1 = re@mr, t2 = im@mi, t3 = (re+im)@mri (mri = mr + mi),
// rr = t1 - t2, ii = t3 - t1 - t2.  The DFT of an axis with a plan runs on
// K7's FFT kernels (dft_fft.cuh, stage_large.cuh; ops/cuda_fft.dft_route).
// M, K and N are any sizes >= 1, at any alignment.
//
// Precision.  The TPU kernel split each operand into bf16 hi/lo and ran
// three MXU passes a product.  Here each operand is split into TF32 hi/lo
// (rdft_dense.cuh `split_tf32`; re + im formed in f32 before its split) and
// each of the three products runs hi.hi + lo.hi + hi.lo on wgmma: ~2^-21
// relative per term.  The tensor cores' f32 accumulate truncates, so each
// consumer folds its three accumulators into two f32 sums in shared memory
// every FLUSH stages (256 of K; rr += t1 - t2, ii += t3 - t1 - t2, round
// to nearest) and starts them again from zero: within 1e-5 of max of the
// plain f32 product (tests/test_torch_cplx_dense.py emulates it).  No TF32
// flag of PyTorch is involved.
//
// Bound.  Three real products at three products each, 18 M K N
// operations at the bf16 rate, 989 TFLOP/s (bf16's split, the TPU's, is
// within 1e-5 of max at every case too: scripts/cplx_dense_bench.py
// --precision; TF32 runs at half that rate, with 2^-21 per term against
// bf16's 2^-16): 3.61 ms at (149504, 1152) x (1152, 1152), where the bytes
// (data, matrices and outputs once) take 1.65 ms, so the tensor-core rate
// bounds it; at (9792, 136) the bytes do.  What the design does about it:
// - the tensor cores do all of the products: two consumer warpgroups, each
//   64 data rows x NT = 64 matrix columns, nine m64n64k8 wgmmas per k8
//   step (Karatsuba saves a quarter of the four-product form's twelve);
// - registers bind: three m64n64 accumulators take 96 a thread and a k8
//   step's A fragments 24, so a consumer splits and issues one k8 step
//   between waits for its wgmmas, and the producer warpgroup hands
//   registers to the consumers (setmaxnreg);
// - the data is wgmma's A operand in registers: each consumer warpgroup
//   stages its rows of re and im in shared memory by asynchronous copies a
//   stage ahead (16-byte copies where K and the alignment allow them), in
//   the 128-byte swizzle, so that its threads' fragment reads hit 32 banks;
//   each thread forms re + im and splits the three in registers;
// - the matrices are the B operand, N-contiguous in memory where wgmma
//   wants K-major: one producer warpgroup loads a stage's rows of mr, mi
//   and mri a stage ahead (coalesced along n), splits them and stores each
//   thread's four k of a column as one 16-byte chunk at its swizzled place
//   (a quarter-warp covers the 32 banks once), through a ring of two slots
//   handed over by mbarriers;
// - the blocks of one row tile run next to each other (the block index
//   walks N tiles first), so the data is read from device memory about
//   once and the matrices stay in L2;
// - ragged edges are masked in the loads (zero rows, columns and k) and in
//   the stores (8-byte pairs where N is even).
// Plain C interface for ctypes: the entry launches on the given stream and
// returns the launch's cudaGetLastError().

#include "cplx_dense.cuh"
#include "sm90_async.cuh"

// Timing-only builds (scripts/cplx_dense_bench.py --variants; results
// wrong): 1 no wgmma; 2 no global loads after the first stages; 3 the
// wgmmas and barriers alone (no loads or splits after the first stages).
#ifndef IPP_CPLX_DENSE_DIAG
#define IPP_CPLX_DENSE_DIAG 0
#endif

using namespace ippcplx;
using namespace ippsm90;

namespace {

// registers a thread of the producer keeps, and a consumer takes, after
// the producer hands its surplus over (the block starts at 65536 / 384,
// rounded down to 8: 168)
constexpr int PRODUCER_REGS = 88;
constexpr int CONSUMER_REGS = 208;
static_assert(PRODUCER_REGS * WG + CONSUMER_REGS * CONSUMERS * WG <= 168 *
              NTHREADS, "the registers a block was launched with");

// One m64n64k8 TF32 wgmma, A (64 x 8) from registers, B (64 x 8) from
// shared memory (a descriptor): D = A . B + (accumulate ? D : 0) in f32.
__device__ __forceinline__ void wgmma64(float (&d)[NACC],
                                        const uint32_t (&a)[4], uint64_t db,
                                        int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

// A consumer warpgroup: its accumulators t[p] (t1, t2, t3), its f32 sums
// in shared memory, its staged data and its place in the block.
template <bool VEC>
struct Consumer {
  const Operands& op;
  uint32_t slots, full, empty;
  float* sums;
  float* raw;   // this warpgroup's data stages: [stage][re, im]
  i64 row0;     // its first data row
  int ntiles, cw, ctid, wtid;

  __device__ __forceinline__ float* raw_at(int kt) const {
    return raw + (kt % RAW) * 2 * RAW_FLOATS;
  }
  __device__ __forceinline__ void copy(int kt) const {
    if (kt < ntiles)
      stage_data<VEC>(op, row0, kt, wtid, raw_at(kt), raw_at(kt) + RAW_FLOATS);
    copy_commit();
  }
  __device__ __forceinline__ void flush(float (&t)[PRODUCTS][NACC]) const {
#pragma unroll
    for (int v = 0; v < NACC; ++v)
      fold(t[0][v], t[1][v], t[2][v], sums[v * CW + ctid],
           sums[(NACC + v) * CW + ctid]);
  }

  // k8 step kk of stage kt: wait for this warpgroup's wgmmas in flight
  // (their A registers are then free); at a stage's first step release
  // the matrix slot of stage kt - 1, fold the accumulators when due, and
  // once stage kt's staged data has landed (its own copies, then the
  // warpgroup's barrier) start the copies of stage kt + 1 into the data
  // stage that kt - 1 used; split the step's data into the A registers,
  // wait for stage kt's matrix tiles and issue its nine wgmmas.
  __device__ __forceinline__ void step(int kt, int kk,
                                       float (&t)[PRODUCTS][NACC],
                                       bool& fresh,
                                       uint32_t (&a)[PRODUCTS][2][4]) const {
    // unconditional: on no path may a register that a wgmma in flight
    // reads or writes be defined (ptxas would serialise every wgmma); an
    // accumulator is never zeroed by hand either: a fresh one starts from
    // its first wgmma (scale-d 0)
    wgmma_wait_all();
#pragma unroll
    for (int p = 0; p < PRODUCTS; ++p) pin(t[p]);
    if (kk == 0) {
      if (kt > 0) {
        if (wtid == 0) mbar_arrive(empty + 8 * ((kt - 1) % SLOTS));
        if (ippdense::flush_after(kt - 1, cw, ntiles)) {
          flush(t);
          fresh = true;
        }
      }
      copy_wait<0>();
      wg_sync(1 + cw);
      if (IPP_CPLX_DENSE_DIAG < 2) copy(kt + 1);
    }
    if (IPP_CPLX_DENSE_DIAG != 3 || kt == 0)
      split_data(raw_at(kt), raw_at(kt) + RAW_FLOATS, wtid, kk, a);
    const int s = kt % SLOTS;
    if (kk == 0) mbar_wait(full + 8 * s, (kt / SLOTS) & 1);
    const uint32_t slot = slots + (uint32_t)(s * SLOT_FLOATS * 4);
#pragma unroll
    for (int p = 0; p < PRODUCTS; ++p) pin(t[p]);
    wgmma_fence();
    if (IPP_CPLX_DENSE_DIAG != 1) {
#pragma unroll
      for (int term = 0; term < 3; ++term)
#pragma unroll
        for (int p = 0; p < PRODUCTS; ++p) {
          const uint32_t b =
              slot + (uint32_t)((2 * p + term_b(term)) * TILE * 4 + 32 * kk);
          wgmma64(t[p], a[p][term_a(term)], desc(b), term > 0 || !fresh);
        }
    }
    wgmma_commit();
    if (IPP_CPLX_DENSE_DIAG == 1) {   // keep the splits that no wgmma reads
#pragma unroll
      for (int i = 0; i < PRODUCTS * 2 * 4; ++i)
        asm volatile("" ::"r"((&a[0][0][0])[i]));
    }
    fresh = IPP_CPLX_DENSE_DIAG == 1 && fresh;
  }

};

// One block: data rows [row0, row0 + 128) x matrix columns [n0, n0 + 64),
// tile blockIdx.x: ntn column tiles a row tile, column tiles first.
// Warpgroup 0 produces the matrix tiles (stage kt into slot kt % SLOTS); 1
// and 2 consume: warpgroup 1 + g owns data rows row0 + 64g .. + 63.
template <bool VEC>
__global__ void __launch_bounds__(NTHREADS, 1)
cplx_dense(const Operands op, int ntn) {
  extern __shared__ unsigned char smem_raw[];
  float* smem = (float*)(((uintptr_t)smem_raw + 1023) & ~(uintptr_t)1023);
  float* sums = smem + SLOTS * SLOT_FLOATS;
  const uint32_t full = ippdense::smem_u32(smem + BAR_OFFSET);  // +8s
  const uint32_t empty = full + 8 * SLOTS;                       // +8s
  const int tid = threadIdx.x, role = tid / WG;
  const int n0 = (int)(blockIdx.x % ntn) * NT;
  const i64 row0 = (i64)(blockIdx.x / ntn) * BM;
  const int ntiles = max(1, (op.K + BK - 1) / BK);
  if (tid == 0) {
    for (int s = 0; s < SLOTS; ++s) {
      mbar_init(full + 8 * s, WG);           // every producer thread
      mbar_init(empty + 8 * s, CONSUMERS);   // one thread of each consumer
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (role < PRODUCERS) {
    // the producer: stage kt + 1's tiles are loaded right after stage kt's
    // are stored, so their loads are in flight while it waits for a slot
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    float4 w[MATS][MAT_CHUNKS];
    load_mats(op, 0, n0, tid, w);
    for (int kt = 0; kt < ntiles; ++kt) {
      const int s = kt % SLOTS;
      mbar_wait(empty + 8 * s, ((kt / SLOTS) & 1) ^ 1);
      if (IPP_CPLX_DENSE_DIAG != 3 || kt < SLOTS)
        store_mats(smem + s * SLOT_FLOATS, tid, w);
      fence_async_smem();
      mbar_arrive(full + 8 * s);
      if (kt + 1 < ntiles && (IPP_CPLX_DENSE_DIAG < 2 || kt + 1 < SLOTS))
        load_mats(op, kt + 1, n0, tid, w);
    }
    return;
  }

  // consumer cw: per k8 step its A fragments split in
  // registers, nine wgmmas a k8 step into t1, t2, t3, which are folded into
  // its f32 sums (rr, ii: NACC each a thread, [v][consumer thread]) every
  // FLUSH stages.  Its data tiles are staged in shared memory by
  // asynchronous copies, a stage ahead.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int cw = role - PRODUCERS, ctid = tid - PRODUCERS * WG;
  const int wtid = ctid & (WG - 1);
  float t[PRODUCTS][NACC];
#pragma unroll
  for (int v = 0; v < NACC; ++v) {
#pragma unroll
    for (int p = 0; p < PRODUCTS; ++p) t[p][v] = 0.f;
    sums[v * CW + ctid] = 0.f;
    sums[(NACC + v) * CW + ctid] = 0.f;
  }
  bool fresh = true;   // the next step starts the accumulators afresh
  uint32_t a[PRODUCTS][2][4];
  const Consumer<VEC> cs{
      op,   ippdense::smem_u32(smem), full, empty, sums,
      smem + RAW_OFFSET + cw * RAW * 2 * RAW_FLOATS,
      row0 + ROWS * cw, ntiles, cw, ctid, wtid};
  cs.copy(0);
  for (int kt = 0; kt < ntiles; ++kt) {
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) cs.step(kt, kk, t, fresh, a);
  }
  wgmma_wait_all();
#pragma unroll
  for (int p = 0; p < PRODUCTS; ++p) pin(t[p]);
  if (!fresh) cs.flush(t);

#pragma unroll 4
  for (int v = 0; v < NACC; v += 2) {
    const ippdense::AccSlot sl = ippdense::acc_slot(wtid, v);
    store_pair(op, cs.row0 + sl.c, n0 + sl.r, sums[v * CW + ctid],
               sums[(v + 1) * CW + ctid], sums[(NACC + v) * CW + ctid],
               sums[(NACC + v + 1) * CW + ctid]);
  }
}

inline bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

template <bool VEC>
int launch(const Operands& op, cudaStream_t st) {
  const cudaError_t e = cudaFuncSetAttribute(
      cplx_dense<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  const int ntn = (op.N + NT - 1) / NT;
  const long long tiles = (op.M + BM - 1) / BM * ntn;
  if (tiles > 0x7FFFFFFFLL) return (int)cudaErrorInvalidConfiguration;
  cplx_dense<VEC><<<(unsigned)tiles, NTHREADS, SMEM_BYTES, st>>>(op, ntn);
  return (int)cudaGetLastError();
}

}  // namespace
extern "C" {

// re, im (M, K); mr, mi, mri (K, N); rr, ii (M, N); all row-major f32.
int ipp_cplx_matmul(const float* re, const float* im, const float* mr,
                    const float* mi, const float* mri, float* rr, float* ii,
                    long long M, int K, int N, void* stream) {
  const Operands op{re, im, mr, mi, mri, rr, ii, M, K, N};
  // 16-byte data copies when K is a multiple of 4 and re, im are aligned
  const bool vec = K % 4 == 0 && aligned16(re) && aligned16(im);
  cudaStream_t st = (cudaStream_t)stream;
  return vec ? launch<true>(op, st) : launch<false>(op, st);
}

}  // extern "C"
