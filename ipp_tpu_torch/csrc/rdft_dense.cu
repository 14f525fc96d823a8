// K1d and K2d: the dense forms of the y real DFT and its inverse, as
// f32-grade GEMMs on Hopper's tensor cores (3xTF32 on wgmma).
//
// Replaces (the dense form of) ipp_tpu/ops/pallas_fft.py `_v2_rfft_call_t`
// (kernel `_v2_rfft_kernel_t`), `_v2_rfft_ratio_call_t`
// (`_v2_rfft_ratio_kernel_t`), `_v2_irfft_call_t` (`_v2_irfft_kernel_t`),
// `_v2_irfft_mul_call_t` (`_v2_irfft_mul_kernel_t`) and, over a batch (grid
// z = nb*nz), `_v2_rfft_call`, `_v2_rfft_ratio_call`, `_v2_irfft_call`,
// `_v2_irfft_mul_call`: one product against an arbitrary (2kp, ny) matrix
// (K1d: rows [0, kp) to re[b, :, z, :], [kp, 2kp) to im; with RATIO of
// num / max(den, FLT_EPSILON)) or (ny, 2kp) matrix against [re; im] (K2d;
// with MUL the output is |mul * y|).  For the real-DFT fold on the v2 walk's
// shapes the real-FFT kernels of rdft_y.cuh run instead
// (ops/cuda_fft.rdft_route); these serve every other matrix and shape.
//
// Precision.  The TPU kernels split both operands into bf16 hi/lo and run
// three MXU passes (`_mm3_lhs`).  Here each operand is split into TF32
// hi/lo (rdft_dense.cuh `split_tf32`) and the products hi.hi + lo.hi +
// hi.lo run on wgmma: ~2^-21 relative per term.  The tensor cores' f32
// accumulate truncates (the card's errors match a round-toward-zero model,
// 2e-5 of max at K = 2576 when one accumulator takes the whole sum), so a
// consumer adds its accumulator into an f32 sum in shared memory (round to
// nearest) every FLUSH stages and starts it again from zero: within 1e-5
// of max of the plain f32 product (tests/test_torch_tf32_split.py emulates
// both).  No TF32 flag of PyTorch is involved.
//
// Bound.  At the CLI block (nz, ny, nx) = (256, 1056, 256) K1d is 2kp x ny
// x nx = 1072 x 1056 x 256 per plane, 148 GFLOP over 256 planes; three
// products at the bf16 rate, 989 TFLOP/s (bf16's split is within 1e-5 here
// too; TF32 runs at half that rate), take 0.45 ms, while the bytes (the
// volume once, the two half-spectrum planes once, the matrix once) take
// 0.17 ms: the tensor-core rate bounds it.  What the design does about it:
// - the tensor cores do all of the products: two consumer warpgroups, each
//   64 data columns x NT = 136 matrix rows (1072 and 1056 rows pad to
//   1088), three m64n136k8 wgmmas per k8 step;
// - the data is wgmma's A operand in registers: each consumer warpgroup
//   stages its 64 columns of the data tile in shared memory by asynchronous
//   copies two stages ahead (one for the ratio, whose den doubles them; a
//   padded row pitch), then each thread reads its own fragment elements,
//   forms the ratio and splits them in registers (the hardware's TF32
//   rounding).  Designs that split and transposed the data in shared memory
//   through producer threads were bound by those threads' stores and their
//   hand-over (and not by L2: with every load served from L1 they ran as
//   slowly); loading the fragments straight into registers a stage ahead
//   left the load latency exposed, and two stages of registers spilled;
// - the matrix is the B operand: one producer warpgroup loads its tile a
//   stage ahead with 16-byte loads, splits it and stores hi and lo with the
//   128-byte swizzle (16-byte stores, a quarter-warp one swizzle period: no
//   bank conflict), through a ring of three slots (two for the ratio)
//   handed over by mbarriers (full: stored; empty: the consumers' wgmmas
//   that read it are done);
// - each consumer waits for its products of a stage before it splits the
//   next (its registers feed them); the tensor cores' f32 accumulate
//   truncates, so each consumer adds its accumulator into f32 sums in
//   shared memory every FLUSH stages;
// - ragged edges are masked in the loads (zero rows, columns and k) and in
//   the stores: any nx, ny, kp and alignment (16-byte matrix loads when its
//   row length and address allow them).
// Plain C interface for ctypes: each entry launches on the given stream and
// returns the launch's cudaGetLastError().

#include "rdft_dense.cuh"
#include "sm90_async.cuh"

// Timing-only builds (scripts/rdft_dense_bench.py --variants; results
// wrong): 1 no wgmma; 2 no global loads after the first stages; 3 the
// wgmmas and barriers alone (no loads or splits after the first stages).
#ifndef IPP_RDFT_DENSE_DIAG
#define IPP_RDFT_DENSE_DIAG 0
#endif

using namespace ippdense;
using namespace ippsm90;

namespace {

// One m64n136k8 TF32 wgmma, A (64 x 8) from registers, B (136 x 8) from
// shared memory (a descriptor): D = A . B + (accumulate ? D : 0) in f32.
__device__ __forceinline__ void wgmma_rs(float (&d)[NACC],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %73, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n136k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67"
      "}, {%68, %69, %70, %71}, %72, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

// A consumer warpgroup's step of stage kt: wait for its products of stage
// kt - 1 (their matrix slot and the A registers are then free) and release
// that slot, flush acc when due; once stage kt's staged data has landed
// (its own copies, then the warpgroup's barrier), start the copies of stage
// kt + LEAD into the data stage that kt - 1 used, split stage kt's data into
// the A registers, wait for stage kt's matrix tile and issue its wgmmas.
template <int MODE, bool VEC>
struct Consumer {
  static constexpr int SLOTS = Ring<MODE>::SLOTS, RAW = Ring<MODE>::RAW;
  static constexpr int LEAD = RAW - 1, STREAMS = Ring<MODE>::STREAMS;
  const Plane<MODE>& p;
  uint32_t slots, full, empty;
  float* sums;
  float* raw;   // this warpgroup's data stages
  int ntiles, cw, ctid, wtid, cbase;

  __device__ __forceinline__ float* raw_at(int kt) const {
    return raw + (kt % RAW) * STREAMS * RAW_FLOATS;
  }
  __device__ __forceinline__ void copy(int kt) const {
    if (kt < ntiles)
      stage_data<MODE, VEC>(p, kt, cbase, wtid, raw_at(kt),
                            raw_at(kt) + RAW_FLOATS);
    copy_commit();
  }

  __device__ __forceinline__ void stage(int kt, float (&acc)[NACC],
                                        bool& fresh,
                                        uint32_t (&ahi)[KSTEPS][4],
                                        uint32_t (&alo)[KSTEPS][4]) const {
    // unconditional: on no path may a register that a wgmma in flight
    // reads or writes be defined (ptxas would serialise every wgmma); acc
    // is never zeroed by hand either: a fresh accumulator starts from the
    // stage's first wgmma (scale-d 0)
    wgmma_wait_all();
    pin(acc);
    if (kt > 0) {
      if (wtid == 0) mbar_arrive(empty + 8 * ((kt - 1) % SLOTS));
      if (flush_after(kt - 1, cw, ntiles)) {
#pragma unroll
        for (int v = 0; v < NACC; ++v) sums[v * CONSUMERS * WG + ctid] += acc[v];
        fresh = true;
      }
    }
    copy_wait<LEAD - 1>();
    wg_sync(1 + cw);
    if (IPP_RDFT_DENSE_DIAG < 2) copy(kt + LEAD);
    if (IPP_RDFT_DENSE_DIAG != 3 || kt == 0) {
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk)
        split_data<MODE>(raw_at(kt), raw_at(kt) + RAW_FLOATS, wtid, kk,
                         ahi[kk], alo[kk]);
    }
    const int s = kt % SLOTS;
    mbar_wait(full + 8 * s, (kt / SLOTS) & 1);
    const uint32_t bhi = slots + (uint32_t)(s * SLOT_FLOATS * 4);
    const uint32_t blo = bhi + NT * BK * 4;
    pin(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < (IPP_RDFT_DENSE_DIAG == 1 ? 0 : KSTEPS); ++kk) {
      const uint64_t dbh = desc(bhi + 32 * kk), dbl = desc(blo + 32 * kk);
      wgmma_rs(acc, ahi[kk], dbh, kk > 0 || !fresh);
      wgmma_rs(acc, alo[kk], dbh, 1);
      wgmma_rs(acc, ahi[kk], dbl, 1);
    }
    wgmma_commit();
    fresh = IPP_RDFT_DENSE_DIAG == 1 && fresh;
  }
};

// One block: data columns [c0, c0 + 128) x matrix rows [r0, r0 + NT) of
// plane blockIdx.z.  Warpgroup 0 produces the matrix tiles (stage kt into
// slot kt % SLOTS); 1 and 2 consume: warpgroup 1 + g owns data columns
// c0 + 64g .. c0 + 64g + 63.
template <int MODE, bool VEC>
__global__ void __launch_bounds__(NTHREADS, 1)
rdft_dense(const float* __restrict__ s0, const float* __restrict__ s1,
           const float* __restrict__ mat, const float* __restrict__ mul,
           float* __restrict__ d0, float* __restrict__ d1, int nz, int ny,
           int nx, int kp) {
  using RG = Ring<MODE>;
  extern __shared__ unsigned char smem_raw[];
  float* smem = (float*)(((uintptr_t)smem_raw + 1023) & ~(uintptr_t)1023);
  float* sums = smem + RG::SLOTS * SLOT_FLOATS;
  const uint32_t full = smem_u32(smem + RG::BAR_OFFSET);   // full[s] at +8s
  const uint32_t empty = full + 8 * RG::SLOTS;             // empty[s] at +8s
  const int tid = threadIdx.x, role = tid / WG;
  const int c0 = blockIdx.x * BM, r0 = blockIdx.y * NT, a = blockIdx.z;
  const int b = a / nz;
  const Plane<MODE> p{s0, s1, nz, ny, nx, kp, b, a - b * nz, a};
  const int K = p.depth(), ntiles = max(1, (K + BK - 1) / BK);
  if (tid == 0) {
    for (int s = 0; s < RG::SLOTS; ++s) {
      mbar_init(full + 8 * s, WG);           // every producer thread
      mbar_init(empty + 8 * s, CONSUMERS);   // one thread of each consumer
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (role < PRODUCERS) {
    // the producer: stage t + 1's matrix tile is loaded before the wait for
    // stage t's slot, and stage t's split is stored once the slot is free
    float4 w[2][MAT_CHUNKS];
    const int R = p.rows();
    load_mat<VEC>(mat, R, K, 0, r0, tid, w[0]);
    for (int kt = 0; kt < ntiles; kt += 2) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int t = kt + h;
        if (t >= ntiles) break;
        if (t + 1 < ntiles && (IPP_RDFT_DENSE_DIAG < 2 || t + 1 < RG::SLOTS))
          load_mat<VEC>(mat, R, K, t + 1, r0, tid, w[h ^ 1]);
        const int s = t % RG::SLOTS;
        mbar_wait(empty + 8 * s, ((t / RG::SLOTS) & 1) ^ 1);
        if (IPP_RDFT_DENSE_DIAG != 3 || t < RG::SLOTS)
          store_mat(smem + s * SLOT_FLOATS, tid, w[h]);
        fence_async_smem();
        mbar_arrive(full + 8 * s);
      }
    }
    return;
  }

  // consumer cw: for each stage, its A fragments split in registers, three
  // wgmmas a k8 step into acc, which is added into its f32 sums (NACC a
  // thread, [v][consumer thread]) every FLUSH stages.  Its data tiles are
  // staged in shared memory by asynchronous copies, LEAD stages ahead.
  const int cw = role - PRODUCERS, ctid = tid - PRODUCERS * WG;
  const int wtid = ctid & (WG - 1), cbase = c0 + 64 * cw;
  float acc[NACC];
#pragma unroll
  for (int v = 0; v < NACC; ++v) {
    acc[v] = 0.f;
    sums[v * CONSUMERS * WG + ctid] = 0.f;
  }
  bool fresh = true;   // the next stage starts acc afresh
  uint32_t ahi[KSTEPS][4], alo[KSTEPS][4];
  const Consumer<MODE, VEC> cs{
      p,    smem_u32(smem), full, empty, sums,
      smem + RG::RAW_OFFSET + cw * RG::RAW * RG::STREAMS * RAW_FLOATS,
      ntiles, cw, ctid, wtid, cbase};
  for (int j = 0; j < cs.LEAD; ++j) cs.copy(j);
  for (int kt = 0; kt < ntiles; ++kt) cs.stage(kt, acc, fresh, ahi, alo);
  wgmma_wait_all();
  pin(acc);
  if (!fresh) {
#pragma unroll
    for (int v = 0; v < NACC; ++v) sums[v * CONSUMERS * WG + ctid] += acc[v];
  }

  const int R = p.rows();
#pragma unroll 4
  for (int v = 0; v < NACC; ++v) {
    const AccSlot sl = acc_slot(wtid, v);
    const int c = cbase + sl.c, r = r0 + sl.r;
    if (c < nx && r < R)
      p.store(d0, d1, mul, r, c, sums[v * CONSUMERS * WG + ctid]);
  }
}

inline unsigned cdiv(long long a, long long b) {
  return (unsigned)((a + b - 1) / b);
}

template <int MODE, bool VEC>
int launch(const float* s0, const float* s1, const float* mat,
           const float* mul, float* d0, float* d1, int nb, int nz, int ny,
           int nx, int kp, int rows, cudaStream_t st) {
  const int bytes = Ring<MODE>::SMEM_BYTES;
  const cudaError_t e = cudaFuncSetAttribute(
      rdft_dense<MODE, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(cdiv(nx, BM), cdiv(rows, NT), nb * nz);
  rdft_dense<MODE, VEC><<<grid, NTHREADS, bytes, st>>>(
      s0, s1, mat, mul, d0, d1, nz, ny, nx, kp);
  return (int)cudaGetLastError();
}

inline bool aligned16(const void* p) {
  return p == nullptr || ((uintptr_t)p & 15) == 0;
}

// 16-byte copies and loads when nx and the matrix's row length are
// multiples of 4 and every operand is 16-byte aligned; 4-byte otherwise
template <int MODE>
int launch_mode(const float* s0, const float* s1, const float* mat,
                const float* mul, float* d0, float* d1, int nb, int nz,
                int ny, int nx, int kp, void* stream) {
  const bool fwdk = MODE <= FWD_RATIO;
  const int rows = fwdk ? 2 * kp : ny, depth = fwdk ? ny : 2 * kp;
  const bool vec = nx % 4 == 0 && depth % 4 == 0 && aligned16(s0) &&
                   aligned16(s1) && aligned16(mat);
  cudaStream_t st = (cudaStream_t)stream;
  return vec ? launch<MODE, true>(s0, s1, mat, mul, d0, d1, nb, nz, ny, nx,
                                  kp, rows, st)
             : launch<MODE, false>(s0, s1, mat, mul, d0, d1, nb, nz, ny, nx,
                                   kp, rows, st);
}

}  // namespace
extern "C" {

// den == nullptr: plain y DFT of num; otherwise of num / max(den, eps).
// num, den: (nb, nz, ny, nx); fwd: (2kp, ny); re, im: (nb, kp, nz, nx).
int ipp_rdft_y_fwd(const float* num, const float* den, const float* fwd,
                   float* re, float* im, int nb, int nz, int ny, int nx,
                   int kp, void* stream) {
  return den ? launch_mode<FWD_RATIO>(num, den, fwd, nullptr, re, im, nb, nz,
                                      ny, nx, kp, stream)
             : launch_mode<FWD>(num, nullptr, fwd, nullptr, re, im, nb, nz,
                                ny, nx, kp, stream);
}

// mul == nullptr: plain inverse y DFT; otherwise |mul * y|.
// re, im: (nb, kp, nz, nx); inv: (ny, 2kp); mul, out: (nb, nz, ny, nx).
int ipp_rdft_y_inv(const float* re, const float* im, const float* inv,
                   const float* mul, float* out, int nb, int nz, int ny,
                   int nx, int kp, void* stream) {
  return mul ? launch_mode<INV_MUL>(re, im, inv, mul, out, nullptr, nb, nz,
                                    ny, nx, kp, stream)
             : launch_mode<INV>(re, im, inv, nullptr, out, nullptr, nb, nz,
                                ny, nx, kp, stream);
}

}  // extern "C"
