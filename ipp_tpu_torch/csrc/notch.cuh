// K8 — the destripe notch along either axis of (B, H, W) f32 tiles, for
// Hopper.
//
// The function (ops/destripe.filter_coefficient): every line of length n
// along the axis (axis -1: the rows, n = W; axis -2: the columns, n = H) goes
// to
//
//   y = irfft(rfft(x) * g, n),      g = notch(n / 2 + 1, sigma)  (real)
//
// which is y = Re IDFT(G . DFT(x)) with G[k] = g[min(k, n - k)].  G is real
// and even in k, so it maps a real line to a real line, and two real lines
// share one complex transform: with z = x_a + i x_b,
//
//   IDFT(G . DFT(z)) = y_a + i y_b.
//
// The two lines of a transform are lines 2i and 2i + 1 of one tile (rows
// 2i, 2i + 1 along x; columns 2i, 2i + 1 along y, one float2 in memory);
// an odd last line of a tile goes alone (x_b = 0).
//
// It replaces no Pallas kernel: the reference notches with the XLA FFT
// (ipp_tpu/ops/destripe.py:168-172, jnp.fft.rfft, multiply, irfft; its
// circulant-matmul form is a TPU lever, not ported).  It takes the place of
// cuFFT (torch.fft.rfft / irfft), which picks its algorithm by the batch
// count, so a destriped tile moved with the batch it came in.  Here each
// output line is computed from its own line pair, n and g alone: no sum
// runs across line pairs, and the plan, the passes and the order of every
// operation depend on n alone, never on the batch, the grid, the block or
// the line's position.  So a batch gives bit for bit its single tiles.
//
// Algorithm: dft_fft.cuh's Stockham passes (`fft_pass` with its specialised
// radices 2, 3, 4, 5, 7, 8, 9, 11, 13, 16 in any pass, and one generic odd
// pass last; plan `ops/cuda_notch.notch_plan(n)`, any n >= 1), forward, the
// product with G / n at the last forward pass's store, inverse; twiddles
// from the float64 table rounded once to f32 (dft_mats.stage_twiddles).
// One block item holds CP line pairs: it loads them from device memory
// into one of two float2 buffers, runs the 2P passes buffer to buffer (a
// barrier after each), and stores buffer 0 back, so each value crosses
// device memory once each way.
//
// Layouts, one code path (`at` below):
// - rows (axis -1): thread j of T in pair c; pair c's slots at c * pitch +
//   e + (e >> 4) * pad (dft_fft.cuh's padded slots, odd pitch); a warp's
//   loads and stores run along a row;
// - columns (axis -2): CP column pairs side by side, lanes along W (c =
//   tid % CP), slot e * CP + c; a warp's loads are CP * 8-byte runs of a
//   row (float2 where W is even and the tensors 8-byte aligned), no
//   transpose.  CP is the largest power of two up to 16 whose two buffers
//   fit half the shared memory (two blocks an SM): 4 at n = 1344, 16 up to
//   n = 454.
// Where even one line pair's two buffers exceed the 227 KB of shared
// memory (n from 14528 on), the buffers live in
// a scratch of device memory the wrapper allocates, one pair of buffers a
// block, and the blocks walk the items; the passes are the same code.
//
// Bound by bytes: 4 in and 4 out an element (8 n log2 n flops a line pair
// are far below the bytes at these lengths).
//
// The geometry and the load, pass and store steps are functions of (item,
// thread) that a host compiler also takes, so tests/torch_notch_host/ runs
// them thread by thread on the host; the kernel (CUDA only) runs them
// between barriers.

#pragma once

#include "dft_fft.cuh"

namespace ippnotch {

typedef long long i64;
using ippdft::Plan;

constexpr int MAX_N = 32768;             // ops/cuda_notch.NOTCH_MAX_N
constexpr int SMEM_LIMIT = 227 * 1024;
constexpr int MAX_THREADS = 512;
constexpr int ROWS_THREADS = 160;        // threads a rows block aims at
constexpr int ROW_PAD = 1;
constexpr int COLS_MAX = 16;             // column pairs a columns block
// for timing only (scripts/notch_bench.py --variants; wrong results): 1
// skips the passes, 2 the loads and stores of device memory
#ifndef IPP_NOTCH_DIAG
#define IPP_NOTCH_DIAG 0
#endif

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// A plan K8 takes: the radices multiply to n, each is a specialised radix
// but possibly the last, which is then the generic pass of an odd radix
// (1 only for n = 1).
inline bool notch_plan_ok(const Plan& pl) {
  if (pl.n < 1 || pl.n > MAX_N || pl.npass < 1 ||
      pl.npass > ippdft::MAX_PASSES)
    return false;
  i64 prod = 1;
  for (int p = 0; p < pl.npass; ++p) {
    const int r = pl.radix[p];
    const bool generic = pl.generic && p == pl.npass - 1;
    if (generic ? (r < 1 || r % 2 == 0) : !ippdft::special(r)) return false;
    prod *= r;
  }
  return prod == pl.n;
}

// -- geometry -----------------------------------------------------------------

struct Geo {
  int n;
  int cols;      // 1: the lines are columns (axis -2)
  i64 B;
  int H, W;      // the input is (B, H, W)
  int CP;        // line pairs a block item
  int T;         // threads a line pair
  int threads;   // CP * T
  int pad;       // rows: slot e + (e >> 4) * pad
  int pitch;     // rows: slots between pairs (odd)
  int buf;       // float2 slots of one of the two buffers
  int smem;      // bytes of shared memory; 0: the buffers are in the scratch
  int tiles;     // columns: items a tile (blocks of CP column pairs)
  int vec2;      // columns: float2 loads and stores
  i64 pairs;     // line pairs of the input
  i64 items;
};

// threads a line pair: n / 8, n / 16 from 512 on (dft_fft.cuh's rule)
inline int pair_threads(int n) {
  int t = n >= 512 ? n / 16 : n / 8;
  return t < 1 ? 1 : t > MAX_THREADS ? MAX_THREADS : t;
}

// The geometry of (B, H, W) along the columns (`cols`) or the rows;
// aligned8: the input and the output are 8-byte aligned.  False for a
// shape K8 does not take.
inline bool geometry(i64 B, int H, int W, bool cols, bool aligned8, Geo& g) {
  g.cols = cols;
  g.B = B;
  g.H = H;
  g.W = W;
  g.n = cols ? H : W;
  if (B < 1 || H < 1 || W < 1 || g.n > MAX_N) return false;
  const int n = g.n;
  const int t0 = pair_threads(n);
  if (!cols) {
    g.pad = ROW_PAD;
    g.pitch = (n - 1 + ((n - 1) >> 4) * g.pad + 1) | 1;
    g.T = t0;
    g.CP = t0 >= ROWS_THREADS ? 1 : ROWS_THREADS / t0;
    while (g.CP > 1 && 16LL * g.CP * g.pitch > SMEM_LIMIT) --g.CP;
    if (16LL * g.pitch > SMEM_LIMIT) {   // one pair: no room for a pad
      g.pad = 0;
      g.pitch = n | 1;
    }
    g.buf = g.CP * g.pitch;
    g.tiles = 0;
    g.vec2 = 0;
    g.pairs = B * (i64)cdiv(H, 2);
    g.items = (g.pairs + g.CP - 1) / g.CP;
  } else {
    g.pad = 0;
    g.pitch = n;
    g.CP = COLS_MAX;
    while (g.CP > 1 && 16LL * g.CP * n > SMEM_LIMIT / 2) g.CP /= 2;
    g.T = t0 < MAX_THREADS / g.CP ? t0 : MAX_THREADS / g.CP;
    g.buf = g.CP * n;
    g.tiles = cdiv(cdiv(W, 2), g.CP);
    g.vec2 = aligned8 && W % 2 == 0;
    g.pairs = B * (i64)cdiv(W, 2);
    g.items = B * g.tiles;
  }
  g.threads = g.CP * g.T;
  const i64 bytes = 16LL * g.buf;
  g.smem = bytes <= SMEM_LIMIT ? (int)bytes : 0;
  return true;
}

// -- a thread's place ---------------------------------------------------------

// Thread tid's line pair c of the item, its index j among the pair's T
// threads, and its slots: element e of pair c at base + e * es + (e >> 4) *
// ps of either buffer.
struct Lane {
  int c, j, base, es, ps;
};

__host__ __device__ inline Lane lane_of(const Geo& g, int tid) {
  Lane l;
  if (g.cols) {
    l.c = tid % g.CP;
    l.j = tid / g.CP;
    l.base = l.c;
    l.es = g.CP;
    l.ps = 0;
  } else {
    l.c = tid / g.T;
    l.j = tid - l.c * g.T;
    l.base = l.c * g.pitch;
    l.es = 1;
    l.ps = g.pad;
  }
  return l;
}

__host__ __device__ inline int at(const Lane& l, int e) {
  return l.base + e * l.es + (e >> 4) * l.ps;
}

// Line pair c of item k in device memory: element e of line a at a + e *
// stride, of line b at b + e * stride; `valid` 0 past the input's pairs,
// `has_b` 0 for an odd last line.
struct Pair {
  i64 a, b, stride;
  bool valid, has_b;
};

__host__ __device__ inline Pair pair_of(const Geo& g, i64 k, int c) {
  Pair r;
  if (!g.cols) {
    const i64 q = k * g.CP + c;
    const int hp = cdiv(g.H, 2);
    const i64 b = q / hp;
    const int i = (int)(q - b * hp);
    r.valid = q < g.pairs;
    r.has_b = 2 * i + 1 < g.H;
    r.a = r.valid ? (b * g.H + 2 * i) * (i64)g.W : 0;
    r.b = r.a + g.W;
    r.stride = 1;
  } else {
    const i64 b = k / g.tiles;
    const int jp = (int)(k - b * g.tiles) * g.CP + c;
    r.valid = jp < cdiv(g.W, 2);
    r.has_b = 2 * jp + 1 < g.W;
    r.a = r.valid ? b * g.H * (i64)g.W + 2 * jp : 0;
    r.b = r.a + 1;
    r.stride = g.W;
  }
  return r;
}

// -- the steps ------------------------------------------------------------------

// Load: item k's line pairs into buffer 0 as z = x_a + i x_b (0 for a
// missing line b and for pairs past the input).
__device__ __forceinline__ void load(const Geo& g, const float* __restrict__ x,
                                     float2* buf, i64 k, int tid) {
  if (IPP_NOTCH_DIAG == 2) return;
  const Lane l = lane_of(g, tid);
  const Pair r = pair_of(g, k, l.c);
  for (int e = l.j; e < g.n; e += g.T) {
    float2 v = make_float2(0.f, 0.f);
    if (r.valid) {
      const i64 o = e * r.stride;
      if (g.vec2) {
        v = *reinterpret_cast<const float2*>(x + r.a + o);
      } else {
        v.x = x[r.a + o];
        if (r.has_b) v.y = x[r.b + o];
      }
    }
    buf[at(l, e)] = v;
  }
}

// Store: buffer 0's y_a + i y_b to item k's lines.
__device__ __forceinline__ void store(const Geo& g, float* __restrict__ y,
                                      const float2* buf, i64 k, int tid) {
  if (IPP_NOTCH_DIAG == 2) return;
  const Lane l = lane_of(g, tid);
  const Pair r = pair_of(g, k, l.c);
  if (!r.valid) return;
  for (int e = l.j; e < g.n; e += g.T) {
    const float2 v = buf[at(l, e)];
    const i64 o = e * r.stride;
    if (g.vec2) {
      *reinterpret_cast<float2*>(y + r.a + o) = v;
    } else {
      y[r.a + o] = v.x;
      if (r.has_b) y[r.b + o] = v.y;
    }
  }
}

// Pass p of the plan, stride S, from src to dst.
template <bool INV, class Src, class Dst>
__device__ __forceinline__ void pass_at(const Plan& pl, int p, int S, int j,
                                        int T, const float2* __restrict__ tw,
                                        Src src, Dst dst) {
  const int R = pl.radix[p];
  if (pl.generic && p == pl.npass - 1)
    ippdft::generic_pass<INV>(j, T, R, S, tw, src, dst);
  else
    ippdft::any_pass<INV>(R, j, T, ippdft::pass_args(pl.n, R, S), tw, src,
                          dst);
}

// Step s < 2P: pass s of the forward transform (s < P) or pass s - P of the
// inverse, from buffer s % 2 to the other; the last forward pass multiplies
// by gs[e] = G[e] / n as it stores.
__device__ __forceinline__ void step(const Geo& g, const Plan& pl,
                                     const float2* __restrict__ tw,
                                     const float* __restrict__ gs,
                                     float2* buf, int s, int tid) {
  if (IPP_NOTCH_DIAG == 1) return;
  const int P = pl.npass;
  const bool inv = s >= P;
  const int p = inv ? s - P : s;
  int S = 1;
  for (int q = 0; q < p; ++q) S *= pl.radix[q];
  const Lane l = lane_of(g, tid);
  const float2* cur = buf + (s & 1) * g.buf;
  float2* nxt = buf + ((s + 1) & 1) * g.buf;
  const bool mul = s == P - 1;
  auto src = [&](int e) -> float2 { return cur[at(l, e)]; };
  auto dst = [&](int e, float2 v) {
    if (mul) {
      const float m = __ldg(gs + e);
      v.x *= m;
      v.y *= m;
    }
    nxt[at(l, e)] = v;
  };
  if (inv)
    pass_at<true>(pl, p, S, l.j, g.T, tw, src, dst);
  else
    pass_at<false>(pl, p, S, l.j, g.T, tw, src, dst);
}

#ifdef __CUDACC__

// -- the kernel -----------------------------------------------------------------

// x, y: (B, H, W); tw: (n) float2, exp(-2 pi i j / n); gs: (n) G / n.  Block
// b takes items b, b + grid, ...; scratch: two buffers a block where the
// geometry has no shared memory.
__global__ void __launch_bounds__(MAX_THREADS)
notch_kernel(const float* __restrict__ x, float* __restrict__ y,
             const float2* __restrict__ tw, const float* __restrict__ gs,
             const Geo g, const Plan pl, float2* scratch) {
  extern __shared__ float2 smem[];
  float2* buf = g.smem ? smem : scratch + (i64)blockIdx.x * 2 * g.buf;
  const int tid = threadIdx.x;
  const int steps = 2 * pl.npass;
  for (i64 k = blockIdx.x; k < g.items; k += gridDim.x) {
    load(g, x, buf, k, tid);
    __syncthreads();
    for (int s = 0; s < steps; ++s) {
      step(g, pl, tw, gs, buf, s, tid);
      __syncthreads();
    }
    store(g, y, buf, k, tid);
    __syncthreads();   // buffer 0 is free for the next item
  }
}

// -- launch ---------------------------------------------------------------------

inline bool aligned8(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 7) == 0;
}

// x, y (B, H, W) f32, along the columns (`cols`) or the rows; tw, gs as
// above; scratch: room for `nscratch` blocks' two buffers (2 * Geo::buf
// float2 each), needed only where the geometry has no shared memory (the
// grid is then at most nscratch blocks).
inline cudaError_t launch(const float* x, float* y, const float2* tw,
                          const float* gs, i64 B, int H, int W, bool cols,
                          const Plan& pl, float2* scratch, i64 nscratch,
                          cudaStream_t st) {
  Geo g;
  if (!notch_plan_ok(pl) ||
      !geometry(B, H, W, cols, aligned8(x) && aligned8(y), g) ||
      pl.n != g.n)
    return cudaErrorInvalidValue;
  i64 grid = g.items;
  if (!g.smem) {
    if (scratch == nullptr || nscratch < 1) return cudaErrorInvalidValue;
    if (grid > nscratch) grid = nscratch;
  }
  if (grid > 2147483647LL) grid = 2147483647LL;
  if (g.smem > 48 * 1024) {
    // per device, so set on every launch: it costs no device time
    const cudaError_t e = cudaFuncSetAttribute(
        notch_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, g.smem);
    if (e != cudaSuccess) return e;
  }
  notch_kernel<<<(unsigned)grid, g.threads, g.smem, st>>>(x, y, tw, gs, g, pl,
                                                          scratch);
  return cudaGetLastError();
}

#endif  // __CUDACC__

}  // namespace ippnotch
