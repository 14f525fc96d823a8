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
// operation depend on n alone, never on the batch, the grid, the block, the
// group or the line's position.  So a batch gives bit for bit its single
// tiles, and a grouped launch bit for bit its one-subband launches.
//
// Algorithm: in-place mixed-radix Cooley-Tukey passes on one buffer, plan
// `ops/cuda_notch.notch_plan(n)` = r_0 .. r_{P-1} (dft_fft.cuh's
// specialised radices 2, 3, 4, 5, 7, 8, 9, 11, 13, 16 and 12 = 3 x 4 here,
// the fewest passes, 12s first: 1344 = 12 16 7, 1152 = 12 12 8; one
// generic odd radix last).  Pass p has span L_p = r_p ... r_{P-1} and M_p = L_p / r_p;
// butterfly i = b M_p + m takes the elements b L_p + m + k M_p, k < r_p, and
// writes its outputs back to the same elements, so a pass needs no second
// buffer and no thread touches another's elements within a pass.
//   forward, decimation in frequency (p = 0 .. P-1): DFT_r, then the
//     twiddle w_n^(m k n / L_p); the spectrum ends digit-reversed (frequency
//     f = k_0 + r_0 k_1 + r_0 r_1 k_2 + ... at element sum_p k_p M_p);
//   the product with G[f] / n, read from a table in that digit-reversed
//     order (`gp`, built on the host), and a conjugation;
//   inverse, decimation in time (p = P-1 .. 0) on the conjugated data: the
//     twiddle w_n^(m k n / L_p), then the FORWARD DFT_r (conj(IDFT(v)) =
//     DFT(conj(v))), so the inverse needs no code of its own and ends in
//     natural order; the store takes y_b = -Im.
// The last forward pass and the first inverse pass have M = 1 (no
// twiddle) and take the same r elements, so one step runs both in
// registers around the gain ("the middle": the spectrum never goes through
// shared memory); the first forward pass loads from device memory into
// registers and the last inverse pass stores from registers.  A plan of P
// specialised passes is 2P - 1 steps with 2P - 2 exchanges through shared
// memory, one barrier each (1344: 5 steps; Stockham passes buffer to
// buffer took 10 round trips and 9 barriers).  A generic odd last radix r (not held in registers: r is a
// run-time number) runs its forward and inverse DFT as two steps of
// dft_fft.cuh's generic items (k, q) from one buffer into a second, and
// back.  A butterfly loads one twiddle w from the float64 table rounded
// once to f32 (dft_mats.stage_twiddles), which stays in L1, and takes its
// powers w^k by products.
//
// Geometry: every block has THREADS = 256 threads (8 whole warps) for every
// length and layout, so one launch serves every notch of a decomposition
// (`ipp_notch_group`: a table of up to MAX_GROUP subbands, the block finds
// its subband by the items before it, largest lengths first).  A line pair
// takes T = pow2ceil(n / VALUES) threads (about 24 values a thread a pass;
// at most THREADS), a block item CP = THREADS / T pairs:
// - rows (axis -1): thread (c = tid / T, j = tid % T); pair c's element e at
//   slot c * pitch + e + (e >> 4) (16 float2 slots are the 32 banks; the
//   pitch is odd); a warp's loads and stores run along a row;
// - columns (axis -2): CP column pairs side by side, lanes along W (c =
//   tid % CP, j = tid / CP), element e at l + (l >> 4), l = e * CP + c; a
//   warp's loads are CP * 8-byte runs of a row (float2 where W is even and
//   the tensors 8-byte aligned), no transpose.
// CP shrinks (T grows) to the pairs there are: a tile's column pairs, the
// input's row pairs.  The thread a butterfly runs on never changes its
// arithmetic.
// One buffer of CP pairs is ~43-48 KB for every n of the destripe chain,
// so four blocks (1024 threads, 16 line pairs at n = 1344) share an SM;
// the registers are cut to 64 for them (MINB; ptxas spills 172 bytes a
// thread.  Measured on an H100: 3 blocks of 80 registers without spills
// were faster along y at n = 1344 but slower along x and at 1152; 16 or
// 48 values a thread were slower, 48 giving CP = 8 column pairs and
// 64-byte runs at n = 1344; persistent blocks prefetching their next item
// into L2 too).
// Where one pair's buffers exceed the 227 KB of shared memory (n above
// ~27000, or ~13600 with a generic radix), they live in a scratch of device
// memory the wrapper allocates, one a block, the blocks walk the items: the
// long form (`notch_kernel<true>`, launched alone, up to MAX_N = 2^20); the
// passes are the same code, its index divisions 64-bit (`Div`).
//
// The chirp route (the long form only; `ops/cuda_notch.notch_route(n)`: a
// line above 32768 whose odd factor left after 3, 5, 7, 11, 13 passes
// 1024): Bluestein's chirp-z transform on the power-of-two passes of m =
// pow2ceil(2n - 1).  With c[j] = exp(-i pi (j^2 mod 2n) / n) and h =
// conj(c) laid out circularly (h[j] at j and m - j, j < n; 0 between), the
// kernel's own passes with the complex gains Hm = DFT_m(h) / m (digit-
// reversed) compute K(v) = DFT_m(conj(Hm . DFT_m(v))) = conj(v (*) h), the
// conjugated circular convolution, which is linear for the first n outputs.
// DFT(z)[k] = c[k] (z c (*) h)[k] (jk = (j^2 + k^2 - (k - j)^2) / 2), so
//
//   y = IDFT(G . DFT(z)) = conj(c) . K(pad(G / n . K(pad(c . z))))
//
// (conj(G/n . DFT(z)) . c = G/n . conj(z c (*) h), |c| = 1): the first
// half's load multiplies by c, its store keeps G[k] / n times the first n
// values (0 past them) in the buffer, the second half's store multiplies
// by conj(c) and writes y_a + i y_b itself.  2 (2P - 1) steps for P passes
// of m.
//
// Bound by bytes: 4 in and 4 out an element (8 n log2 n flops a line pair
// are far below the bytes at these lengths; the long form reads and writes
// its scratch once a step on top).
//
// The geometry and the steps are functions of (item, thread) that a host
// compiler also takes, so tests/torch_notch_host/ runs them thread by thread
// on the host; the kernel (CUDA only) runs them between barriers.

#pragma once

#include "dft_fft.cuh"

namespace ippnotch {

typedef long long i64;
using ippdft::Plan;
using ippdft::cmul;

constexpr int MAX_N = 1 << 20;           // ops/cuda_notch.NOTCH_MAX_N
constexpr int SMEM_LIMIT = 227 * 1024;
constexpr int THREADS = 256;             // every block, every length
constexpr int VALUES = 24;               // values a thread aims at a pass
constexpr int MINB = 4;                  // blocks an SM (registers cut to 64)
constexpr int MINB_LONG = 2;             // the long form's (128 registers)
constexpr int TMIN = 16;                 // threads a pair at least
constexpr int MAX_GROUP = 16;            // subbands a launch
constexpr int DESC = 24;                 // int64 words of a subband's row
// for timing only (scripts/notch_bench.py --variants; wrong results): 1
// runs no butterfly (the first pass loads, the last stores, nothing
// between), 2 reads and writes no device memory
#ifndef IPP_NOTCH_DIAG
#define IPP_NOTCH_DIAG 0
#endif

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ inline int pow2ceil(int v) {
  int p = 1;
  while (p < v) p <<= 1;
  return p;
}
__host__ __device__ inline int log2i(int v) {   // v a power of two
  int s = 0;
  while ((1 << s) < v) ++s;
  return s;
}

// The radices with a butterfly of constant roots: dft_fft.cuh's and 12.
__host__ __device__ constexpr bool special(int r) {
  return ippdft::special(r) || r == 12;
}

// The transform length of a line of n: n, or on the chirp route m =
// pow2ceil(2n - 1), where the circular convolution of n values with the
// 2n - 1 of the chirp is linear.
__host__ __device__ inline int transform_length(int n, bool chirp) {
  return chirp ? pow2ceil(2 * n - 1) : n;
}

// A plan K8 takes for lines of n: the radices multiply to the transform
// length, each is a specialised radix but possibly the last, which is then
// the generic pass of an odd radix (1 only for n = 1); the chirp route
// (lines above 32768 only) has no generic pass.
inline bool notch_plan_ok(const Plan& pl, int n, bool chirp) {
  if (n < 1 || n > MAX_N || (chirp && n <= 32768) || pl.npass < 1 ||
      pl.npass > ippdft::MAX_PASSES || pl.n != transform_length(n, chirp) ||
      (chirp && pl.generic))
    return false;
  i64 prod = 1;
  for (int p = 0; p < pl.npass; ++p) {
    const int r = pl.radix[p];
    const bool generic = pl.generic && p == pl.npass - 1;
    if (generic ? (r < 1 || r % 2 == 0) : !special(r)) return false;
    prod *= r;
  }
  return prod == pl.n;
}

// -- geometry -----------------------------------------------------------------

struct Geo {
  int n;         // the line length
  int m;         // the transform length (n, or the chirp route's)
  int chirp;     // 1: the chirp route
  int cols;      // 1: the lines are columns (axis -2)
  int H, W;      // a tile is (H, W)
  int CP;        // line pairs a block item
  int T;         // threads a line pair; CP * T = THREADS
  int cshift;    // log2 CP
  int tshift;    // log2 T
  int pitch;     // rows: slots between pairs (odd)
  int buf;       // float2 slots of one buffer
  int nbuf;      // buffers: 2 with a generic radix, else 1
  int smem;      // bytes of shared memory; 0: the buffers are in a scratch
  int tiles;     // columns: items a tile (blocks of CP column pairs)
  int vec2;      // columns: float2 loads and stores
  i64 pairs;     // line pairs of the input
  i64 items;
};

// threads a line pair: the power of two at or above n / VALUES, at least
// TMIN (short lines: more, shorter items)
__host__ __device__ inline int pair_threads(int n) {
  const int t = pow2ceil(cdiv(n, VALUES));
  return t < TMIN ? TMIN : t > THREADS ? THREADS : t;
}

// The geometry of (B, H, W) along the columns (`cols`) or the rows;
// aligned8: the input and the output are 8-byte aligned; generic: the plan
// ends in a generic pass (two buffers); chirp: the chirp route (a buffer
// of the transform length m).  False for a shape K8 does not take.
inline bool geometry(i64 B, int H, int W, bool cols, bool aligned8,
                     bool generic, bool chirp, Geo& g) {
  g.cols = cols;
  g.H = H;
  g.W = W;
  g.n = cols ? H : W;
  if (B < 1 || H < 1 || W < 1 || g.n > MAX_N) return false;
  g.chirp = chirp;
  g.m = transform_length(g.n, chirp);
  const int n = g.m;   // the buffers hold the transform
  const int t0 = pair_threads(n);
  g.CP = THREADS / t0;
  if (!cols) {
    g.pairs = B * (i64)cdiv(H, 2);
    while (g.CP > 1 && (i64)(g.CP / 2) >= g.pairs) g.CP /= 2;
    g.pitch = (n - 1 + ((n - 1) >> 4) + 1) | 1;
    g.buf = g.CP * g.pitch;
    g.tiles = 0;
    g.vec2 = 0;
    g.items = (g.pairs + g.CP - 1) / g.CP;
  } else {
    const int wp = pow2ceil(cdiv(W, 2));
    if (g.CP > wp) g.CP = wp;
    g.pitch = 0;
    const int l = g.CP * n - 1;
    g.buf = l + (l >> 4) + 1;
    g.tiles = cdiv(cdiv(W, 2), g.CP);
    g.vec2 = aligned8 && W % 2 == 0;
    g.pairs = B * (i64)cdiv(W, 2);
    g.items = B * g.tiles;
  }
  g.T = THREADS / g.CP;
  g.cshift = log2i(g.CP);
  g.tshift = log2i(g.T);
  g.nbuf = generic ? 2 : 1;
  const i64 bytes = 8LL * g.nbuf * g.buf;
  g.smem = bytes <= SMEM_LIMIT ? (int)bytes : 0;
  return true;
}

// -- a thread's place ---------------------------------------------------------

// Thread tid's line pair c of the item, its index j among the pair's T
// threads, and its slots: element e of pair c at q + (q >> 4) + base of
// either buffer, q = e * es + off (rows: c * pitch + e + (e >> 4);
// columns: l + (l >> 4), l = e * CP + c).
struct Lane {
  int c, j, base, es, off;
};

__host__ __device__ inline Lane lane_of(const Geo& g, int tid) {
  Lane l;
  if (g.cols) {
    l.c = tid & (g.CP - 1);
    l.j = tid >> g.cshift;
    l.base = 0;
    l.es = g.CP;
    l.off = l.c;
  } else {
    l.c = tid >> g.tshift;
    l.j = tid & (g.T - 1);
    l.base = l.c * g.pitch;
    l.es = 1;
    l.off = 0;
  }
  return l;
}

__host__ __device__ inline int at(const Lane& l, int e) {
  const int q = e * l.es + l.off;
  return q + (q >> 4) + l.base;
}

// i / M by a multiply-high with magic = floor((2^B - 1) / M) + 1 for any M
// >= 2: magic M = 2^B + e with 0 <= e < M, so i magic / 2^B = i / M + i e
// / (M 2^B), exact while i e < 2^B.  B = 32 (one __umulhi) holds for i and
// M below 32768, every index of the shared-memory form; the long form's
// indices reach 2^20, so it takes B = 64 (__umul64hi), exact for every i, M
// below 2^31.
__host__ __device__ inline unsigned mulhi(unsigned a, unsigned b) {
#ifdef __CUDA_ARCH__
  return __umulhi(a, b);
#else
  return (unsigned)(((unsigned long long)a * b) >> 32);
#endif
}
__host__ __device__ inline unsigned magic(int M) {
  return 0xFFFFFFFFu / (unsigned)M + 1u;
}
__host__ __device__ inline unsigned long long mulhi64(unsigned long long a,
                                                      unsigned long long b) {
#ifdef __CUDA_ARCH__
  return __umul64hi(a, b);
#else
  return (unsigned long long)(((unsigned __int128)a * b) >> 64);
#endif
}

template <bool LONG>
struct Div {   // the shared-memory form: B = 32
  unsigned mg;
  __host__ __device__ explicit Div(int M) : mg(magic(M)) {}
  __host__ __device__ int operator()(int i) const {
    return (int)mulhi((unsigned)i, mg);
  }
};
template <>
struct Div<true> {   // the long form: B = 64
  unsigned long long mg;
  __host__ __device__ explicit Div(int M)
      : mg(0xFFFFFFFFFFFFFFFFull / (unsigned)M + 1ull) {}
  __host__ __device__ int operator()(int i) const {
    return (int)mulhi64((unsigned long long)i, mg);
  }
};

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

// -- one subband ----------------------------------------------------------------

// A subband of a launch: x -> y (B, H, W) f32, its twiddle table tw (m)
// float2 exp(-2 pi i j / m), its gains gp (n) in the digit-reversed order
// of the plan (ops/cuda_notch.notch_gains; the chirp route: G / n in
// natural order), on the chirp route the chirp c (n) float2 and the
// complex gains hm (m) float2 in the plan's digit-reversed order
// (ops/cuda_notch.chirp_tables), its geometry and plan, and the first item
// of it in the launch's numbering.
struct Sub {
  const float* x;
  float* y;
  const float2* tw;
  const float* gp;
  const float2* chirp;
  const float2* hm;
  Geo g;
  Plan pl;
  i64 start;
};

// -- the steps ------------------------------------------------------------------

enum Kind { DIF, MID, DIT, LOAD, STORE, GEN_DIF, GEN_DIT, MIDC };

// Step s of an item: its kind, the pass it runs and its half (the chirp
// route's two transforms; 0 elsewhere).  P specialised passes: DIF 0 (from
// device memory) .. DIF P-2, MID (P-1), DIT P-2 .. DIT 0 (to device
// memory); a generic last radix: GEN_DIF into the second buffer and GEN_DIT
// back in place of MID; P = 1: LOAD first, the middle, STORE last (GEN_DIT
// stores itself).  The chirp route: those 2P - 1 steps twice, MIDC (the
// complex gains) in the middle, the first half's DIT 0 back into the
// buffer.
__host__ __device__ inline int num_steps(const Plan& pl, bool chirp) {
  const int P = pl.npass;
  if (chirp) return 2 * (2 * P - 1);
  if (P == 1) return 3;
  return pl.generic ? 2 * P : 2 * P - 1;
}

__host__ __device__ inline void step_of(const Plan& pl, bool chirp, int s,
                                        int& kind, int& pass, int& half) {
  const int P = pl.npass;
  half = 0;
  if (chirp) {
    half = s >= 2 * P - 1;
    if (half) s -= 2 * P - 1;
    kind = s < P - 1 ? DIF : s == P - 1 ? MIDC : DIT;
    pass = s < P ? s : 2 * P - 2 - s;
    return;
  }
  if (P == 1) {
    pass = 0;
    kind = s == 0 ? LOAD : s == 1 ? (pl.generic ? GEN_DIF : MID)
                                  : (pl.generic ? GEN_DIT : STORE);
    return;
  }
  const int mid = pl.generic ? 2 : 1;   // steps of the middle
  if (s < P - 1) {
    kind = DIF;
    pass = s;
  } else if (s < P - 1 + mid) {
    pass = P - 1;
    kind = !pl.generic ? MID : s == P - 1 ? GEN_DIF : GEN_DIT;
  } else {
    kind = DIT;
    pass = 2 * P - 3 + mid - s;
  }
}

// span L_p of pass p: the product of the radices from p on
__host__ __device__ inline int span_of(const Plan& pl, int p) {
  int L = 1;
  for (int q = p; q < pl.npass; ++q) L *= pl.radix[q];
  return L;
}

// The forward 12-point DFT as 3 x 4: 3-point DFTs of the inputs j = 4 j1 +
// j2 for each j2, the roots w12^(j2 k1), 4-point DFTs; output k = k1 + 3 k2.
__device__ __forceinline__ void dft12(float2 (&v)[12]) {
  constexpr float C = 0.86602540378443864676f;   // cos 30 degrees
  float2 t[4][3];
#pragma unroll
  for (int j2 = 0; j2 < 4; ++j2) {
    float2 a[3] = {v[j2], v[4 + j2], v[8 + j2]};
    ippdft::dft_odd<3, false>(a);
#pragma unroll
    for (int k1 = 0; k1 < 3; ++k1) t[j2][k1] = a[k1];
  }
  // w12^m = (cos, -sin)(2 pi m / 12) for m = j2 k1 in {1, 2, 3, 4, 6}
  t[1][1] = cmul(t[1][1], make_float2(C, -0.5f));
  t[1][2] = cmul(t[1][2], make_float2(0.5f, -C));
  t[2][1] = cmul(t[2][1], make_float2(0.5f, -C));
  t[2][2] = cmul(t[2][2], make_float2(-0.5f, -C));
  t[3][1] = ippdft::quarter<false>(t[3][1]);
  t[3][2] = make_float2(-t[3][2].x, -t[3][2].y);
#pragma unroll
  for (int k1 = 0; k1 < 3; ++k1) {
    ippdft::dft4<false>(t[0][k1], t[1][k1], t[2][k1], t[3][k1]);
#pragma unroll
    for (int k2 = 0; k2 < 4; ++k2) v[k1 + 3 * k2] = t[k2][k1];
  }
}

template <int R>
__device__ __forceinline__ void dft_r(float2 (&v)[R]) {
  if constexpr (R == 12)
    dft12(v);
  else
    ippdft::dft<R, false>(v);
}

// v[k] *= w^k, k = 1 .. R-1: w from the table, its powers by products
// (k - 1 roundings: within 1e-6 at R = 16, far below the 1e-5 of the
// notch), one table load a butterfly
template <int R>
__device__ __forceinline__ void twiddle(float2 (&v)[R], float2 w) {
  float2 wk = w;
#pragma unroll
  for (int k = 1; k < R; ++k) {
    v[k] = cmul(v[k], wk);
    if (k + 1 < R) wk = cmul(wk, w);
  }
}

// One specialised pass of radix R over the pair's butterflies j, j + T, ...
// of a transform of n (KIND DIF: DFT then twiddle; DIT: twiddle then DFT;
// MID: DFT, gain, conjugation, DFT; MIDC: the same with the complex gain
// hm), elements read by src(e), written by dst(e, v).
template <int R, int KIND, bool LONG, class Src, class Dst>
__device__ __forceinline__ void radix_pass(int j, int T, int n, int L,
                                           const float2* __restrict__ tw,
                                           const float* __restrict__ gp,
                                           const float2* __restrict__ hm,
                                           Src src, Dst dst) {
  const int M = L / R;
  const int NB = n / R;
  const int tscale = n / L;
  const bool pow2 = (M & (M - 1)) == 0;
  const int mshift = pow2 ? log2i(M) : 0;
  const Div<LONG> div(pow2 ? 2 : M);
  for (int i = j; i < NB; i += T) {
    int b, m;
    if (pow2) {
      b = i >> mshift;
      m = i & (M - 1);
    } else {
      b = div(i);
      m = i - b * M;
    }
    const int base = b * L + m;
    float2 v[R];
#pragma unroll
    for (int k = 0; k < R; ++k) v[k] = src(base + k * M);
    if (IPP_NOTCH_DIAG != 1) {
      const int tm = m * tscale;
      if (KIND == DIT && tm != 0) twiddle<R>(v, __ldg(&tw[tm]));
      dft_r<R>(v);
      if (KIND == MID) {
#pragma unroll
        for (int k = 0; k < R; ++k) {
          const float s = __ldg(&gp[base + k]);
          v[k] = make_float2(v[k].x * s, -(v[k].y * s));
        }
      }
      if (KIND == MIDC) {
#pragma unroll
        for (int k = 0; k < R; ++k) {
          const float2 t = cmul(v[k], __ldg(&hm[base + k]));
          v[k] = make_float2(t.x, -t.y);
        }
      }
      if (KIND == MID || KIND == MIDC) dft_r<R>(v);
      if (KIND == DIF && tm != 0) twiddle<R>(v, __ldg(&tw[tm]));
    }
#pragma unroll
    for (int k = 0; k < R; ++k) dst(base + k * M, v[k]);
  }
}

template <int KIND, bool LONG, class Src, class Dst>
__device__ __forceinline__ void any_radix(int R, int j, int T, int n, int L,
                                          const float2* __restrict__ tw,
                                          const float* __restrict__ gp,
                                          const float2* __restrict__ hm,
                                          Src src, Dst dst) {
#define IPP_NOTCH_RADIX(r)                                                \
  case r:                                                                 \
    radix_pass<r, KIND, LONG>(j, T, n, L, tw, gp, hm, src, dst);          \
    break;
  switch (R) {
    IPP_NOTCH_RADIX(2)
    IPP_NOTCH_RADIX(3)
    IPP_NOTCH_RADIX(4)
    IPP_NOTCH_RADIX(5)
    IPP_NOTCH_RADIX(7)
    IPP_NOTCH_RADIX(8)
    IPP_NOTCH_RADIX(9)
    IPP_NOTCH_RADIX(11)
    IPP_NOTCH_RADIX(12)
    IPP_NOTCH_RADIX(13)
    IPP_NOTCH_RADIX(16)
  }
#undef IPP_NOTCH_RADIX
}

// The generic DFT of odd radix r over the n / r blocks of r consecutive
// elements (M = 1: no twiddle), forward: output k of block q is sum_j
// src(q r + j) wr^(j k).  One work item (k <= r / 2, q) gives outputs k and
// r - k (their roots are conjugates); items run over the pair's T threads
// with q fastest.  GAIN: the outputs times gp and conjugated (the forward
// transform's end); dst(e, v) takes them.
template <bool GAIN, bool LONG, class Src, class Dst>
__device__ __forceinline__ void generic_radix(int j, int T, int n, int r,
                                              const float2* __restrict__ tw,
                                              const float* __restrict__ gp,
                                              Src src, Dst dst) {
  const int nb = n / r, h = r / 2;
  const int items = (h + 1) * nb;
  const Div<LONG> div(nb == 1 ? 2 : nb);
  for (int o = j; o < items; o += T) {
    const int k = nb == 1 ? o : div(o);
    const int q = o - k * nb;
    const int base = q * r;
    float2 a = src(base), bb = make_float2(0.f, 0.f);
    if (IPP_NOTCH_DIAG != 1) {
      int e = 0;   // (jj * k) % r
#pragma unroll 4
      for (int jj = 1; jj <= h; ++jj) {
        e += k;
        if (e >= r) e -= r;
        const float2 w = __ldg(&tw[e * nb]);   // (cos, -sin) of 2 pi e / r
        const float2 x1 = src(base + jj), x2 = src(base + r - jj);
        a.x = fmaf(x1.x + x2.x, w.x, a.x);
        a.y = fmaf(x1.y + x2.y, w.x, a.y);
        bb.x = fmaf(x1.x - x2.x, -w.y, bb.x);
        bb.y = fmaf(x1.y - x2.y, -w.y, bb.y);
      }
    }
    float2 lo = make_float2(a.x + bb.y, a.y - bb.x);   // a - i b: output k
    float2 hi = make_float2(a.x - bb.y, a.y + bb.x);   // a + i b: r - k
    if (GAIN) {
      const float sl = __ldg(&gp[base + k]), sh = __ldg(&gp[base + r - k]);
      lo = make_float2(lo.x * sl, -(lo.y * sl));
      hi = make_float2(hi.x * sh, -(hi.y * sh));
    }
    dst(base + k, lo);
    if (k != 0) dst(base + r - k, hi);
  }
}

// Step s of an item for the thread of lane l and line pair pr (lane_of,
// pair_of: once an item): the subband's buffers A (buf) and B (buf +
// g.buf, generic plans only).  LONG: the long form (64-bit divisions; the
// chirp route).
template <bool LONG>
__device__ __forceinline__ void run_step(const Sub& sb, const Lane& l,
                                         const Pair& pr, float2* buf,
                                         int s) {
  const Geo& g = sb.g;
  const Plan& pl = sb.pl;
  const int n = g.n;    // the line
  const int m = g.m;    // the transform (n but on the chirp route)
  const float* __restrict__ x = sb.x;
  float* __restrict__ y = sb.y;
  float2* A = buf;
  float2* Bf = buf + g.buf;
  const bool chirp = LONG && g.chirp;   // only the long form takes it
  int kind, p, half;
  step_of(pl, chirp, s, kind, p, half);
  const int L = span_of(pl, p);
  const int R = pl.radix[p];

  auto from_global = [&](int e) -> float2 {
    float2 v = make_float2(0.f, 0.f);
    if (IPP_NOTCH_DIAG == 2) {
      v.x = (float)e;
      return v;
    }
    if (pr.valid) {
      const i64 o = e * pr.stride;
      if (g.vec2) {
        v = *reinterpret_cast<const float2*>(x + pr.a + o);
      } else {
        v.x = x[pr.a + o];
        if (pr.has_b) v.y = x[pr.b + o];
      }
    }
    return v;
  };
  // stores y_a + i y_b
  auto store = [&](int e, float2 v) {
    if (IPP_NOTCH_DIAG == 2) {
      if (v.x == 1234567.f) y[0] = v.y;   // keeps the passes alive
      return;
    }
    if (!pr.valid) return;
    const i64 o = e * pr.stride;
    if (g.vec2) {
      *reinterpret_cast<float2*>(y + pr.a + o) = v;
    } else {
      y[pr.a + o] = v.x;
      if (pr.has_b) y[pr.b + o] = v.y;
    }
  };
  // y_a + i y_b is the conjugate of what the inverse passes leave
  auto to_global = [&](int e, float2 v) { store(e, make_float2(v.x, -v.y)); };
  auto from_a = [&](int e) -> float2 { return A[at(l, e)]; };
  auto to_a = [&](int e, float2 v) { A[at(l, e)] = v; };
  auto from_b = [&](int e) -> float2 { return Bf[at(l, e)]; };
  auto to_b = [&](int e, float2 v) { Bf[at(l, e)] = v; };

  const int last = num_steps(pl, chirp) - 1;
  if (IPP_NOTCH_DIAG == 1 && s != 0 && s != last) return;
  switch (kind) {
    case LOAD:
      for (int e = l.j; e < n; e += g.T) to_a(e, from_global(e));
      break;
    case STORE:
      for (int e = l.j; e < n; e += g.T) to_global(e, from_a(e));
      break;
    case DIF:
      if (p != 0 || half)
        any_radix<DIF, LONG>(R, l.j, g.T, m, L, sb.tw, sb.gp, sb.hm, from_a,
                             to_a);
      else if (!chirp)
        any_radix<DIF, LONG>(R, l.j, g.T, m, L, sb.tw, sb.gp, sb.hm,
                             from_global, to_a);
      else if constexpr (LONG)   // the chirp's first load: c . z, 0 past n
        any_radix<DIF, LONG>(R, l.j, g.T, m, L, sb.tw, sb.gp, sb.hm,
                             [&](int e) -> float2 {
                               return e < n ? cmul(from_global(e),
                                                   __ldg(&sb.chirp[e]))
                                            : make_float2(0.f, 0.f);
                             },
                             to_a);
      break;
    case MID:
      any_radix<MID, LONG>(R, l.j, g.T, m, L, sb.tw, sb.gp, sb.hm, from_a,
                           to_a);
      break;
    case MIDC:
      if constexpr (LONG)
        any_radix<MIDC, LONG>(R, l.j, g.T, m, L, sb.tw, sb.gp, sb.hm, from_a,
                              to_a);
      break;
    case DIT:
      if (p != 0)
        any_radix<DIT, LONG>(R, l.j, g.T, m, L, sb.tw, sb.gp, sb.hm, from_a,
                             to_a);
      else if (!chirp)
        any_radix<DIT, LONG>(R, l.j, g.T, m, L, sb.tw, sb.gp, sb.hm, from_a,
                             to_global);
      else if constexpr (LONG) {
        if (half == 0)   // G / n times the first n values, 0 past them
          any_radix<DIT, LONG>(R, l.j, g.T, m, L, sb.tw, sb.gp, sb.hm,
                               from_a, [&](int e, float2 v) {
                                 float2 u = make_float2(0.f, 0.f);
                                 if (e < n) {
                                   const float s = __ldg(&sb.gp[e]);
                                   u = make_float2(v.x * s, v.y * s);
                                 }
                                 to_a(e, u);
                               });
        else             // y = conj(c) . v
          any_radix<DIT, LONG>(R, l.j, g.T, m, L, sb.tw, sb.gp, sb.hm,
                               from_a, [&](int e, float2 v) {
                                 if (e >= n) return;
                                 const float2 c = __ldg(&sb.chirp[e]);
                                 store(e, make_float2(c.x * v.x + c.y * v.y,
                                                      c.x * v.y - c.y * v.x));
                               });
      }
      break;
    case GEN_DIF:
      generic_radix<true, LONG>(l.j, g.T, m, R, sb.tw, sb.gp, from_a, to_b);
      break;
    case GEN_DIT:
      if (pl.npass == 1)
        generic_radix<false, LONG>(l.j, g.T, m, R, sb.tw, sb.gp, from_b,
                                   to_global);
      else
        generic_radix<false, LONG>(l.j, g.T, m, R, sb.tw, sb.gp, from_b,
                                   to_a);
      break;
  }
}

// -- a launch's table -----------------------------------------------------------

struct Group {
  int count;
  int smem;          // dynamic shared memory of the launch
  i64 total;         // items of all subbands
  i64 scratch_slots; // float2 slots of one block's scratch (0: none)
  float2* scratch;
  Sub sub[MAX_GROUP];
};

// The subband of launch item t: the last whose first item is at or before t.
__host__ __device__ inline int sub_of(const Group& grp, i64 t) {
  int s = 0;
  for (int q = 1; q < grp.count; ++q)
    if (t >= grp.sub[q].start) s = q;
  return s;
}

// Fill a Group from `count` rows of DESC int64 words (x, y, tw, gp, B, H,
// W, cols, npass, generic, radices[MAX_PASSES], chirp, hm; chirp and hm 0
// but on the chirp route); subbands sorted by length, longest first.  False
// for a row K8 does not take or a group that mixes scratch and
// shared-memory subbands or holds more than one of the former.
inline bool make_group(const i64* desc, int count, Group& grp) {
  if (count < 1 || count > MAX_GROUP) return false;
  grp.count = count;
  grp.smem = 0;
  grp.total = 0;
  grp.scratch_slots = 0;
  grp.scratch = nullptr;
  int order[MAX_GROUP];
  for (int q = 0; q < count; ++q) {
    const i64* d = desc + (i64)q * DESC;
    Sub& sb = grp.sub[q];
    sb.x = reinterpret_cast<const float*>(d[0]);
    sb.y = reinterpret_cast<float*>(d[1]);
    sb.tw = reinterpret_cast<const float2*>(d[2]);
    sb.gp = reinterpret_cast<const float*>(d[3]);
    sb.chirp = reinterpret_cast<const float2*>(d[10 + ippdft::MAX_PASSES]);
    sb.hm = reinterpret_cast<const float2*>(d[11 + ippdft::MAX_PASSES]);
    const bool chirp = sb.chirp != nullptr;
    const int cols = (int)d[7], npass = (int)d[8];
    const i64 n = cols ? d[5] : d[6], lines = cols ? d[6] : d[5];
    if (npass < 1 || npass > ippdft::MAX_PASSES || n < 1 || n > MAX_N ||
        lines < 1 || lines > (1LL << 30) || chirp != (sb.hm != nullptr))
      return false;
    sb.pl.n = (int)transform_length((int)n, chirp);
    sb.pl.npass = npass;
    sb.pl.generic = (int)d[9];
    for (int p = 0; p < ippdft::MAX_PASSES; ++p)
      sb.pl.radix[p] = p < npass ? (int)d[10 + p] : 1;
    const bool aligned8 = ((d[0] | d[1]) & 7) == 0;
    if (!notch_plan_ok(sb.pl, (int)n, chirp) ||
        !geometry(d[4], (int)d[5], (int)d[6], cols != 0, aligned8,
                  sb.pl.generic != 0, chirp, sb.g) ||
        (chirp && sb.g.smem != 0))
      return false;
    order[q] = q;
  }
  // longest first (stable): their items start first
  for (int a = 1; a < count; ++a)
    for (int b = a; b > 0 && grp.sub[order[b]].g.n > grp.sub[order[b - 1]].g.n;
         --b) {
      const int t = order[b];
      order[b] = order[b - 1];
      order[b - 1] = t;
    }
  Sub sorted[MAX_GROUP];
  for (int q = 0; q < count; ++q) sorted[q] = grp.sub[order[q]];
  int scratch = 0;
  for (int q = 0; q < count; ++q) {
    Sub& sb = grp.sub[q];
    sb = sorted[q];
    sb.start = grp.total;
    grp.total += sb.g.items;
    if (sb.g.smem == 0) {
      ++scratch;
      grp.scratch_slots = (i64)sb.g.nbuf * sb.g.buf;
    }
    if (sb.g.smem > grp.smem) grp.smem = sb.g.smem;
  }
  return scratch == 0 || (scratch == 1 && count == 1);
}

#ifdef __CUDACC__

// -- the kernel -----------------------------------------------------------------

// Block b takes launch items b, b + grid, ...; LONG: the long form, whose
// buffers are the block's part of grp.scratch (one subband whose buffers
// exceed shared memory), else dynamic shared memory.
template <bool LONG>
__global__ void __launch_bounds__(THREADS, LONG ? MINB_LONG : MINB)
notch_kernel(const __grid_constant__ Group grp) {
  extern __shared__ float2 smem[];
  float2* buf = LONG ? grp.scratch + (i64)blockIdx.x * grp.scratch_slots
                     : smem;
  const int tid = threadIdx.x;
  for (i64 t = blockIdx.x; t < grp.total; t += gridDim.x) {
    const Sub& sb = grp.sub[sub_of(grp, t)];
    const Lane l = lane_of(sb.g, tid);
    const Pair pr = pair_of(sb.g, t - sb.start, l.c);
    const int steps = num_steps(sb.pl, LONG && sb.g.chirp);
    for (int s = 0; s < steps; ++s) {
      run_step<LONG>(sb, l, pr, buf, s);
      __syncthreads();
    }
  }
}

// -- launch ---------------------------------------------------------------------

// `count` subbands (rows of DESC words, see make_group) in one launch;
// scratch: room for `nscratch` blocks' buffers (nbuf * Geo::buf float2
// each), needed only for a lone subband whose buffers exceed shared memory
// (the grid is then at most nscratch blocks).
inline cudaError_t launch_group(const i64* desc, int count, float2* scratch,
                                i64 nscratch, cudaStream_t st) {
  Group grp;
  if (!make_group(desc, count, grp)) return cudaErrorInvalidValue;
  i64 grid = grp.total;
  if (grp.scratch_slots) {
    if (scratch == nullptr || nscratch < 1) return cudaErrorInvalidValue;
    grp.scratch = scratch;
    if (grid > nscratch) grid = nscratch;
    if (grid > 2147483647LL) grid = 2147483647LL;
    notch_kernel<true><<<(unsigned)grid, THREADS, 0, st>>>(grp);
    return cudaGetLastError();
  }
  if (grid > 2147483647LL) grid = 2147483647LL;
  if (grp.smem > 48 * 1024) {
    // per device, so set on every launch: it costs no device time
    const cudaError_t e = cudaFuncSetAttribute(
        notch_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        grp.smem);
    if (e != cudaSuccess) return e;
  }
  notch_kernel<false><<<(unsigned)grid, THREADS, grp.smem, st>>>(grp);
  return cudaGetLastError();
}

#endif  // __CUDACC__

}  // namespace ippnotch
