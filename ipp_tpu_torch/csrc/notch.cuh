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
//
// The long form K8l: lines whose pair's buffers pass the 227 KB of shared
// memory (n above ~27000, or ~13600 with a generic radix), up to MAX_N =
// 2^20, each subband in launches of its own.  The transform of length m
// is split m = n1 n2 (`ops/cuda_notch.notch_long_plan(n)`, a function of n
// alone), element j = n2 j1 + j2, frequency k = k1 + n1 k2, and runs as
// the four-step FFT in three kernels over device memory, many blocks a
// line pair:
//   (a) `notch_long_kernel<0>`: a block takes a tile of C columns (pair,
//     j2), n1 values each (j1), the forward passes of `plan1` on them in
//     shared memory, and stores row r (the position where frequency k1
//     lands) times the twiddle w_m^(j2 k1) (a table by row, `twr`, so a
//     warp's twiddles are one run) at element r n2 + j2;
//     along x a tile's columns are C neighbouring j2 (4C-byte runs of each
//     line), along y CPt neighbouring column pairs by TJ j2 (8 CPt-byte
//     runs);
//   (b) `<1>`: a block takes R rows (pair, r) of n2 values, the middle as
//     the shared-memory form runs it on a line of n2 (`plan2`'s forward
//     passes, the gains G[k1 + n1 k2] / n in the digit order of both plans,
//     the inverse passes; a generic radix in two buffers), and stores
//     times w_m^(j2 k1): the conjugated inverse of the rows, turned back;
//   (c) `<2>`: the tiles of (a) again, plan1's inverse passes, the store
//     of y_a + i y_b at j = n2 j1 + j2.
// Each kernel reads and writes one complex value an element: 3 x 16 bytes
// a line pair's element where the shared-memory form moves 8.  The store of
// each kernel takes the elements its loads took, so every kernel runs in
// place; the storage between them is y itself (re in line 2i, im in line
// 2i + 1; the float2 of a column pair) where every pair has both lines, else
// a scratch of the subband's size the wrapper allocates.  A large odd factor
// never reads device memory p times a value: a row whose odd factor passes
// the generic limit (`ops/cuda_notch.GENERIC_MAX`) runs, n2 = p prime,
// Rader's algorithm, the DFT of p as a cyclic convolution of p - 1 on the
// specialised radices (`rows` 2: 520 = 8 5 13 for the 521 of 33344; in
// long_step_b), else Bluestein's chirp-z transform inside the row (`rows`
// 1, below) on the power-of-two passes of m2 = pow2ceil(2 n2 - 1); a line
// with no split (a prime past ROW_MAX, 65537) takes the chirp route on
// the whole line.
//
// The chirp-z transform (Bluestein): with c[j] = exp(-i pi (j^2 mod 2L) / L)
// for a length L and h = conj(c) laid out circularly in M = pow2ceil(2L - 1)
// (h[j] at j and M - j, j < L; 0 between), the passes of M with the complex
// gains Hm = DFT_M(h) / M in the middle (digit-reversed) compute K(v) =
// DFT_M(conj(Hm . DFT_M(v))) = conj(v (*) h), the conjugated circular
// convolution, which is linear for the first L outputs, and DFT(z)[k] =
// c[k] (z c (*) h)[k], so
//
//   IDFT(G . DFT(z)) = conj(c) . K(pad(G / L . K(pad(c . z)))).
//
// The whole-line chirp route (L = n, M = m): kernels a, b, c twice, the
// first (a) multiplying by c at its load, (b) with Hm (in the four-step's
// digit order) in place of G, the first (c) storing G / n times the first n
// values into the scratch (a second (a) reads 0 past them), the second (c)
// storing conj(c) times them: 6 launches.  Inside a row (L = n2, M = m2):
// (b) loads c2 . a, runs K, G[k1 + n1 k2] / n on the first n2 values, K,
// and stores c2 . conj(K(.)) times w_m^(j2 k1) (the conjugated inverse (c)
// expects).
//
// Bound by bytes: 4 in and 4 out an element (8 n log2 n flops a line pair
// are far below the bytes at these lengths).
//
// The geometry and the steps are functions of (item, thread) that a host
// compiler also takes, so tests/torch_notch_host/ runs them thread by thread
// on the host; the kernels (CUDA only) run them between barriers.

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
constexpr int TMIN = 16;                 // threads a pair at least
constexpr int MAX_GROUP = 16;            // subbands a launch
constexpr int DESC = 22;                 // int64 words of a subband's row
// the long form (ops/cuda_notch mirrors these)
constexpr int LONG_N1_MAX = 1024;        // the strided sub-transform, at most
constexpr int ROW_MAX = 4096;            // a row's transform, at most
constexpr int TILE_VALUES = 8192;        // a strided tile's slots, at most
constexpr int TILE_CMAX = 32;            // columns of a tile, at most
constexpr int ROW_SMEM = 100 * 1024;     // a row block's bytes (but one row)
constexpr int ROWS_Y = 8;                // rows a block along y, at least
constexpr int MINB_LONG = 3;             // the long kernels' blocks an SM
constexpr int LDESC = 47;                // int64 words of a long subband
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

// A plan K8 takes for a transform of `len`: the radices multiply to len,
// each is a specialised radix but possibly the last, which is then the
// generic pass of an odd radix (1 only for len = 1).
inline bool plan_ok(const Plan& pl, int len) {
  if (len < 1 || pl.npass < 1 || pl.npass > ippdft::MAX_PASSES ||
      pl.n != len)
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
  int cols;      // 1: the lines are columns (axis -2)
  int H, W;      // a tile is (H, W)
  int CP;        // line pairs a block item
  int T;         // threads a line pair; CP * T = THREADS
  int cshift;    // log2 CP
  int tshift;    // log2 T
  int pitch;     // rows: slots between pairs (odd)
  int buf;       // float2 slots of one buffer
  int nbuf;      // buffers: 2 with a generic radix, else 1
  int smem;      // bytes of shared memory; 0: past shared memory (K8l)
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
// ends in a generic pass (two buffers).  False for a shape K8 does not take.
inline bool geometry(i64 B, int H, int W, bool cols, bool aligned8,
                     bool generic, Geo& g) {
  g.cols = cols;
  g.H = H;
  g.W = W;
  g.n = cols ? H : W;
  if (B < 1 || H < 1 || W < 1 || g.n > MAX_N) return false;
  const int n = g.n;
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

// i / M by a multiply-high with magic = floor((2^32 - 1) / M) + 1 for any M
// >= 2: magic M = 2^32 + e with 0 <= e < M, so i magic / 2^32 = i / M + i e
// / (M 2^32), exact while i e < 2^32, which holds for i and M below 32768:
// every index of a transform (at most ROW_MAX in the long form).
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

struct Div {
  unsigned mg;
  __host__ __device__ explicit Div(int M) : mg(magic(M)) {}
  __host__ __device__ int operator()(int i) const {
    return (int)mulhi((unsigned)i, mg);
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

// A subband of a launch: x -> y (B, H, W) f32, its twiddle table tw (n)
// float2 exp(-2 pi i j / n), its gains gp (n) in the digit-reversed order
// of the plan (ops/cuda_notch.notch_gains), its geometry and plan, and the
// first item of it in the launch's numbering.
struct Sub {
  const float* x;
  float* y;
  const float2* tw;
  const float* gp;
  Geo g;
  Plan pl;
  i64 start;
};

// -- the steps ------------------------------------------------------------------

enum Kind { DIF, MID, DIT, LOAD, STORE, GEN_DIF, GEN_DIT, MIDC };

// Step s of an item: its kind, the pass it runs and its half (the chirp-z
// transform's two; 0 elsewhere).  P specialised passes: DIF 0 (from device
// memory) .. DIF P-2, MID (P-1), DIT P-2 .. DIT 0 (to device memory); a
// generic last radix: GEN_DIF into the second buffer and GEN_DIT back in
// place of MID; P = 1: LOAD first, the middle, STORE last (GEN_DIT stores
// itself).  The chirp-z transform (P >= 2 power-of-two passes): those 2P -
// 1 steps twice, MIDC (the complex gains) in the middle, the first half's
// DIT 0 back into the buffer.
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
// hm, and the forward transform's value at frequency 0 into *sum where
// sum is given), elements read by src(e), written by dst(e, v).
template <int R, int KIND, class Src, class Dst>
__device__ __forceinline__ void radix_pass(int j, int T, int n, int L,
                                           const float2* __restrict__ tw,
                                           const float* __restrict__ gp,
                                           const float2* __restrict__ hm,
                                           Src src, Dst dst, float2* sum) {
  const int M = L / R;
  const int NB = n / R;
  const int tscale = n / L;
  const bool pow2 = (M & (M - 1)) == 0;
  const int mshift = pow2 ? log2i(M) : 0;
  const Div div(pow2 ? 2 : M);
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
        if (sum != nullptr && base == 0) *sum = v[0];
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

template <int KIND, class Src, class Dst>
__device__ __forceinline__ void any_radix(int R, int j, int T, int n, int L,
                                          const float2* __restrict__ tw,
                                          const float* __restrict__ gp,
                                          const float2* __restrict__ hm,
                                          Src src, Dst dst,
                                          float2* sum = nullptr) {
#define IPP_NOTCH_RADIX(r)                                                \
  case r:                                                                 \
    radix_pass<r, KIND>(j, T, n, L, tw, gp, hm, src, dst, sum);           \
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
template <bool GAIN, class Src, class Dst>
__device__ __forceinline__ void generic_radix(int j, int T, int n, int r,
                                              const float2* __restrict__ tw,
                                              const float* __restrict__ gp,
                                              Src src, Dst dst) {
  const int nb = n / r, h = r / 2;
  const int items = (h + 1) * nb;
  const Div div(nb == 1 ? 2 : nb);
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
// g.buf, generic plans only).
__device__ __forceinline__ void run_step(const Sub& sb, const Lane& l,
                                         const Pair& pr, float2* buf,
                                         int s) {
  const Geo& g = sb.g;
  const Plan& pl = sb.pl;
  const int n = g.n;
  const float* __restrict__ x = sb.x;
  float* __restrict__ y = sb.y;
  float2* A = buf;
  float2* Bf = buf + g.buf;
  int kind, p, half;
  step_of(pl, false, s, kind, p, half);
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

  const int last = num_steps(pl, false) - 1;
  if (IPP_NOTCH_DIAG == 1 && s != 0 && s != last) return;
  switch (kind) {
    case LOAD:
      for (int e = l.j; e < n; e += g.T) to_a(e, from_global(e));
      break;
    case STORE:
      for (int e = l.j; e < n; e += g.T) to_global(e, from_a(e));
      break;
    case DIF:
      if (p != 0)
        any_radix<DIF>(R, l.j, g.T, n, L, sb.tw, sb.gp, nullptr, from_a,
                       to_a);
      else
        any_radix<DIF>(R, l.j, g.T, n, L, sb.tw, sb.gp, nullptr,
                       from_global, to_a);
      break;
    case MID:
      any_radix<MID>(R, l.j, g.T, n, L, sb.tw, sb.gp, nullptr, from_a, to_a);
      break;
    case DIT:
      if (p != 0)
        any_radix<DIT>(R, l.j, g.T, n, L, sb.tw, sb.gp, nullptr, from_a,
                       to_a);
      else
        any_radix<DIT>(R, l.j, g.T, n, L, sb.tw, sb.gp, nullptr, from_a,
                       to_global);
      break;
    case GEN_DIF:
      generic_radix<true>(l.j, g.T, n, R, sb.tw, sb.gp, from_a, to_b);
      break;
    case GEN_DIT:
      if (pl.npass == 1)
        generic_radix<false>(l.j, g.T, n, R, sb.tw, sb.gp, from_b,
                             to_global);
      else
        generic_radix<false>(l.j, g.T, n, R, sb.tw, sb.gp, from_b, to_a);
      break;
  }
}

// -- a launch's table -----------------------------------------------------------

struct Group {
  int count;
  int smem;          // dynamic shared memory of the launch
  i64 total;         // items of all subbands
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
// W, cols, npass, generic, radices[MAX_PASSES]); subbands sorted by length,
// longest first.  False for a row K8 does not take, or one whose buffers
// pass shared memory (the long form's).
inline bool make_group(const i64* desc, int count, Group& grp) {
  if (count < 1 || count > MAX_GROUP) return false;
  grp.count = count;
  grp.smem = 0;
  grp.total = 0;
  int order[MAX_GROUP];
  for (int q = 0; q < count; ++q) {
    const i64* d = desc + (i64)q * DESC;
    Sub& sb = grp.sub[q];
    sb.x = reinterpret_cast<const float*>(d[0]);
    sb.y = reinterpret_cast<float*>(d[1]);
    sb.tw = reinterpret_cast<const float2*>(d[2]);
    sb.gp = reinterpret_cast<const float*>(d[3]);
    const int cols = (int)d[7], npass = (int)d[8];
    const i64 n = cols ? d[5] : d[6], lines = cols ? d[6] : d[5];
    if (npass < 1 || npass > ippdft::MAX_PASSES || n < 1 || n > MAX_N ||
        lines < 1 || lines > (1LL << 30))
      return false;
    sb.pl.n = (int)n;
    sb.pl.npass = npass;
    sb.pl.generic = (int)d[9];
    for (int p = 0; p < ippdft::MAX_PASSES; ++p)
      sb.pl.radix[p] = p < npass ? (int)d[10 + p] : 1;
    const bool aligned8 = ((d[0] | d[1]) & 7) == 0;
    if (!plan_ok(sb.pl, (int)n) ||
        !geometry(d[4], (int)d[5], (int)d[6], cols != 0, aligned8,
                  sb.pl.generic != 0, sb.g) ||
        sb.g.smem == 0)
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
  for (int q = 0; q < count; ++q) {
    Sub& sb = grp.sub[q];
    sb = sorted[q];
    sb.start = grp.total;
    grp.total += sb.g.items;
    if (sb.g.smem > grp.smem) grp.smem = sb.g.smem;
  }
  return true;
}

// -- the long form K8l: geometry ------------------------------------------------

struct LongGeo {
  int n;          // the line length
  int m;          // the transform: n, or the whole-line chirp's
  int n1, n2;     // m = n1 n2: the strided and the row sub-transforms
  int m2;         // the row's transform: n2, or its chirp's
  int chirp;      // 1: the whole-line chirp route
  int rows;       // the rows: 0 mixed radix, 1 chirp-z, 2 Rader's
  int cols;       // 1: the lines are columns (axis -2)
  int H, W;
  int WP;         // column pairs a tile row (columns only)
  int ystore;     // 1: y is the storage between the kernels
  int vec2;       // columns: float2 loads and stores of x and y
  i64 B, pairs;
  // the strided kernels (a, c): tiles of C columns (CPt pairs by TJ j2), T
  // threads a column, one buffer for (a), nbufc for (c)
  int C, cshift, T, CPt, cpshift, TJ, ntj, ngp, bufc, nbufc, smem_a, smem_c;
  i64 items_ac;
  // the row kernel (b): R rows a block, Tb threads a row
  int R, rshift, Tb, tbshift, pitch, bufb, nbufb, ngr, smem_b;
  i64 items_b;
};

// The long form's geometry of (B, H, W) along the columns (`cols`) or the
// rows for the split n1 x n2 (m2 the row's transform, rows its kind,
// generic1 / generic2: the sub-plans end in a generic pass); aligned8: x
// and y 8-byte aligned; ystore: y serves as the storage.
// ops/cuda_notch.notch_long_geometry mirrors it.
inline void long_geometry(i64 B, int H, int W, bool cols, bool aligned8,
                          int n1, int n2, int m2, bool chirp, int rows,
                          bool generic1, bool generic2, bool ystore,
                          LongGeo& g) {
  g.cols = cols;
  g.H = H;
  g.W = W;
  g.B = B;
  g.n = cols ? H : W;
  g.chirp = chirp;
  g.rows = rows;
  g.n1 = n1;
  g.n2 = n2;
  g.m = n1 * n2;
  g.m2 = m2;
  g.WP = cols ? cdiv(W, 2) : 0;
  g.pairs = cols ? B * (i64)g.WP : B * (i64)cdiv(H, 2);
  g.vec2 = cols && aligned8 && W % 2 == 0;
  g.ystore = ystore;
  // (a), (c): C columns of n1 values a tile
  g.nbufc = generic1 ? 2 : 1;
  g.C = TILE_CMAX;
  while (g.C > 1 && g.C * n1 * g.nbufc > TILE_VALUES) g.C /= 2;
  g.CPt = 1;
  if (cols) {
    g.CPt = pow2ceil(g.WP);
    if (g.CPt > g.C) g.CPt = g.C;
  }
  g.TJ = g.C / g.CPt;
  g.T = THREADS / g.C;
  g.cshift = log2i(g.C);
  g.cpshift = log2i(g.CPt);
  g.ntj = cdiv(n2, g.TJ);
  g.ngp = cols ? cdiv(g.WP, g.CPt) : 0;
  g.items_ac = cols ? B * g.ngp * g.ntj : g.pairs * g.ntj;
  const int lc = g.C * n1 - 1;
  g.bufc = lc + (lc >> 4) + 1;
  g.smem_a = 8 * g.bufc;
  g.smem_c = 8 * g.nbufc * g.bufc;
  // (b): R rows of m2 a block; Rader's: two buffers of the row's n2 values
  // (it loads and stores them whole) and three values a row
  g.nbufb = generic2 || rows == 2 ? 2 : 1;
  const int len = rows == 2 ? n2 : m2;
  g.R = THREADS / pair_threads(m2);
  if (cols) {
    if (g.R < ROWS_Y) g.R = ROWS_Y;
    if (g.R > pow2ceil(g.WP)) g.R = pow2ceil(g.WP);
  }
  for (;;) {
    if (cols) {
      const int l = g.R * len - 1;
      g.pitch = 0;
      g.bufb = l + (l >> 4) + 1;
    } else {
      g.pitch = (len - 1 + ((len - 1) >> 4) + 1) | 1;
      g.bufb = g.R * g.pitch;
    }
    g.smem_b = 8 * (g.nbufb * g.bufb + (rows == 2 ? 3 * g.R : 0));
    if (g.R == 1 || g.smem_b <= ROW_SMEM) break;
    g.R /= 2;
  }
  g.Tb = THREADS / g.R;
  g.rshift = log2i(g.R);
  g.tbshift = log2i(g.Tb);
  g.ngr = cols ? cdiv(g.WP, g.R) : 0;
  g.items_b = cols ? B * g.ngr * n1 : (g.pairs * n1 + g.R - 1) / g.R;
}

// Thread tid's column (a, c) or row (b) c of a block item and its index j
// among the T threads of it, with the slots of lane_of: (a) and (c) and the
// rows along y interleave their columns (l = e * C + c), the rows along x
// lie one after another (c * pitch + e).
__host__ __device__ inline Lane long_lane(const LongGeo& g, int kernel,
                                          int tid) {
  Lane l;
  const bool row = kernel == 1;
  const int CP = row ? g.R : g.C;
  const int cshift = row ? g.rshift : g.cshift;
  if (!row || g.cols) {
    l.c = tid & (CP - 1);
    l.j = tid >> cshift;
    l.base = 0;
    l.es = CP;
    l.off = l.c;
  } else {
    l.c = tid >> g.tbshift;
    l.j = tid & (g.Tb - 1);
    l.base = l.c * g.pitch;
    l.es = 1;
    l.off = 0;
  }
  return l;
}

// A line pair's complex elements in memory: element e's real part at a + e
// es, its imaginary part d further (or 0 where !has_b); vec2: one float2.
struct At {
  i64 a, d, es;
  bool has_b, vec2;
};

__device__ __forceinline__ float2 ld(const float* __restrict__ p,
                                     const At& t, int e) {
  const i64 o = t.a + e * t.es;
  if (t.vec2) return *reinterpret_cast<const float2*>(p + o);
  return make_float2(p[o], t.has_b ? p[o + t.d] : 0.f);
}

__device__ __forceinline__ void st(float* __restrict__ p, const At& t, int e,
                                   float2 v) {
  const i64 o = t.a + e * t.es;
  if (t.vec2) {
    *reinterpret_cast<float2*>(p + o) = v;
  } else {
    p[o] = v.x;
    if (t.has_b) p[o + t.d] = v.y;
  }
}

// A column (pair, j2) of a strided tile or a row (pair, r): the pair in x
// and y (io) and in the storage (sto), j = j2 or r; valid 0 past the
// pairs or the row's n2.
struct LCol {
  At io, sto;
  int j;
  bool valid;
};

// the pair of row pairs q (along x) or of column pair jp of tile bt (along
// y) in x / y and in the storage
__host__ __device__ inline void pair_at(const LongGeo& g, i64 q, i64 bt,
                                        int jp, LCol& c) {
  if (!g.cols) {
    const int hp = cdiv(g.H, 2);
    const i64 b = q / hp;
    const int i = (int)(q - b * hp);
    c.io.a = (b * g.H + 2 * i) * (i64)g.W;
    c.io.d = g.W;
    c.io.es = 1;
    c.io.has_b = 2 * i + 1 < g.H;
    c.io.vec2 = false;
    c.sto.a = 2 * q * g.m;
    c.sto.es = 2;
  } else {
    c.io.a = bt * g.H * (i64)g.W + 2 * jp;
    c.io.d = 1;
    c.io.es = g.W;
    c.io.has_b = 2 * jp + 1 < g.W;
    c.io.vec2 = g.vec2;
    c.sto.a = 2 * (bt * g.m * (i64)g.WP + jp);
    c.sto.es = 2 * (i64)g.WP;
  }
  if (g.ystore) {
    c.sto = c.io;
  } else {
    c.sto.d = 1;
    c.sto.has_b = true;
    c.sto.vec2 = true;
  }
}

// column c of tile item k (kernels a, c)
__host__ __device__ inline LCol long_col(const LongGeo& g, i64 k, int c) {
  LCol r;
  if (!g.cols) {
    const i64 q = k / g.ntj;
    const int jt = (int)(k - q * g.ntj);
    r.j = jt * g.TJ + c;
    r.valid = r.j < g.n2;
    pair_at(g, q, 0, 0, r);
  } else {
    const i64 per = (i64)g.ngp * g.ntj;
    const i64 bt = k / per;
    const int rem = (int)(k - bt * per);
    const int pg = rem / g.ntj, jt = rem - pg * g.ntj;
    const int jp = pg * g.CPt + (c & (g.CPt - 1));
    r.j = jt * g.TJ + (c >> g.cpshift);
    r.valid = jp < g.WP && r.j < g.n2;
    pair_at(g, 0, bt, r.valid ? jp : 0, r);
  }
  return r;
}

// row c of row item k (kernel b)
__host__ __device__ inline LCol long_row(const LongGeo& g, i64 k, int c) {
  LCol r;
  if (!g.cols) {
    const i64 u = k * g.R + c;
    const i64 q = u / g.n1;
    r.j = (int)(u - q * g.n1);
    r.valid = q < g.pairs;
    pair_at(g, r.valid ? q : 0, 0, 0, r);
  } else {
    const i64 per = (i64)g.ngr * g.n1;
    const i64 bt = k / per;
    const int rem = (int)(k - bt * per);
    const int pg = rem / g.n1;
    r.j = rem - pg * g.n1;
    const int jp = pg * g.R + c;
    r.valid = jp < g.WP;
    pair_at(g, 0, bt, r.valid ? jp : 0, r);
  }
  return r;
}

// -- the long form: one subband -------------------------------------------------

// x -> y (B, H, W); s: the scratch storage (null: y); the four-step's
// twiddles by row twr (m: w_m^(j2 k1) at r n2 + j2, k1 the frequency at
// row r), the passes' tables tw1 (n1) and tw2 (m2); gp the gains
// (ops/cuda_notch.notch_long_tables: the direct route G / n at r m2 + the
// row's digit order, with a row chirp or Rader's by row, r n2 + .; the
// chirp route G / n natural); the whole-line chirp c (n) and its gains hm
// (m, at r m2 + the row's digit order); the rows' chirp c2 (n2) and its gains hm2 (m2), or for
// Rader's rows the powers perm (m2 = n2 - 1) of a primitive root and the
// gains hm2 (m2) of the cyclic convolution.
struct LongSub {
  const float* x;
  float* y;
  float* s;
  const float2* twr;
  const float2* tw1;
  const float2* tw2;
  const float* gp;
  const float2* chirp;
  const float2* hm;
  const float2* c2;
  const int* perm;
  const float2* hm2;
  LongGeo g;
  Plan p1, p2;
};

// steps of kernel a (0), b (1), c (2)
__host__ __device__ inline int long_steps(const LongSub& sb, int kernel) {
  const int P1 = sb.p1.npass;
  if (kernel == 1)   // Rader's rows: a load and a store step besides
    return num_steps(sb.p2, sb.g.rows != 0) + 2 * (sb.g.rows == 2);
  if (kernel == 0) return P1 + (sb.p1.generic && P1 == 1);
  return P1 + sb.p1.generic;
}

// Kernel a, step s: plan1's forward passes over the tile's column (the
// first from device memory, x times the chirp or the scratch's first n on
// the chirp route), the last storing row r times twr (w_m^(j2 k1)).
__device__ __forceinline__ void long_step_a(const LongSub& sb, int half,
                                            const Lane& l, const LCol& col,
                                            float2* buf, int s) {
  const LongGeo& g = sb.g;
  const Plan& pl = sb.p1;
  const int P = pl.npass, n1 = g.n1;
  float* __restrict__ sto = g.ystore ? sb.y : sb.s;
  auto gload = [&](int j1) -> float2 {
    const int e = j1 * g.n2 + col.j;
    if (!col.valid || (g.chirp && e >= g.n)) return make_float2(0.f, 0.f);
    if (!g.chirp) return ld(sb.x, col.io, e);
    if (half) return ld(sb.s, col.sto, e);
    return cmul(ld(sb.x, col.io, e), __ldg(&sb.chirp[e]));
  };
  auto gstore = [&](int r, float2 v) {
    if (!col.valid) return;
    const int e = r * g.n2 + col.j;
    st(sto, col.sto, e, cmul(v, __ldg(&sb.twr[e])));
  };
  auto from_a = [&](int e) -> float2 { return buf[at(l, e)]; };
  auto to_a = [&](int e, float2 v) { buf[at(l, e)] = v; };
  if (pl.generic && P == 1) {
    if (s == 0)
      for (int e = l.j; e < n1; e += g.T) to_a(e, gload(e));
    else
      generic_radix<false>(l.j, g.T, n1, pl.radix[0], sb.tw1, nullptr,
                           from_a, gstore);
    return;
  }
  const int R = pl.radix[s], L = span_of(pl, s);
  const bool first = s == 0, last = s == P - 1;
  if (last && pl.generic)
    generic_radix<false>(l.j, g.T, n1, R, sb.tw1, nullptr, from_a, gstore);
  else if (first && last)
    any_radix<DIF>(R, l.j, g.T, n1, L, sb.tw1, nullptr, nullptr, gload,
                   gstore);
  else if (first)
    any_radix<DIF>(R, l.j, g.T, n1, L, sb.tw1, nullptr, nullptr, gload,
                   to_a);
  else if (last)
    any_radix<DIF>(R, l.j, g.T, n1, L, sb.tw1, nullptr, nullptr, from_a,
                   gstore);
  else
    any_radix<DIF>(R, l.j, g.T, n1, L, sb.tw1, nullptr, nullptr, from_a,
                   to_a);
}

// Kernel b, step s: the middle of the shared-memory form on row r of n2
// (`step_of`: plan2's forward passes, G / n or the whole-line chirp's hm,
// the inverse passes), the first step loading the row from the storage,
// the last storing it times twr (w_m^(j2 k1)).  With the rows' chirp-z
// transform (rows 1) K twice around G / n, c2 at the load, c2 . conj(v)
// at the store.  With Rader's (rows 2, n2 = p prime, m2 = p - 1, g a
// primitive root, perm[r] = g^r mod p): the forward DFT is A[0] = sum a,
// A[g^-q] = a[0] + conj(K(u))[q], u[r] = a[g^r] (K of m2 points with the
// gains hm2 of the cyclic convolution, in buffer A); the inverse of V = G
// / n . A as the conjugate of the forward DFT of conj(V), which takes
// u2[r] = conj(V[g^r]) = G (conj(a[0]) + K(u)[(m2 - r) % m2]) (K again, in
// buffer B), D[0] = conj(V[0]) + sum u2, D[g^-q] = conj(V[0]) +
// conj(K(u2))[q]; the store takes D times the twiddle.  The sums are the
// forward transforms' values at frequency 0 (MIDC's sum), kept with a[0]
// in three float2 a row after the buffers.  A first step copies the row
// into B as it lies, which the first pass reads in the order of perm, and
// the last K leaves D in A in natural order, which a last step stores:
// both device-memory transfers run along the row.
__device__ __forceinline__ void long_step_b(const LongSub& sb, const Lane& l,
                                            const LCol& row, float2* buf,
                                            int s) {
  const LongGeo& g = sb.g;
  const Plan& pl = sb.p2;
  const int m2 = g.m2, n2 = g.n2, r = row.j;
  const bool rc = g.rows == 1, rader = g.rows == 2;
  float* __restrict__ sto = g.ystore ? sb.y : sb.s;
  float2* Bf = buf + g.bufb;
  float2* sc = buf + g.nbufb * g.bufb + 3 * l.c;   // Rader: a[0], two sums
  if (rader && s == 0) {   // the row as it lies, into B
    for (int e = l.j; e < n2; e += g.Tb)
      Bf[at(l, e)] = row.valid ? ld(sto, row.sto, r * n2 + e)
                               : make_float2(0.f, 0.f);
    return;
  }
  if (rader && s == num_steps(pl, true) + 1) {   // D from A, along the row
    for (int e = l.j; e < n2; e += g.Tb)
      if (row.valid) {
        const float2 v = buf[at(l, e)];
        const int o = r * n2 + e;
        st(sto, row.sto, o, cmul(v, __ldg(&sb.twr[o])));
      }
    return;
  }
  int kind, p, half;
  step_of(pl, g.rows != 0, s - rader, kind, p, half);
  // Rader's second transform runs in buffer B
  float2* A = rader && half ? Bf : buf;
  const int L = span_of(pl, p);
  const int R = pl.radix[p];
  const float* gp = sb.gp + (i64)r * (g.rows ? n2 : m2);
  const float2* hm = g.chirp ? sb.hm + (i64)r * m2 : sb.hm2;
  auto put = [&](int e, float2 v) {   // element e of the row, turned back
    e += r * n2;
    st(sto, row.sto, e, cmul(v, __ldg(&sb.twr[e])));
  };
  auto gload = [&](int e) -> float2 {
    if (rader) return Bf[at(l, __ldg(&sb.perm[e]))];   // u[e] = a[g^e]
    if (!row.valid || e >= n2) return make_float2(0.f, 0.f);
    const float2 v = ld(sto, row.sto, r * n2 + e);
    return rc ? cmul(v, __ldg(&sb.c2[e])) : v;
  };
  auto gstore = [&](int e, float2 v) {
    if (!row.valid || e >= n2) return;
    if (rc) v = cmul(__ldg(&sb.c2[e]), make_float2(v.x, -v.y));
    put(e, v);
  };
  auto from_a = [&](int e) -> float2 { return A[at(l, e)]; };
  auto to_a = [&](int e, float2 v) { A[at(l, e)] = v; };
  auto from_b = [&](int e) -> float2 { return Bf[at(l, e)]; };
  auto to_b = [&](int e, float2 v) { Bf[at(l, e)] = v; };
  // the row chirp's first half ends in G / n times its first n2 values
  auto to_a_gain = [&](int e, float2 v) {
    const float k = e < n2 ? __ldg(&gp[e]) : 0.f;
    to_a(e, make_float2(v.x * k, v.y * k));
  };
  // Rader's first half ends in u2[(m2 - q) % m2] = G (conj(a[0]) + v_q)
  auto to_u2 = [&](int q, float2 v) {
    const int e = q ? m2 - q : 0;
    const float k = __ldg(&gp[1 + e]);
    to_b(e, make_float2((sc[0].x + v.x) * k, (v.y - sc[0].y) * k));
  };
  // Rader's second: D[g^-q] = conj(V[0]) + conj(v_q), and D[0] with q =
  // 0, into buffer A in natural order
  auto to_d = [&](int q, float2 v) {
    const float k = __ldg(&gp[0]);
    const float2 v0 = make_float2((sc[0].x + sc[1].x) * k,
                                  -((sc[0].y + sc[1].y) * k));
    buf[at(l, __ldg(&sb.perm[q ? m2 - q : 0]))] =
        make_float2(v0.x + v.x, v0.y - v.y);
    if (q == 0) buf[at(l, 0)] = make_float2(v0.x + sc[2].x, v0.y + sc[2].y);
  };
  switch (kind) {
    case LOAD:
      for (int e = l.j; e < m2; e += g.Tb) to_a(e, gload(e));
      break;
    case STORE:
      for (int e = l.j; e < m2; e += g.Tb) gstore(e, from_a(e));
      break;
    case DIF:
      if (p != 0 || half) {
        any_radix<DIF>(R, l.j, g.Tb, m2, L, sb.tw2, gp, hm, from_a, to_a);
      } else {
        any_radix<DIF>(R, l.j, g.Tb, m2, L, sb.tw2, gp, hm, gload, to_a);
        if (rader && l.j == 0) sc[0] = Bf[at(l, 0)];
      }
      break;
    case MID:
      if (g.chirp)
        any_radix<MIDC>(R, l.j, g.Tb, m2, L, sb.tw2, gp, hm, from_a, to_a);
      else
        any_radix<MID>(R, l.j, g.Tb, m2, L, sb.tw2, gp, hm, from_a, to_a);
      break;
    case MIDC:
      any_radix<MIDC>(R, l.j, g.Tb, m2, L, sb.tw2, gp, hm, from_a, to_a,
                      rader ? sc + 1 + half : nullptr);
      break;
    case DIT:
      if (p != 0)
        any_radix<DIT>(R, l.j, g.Tb, m2, L, sb.tw2, gp, hm, from_a, to_a);
      else if (rader && half == 0)
        any_radix<DIT>(R, l.j, g.Tb, m2, L, sb.tw2, gp, hm, from_a, to_u2);
      else if (rader)
        any_radix<DIT>(R, l.j, g.Tb, m2, L, sb.tw2, gp, hm, from_a, to_d);
      else if (rc && half == 0)
        any_radix<DIT>(R, l.j, g.Tb, m2, L, sb.tw2, gp, hm, from_a,
                       to_a_gain);
      else
        any_radix<DIT>(R, l.j, g.Tb, m2, L, sb.tw2, gp, hm, from_a, gstore);
      break;
    case GEN_DIF:
      generic_radix<true>(l.j, g.Tb, m2, R, sb.tw2, gp, from_a, to_b);
      break;
    case GEN_DIT:
      if (pl.npass == 1)
        generic_radix<false>(l.j, g.Tb, m2, R, sb.tw2, gp, from_b, gstore);
      else
        generic_radix<false>(l.j, g.Tb, m2, R, sb.tw2, gp, from_b, to_a);
      break;
  }
}

// Kernel c, step s: plan1's inverse passes over the tile's column (a
// generic last radix first, from a copy of the column into the second
// buffer), the last storing j = n2 j1 + j2: y_a + i y_b on the direct
// route; on the chirp route G / n times the first n values into the scratch
// (half 0) or conj(c) times them into y (half 1).
__device__ __forceinline__ void long_step_c(const LongSub& sb, int half,
                                            const Lane& l, const LCol& col,
                                            float2* buf, int s) {
  const LongGeo& g = sb.g;
  const Plan& pl = sb.p1;
  const int P = pl.npass, n1 = g.n1;
  float* __restrict__ sto = g.ystore ? sb.y : sb.s;
  float2* A = buf;
  float2* Bf = buf + g.bufc;
  auto gload = [&](int r) -> float2 {
    if (!col.valid) return make_float2(0.f, 0.f);
    return ld(sto, col.sto, r * g.n2 + col.j);
  };
  auto gstore = [&](int j1, float2 v) {
    const int e = j1 * g.n2 + col.j;
    if (!col.valid || (g.chirp && e >= g.n)) return;
    if (!g.chirp) {
      st(sb.y, col.io, e, make_float2(v.x, -v.y));
    } else if (half == 0) {
      const float k = __ldg(&sb.gp[e]);
      st(sb.s, col.sto, e, make_float2(v.x * k, v.y * k));
    } else {
      const float2 c = __ldg(&sb.chirp[e]);
      st(sb.y, col.io, e, make_float2(c.x * v.x + c.y * v.y,
                                      c.x * v.y - c.y * v.x));
    }
  };
  auto from_a = [&](int e) -> float2 { return A[at(l, e)]; };
  auto to_a = [&](int e, float2 v) { A[at(l, e)] = v; };
  auto from_b = [&](int e) -> float2 { return Bf[at(l, e)]; };
  auto to_b = [&](int e, float2 v) { Bf[at(l, e)] = v; };
  if (pl.generic) {
    if (s == 0) {
      for (int e = l.j; e < n1; e += g.T) to_b(e, gload(e));
    } else if (s == 1) {
      if (P == 1)
        generic_radix<false>(l.j, g.T, n1, pl.radix[0], sb.tw1, nullptr,
                             from_b, gstore);
      else
        generic_radix<false>(l.j, g.T, n1, pl.radix[P - 1], sb.tw1,
                             nullptr, from_b, to_a);
    } else {
      const int p = P - s;
      const int R = pl.radix[p], L = span_of(pl, p);
      if (p == 0)
        any_radix<DIT>(R, l.j, g.T, n1, L, sb.tw1, nullptr, nullptr, from_a,
                       gstore);
      else
        any_radix<DIT>(R, l.j, g.T, n1, L, sb.tw1, nullptr, nullptr, from_a,
                       to_a);
    }
    return;
  }
  const int p = P - 1 - s;
  const int R = pl.radix[p], L = span_of(pl, p);
  if (s == 0 && p == 0)
    any_radix<DIT>(R, l.j, g.T, n1, L, sb.tw1, nullptr, nullptr, gload,
                   gstore);
  else if (s == 0)
    any_radix<DIT>(R, l.j, g.T, n1, L, sb.tw1, nullptr, nullptr, gload,
                   to_a);
  else if (p == 0)
    any_radix<DIT>(R, l.j, g.T, n1, L, sb.tw1, nullptr, nullptr, from_a,
                   gstore);
  else
    any_radix<DIT>(R, l.j, g.T, n1, L, sb.tw1, nullptr, nullptr, from_a,
                   to_a);
}

// Fill a LongSub from a row of LDESC int64 words: x, y, s, twr, tw1, tw2,
// gp, chirp, hm, c2 or perm, hm2, B, H, W, cols, n1, n2, chirp route,
// rows (0 mixed radix, 1 chirp-z, 2 Rader's), npass1, generic1, npass2,
// generic2, radices1[MAX_PASSES], radices2[MAX_PASSES]
// (ops/cuda_notch._long_row).  False for a row the long form does not take.
inline bool make_long(const i64* d, LongSub& sb) {
  sb.x = reinterpret_cast<const float*>(d[0]);
  sb.y = reinterpret_cast<float*>(d[1]);
  sb.s = reinterpret_cast<float*>(d[2]);
  sb.twr = reinterpret_cast<const float2*>(d[3]);
  sb.tw1 = reinterpret_cast<const float2*>(d[4]);
  sb.tw2 = reinterpret_cast<const float2*>(d[5]);
  sb.gp = reinterpret_cast<const float*>(d[6]);
  sb.chirp = reinterpret_cast<const float2*>(d[7]);
  sb.hm = reinterpret_cast<const float2*>(d[8]);
  const i64 rows = d[18];
  sb.c2 = rows == 1 ? reinterpret_cast<const float2*>(d[9]) : nullptr;
  sb.perm = rows == 2 ? reinterpret_cast<const int*>(d[9]) : nullptr;
  sb.hm2 = reinterpret_cast<const float2*>(d[10]);
  const i64 B = d[11], H = d[12], W = d[13];
  const bool cols = d[14] != 0, chirp = d[17] != 0;
  const i64 n = cols ? H : W, lines = cols ? W : H;
  const i64 n1 = d[15], n2 = d[16];
  if (B < 1 || n < 2 || n > MAX_N || lines < 1 || lines > (1LL << 30) ||
      n1 < 2 || n1 > LONG_N1_MAX || n2 < 2 || n2 > ROW_MAX || rows < 0 ||
      rows > 2 || n1 * n2 != (chirp ? pow2ceil(2 * (int)n - 1) : n) ||
      (chirp && rows) || !sb.x || !sb.y || !sb.twr || !sb.tw1 || !sb.tw2 ||
      !sb.gp || (chirp && (!sb.chirp || !sb.hm || !sb.s)) ||
      (rows && (!d[9] || !sb.hm2)))
    return false;
  const int m2 = rows == 1 ? pow2ceil(2 * (int)n2 - 1)
                 : rows == 2 ? (int)n2 - 1 : (int)n2;
  Plan* pls[2] = {&sb.p1, &sb.p2};
  const int lens[2] = {(int)n1, m2};
  for (int q = 0; q < 2; ++q) {
    Plan& pl = *pls[q];
    const int npass = (int)d[19 + 2 * q];
    if (npass < 1 || npass > ippdft::MAX_PASSES) return false;
    pl.n = lens[q];
    pl.npass = npass;
    pl.generic = (int)d[20 + 2 * q];
    for (int p = 0; p < ippdft::MAX_PASSES; ++p)
      pl.radix[p] = p < npass ? (int)d[23 + q * ippdft::MAX_PASSES + p] : 1;
    if (!plan_ok(pl, lens[q])) return false;
  }
  if (m2 > ROW_MAX || ((chirp || rows) && sb.p2.generic) ||
      (rows && sb.p2.npass < 2))
    return false;
  const bool aligned8 = ((d[0] | d[1]) & 7) == 0;
  const bool ystore = sb.s == nullptr;
  // y holds the storage only where every pair has both lines
  if (ystore && (chirp || (cols ? W % 2 || !aligned8 : H % 2))) return false;
  long_geometry(B, (int)H, (int)W, cols, aligned8, (int)n1, (int)n2, m2,
                chirp, (int)rows, sb.p1.generic != 0, sb.p2.generic != 0,
                ystore, sb.g);
  return sb.g.smem_b <= SMEM_LIMIT && sb.g.smem_c <= SMEM_LIMIT;
}

#ifdef __CUDACC__

// -- the kernels ----------------------------------------------------------------

// Block b takes launch items b, b + grid, ...
__global__ void __launch_bounds__(THREADS, MINB)
notch_kernel(const __grid_constant__ Group grp) {
  extern __shared__ float2 smem[];
  const int tid = threadIdx.x;
  for (i64 t = blockIdx.x; t < grp.total; t += gridDim.x) {
    const Sub& sb = grp.sub[sub_of(grp, t)];
    const Lane l = lane_of(sb.g, tid);
    const Pair pr = pair_of(sb.g, t - sb.start, l.c);
    const int steps = num_steps(sb.pl, false);
    for (int s = 0; s < steps; ++s) {
      run_step(sb, l, pr, smem, s);
      __syncthreads();
    }
  }
}

// The long form's kernel a (KERNEL 0), b (1) or c (2); half: the chirp
// route's second transform.
template <int KERNEL>
__global__ void __launch_bounds__(THREADS, MINB_LONG)
notch_long_kernel(const __grid_constant__ LongSub sb, int half) {
  extern __shared__ float2 smem[];
  const Lane l = long_lane(sb.g, KERNEL, threadIdx.x);
  const i64 items = KERNEL == 1 ? sb.g.items_b : sb.g.items_ac;
  const int steps = long_steps(sb, KERNEL);
  for (i64 t = blockIdx.x; t < items; t += gridDim.x) {
    const LCol col = KERNEL == 1 ? long_row(sb.g, t, l.c)
                                 : long_col(sb.g, t, l.c);
    for (int s = 0; s < steps; ++s) {
      if (KERNEL == 0) long_step_a(sb, half, l, col, smem, s);
      if (KERNEL == 1) long_step_b(sb, l, col, smem, s);
      if (KERNEL == 2) long_step_c(sb, half, l, col, smem, s);
      __syncthreads();
    }
  }
}

// -- launch ---------------------------------------------------------------------

// `count` subbands (rows of DESC words, see make_group) in one launch.
inline cudaError_t launch_group(const i64* desc, int count, cudaStream_t st) {
  Group grp;
  if (!make_group(desc, count, grp)) return cudaErrorInvalidValue;
  i64 grid = grp.total;
  if (grid > 2147483647LL) grid = 2147483647LL;
  if (grp.smem > 48 * 1024) {
    // per device, so set on every launch: it costs no device time
    const cudaError_t e = cudaFuncSetAttribute(
        notch_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, grp.smem);
    if (e != cudaSuccess) return e;
  }
  notch_kernel<<<(unsigned)grid, THREADS, grp.smem, st>>>(grp);
  return cudaGetLastError();
}

template <int KERNEL>
inline cudaError_t launch_long_kernel(const LongSub& sb, int half,
                                      cudaStream_t st) {
  const i64 items = KERNEL == 1 ? sb.g.items_b : sb.g.items_ac;
  const int smem = KERNEL == 0 ? sb.g.smem_a
                   : KERNEL == 1 ? sb.g.smem_b : sb.g.smem_c;
  const i64 grid = items < 2147483647LL ? items : 2147483647LL;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        notch_long_kernel<KERNEL>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  notch_long_kernel<KERNEL><<<(unsigned)grid, THREADS, smem, st>>>(sb, half);
  return cudaGetLastError();
}

// The long form on one subband (a row of LDESC words, see make_long): its
// kernels a, b, c in order, on the chirp route a, b, c again for its
// second transform.
inline cudaError_t launch_long(const i64* desc, cudaStream_t st) {
  LongSub sb;
  if (!make_long(desc, sb)) return cudaErrorInvalidValue;
  for (int half = 0; half <= sb.g.chirp; ++half) {
    cudaError_t e = launch_long_kernel<0>(sb, half, st);
    if (e == cudaSuccess) e = launch_long_kernel<1>(sb, half, st);
    if (e == cudaSuccess) e = launch_long_kernel<2>(sb, half, st);
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

#endif  // __CUDACC__

}  // namespace ippnotch
