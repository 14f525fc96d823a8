// The dense-axis DFT of the v1 walk as a mixed-radix FFT kernel (K7).
//
// The function: the n-point complex DFT (forward) or inverse DFT with 1/n
// along the last axis of contiguous (rows, n) f32 planes re, im, natural
// order in and out.  The TPU kernel it replaces (pallas_fft.py `_fused_call`
// through `fused_cplx_matmul`) multiplies by the dense n x n DFT matrix:
// O(n) multiply-adds per value, cheap on a matrix unit, bound by the FMA
// rate on CUDA cores.  The function moves every value once in and once out
// and needs 5 n log2 n FLOPs per row, so on this card it is bound by bytes;
// this kernel does O(log n) work per value for the factors 2, 3, 5, 7, 11, 13
// of n and O(r) for what is left of it.
//
// Algorithm: Stockham autosort, decimation in frequency, mixed radix, as
// stage_fft.cuh, with n, the pass list and the strides as run-time
// arguments.  Pass P with radix R and stride S (the product of the earlier
// radices), on butterfly i of NB = n/R (q = i % S, p = i / S):
//     a_k = x[i + k * NB]                                    k = 0..R-1
//     y[q + S * (R * p + k)] = w^(p * k * S) * sum_j a_j * wR^(j * k)
// with w = exp(-+2 pi i / n) from a table (float64 rounded once to f32;
// ops/dft_mats.stage_twiddles) and wR = w^(n/R).  After the last pass the
// spectrum is in natural order.
//
// The plan (ops/dft_mats.dft_fft_plan, checked again by `plan_ok`): n =
// 2^a * m, a >= 3, m odd.  First the passes of 2^a (8s, then 16s: ceil(a /
// 4) of them; 8, 4 for a = 5), then 9, 3, 5, 7, 11, 13 for those factors of
// m, and last ONE generic pass of radix r for what is left of m (17, 67, any
// odd r).  The kernel also takes 2 and 4 anywhere after the first pass.
// This order keeps S a power of two for every pass up to the first odd one
// (q and p are a mask and a shift there); the later odd passes divide by S
// once per butterfly.  The generic pass comes last because there p is 0:
// no twiddle, and output q + S * k is a sum over the r inputs q + j * S, so
// consecutive threads take consecutive q, read shared memory without
// conflicts and store coalesced runs.  It pairs outputs k and r - k, whose roots are
// conjugates: one root and two inputs serve four real sums.
//
// The butterflies of 3, 5, 7, 9, 11 and 13 are specialised: their roots are
// constants, and they pair inputs j and R - j the same way.  Radix 16 is
// four radix-4 butterflies twice, radix 9 three radix-3 twice.
//
// One thread block holds COLS whole rows.  The first pass loads from device
// memory straight into registers and the last stores straight from
// registers, so each value crosses device memory once each way; shared
// memory carries the exchanges between passes only.  A pass reads one
// buffer and writes the other (two buffers of float2, 8-byte accesses), so a
// butterfly lives in registers only while it is computed, the butterflies a
// thread runs are a run-time loop, and one barrier ends a pass.  A row
// takes n / 8 threads, n / 16 from n = 512 on (at most 512); a block takes
// enough rows for ~160 threads, so short rows (n = 40, 48, 136) still fill
// a block.
//
// Bank conflicts: with odd factors the strides are not powers of two, so
// the XOR swizzle of stage_fft.cuh does not apply.  The slot of element e
// is e + (e >> 4) * PAD for a pad PAD chosen at the launch (16 float2 slots
// are the 32 banks), and the row pitch is odd so that the rows of one warp
// (short n) start in different banks.  Measured on an H100
// (scripts/dft_fft_bench.py --sweep): PAD = 1 beats 0 by 5-20% from n = 136
// on; float2 slots beat separate re and im planes by 4-13% from n = 264 on
// (half the shared-memory instructions).

#pragma once

#include <cuda_runtime.h>

namespace ippdft {

typedef long long i64;

constexpr int MAX_PASSES = 12;
constexpr int MAX_THREADS = 512;          // per block
constexpr int MAX_N = 12288;              // ops/dft_mats.DFT_FFT_MAX_N
constexpr int SMEM_LIMIT = 227 * 1024;    // opt-in dynamic shared memory

struct Plan {
  int n;
  int npass;
  int radix[MAX_PASSES];   // the generic pass's own radix, last
  int generic;             // 1 when the last pass is the generic one
};

// -- the plan's rules ---------------------------------------------------------

__host__ __device__ constexpr bool special(int r) {
  return r == 2 || r == 3 || r == 4 || r == 5 || r == 7 || r == 8 || r == 9 ||
         r == 11 || r == 13 || r == 16;
}

// A plan this kernel takes: the radices multiply to n, the first is 8 or
// 16, every pass is specialised but possibly the last, which is then an odd
// radix >= 3.
inline bool plan_ok(const Plan& pl) {
  if (pl.n < 8 || pl.npass < 1 || pl.npass > MAX_PASSES) return false;
  if (pl.radix[0] != 8 && pl.radix[0] != 16) return false;
  i64 prod = 1;
  for (int p = 0; p < pl.npass; ++p) {
    const int r = pl.radix[p];
    const bool generic = pl.generic && p == pl.npass - 1;
    if (generic ? (r < 3 || r % 2 == 0 || p == 0) : !special(r)) return false;
    prod *= r;
  }
  return prod == pl.n;
}

// -- geometry -----------------------------------------------------------------

struct Geo {
  int T;       // threads per row
  int cols;    // rows per block
  int pitch;   // float2 slots between rows of one buffer (odd)
  int smem;    // bytes: two buffers of float2
};

__host__ __device__ inline int slot(int e, int pad) {
  return e + (e >> 4) * pad;
}

// T: n / 8 for short rows, n / 16 from n = 512 on (16 values a thread in
// every pass), at most MAX_THREADS; cols: rows for ~160 threads (measured:
// 128-220 threads a block win at every length, 256 and more lose 5-25%).
// `tpr` and `cols` > 0 override them.
inline Geo geometry(const Plan& pl, int pad, int tpr, int cols) {
  Geo g;
  g.T = tpr > 0 ? tpr : pl.n / (pl.n >= 512 ? 16 : 8);
  if (g.T > MAX_THREADS) g.T = MAX_THREADS;
  if (g.T < 1) g.T = 1;
  g.cols = g.T >= 160 ? 1 : 160 / g.T;
  if (cols > 0) g.cols = cols;
  if (g.cols * g.T > MAX_THREADS) g.cols = MAX_THREADS / g.T;
  g.pitch = (slot(pl.n - 1, pad) + 1) | 1;
  g.smem = 2 * g.cols * g.pitch * (int)sizeof(float2);
  return g;
}

// -- complex helpers ----------------------------------------------------------

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ float2 cmul(float2 a, float2 w) {
  return make_float2(fmaf(a.x, w.x, -a.y * w.y), fmaf(a.x, w.y, a.y * w.x));
}
// a * (-i) forward, a * (+i) inverse: a quarter turn in the transform's sense
template <bool INV>
__device__ __forceinline__ float2 quarter(float2 a) {
  return INV ? make_float2(-a.y, a.x) : make_float2(a.y, -a.x);
}

// cos and sin of 2 pi k / R for the odd specialised radices, k < R
template <int R>
__host__ __device__ constexpr float rcos(int k) {
  if (k == 0) return 1.f;
  if (2 * k > R) k = R - k;
  if (R == 3) return -0.5f;
  if (R == 5) return k == 1 ? 0.30901699437494742410f : -0.80901699437494742410f;
  if (R == 7)
    return k == 1 ? 0.62348980185873353053f
                  : k == 2 ? -0.22252093395631440429f : -0.90096886790241912624f;
  if (R == 9)
    return k == 1 ? 0.76604444311897803520f
                  : k == 2 ? 0.17364817766693034885f
                           : k == 3 ? -0.5f : -0.93969262078590838405f;
  if (R == 11)
    return k == 1 ? 0.84125353283118116886f
                  : k == 2 ? 0.41541501300188642553f
                           : k == 3 ? -0.14231483827328514044f
                                    : k == 4 ? -0.65486073394528506406f
                                             : -0.95949297361449738989f;
  // R == 13
  return k == 1 ? 0.88545602565320989590f
                : k == 2 ? 0.56806474673115580251f
                         : k == 3 ? 0.12053668025532305335f
                                  : k == 4 ? -0.35460488704253562597f
                                           : k == 5 ? -0.74851074817110109863f
                                                    : -0.97094181742605202716f;
}
template <int R>
__host__ __device__ constexpr float rsin(int k) {
  if (k == 0) return 0.f;
  const float sign = 2 * k > R ? -1.f : 1.f;
  if (2 * k > R) k = R - k;
  float s = 0.f;
  if (R == 3) s = 0.86602540378443864676f;
  if (R == 5) s = k == 1 ? 0.95105651629515357212f : 0.58778525229247312917f;
  if (R == 7)
    s = k == 1 ? 0.78183148246802980871f
               : k == 2 ? 0.97492791218182360702f : 0.43388373911755812048f;
  if (R == 9)
    s = k == 1 ? 0.64278760968653932632f
               : k == 2 ? 0.98480775301220805937f
                        : k == 3 ? 0.86602540378443864676f
                                 : 0.34202014332566873304f;
  if (R == 11)
    s = k == 1 ? 0.54064081745559758211f
               : k == 2 ? 0.90963199535451837141f
                        : k == 3 ? 0.98982144188093273238f
                                 : k == 4 ? 0.75574957435425828377f
                                          : 0.28173255684142969771f;
  if (R == 13)
    s = k == 1 ? 0.46472317204376854566f
               : k == 2 ? 0.82298386589365639458f
                        : k == 3 ? 0.99270887409805399280f
                                 : k == 4 ? 0.93501624268541482344f
                                          : k == 5 ? 0.66312265824079520238f
                                                   : 0.23931566428755776715f;
  return sign * s;
}

// -- butterflies --------------------------------------------------------------

template <bool INV>
__device__ __forceinline__ void dft4(float2& a0, float2& a1,
                                              float2& a2, float2& a3) {
  const float2 t0 = cadd(a0, a2), t1 = csub(a0, a2);
  const float2 t2 = cadd(a1, a3), t3 = quarter<INV>(csub(a1, a3));
  a0 = cadd(t0, t2);
  a1 = cadd(t1, t3);
  a2 = csub(t0, t2);
  a3 = csub(t1, t3);
}

// An odd R-point DFT with constant roots, inputs j and R - j paired:
//   v[k], v[R-k] = a0 + sum_j (a_j + a_{R-j}) cos(2 pi jk/R)
//                  -+ i * sum_j (a_j - a_{R-j}) sin(2 pi jk/R)
template <int R, bool INV>
__device__ __forceinline__ void dft_odd(float2 (&v)[R]) {
  constexpr int H = R / 2;
  float2 sp[H], sm[H];
#pragma unroll
  for (int j = 1; j <= H; ++j) {
    sp[j - 1] = cadd(v[j], v[R - j]);
    sm[j - 1] = csub(v[j], v[R - j]);
  }
  const float2 a0 = v[0];
  float2 sum = a0;
#pragma unroll
  for (int j = 0; j < H; ++j) sum = cadd(sum, sp[j]);
  v[0] = sum;
#pragma unroll
  for (int k = 1; k <= H; ++k) {
    float2 a = a0, b = make_float2(0.f, 0.f);
#pragma unroll
    for (int j = 1; j <= H; ++j) {
      const float c = rcos<R>((j * k) % R), s = rsin<R>((j * k) % R);
      a.x = fmaf(sp[j - 1].x, c, a.x);
      a.y = fmaf(sp[j - 1].y, c, a.y);
      b.x = fmaf(sm[j - 1].x, s, b.x);
      b.y = fmaf(sm[j - 1].y, s, b.y);
    }
    // forward: a - i b at k, a + i b at R - k; the inverse swaps them
    const float2 lo = make_float2(a.x + b.y, a.y - b.x);
    const float2 hi = make_float2(a.x - b.y, a.y + b.x);
    v[k] = INV ? hi : lo;
    v[R - k] = INV ? lo : hi;
  }
}

// In-place R-point DFT of v (sign of the exponent: - forward, + inverse).
template <int R, bool INV>
__device__ __forceinline__ void dft(float2 (&v)[R]) {
  if constexpr (R == 2) {
    const float2 a = v[0], b = v[1];
    v[0] = cadd(a, b);
    v[1] = csub(a, b);
  } else if constexpr (R == 4) {
    dft4<INV>(v[0], v[1], v[2], v[3]);
  } else if constexpr (R == 8) {
    constexpr float H = 0.70710678118654752440f;
    float2 e[4], o[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      e[j] = cadd(v[j], v[j + 4]);
      o[j] = csub(v[j], v[j + 4]);
    }
    // o[j] *= w8^j: 1, (1 -+ i)/sqrt2, -+i, (-1 -+ i)/sqrt2
    const float2 q1 = quarter<INV>(o[1]), q3 = quarter<INV>(o[3]);
    o[1] = make_float2((o[1].x + q1.x) * H, (o[1].y + q1.y) * H);
    o[2] = quarter<INV>(o[2]);
    o[3] = make_float2((q3.x - o[3].x) * H, (q3.y - o[3].y) * H);
    dft4<INV>(e[0], e[1], e[2], e[3]);
    dft4<INV>(o[0], o[1], o[2], o[3]);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[2 * j] = e[j];
      v[2 * j + 1] = o[j];
    }
  } else if constexpr (R == 16) {
    // 4 x 4: columns j2 of the inputs j = 4 j1 + j2, the roots w16^(j2 k1),
    // then rows; the output k = k1 + 4 k2
    constexpr float C1 = 0.92387953251128675613f, S1 = 0.38268343236508977173f;
    constexpr float H = 0.70710678118654752440f;
    const float cs[4] = {1.f, C1, H, S1};   // cos(2 pi m / 16), m = 0..3
    const float sn[4] = {0.f, S1, H, C1};   // sin
    float2 t[4][4];
#pragma unroll
    for (int j2 = 0; j2 < 4; ++j2) {
      float2 a0 = v[j2], a1 = v[4 + j2], a2 = v[8 + j2], a3 = v[12 + j2];
      dft4<INV>(a0, a1, a2, a3);
      t[j2][0] = a0;
      t[j2][1] = a1;
      t[j2][2] = a2;
      t[j2][3] = a3;
    }
#pragma unroll
    for (int k1 = 0; k1 < 4; ++k1) {
      float2 b[4];
#pragma unroll
      for (int j2 = 0; j2 < 4; ++j2) {
        const int m = j2 * k1;   // 0..9: w16^m
        float2 x = t[j2][k1];
        if (m == 0) {
          b[j2] = x;
        } else {
          // w16^m = w16^(m % 4) turned by m / 4 quarter turns
          const int mq = m / 4, mr = m % 4;
          const float2 w =
              make_float2(cs[mr], INV ? sn[mr] : -sn[mr]);
          x = mr == 0 ? x : cmul(x, w);
          if (mq >= 1) x = quarter<INV>(x);
          if (mq >= 2) x = quarter<INV>(x);
          b[j2] = x;
        }
      }
      dft4<INV>(b[0], b[1], b[2], b[3]);
#pragma unroll
      for (int k2 = 0; k2 < 4; ++k2) v[k1 + 4 * k2] = b[k2];
    }
  } else if constexpr (R == 9) {
    // 3 x 3: columns j2 of the inputs j = 3 j1 + j2, the roots w9^(j2 k1),
    // then rows; the output k = k1 + 3 k2
    float2 t[3][3];
#pragma unroll
    for (int j2 = 0; j2 < 3; ++j2) {
      float2 a[3] = {v[j2], v[3 + j2], v[6 + j2]};
      dft_odd<3, INV>(a);
#pragma unroll
      for (int k1 = 0; k1 < 3; ++k1) t[j2][k1] = a[k1];
    }
#pragma unroll
    for (int k1 = 0; k1 < 3; ++k1) {
      float2 b[3];
#pragma unroll
      for (int j2 = 0; j2 < 3; ++j2) {
        const int m = j2 * k1;   // 0, 1, 2, 4
        const float2 w = make_float2(rcos<9>(m),
                                     INV ? rsin<9>(m) : -rsin<9>(m));
        b[j2] = m == 0 ? t[j2][k1] : cmul(t[j2][k1], w);
      }
      dft_odd<3, INV>(b);
#pragma unroll
      for (int k2 = 0; k2 < 3; ++k2) v[k1 + 3 * k2] = b[k2];
    }
  } else {
    dft_odd<R, INV>(v);
  }
}

// -- the passes ---------------------------------------------------------------

// The run-time facts of one pass: stride S, log2 S or -1, butterflies NB.
struct PassArgs {
  int S, shift, NB;
};

__host__ __device__ inline PassArgs pass_args(int n, int R, int S) {
  PassArgs a;
  a.S = S;
  a.NB = n / R;
  a.shift = -1;
  if ((S & (S - 1)) == 0) {
    a.shift = 0;
    while ((1 << a.shift) < S) ++a.shift;
  }
  return a;
}

// What fft_pass does to a butterfly's inputs once all are loaded, and to its
// outputs before any is stored: nothing.
struct NoHook {
  template <int R>
  __device__ __forceinline__ void operator()(int, int, float2 (&)[R]) const {}
};

// Thread j of its row's T runs butterflies j, j + T, ...: src(e) gives
// element e of the pass input, dst(e, value) takes element e of its output.
// pre(i, NB, v) may change the R inputs v of butterfly i (elements i + k *
// NB) after all of them are loaded, before the transform; post(base, S, v)
// its R outputs (elements base + S * k) before any of them is stored.
template <int R, bool INV, class Src, class Dst, class Pre = NoHook,
          class Post = NoHook>
__device__ __forceinline__ void fft_pass(int j, int T, PassArgs a,
                                                  const float2* __restrict__ tw,
                                                  Src src, Dst dst,
                                                  Pre pre = Pre(),
                                                  Post post = Post()) {
  for (int i = j; i < a.NB; i += T) {
    float2 v[R];
#pragma unroll
    for (int k = 0; k < R; ++k) v[k] = src(i + k * a.NB);
    pre(i, a.NB, v);
    dft<R, INV>(v);
    int p, q;
    if (a.shift >= 0) {
      p = i >> a.shift;
      q = i & (a.S - 1);
    } else {
      p = i / a.S;
      q = i - p * a.S;
    }
    if (p != 0) {   // the last pass has p == 0 throughout: no twiddle
      const int ps = p * a.S;
#pragma unroll
      for (int k = 1; k < R; ++k) {
        float2 w = __ldg(&tw[ps * k]);
        if (INV) w.y = -w.y;
        v[k] = cmul(v[k], w);
      }
    }
    const int base = q + a.S * R * p;
    post(base, a.S, v);
#pragma unroll
    for (int k = 0; k < R; ++k) dst(base + a.S * k, v[k]);
  }
}

// The generic last pass of odd radix r, stride S = n / r: output q + S * k
// is sum_j x[q + j * S] * wr^(j * k).  One work item is (k, q) for k <=
// r / 2 and gives outputs k and r - k; items run over the row's T threads
// with q fastest.
template <bool INV, class Src, class Dst>
__device__ __forceinline__ void generic_pass(
    int j, int T, int r, int S, const float2* __restrict__ tw, Src src,
    Dst dst) {
  const int h = r / 2;
  const int items = (h + 1) * S;
  for (int o = j; o < items; o += T) {
    const int k = o / S, q = o - k * S;
    float2 a = src(q), b = make_float2(0.f, 0.f);
    int e = 0;   // (jj * k) % r
#pragma unroll 4
    for (int jj = 1; jj <= h; ++jj) {
      e += k;
      if (e >= r) e -= r;
      const float2 w = __ldg(&tw[e * S]);   // (cos, -sin) of 2 pi e / r
      const float2 x1 = src(q + jj * S), x2 = src(q + (r - jj) * S);
      a.x = fmaf(x1.x + x2.x, w.x, a.x);
      a.y = fmaf(x1.y + x2.y, w.x, a.y);
      b.x = fmaf(x1.x - x2.x, -w.y, b.x);
      b.y = fmaf(x1.y - x2.y, -w.y, b.y);
    }
    const float2 lo = make_float2(a.x + b.y, a.y - b.x);   // a - i b
    const float2 hi = make_float2(a.x - b.y, a.y + b.x);   // a + i b
    dst(q + S * k, INV ? hi : lo);
    if (k != 0) dst(q + S * (r - k), INV ? lo : hi);
  }
}

// One specialised pass chosen by its run-time radix; `post` as in fft_pass.
template <bool INV, class Src, class Dst, class Post = NoHook>
__device__ __forceinline__ void any_pass(int R, int j, int T,
                                                  PassArgs a,
                                                  const float2* tw, Src src,
                                                  Dst dst,
                                                  Post post = Post()) {
  const NoHook pre;
  switch (R) {
    case 2: fft_pass<2, INV>(j, T, a, tw, src, dst, pre, post); break;
    case 3: fft_pass<3, INV>(j, T, a, tw, src, dst, pre, post); break;
    case 4: fft_pass<4, INV>(j, T, a, tw, src, dst, pre, post); break;
    case 5: fft_pass<5, INV>(j, T, a, tw, src, dst, pre, post); break;
    case 7: fft_pass<7, INV>(j, T, a, tw, src, dst, pre, post); break;
    case 8: fft_pass<8, INV>(j, T, a, tw, src, dst, pre, post); break;
    case 9: fft_pass<9, INV>(j, T, a, tw, src, dst, pre, post); break;
    case 11: fft_pass<11, INV>(j, T, a, tw, src, dst, pre, post); break;
    case 13: fft_pass<13, INV>(j, T, a, tw, src, dst, pre, post); break;
    case 16: fft_pass<16, INV>(j, T, a, tw, src, dst, pre, post); break;
  }
}

#ifdef __CUDACC__

// The pass sequence of one transform, shared by every kernel on these
// passes (dft_last below; the stage kernel of stage_mixed.cuh): the first
// pass reads load(e) (device memory) and writes buffer nxt, every later pass
// reads the buffer the one before it wrote and writes the other, the last
// writes store(e, v) (device memory).  cur and nxt are this transform's
// views of the two buffers, at(e) element e's slot in either; `pre` is the
// first pass's fft_pass hook (a fused stream's loads issued a butterfly at
// a time).  One barrier ends every pass but the last, so every thread of
// the block calls this.
template <bool INV, class Load, class Store, class At, class Pre = NoHook>
__device__ __forceinline__ void run_passes(const Plan& pl, int j, int T,
                                           const float2* __restrict__ tw,
                                           float2* cur, float2* nxt,
                                           Load load, Store store, At at,
                                           Pre pre = Pre()) {
  const int n = pl.n;
  auto from_smem = [&](int e) -> float2 { return cur[at(e)]; };
  auto to_smem = [&](int e, float2 v) { nxt[at(e)] = v; };

  const int last = pl.npass - 1;
  const int R0 = pl.radix[0];   // 8 or 16 (`plan_ok`)
  if (last == 0) {   // n == 8 or 16: one pass, device memory to device memory
    if (R0 == 16)
      fft_pass<16, INV>(j, T, pass_args(n, 16, 1), tw, load, store, pre);
    else
      fft_pass<8, INV>(j, T, pass_args(n, 8, 1), tw, load, store, pre);
    return;
  }
  if (R0 == 16)
    fft_pass<16, INV>(j, T, pass_args(n, 16, 1), tw, load, to_smem, pre);
  else
    fft_pass<8, INV>(j, T, pass_args(n, 8, 1), tw, load, to_smem, pre);
  int S = R0;
  __syncthreads();
  for (int p = 1; p < last; ++p) {
    float2* t = cur;
    cur = nxt;
    nxt = t;
    const int R = pl.radix[p];
    any_pass<INV>(R, j, T, pass_args(n, R, S), tw, from_smem, to_smem);
    S *= R;
    __syncthreads();
  }
  cur = nxt;   // the last pass reads what the one before it wrote
  const int R = pl.radix[last];
  if (pl.generic)
    generic_pass<INV>(j, T, R, S, tw, from_smem, store);
  else
    any_pass<INV>(R, j, T, pass_args(n, R, S), tw, from_smem, store);
}

// -- the kernel ---------------------------------------------------------------

// xr, xi, rr, ii: (rows, n).  INV: the inverse transform, times `scale`
// (1/n).  tw: (n) float2, exp(-2 pi i j / n).
template <bool INV>
__global__ void __launch_bounds__(MAX_THREADS)
dft_last(const float* __restrict__ xr, const float* __restrict__ xi,
         const float2* __restrict__ tw, float* __restrict__ rr,
         float* __restrict__ ii, i64 rows, Plan pl, int T, int cols,
         int pitch, int pad, float scale) {
  extern __shared__ float2 smem[];
  const int n = pl.n;

  const int c = threadIdx.x / T, j = threadIdx.x - c * T;
  const i64 row = (i64)blockIdx.x * cols + c;
  const bool ok = row < rows;
  const i64 base = row * n;
  float2* cur = smem + c * pitch;

  auto from_global = [&](int e) -> float2 {
    if (!ok) return make_float2(0.f, 0.f);
    return make_float2(xr[base + e], xi[base + e]);
  };
  auto to_global = [&](int e, float2 v) {
    if (!ok) return;
    rr[base + e] = INV ? v.x * scale : v.x;
    ii[base + e] = INV ? v.y * scale : v.y;
  };
  run_passes<INV>(pl, j, T, tw, cur, cur + cols * pitch, from_global,
                  to_global, [&](int e) { return slot(e, pad); });
}

// -- launch -------------------------------------------------------------------

constexpr int DEFAULT_PAD = 1;   // of the shared-memory slots (see the top)

// pad < 0, tpr <= 0 and cols <= 0 take the defaults; a bench passes others.
template <bool INV>
inline cudaError_t launch(const float* xr, const float* xi, const float2* tw,
                          float* rr, float* ii, i64 rows, const Plan& pl,
                          int pad, int tpr, int cols, cudaStream_t st) {
  if (pad < 0) pad = DEFAULT_PAD;
  if (!plan_ok(pl) || pl.n > MAX_N || rows < 1 || pad > 4)
    return cudaErrorInvalidValue;
  const Geo g = geometry(pl, pad, tpr, cols);
  if (g.smem > SMEM_LIMIT || g.T < 1) return cudaErrorInvalidValue;
  auto kernel = dft_last<INV>;
  if (g.smem > 48 * 1024) {
    // per device, so set on every launch: it costs no device time
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, g.smem);
    if (e != cudaSuccess) return e;
  }
  const i64 blocks = (rows + g.cols - 1) / g.cols;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, g.cols * g.T, g.smem, st>>>(
      xr, xi, tw, rr, ii, rows, pl, g.T, g.cols, g.pitch, pad,
      1.f / (float)pl.n);
  return cudaGetLastError();
}

#endif  // __CUDACC__

}  // namespace ippdft
