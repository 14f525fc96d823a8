// Host check of ipp_tpu_torch/csrc/notch.cuh (K8): the launch table, the
// geometry and the steps, run item by item and thread by thread with the
// header's own functions, every thread through one step before any runs the
// next (the kernel's barriers), the buffers NaN before each item.
//
//   g++ -std=c++17 -O2 -I tests/torch_dft_fft_host -I ipp_tpu_torch/csrc
//       tests/torch_notch_host/check.cpp -o check      (one command)
//   ./check [group] AXIS B H W GENERIC R0 R1 ... [/ ...]
//   ./check [group] AXIS B H W long CHIRP ROWS N1 R1... : R2... [/ ...]
//   ./check row W0 .. W46
//
// AXIS -1 notches the rows of (B, H, W) (n = W), -2 the columns (n = H).
// The shared-memory form: the radices are the plan
// ops/cuda_notch.notch_plan(n) gives, GENERIC 1 when the last is the
// generic pass.  The long form K8l (`long`): the split of
// ops/cuda_notch.notch_long_plan(n), the whole-line chirp route (CHIRP 1,
// m = pow2ceil(2n - 1) = N1 N2) or not, the rows' kind (ROWS 0 mixed
// radix, 1 the chirp-z transform, 2 Rader's), N1 and the radices of N1,
// then those of the row's transform.  Random data, g = notch(n / 2 + 1, n / 6) of ops/destripe.notch,
// every table computed here from the digits and a float64 radix-2 FFT of
// this file, not by the wrapper's code.  For each case, a one-subband
// launch (`make_group`, or the long form's kernels a, b, c, twice on the
// chirp route) on the batch, and on each tile alone (B = 1), against a
// float64 irfft(rfft(x) * g) line by line (a direct DFT up to n = 4096,
// above it this file's float64 FFT, Bluestein's for n not a power of two).
// With `group` first, all cases also run as the wrapper launches them
// (ops/cuda_notch._launches: the shared-memory cases in one table, as
// `ipp_notch_group` launches a decomposition, the long ones each alone),
// each subband's output bit-compared with its one-subband run.  Prints one
// line per case with the geometry; exits 1 if a case is refused, an output
// is left unwritten or written outside the output, a tile alone differs in
// any bit from its place in the batch, a grouped subband from its lone run,
// or an error exceeds 1e-5 of the reference's max.  `row`: the long form's
// geometry from a row of the wrapper's (make_long), or "refused".

#include <algorithm>
#include <cmath>
#include <complex>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <random>
#include <string>
#include <vector>

#include "notch.cuh"

using namespace ippnotch;

static const double PI = 3.14159265358979323846;
static const int GUARD = 64;
static const float SENTINEL = 12345.f;

typedef std::complex<double> cd;

struct Case {
  int axis, H, W, n;
  bool lng, chirp;
  int rows;          // 0 mixed radix, 1 chirp-z, 2 Rader's
  int n1, n2, m2;
  i64 B;
  Plan pl, p1, p2;   // the shared form's plan; the long form's two
  std::vector<float> x, gv, gp;
  std::vector<int> rev1, perm;
  std::vector<float2> tw, tw1, tw2, twr, c, hm, c2, hm2;
};

// the kernel's item loop on the host, over a table
static void run(const Group& grp) {
  i64 slots = 0;
  for (int q = 0; q < grp.count; ++q)
    slots = std::max<i64>(slots, (i64)grp.sub[q].g.nbuf * grp.sub[q].g.buf);
  std::vector<float2> buf((size_t)slots);
  for (i64 t = 0; t < grp.total; ++t) {
    const Sub& sb = grp.sub[sub_of(grp, t)];
    std::fill(buf.begin(), buf.end(), make_float2(NAN, NAN));
    for (int s = 0; s < num_steps(sb.pl, false); ++s)
      for (int tid = 0; tid < THREADS; ++tid) {
        const Lane l = lane_of(sb.g, tid);
        const Pair pr = pair_of(sb.g, t - sb.start, l.c);
        run_step(sb, l, pr, buf.data(), s);
      }
  }
}

// the long form's kernels a, b, c (twice on the chirp route) on the host:
// each kernel's items, its steps between barriers
static void run_long(const LongSub& sb) {
  const LongGeo& g = sb.g;
  const i64 slots = std::max<i64>(g.smem_c, g.smem_b) / 8;
  std::vector<float2> buf((size_t)slots);
  for (int half = 0; half <= g.chirp; ++half)
    for (int kernel = 0; kernel < 3; ++kernel) {
      const i64 items = kernel == 1 ? g.items_b : g.items_ac;
      for (i64 t = 0; t < items; ++t) {
        std::fill(buf.begin(), buf.end(), make_float2(NAN, NAN));
        for (int s = 0; s < long_steps(sb, kernel); ++s)
          for (int tid = 0; tid < THREADS; ++tid) {
            const Lane l = long_lane(g, kernel, tid);
            const LCol col = kernel == 1 ? long_row(g, t, l.c)
                                         : long_col(g, t, l.c);
            if (kernel == 0) long_step_a(sb, half, l, col, buf.data(), s);
            if (kernel == 1) long_step_b(sb, l, col, buf.data(), s);
            if (kernel == 2) long_step_c(sb, half, l, col, buf.data(), s);
          }
      }
    }
}

// float64 FFTs, independent of the header: an in-place radix-2 FFT of a
// power-of-two length (sign -1 forward, +1 inverse, unscaled), and the
// forward DFT of any length by Bluestein's chirp-z on it
static void fft2(std::vector<cd>& a, int sign) {
  const size_t n = a.size();
  for (size_t i = 1, j = 0; i < n; ++i) {
    size_t bit = n >> 1;
    for (; j & bit; bit >>= 1) j ^= bit;
    j ^= bit;
    if (i < j) std::swap(a[i], a[j]);
  }
  std::vector<cd> w(n / 2 + 1);
  for (size_t k = 0; k < w.size(); ++k)
    w[k] = std::polar(1.0, sign * 2 * PI * (double)k / (double)n);
  for (size_t len = 2; len <= n; len <<= 1)
    for (size_t i = 0; i < n; i += len)
      for (size_t k = 0; k < len / 2; ++k) {
        const cd u = a[i + k], v = a[i + k + len / 2] * w[k * (n / len)];
        a[i + k] = u + v;
        a[i + k + len / 2] = u - v;
      }
}

static size_t pow2_at_least(size_t v) {
  size_t p = 1;
  while (p < v) p <<= 1;
  return p;
}

// exp(-i pi (j^2 mod 2n) / n)
static cd chirp_of(i64 j, int n) {
  return std::polar(1.0, -PI * (double)((j * j) % (2LL * n)) / n);
}

static std::vector<cd> dft(const std::vector<cd>& x) {
  const int n = (int)x.size();
  std::vector<cd> a(x);
  if ((n & (n - 1)) == 0) {
    fft2(a, -1);
    return a;
  }
  const size_t m = pow2_at_least(2 * (size_t)n - 1);
  a.assign(m, 0.0);
  std::vector<cd> b(m, 0.0);
  for (int j = 0; j < n; ++j) {
    a[j] = x[j] * chirp_of(j, n);
    b[j] = std::conj(chirp_of(j, n));
    if (j) b[m - j] = b[j];
  }
  fft2(a, -1);
  fft2(b, -1);
  for (size_t k = 0; k < m; ++k) a[k] *= b[k] / (double)m;
  fft2(a, 1);
  std::vector<cd> out(n);
  for (int k = 0; k < n; ++k) out[k] = a[k] * chirp_of(k, n);
  return out;
}

// the element where the forward passes of the plan leave frequency f
static int spectrum_at(const Plan& pl, int f) {
  int rest = f, e = 0, M = pl.n;
  for (int p = 0; p < pl.npass; ++p) {
    const int r = pl.radix[p];
    M /= r;
    e += (rest % r) * M;
    rest /= r;
  }
  return e;
}

static std::vector<i64> desc_row(const Case& c, i64 B, const float* x,
                                 float* y) {
  std::vector<i64> d(DESC, 0);
  d[0] = (i64)x;
  d[1] = (i64)y;
  d[2] = (i64)c.tw.data();
  d[3] = (i64)c.gp.data();
  d[4] = B;
  d[5] = c.H;
  d[6] = c.W;
  d[7] = c.axis == -2;
  d[8] = c.pl.npass;
  d[9] = c.pl.generic;
  for (int p = 0; p < c.pl.npass; ++p) d[10 + p] = c.pl.radix[p];
  return d;
}

// the long form's row (make_long's layout); s: the scratch or null (y)
static std::vector<i64> long_row(const Case& c, i64 B, const float* x,
                                 float* y, float* s) {
  std::vector<i64> d(LDESC, 0);
  const void* ptrs[11] = {x, y, s, c.twr.data(), c.tw1.data(), c.tw2.data(),
                          c.gp.data(), c.chirp ? c.c.data() : nullptr,
                          c.chirp ? c.hm.data() : nullptr,
                          c.rows == 1 ? (const void*)c.c2.data()
                          : c.rows == 2 ? (const void*)c.perm.data()
                                        : nullptr,
                          c.rows ? c.hm2.data() : nullptr};
  for (int q = 0; q < 11; ++q) d[q] = (i64)ptrs[q];
  d[11] = B;
  d[12] = c.H;
  d[13] = c.W;
  d[14] = c.axis == -2;
  d[15] = c.n1;
  d[16] = c.n2;
  d[17] = c.chirp;
  d[18] = c.rows;
  const Plan* pls[2] = {&c.p1, &c.p2};
  for (int q = 0; q < 2; ++q) {
    d[19 + 2 * q] = pls[q]->npass;
    d[20 + 2 * q] = pls[q]->generic;
    for (int p = 0; p < pls[q]->npass; ++p)
      d[23 + q * ippdft::MAX_PASSES + p] = pls[q]->radix[p];
  }
  return d;
}

// y holds the long form's storage where every pair has both lines
static bool ystore_ok(const Case& c) {
  return !c.chirp && (c.axis == -2 ? c.W % 2 == 0 : c.H % 2 == 0);
}

static std::vector<float> guarded(size_t n) {
  std::vector<float> v(n + 2 * GUARD, NAN);
  for (int i = 0; i < GUARD; ++i) v[i] = v[v.size() - 1 - i] = SENTINEL;
  return v;
}

static bool guards_intact(const std::vector<float>& v) {
  for (int i = 0; i < GUARD; ++i)
    if (v[i] != SENTINEL || v[v.size() - 1 - i] != SENTINEL) return false;
  return true;
}

// one subband alone; false if it is refused.  geo / lgeo: its geometry
static bool run_alone(const Case& c, i64 B, const float* x, float* y,
                      Geo* geo, LongGeo* lgeo) {
  if (c.lng) {
    std::vector<float> scratch;
    const i64 pairs = B * (c.axis == -2 ? (c.W + 1) / 2 : (c.H + 1) / 2);
    if (!ystore_ok(c)) scratch.assign((size_t)(2 * pairs * c.n1 * c.n2), NAN);
    const std::vector<i64> d =
        long_row(c, B, x, y, scratch.empty() ? nullptr : scratch.data());
    LongSub sb;
    if (!make_long(d.data(), sb)) return false;
    if (lgeo) *lgeo = sb.g;
    run_long(sb);
    return true;
  }
  Group grp;
  const std::vector<i64> d = desc_row(c, B, x, y);
  if (!make_group(d.data(), 1, grp)) return false;
  if (geo) *geo = grp.sub[0].g;
  run(grp);
  return true;
}

static std::vector<float2> twiddles(int len) {
  std::vector<float2> t(len);
  for (int k = 0; k < len; ++k)
    t[k] = make_float2((float)std::cos(2 * PI * k / len),
                       (float)-std::sin(2 * PI * k / len));
  return t;
}

// c[j] of the chirp of L, and Hm = DFT_M(h) / M (natural order) of h =
// conj(c) laid out circularly in M = pow2ceil(2L - 1)
static std::vector<cd> chirp_gains(int L, std::vector<float2>& c) {
  const int M = (int)pow2_at_least(2 * (size_t)L - 1);
  std::vector<cd> h(M, 0.0);
  c.resize(L);
  for (int j = 0; j < L; ++j) {
    const cd w = chirp_of(j, L);
    c[j] = make_float2((float)w.real(), (float)w.imag());
    h[j] = std::conj(w);
    if (j) h[M - j] = h[j];
  }
  fft2(h, -1);
  for (auto& v : h) v /= (double)M;
  return h;
}

static void make_case(Case& c, std::mt19937& gen) {
  const int n = c.n;
  std::uniform_real_distribution<float> uni(-1.f, 1.f);
  c.x.resize((size_t)c.B * c.H * c.W);
  for (auto& v : c.x) v = uni(gen);
  // g of ops/destripe.notch, sigma n / 6
  const int kh = n / 2 + 1;
  const double sigma = n / 6.0;
  c.gv.resize(kh);
  for (int k = 0; k < kh; ++k)
    c.gv[k] = (float)(1.0 - std::exp(-(double)k * k / (2 * sigma * sigma)));
  auto G = [&](i64 f) { return (double)c.gv[f < n - f ? f : n - f] / n; };
  if (!c.lng) {
    // G[f] / n at element sum_p k_p M_p of frequency f = k_0 + r_0 k_1 + ...
    c.gp.assign(n, NAN);
    for (int f = 0; f < n; ++f) c.gp[spectrum_at(c.pl, f)] = (float)G(f);
    c.tw = twiddles(n);
    return;
  }
  const int n1 = c.n1, n2 = c.n2, m2 = c.m2;
  c.tw1 = twiddles(n1);
  c.tw2 = twiddles(m2);
  // the frequency k1 the forward passes of plan1 leave at row r, and the
  // four-step's twiddles w_m^(j2 k1) by row
  c.rev1.assign(n1, -1);
  for (int k1 = 0; k1 < n1; ++k1) c.rev1[spectrum_at(c.p1, k1)] = k1;
  c.twr.resize((size_t)n1 * n2);
  for (int r = 0; r < n1; ++r)
    for (int j2 = 0; j2 < n2; ++j2) {
      const double a = 2 * PI * (double)((i64)j2 * c.rev1[r]) / (n1 * n2);
      c.twr[(size_t)r * n2 + j2] =
          make_float2((float)std::cos(a), (float)-std::sin(a));
    }
  if (c.chirp) {   // G / n natural; Hm[k1 + n1 k2] at r m2 + plan2's order
    c.gp.resize(n);
    for (int f = 0; f < n; ++f) c.gp[f] = (float)G(f);
    const std::vector<cd> H = chirp_gains(n, c.c);
    c.hm.assign((size_t)n1 * m2, make_float2(NAN, NAN));
    for (int r = 0; r < n1; ++r)
      for (int k2 = 0; k2 < n2; ++k2) {
        const cd v = H[c.rev1[r] + (size_t)n1 * k2];
        c.hm[(size_t)r * m2 + spectrum_at(c.p2, k2)] =
            make_float2((float)v.real(), (float)v.imag());
      }
    return;
  }
  if (c.rows == 2) {
    // Rader's: g a primitive root of p = n2, perm[q] = g^q; the gains of
    // the cyclic convolution DFT_L(t) / L, t[s] = w_p^(g^-s), L = p - 1;
    // G at 0, then at g^q for each row
    const int p = n2, L = m2;
    int root = 2;
    for (;; ++root) {
      i64 v = 1;
      int order = 0;
      do {
        v = v * root % p;
        ++order;
      } while (v != 1);
      if (order == L) break;
    }
    c.perm.resize(L);
    for (int q = 0, v = 1; q < L; ++q, v = (int)((i64)v * root % p))
      c.perm[q] = v;
    c.hm2.assign(L, make_float2(NAN, NAN));
    for (int k = 0; k < L; ++k) {
      cd acc = 0.0;
      for (int s = 0; s < L; ++s) {
        const int e = c.perm[(L - s) % L];   // g^-s
        acc += std::polar(1.0, -2 * PI * e / p) *
               std::polar(1.0, -2 * PI * (double)((i64)s * k % L) / L);
      }
      acc /= (double)L;
      c.hm2[spectrum_at(c.p2, k)] =
          make_float2((float)acc.real(), (float)acc.imag());
    }
    c.gp.assign((size_t)n1 * n2, NAN);
    for (int r = 0; r < n1; ++r) {
      c.gp[(size_t)r * n2] = (float)G(c.rev1[r]);
      for (int q = 0; q < L; ++q)
        c.gp[(size_t)r * n2 + 1 + q] =
            (float)G(c.rev1[r] + (i64)n1 * c.perm[q]);
    }
    return;
  }
  const bool rc = c.rows == 1;
  c.gp.assign((size_t)n1 * (rc ? n2 : m2), NAN);
  for (int r = 0; r < n1; ++r)
    for (int k2 = 0; k2 < n2; ++k2)
      c.gp[(size_t)r * (rc ? n2 : m2) + (rc ? k2 : spectrum_at(c.p2, k2))] =
          (float)G(c.rev1[r] + (i64)n1 * k2);
  if (!rc) return;
  const std::vector<cd> H2 = chirp_gains(n2, c.c2);
  c.hm2.assign(m2, make_float2(NAN, NAN));
  for (int k = 0; k < m2; ++k)
    c.hm2[spectrum_at(c.p2, k)] =
        make_float2((float)H2[k].real(), (float)H2[k].imag());
}

static int check(Case& c, std::vector<float>& out) {
  const bool cols = c.axis == -2;
  const int n = c.n, H = c.H, W = c.W;
  const i64 B = c.B;
  const size_t tile = (size_t)H * W, total = tile * B;
  std::vector<float> y = guarded(total);
  Geo g;
  LongGeo lg;
  if (!run_alone(c, B, c.x.data(), y.data() + GUARD, &g, &lg)) {
    printf("axis %d B %lld H %d W %d: refused\n", c.axis, B, H, W);
    return 1;
  }
  bool guards = guards_intact(y), alone_differs = false;
  for (i64 b = 0; b < B && B > 1; ++b) {
    std::vector<float> y1 = guarded(tile);
    run_alone(c, 1, c.x.data() + b * tile, y1.data() + GUARD, nullptr,
              nullptr);
    guards = guards && guards_intact(y1);
    if (std::memcmp(y1.data() + GUARD, y.data() + GUARD + b * tile,
                    tile * sizeof(float)))
      alone_differs = true;
  }
  // float64 irfft(rfft(x) * g) of every line
  const int kh = n / 2 + 1;
  const int lines = cols ? W : H;
  std::vector<double> re(kh), im(kh), ct(n), st(n), ref(n);
  for (int m = 0; m < n; ++m) {
    ct[m] = std::cos(2 * PI * m / n);
    st[m] = std::sin(2 * PI * m / n);
  }
  double scale = 0, err = 0;
  bool unwritten = false;
  for (i64 b = 0; b < B; ++b)
    for (int l = 0; l < lines; ++l) {
      const size_t base = b * tile + (cols ? (size_t)l : (size_t)l * W);
      const size_t stride = cols ? W : 1;
      if (n > 4096) {   // by the FFT: G real and even keeps y real
        std::vector<cd> v(n);
        for (int t = 0; t < n; ++t) v[t] = c.x[base + t * stride];
        v = dft(v);
        for (int k = 0; k < n; ++k)
          v[k] = std::conj(v[k] * (double)c.gv[k < n - k ? k : n - k]);
        v = dft(v);
        for (int t = 0; t < n; ++t) ref[t] = v[t].real() / n;
      } else {
        for (int k = 0; k < kh; ++k) {
          double sr = 0, si = 0;
          for (int t = 0, m = 0; t < n; ++t, m = m + k >= n ? m + k - n
                                                           : m + k) {
            sr += c.x[base + t * stride] * ct[m];   // m = k t mod n
            si -= c.x[base + t * stride] * st[m];
          }
          re[k] = sr * c.gv[k];
          im[k] = si * c.gv[k];
        }
        for (int t = 0; t < n; ++t) {
          double v = 0;
          for (int k = 0, m = 0; k < n; ++k, m = m + t >= n ? m + t - n
                                                           : m + t) {
            const int kk = k < n - k ? k : n - k;
            // the Hermitian extension of the half spectrum
            const double ri = re[kk], ii = k == kk ? im[kk] : -im[kk];
            v += ri * ct[m] - ii * st[m];
          }
          ref[t] = v / n;
        }
      }
      for (int t = 0; t < n; ++t) {
        const float got = y[GUARD + base + t * stride];
        if (std::isnan(got)) unwritten = true;
        scale = std::fmax(scale, std::fabs(ref[t]));
        err = std::fmax(err, std::fabs(got - ref[t]));
      }
    }
  const double rel = err / std::fmax(scale, 1e-30);
  const bool ok = !unwritten && guards && !alone_differs && rel <= 1e-5;
  printf("axis %d B %lld H %d W %d n %d: ", c.axis, B, H, W, n);
  if (c.lng)
    printf("long n1 %d n2 %d m2 %d ystore %d C %d CPt %d TJ %d ntj %d bufc "
           "%d nbufc %d items %lld R %d pitch %d bufb %d nbufb %d items %lld "
           "smem %d %d %d;",
           lg.n1, lg.n2, lg.m2, lg.ystore, lg.C, lg.CPt, lg.TJ, lg.ntj,
           lg.bufc, lg.nbufc, lg.items_ac, lg.R, lg.pitch, lg.bufb, lg.nbufb,
           lg.items_b, lg.smem_a, lg.smem_b, lg.smem_c);
  else
    printf("CP %d T %d pitch %d buf %d nbuf %d smem %d tiles %d vec2 %d "
           "items %lld steps %d;",
           g.CP, g.T, g.pitch, g.buf, g.nbuf, g.smem, g.tiles, g.vec2,
           g.items, num_steps(c.pl, false));
  printf(" rel %.2e%s%s%s\n", rel, unwritten ? " UNWRITTEN" : "",
         guards ? "" : " WRITE OUTSIDE", alone_differs ? " ALONE DIFFERS" : "");
  out.assign(y.begin() + GUARD, y.end() - GUARD);
  return ok ? 0 : 1;
}

// the long form's geometry as make_long reads a row of LDESC words (the
// wrapper's: ops/cuda_notch._long_row); pointers are only checked, never
// read
static int row_geometry(int argc, char** argv) {
  if (argc != 2 + LDESC) {
    printf("usage: row W0 .. W%d\n", LDESC - 1);
    return 2;
  }
  std::vector<i64> d(LDESC);
  for (int q = 0; q < LDESC; ++q) d[q] = atoll(argv[2 + q]);
  LongSub sb;
  if (!make_long(d.data(), sb)) {
    printf("refused\n");
    return 1;
  }
  const LongGeo& g = sb.g;
  printf("n1 %d n2 %d m2 %d ystore %d C %d CPt %d TJ %d ntj %d bufc %d "
         "nbufc %d items %lld R %d pitch %d bufb %d nbufb %d items %lld smem "
         "%d %d %d steps %d %d %d\n",
         g.n1, g.n2, g.m2, g.ystore, g.C, g.CPt, g.TJ, g.ntj, g.bufc,
         g.nbufc, g.items_ac, g.R, g.pitch, g.bufb, g.nbufb, g.items_b,
         g.smem_a, g.smem_b, g.smem_c, long_steps(sb, 0), long_steps(sb, 1),
         long_steps(sb, 2));
  return 0;
}

int main(int argc, char** argv) {
  if (argc > 1 && std::string(argv[1]) == "row") return row_geometry(argc, argv);
  int first = 1;
  const bool group = argc > 1 && std::string(argv[1]) == "group";
  if (group) first = 2;
  std::vector<std::vector<std::string>> args(1);
  for (int i = first; i < argc; ++i) {
    if (std::string(argv[i]) == "/")
      args.emplace_back();
    else
      args.back().push_back(argv[i]);
  }
  std::mt19937 gen(7);
  std::vector<Case> cases(args.size());
  std::vector<std::vector<float>> outs(args.size());
  int bad = 0;
  for (size_t q = 0; q < args.size(); ++q) {
    const auto& a = args[q];
    Case& c = cases[q];
    const bool lng = a.size() > 4 && a[4] == "long";
    if (a.size() < 6 || (lng && a.size() < 10)) {
      printf("usage: [group] AXIS B H W GENERIC R0 [R1 ...] [/ ...] or "
             "AXIS B H W long CHIRP ROWCHIRP N1 R1... : R2...\n");
      return 2;
    }
    c.axis = atoi(a[0].c_str());
    c.B = atoll(a[1].c_str());
    c.H = atoi(a[2].c_str());
    c.W = atoi(a[3].c_str());
    c.n = c.axis == -2 ? c.H : c.W;
    c.lng = lng;
    // the plan of a transform of `len` from radices a[from, to)
    auto plan_of = [&](size_t from, size_t to, int len, Plan& pl) {
      pl.n = len;
      pl.npass = (int)(to - from);
      for (int p = 0; p < ippdft::MAX_PASSES; ++p)
        pl.radix[p] = p < pl.npass ? atoi(a[from + p].c_str()) : 1;
      pl.generic = !special(pl.radix[pl.npass - 1]);
    };
    if (!lng) {
      plan_of(5, a.size(), c.n, c.pl);
      c.pl.generic = atoi(a[4].c_str()) == 1;
    } else {
      c.chirp = atoi(a[5].c_str()) != 0;
      c.rows = atoi(a[6].c_str());
      c.n1 = atoi(a[7].c_str());
      const int m = c.chirp ? (int)pow2_at_least(2 * (size_t)c.n - 1) : c.n;
      c.n2 = m / c.n1;
      c.m2 = c.rows == 1   ? (int)pow2_at_least(2 * (size_t)c.n2 - 1)
             : c.rows == 2 ? c.n2 - 1
                           : c.n2;
      const size_t colon =
          std::find(a.begin(), a.end(), std::string(":")) - a.begin();
      plan_of(8, colon, c.n1, c.p1);
      plan_of(colon + 1, a.size(), c.m2, c.p2);
    }
    make_case(c, gen);
    bad |= check(c, outs[q]);
  }
  if (group) {
    // the cases as the wrapper launches them: those whose buffers fit
    // shared memory in one table, each other one alone; every output
    // bit-equal to its lone run
    std::vector<i64> desc;
    std::vector<size_t> in_table, alone;
    std::vector<std::vector<float>> ys(cases.size());
    for (size_t q = 0; q < cases.size(); ++q) {
      ys[q] = guarded(cases[q].x.size());
      if (cases[q].lng) {
        alone.push_back(q);
        if (!run_alone(cases[q], cases[q].B, cases[q].x.data(),
                       ys[q].data() + GUARD, nullptr, nullptr)) {
          printf("group: case %zu refused\n", q);
          return 1;
        }
        continue;
      }
      const std::vector<i64> d = desc_row(cases[q], cases[q].B,
                                          cases[q].x.data(),
                                          ys[q].data() + GUARD);
      in_table.push_back(q);
      desc.insert(desc.end(), d.begin(), d.end());
    }
    Group grp;
    if (!make_group(desc.data(), (int)in_table.size(), grp)) {
      printf("group of %zu: refused\n", in_table.size());
      return 1;
    }
    run(grp);
    int differ = 0, outside = 0;
    for (size_t q = 0; q < cases.size(); ++q) {
      outside += !guards_intact(ys[q]);
      differ += std::memcmp(ys[q].data() + GUARD, outs[q].data(),
                            outs[q].size() * sizeof(float)) != 0;
    }
    printf("group of %zu: smem %d total %lld order", in_table.size(),
           grp.smem, grp.total);
    for (int q = 0; q < grp.count; ++q) printf(" %d", grp.sub[q].g.n);
    printf("; %zu alone", alone.size());
    for (size_t q : alone) printf(" %d", cases[q].n);
    printf("; %d differ from their lone runs%s\n", differ,
           outside ? " WRITE OUTSIDE" : "");
    bad |= differ != 0 || outside != 0;
  }
  return bad;
}
