// Host check of ipp_tpu_torch/csrc/notch.cuh (K8): the launch table, the
// geometry and the steps, run item by item and thread by thread with the
// header's own functions, every thread through one step before any runs the
// next (the kernel's barriers), the buffers NaN before each item.
//
//   g++ -std=c++17 -O2 -I tests/torch_dft_fft_host -I ipp_tpu_torch/csrc
//       tests/torch_notch_host/check.cpp -o check      (one command)
//   ./check [group] AXIS B H W ROUTE R0 R1 ... [/ ...]
//
// AXIS -1 notches the rows of (B, H, W) (n = W), -2 the columns (n = H);
// the radices are the plan ops/cuda_notch.notch_plan(n) gives, ROUTE 1
// when the last is the generic pass, 2 on the chirp route (the radices of
// m = pow2ceil(2n - 1)), else 0.  Random data, g = notch(n / 2 + 1, n / 6)
// of ops/destripe.notch, the gains in the plan's digit-reversed order
// (computed here from the digits, not by the wrapper's code; on the chirp
// route G / n in natural order, the chirp and the DFT of its conjugate
// from a float64 radix-2 FFT of this file).  For each case, a one-subband
// table (`make_group`) on the batch, and on each tile alone (B = 1),
// against a float64 irfft(rfft(x) * g) line by line (a direct DFT up to n
// = 32768, above it this file's float64 FFT, Bluestein's for n not a power
// of two).  With `group` first, all cases also run as the wrapper launches
// them (ops/cuda_notch._launches: the subbands whose buffers fit shared
// memory in one table, as `ipp_notch_group` launches a decomposition, the
// others each alone), each subband's output bit-compared with its
// one-subband run.  Prints one line per case with the geometry; exits 1 if
// a case is refused, an output is left unwritten or written outside the
// output, a tile alone differs in any bit from its place in the batch, a
// grouped subband from its lone run, or an error exceeds 1e-5 of the
// reference's max.

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
  bool chirp;
  i64 B;
  Plan pl;
  std::vector<float> x, gv, gp;
  std::vector<float2> tw, c, hm;
};

// the kernel's item loop on the host, over a table (the long form's code
// where the buffers live in the scratch)
static void run(const Group& grp) {
  i64 slots = grp.scratch_slots;
  for (int q = 0; q < grp.count; ++q)
    slots = std::max<i64>(slots, (i64)grp.sub[q].g.nbuf * grp.sub[q].g.buf);
  std::vector<float2> buf((size_t)slots);
  for (i64 t = 0; t < grp.total; ++t) {
    const Sub& sb = grp.sub[sub_of(grp, t)];
    std::fill(buf.begin(), buf.end(), make_float2(NAN, NAN));
    for (int s = 0; s < num_steps(sb.pl, sb.g.chirp != 0); ++s)
      for (int tid = 0; tid < THREADS; ++tid) {
        const Lane l = lane_of(sb.g, tid);
        const Pair pr = pair_of(sb.g, t - sb.start, l.c);
        if (grp.scratch_slots)
          run_step<true>(sb, l, pr, buf.data(), s);
        else
          run_step<false>(sb, l, pr, buf.data(), s);
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
  if (c.chirp) {
    d[10 + ippdft::MAX_PASSES] = (i64)c.c.data();
    d[11 + ippdft::MAX_PASSES] = (i64)c.hm.data();
  }
  return d;
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

// one subband alone; false if make_group refuses it
static bool run_alone(const Case& c, i64 B, const float* x, float* y,
                      Geo* geo) {
  Group grp;
  const std::vector<i64> d = desc_row(c, B, x, y);
  if (!make_group(d.data(), 1, grp)) return false;
  if (geo) *geo = grp.sub[0].g;
  run(grp);
  return true;
}

static void make_case(Case& c, std::mt19937& gen) {
  const int n = c.n, m = c.pl.n;
  std::uniform_real_distribution<float> uni(-1.f, 1.f);
  c.x.resize((size_t)c.B * c.H * c.W);
  for (auto& v : c.x) v = uni(gen);
  // g of ops/destripe.notch, sigma n / 6
  const int kh = n / 2 + 1;
  const double sigma = n / 6.0;
  c.gv.resize(kh);
  for (int k = 0; k < kh; ++k)
    c.gv[k] = (float)(1.0 - std::exp(-(double)k * k / (2 * sigma * sigma)));
  // G[f] / n at element sum_p k_p M_p of frequency f = k_0 + r_0 k_1 + ...
  // (the chirp route: in natural order)
  c.gp.assign(n, NAN);
  for (int f = 0; f < n; ++f)
    c.gp[c.chirp ? f : spectrum_at(c.pl, f)] =
        (float)((double)c.gv[f < n - f ? f : n - f] / n);
  c.tw.resize(m);
  for (int k = 0; k < m; ++k)
    c.tw[k] = make_float2((float)std::cos(2 * PI * k / m),
                          (float)-std::sin(2 * PI * k / m));
  if (!c.chirp) return;
  // the chirp c and Hm = DFT_m(h) / m of h = conj(c) laid out circularly
  std::vector<cd> h(m, 0.0);
  c.c.resize(n);
  for (int j = 0; j < n; ++j) {
    const cd w = chirp_of(j, n);
    c.c[j] = make_float2((float)w.real(), (float)w.imag());
    h[j] = std::conj(w);
    if (j) h[m - j] = h[j];
  }
  fft2(h, -1);
  c.hm.assign(m, make_float2(NAN, NAN));
  for (int f = 0; f < m; ++f) {
    const cd v = h[f] / (double)m;
    c.hm[spectrum_at(c.pl, f)] = make_float2((float)v.real(),
                                             (float)v.imag());
  }
}

static int check(Case& c, std::vector<float>& out) {
  const bool cols = c.axis == -2;
  const int n = c.n, H = c.H, W = c.W;
  const i64 B = c.B;
  const size_t tile = (size_t)H * W, total = tile * B;
  std::vector<float> y = guarded(total);
  Geo g;
  if (!run_alone(c, B, c.x.data(), y.data() + GUARD, &g)) {
    printf("axis %d B %lld H %d W %d: refused\n", c.axis, B, H, W);
    return 1;
  }
  bool guards = guards_intact(y), alone_differs = false;
  for (i64 b = 0; b < B && B > 1; ++b) {
    std::vector<float> y1 = guarded(tile);
    run_alone(c, 1, c.x.data() + b * tile, y1.data() + GUARD, nullptr);
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
      if (n > 32768) {   // by the FFT: G real and even keeps y real
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
  printf("axis %d B %lld H %d W %d n %d: CP %d T %d pitch %d buf %d nbuf %d "
         "smem %d tiles %d vec2 %d items %lld steps %d; rel %.2e%s%s%s\n",
         c.axis, B, H, W, n, g.CP, g.T, g.pitch, g.buf, g.nbuf, g.smem,
         g.tiles, g.vec2, g.items, num_steps(c.pl, c.chirp), rel,
         unwritten ? " UNWRITTEN" : "", guards ? "" : " WRITE OUTSIDE",
         alone_differs ? " ALONE DIFFERS" : "");
  out.assign(y.begin() + GUARD, y.end() - GUARD);
  return ok ? 0 : 1;
}

int main(int argc, char** argv) {
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
    if (a.size() < 6 || a.size() - 5 > (size_t)ippdft::MAX_PASSES) {
      printf("usage: [group] AXIS B H W ROUTE R0 [R1 ...] [/ ...]\n");
      return 2;
    }
    Case& c = cases[q];
    c.axis = atoi(a[0].c_str());
    c.B = atoll(a[1].c_str());
    c.H = atoi(a[2].c_str());
    c.W = atoi(a[3].c_str());
    c.n = c.axis == -2 ? c.H : c.W;
    const int route = atoi(a[4].c_str());
    c.chirp = route == 2;
    c.pl.n = transform_length(c.n, c.chirp);
    c.pl.generic = route == 1;
    c.pl.npass = (int)a.size() - 5;
    for (int p = 0; p < ippdft::MAX_PASSES; ++p)
      c.pl.radix[p] = p < c.pl.npass ? atoi(a[5 + p].c_str()) : 1;
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
      const std::vector<i64> d = desc_row(cases[q], cases[q].B,
                                          cases[q].x.data(),
                                          ys[q].data() + GUARD);
      Group one;
      if (!make_group(d.data(), 1, one)) {
        printf("group: case %zu refused\n", q);
        return 1;
      }
      if (one.scratch_slots) {
        alone.push_back(q);
        run(one);
      } else {
        in_table.push_back(q);
        desc.insert(desc.end(), d.begin(), d.end());
      }
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
