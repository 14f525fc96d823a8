// Host check of ipp_tpu_torch/csrc/notch.cuh (K8): the geometry and the
// load, pass and store steps, run item by item and thread by thread with the
// header's own functions, every thread through one step before any runs the
// next (the kernel's barriers), both buffers NaN before each item.
//
//   g++ -std=c++17 -O2 -I tests/torch_dft_fft_host -I ipp_tpu_torch/csrc
//       tests/torch_notch_host/check.cpp -o check      (one command)
//   ./check AXIS B H W GENERIC R0 R1 ... [/ ...]
//
// AXIS -1 notches the rows of (B, H, W) (n = W), -2 the columns (n = H);
// the radices are the plan ops/cuda_notch.notch_plan(n) gives, GENERIC 1
// when the last is the generic pass.  Random data, g = notch(n / 2 + 1, n /
// 6) of ops/destripe.notch.  For each case: the kernel's steps on the
// batch, and on each tile alone (B = 1), against a float64 irfft(rfft(x) *
// g) line by line.  Prints one line per case with the geometry; exits 1 if
// a case is refused, an output is left unwritten or written outside the
// output, a tile alone differs in any bit from its place in the batch, or
// an error exceeds 1e-5 of the reference's max.

#include <cmath>
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

// the kernel's item loop on the host: y (with GUARD sentinels each side)
static void run(const Geo& g, const Plan& pl, const float* x, float* y,
                const std::vector<float2>& tw, const std::vector<float>& gs) {
  std::vector<float2> buf(2 * (size_t)g.buf);
  for (i64 k = 0; k < g.items; ++k) {
    std::fill(buf.begin(), buf.end(), make_float2(NAN, NAN));
    for (int t = 0; t < g.threads; ++t) load(g, x, buf.data(), k, t);
    for (int s = 0; s < 2 * pl.npass; ++s)
      for (int t = 0; t < g.threads; ++t)
        step(g, pl, tw.data(), gs.data(), buf.data(), s, t);
    for (int t = 0; t < g.threads; ++t) store(g, y, buf.data(), k, t);
  }
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

static int check(int axis, i64 B, int H, int W, const Plan& pl,
                 std::mt19937& gen) {
  const bool cols = axis == -2;
  const int n = cols ? H : W;
  Geo g;
  if (!notch_plan_ok(pl) || !geometry(B, H, W, cols, true, g) || pl.n != n) {
    printf("axis %d B %lld H %d W %d: refused\n", axis, B, H, W);
    return 1;
  }
  std::uniform_real_distribution<float> uni(-1.f, 1.f);
  const size_t tile = (size_t)H * W, total = tile * B;
  std::vector<float> x(total);
  for (auto& v : x) v = uni(gen);
  // g of ops/destripe.notch, sigma n / 6, and the kernel's tables
  const int kh = n / 2 + 1;
  const double sigma = n / 6.0;
  std::vector<float> gv(kh);
  for (int k = 0; k < kh; ++k)
    gv[k] = (float)(1.0 - std::exp(-(double)k * k / (2 * sigma * sigma)));
  std::vector<float> gs(n);
  for (int k = 0; k < n; ++k)
    gs[k] = (float)((double)gv[k < n - k ? k : n - k] / n);
  std::vector<float2> tw(n);
  for (int k = 0; k < n; ++k)
    tw[k] = make_float2((float)std::cos(2 * PI * k / n),
                        (float)-std::sin(2 * PI * k / n));
  std::vector<float> y = guarded(total);
  run(g, pl, x.data(), y.data() + GUARD, tw, gs);
  bool guards = guards_intact(y), alone_differs = false;
  for (i64 b = 0; b < B && B > 1; ++b) {
    Geo g1;
    geometry(1, H, W, cols, true, g1);
    std::vector<float> y1 = guarded(tile);
    run(g1, pl, x.data() + b * tile, y1.data() + GUARD, tw, gs);
    guards = guards && guards_intact(y1);
    if (std::memcmp(y1.data() + GUARD, y.data() + GUARD + b * tile,
                    tile * sizeof(float)))
      alone_differs = true;
  }
  // float64 irfft(rfft(x) * g) of every line
  const int lines = cols ? W : H;
  std::vector<double> re(kh), im(kh), ct(n), st(n);
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
      for (int k = 0; k < kh; ++k) {
        double sr = 0, si = 0;
        for (int t = 0; t < n; ++t) {
          const int m = (int)((i64)k * t % n);
          sr += x[base + t * stride] * ct[m];
          si -= x[base + t * stride] * st[m];
        }
        re[k] = sr * gv[k];
        im[k] = si * gv[k];
      }
      for (int t = 0; t < n; ++t) {
        double v = 0;
        for (int k = 0; k < n; ++k) {
          const int kk = k < n - k ? k : n - k;
          const int m = (int)((i64)k * t % n);
          // the Hermitian extension of the half spectrum
          const double ri = re[kk], ii = k == kk ? im[kk] : -im[kk];
          v += ri * ct[m] - ii * st[m];
        }
        v /= n;
        const float got = y[GUARD + base + t * stride];
        if (std::isnan(got)) unwritten = true;
        scale = std::fmax(scale, std::fabs(v));
        err = std::fmax(err, std::fabs(got - v));
      }
    }
  const double rel = err / std::fmax(scale, 1e-30);
  const bool ok = !unwritten && guards && !alone_differs && rel <= 1e-5;
  printf("axis %d B %lld H %d W %d n %d: CP %d T %d threads %d pitch %d "
         "buf %d smem %d tiles %d vec2 %d items %lld; rel %.2e%s%s%s\n",
         axis, B, H, W, n, g.CP, g.T, g.threads, g.pitch, g.buf, g.smem,
         g.tiles, g.vec2, g.items, rel, unwritten ? " UNWRITTEN" : "",
         guards ? "" : " WRITE OUTSIDE",
         alone_differs ? " ALONE DIFFERS" : "");
  return ok ? 0 : 1;
}

int main(int argc, char** argv) {
  std::vector<std::vector<std::string>> cases(1);
  for (int i = 1; i < argc; ++i) {
    if (std::string(argv[i]) == "/")
      cases.emplace_back();
    else
      cases.back().push_back(argv[i]);
  }
  std::mt19937 gen(7);
  int bad = 0;
  for (const auto& c : cases) {
    if (c.size() < 6 || c.size() - 5 > (size_t)ippdft::MAX_PASSES) {
      printf("usage: AXIS B H W GENERIC R0 [R1 ...] [/ ...]\n");
      return 2;
    }
    const int axis = atoi(c[0].c_str());
    const i64 B = atoll(c[1].c_str());
    const int H = atoi(c[2].c_str()), W = atoi(c[3].c_str());
    Plan pl;
    pl.n = axis == -2 ? H : W;
    pl.generic = atoi(c[4].c_str());
    pl.npass = (int)c.size() - 5;
    for (int p = 0; p < ippdft::MAX_PASSES; ++p)
      pl.radix[p] = p < pl.npass ? atoi(c[5 + p].c_str()) : 1;
    bad |= check(axis, B, H, W, pl, gen);
  }
  return bad;
}
