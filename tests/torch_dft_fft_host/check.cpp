// Host check of the pass templates of ipp_tpu_torch/csrc/dft_fft.cuh.
//
//   g++ -std=c++17 -O1 -I tests/torch_dft_fft_host -I ipp_tpu_torch/csrc
//       tests/torch_dft_fft_host/check.cpp -o check     (one command)
//   ./check PAD N GENERIC R0 R1 ... [/ N GENERIC R0 ...]
//
// For each plan (as ops/dft_mats.dft_fft_plan gives it) it runs the kernel's
// pass sequence on the host, thread by thread and pass by pass with the
// header's own fft_pass / generic_pass, butterflies, slots, geometry and two
// buffers, on three rows, forward and inverse, and compares with a naive
// float64 DFT.  Prints one line per plan; exits 1 if a plan is refused or
// any error exceeds 1e-5 of the reference's max.

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

#include "dft_fft.cuh"

using namespace ippdft;

static const double PI = 3.14159265358979323846;

template <bool INV>
static double run(const Plan& pl, int pad) {
  const int n = pl.n, rows = 3;
  const Geo g = geometry(pl, pad, 0, 0);
  std::vector<float2> tw(n);
  for (int k = 0; k < n; ++k)
    tw[k] = make_float2((float)std::cos(2 * PI * k / n),
                        (float)-std::sin(2 * PI * k / n));
  std::vector<float> xr(rows * n), xi(rows * n), rr(rows * n), ii(rows * n);
  unsigned s = 12345u + n;
  for (auto* v : {&xr, &xi})
    for (auto& f : *v) {
      s = s * 1664525u + 1013904223u;
      f = (float)(s >> 8) / (1 << 24) - 0.5f;
    }
  const float scale = 1.f / (float)n;
  double worst = 0, top = 0;
  for (int row = 0; row < rows; ++row) {
    const int base = row * n;
    std::vector<float2> a(g.pitch), b(g.pitch);
    float2 *cur = a.data(), *nxt = b.data();
    auto from_global = [&](int e) {
      return make_float2(xr[base + e], xi[base + e]);
    };
    auto to_global = [&](int e, float2 v) {
      rr[base + e] = INV ? v.x * scale : v.x;
      ii[base + e] = INV ? v.y * scale : v.y;
    };
    auto from_smem = [&](int e) { return cur[slot(e, pad)]; };
    auto to_smem = [&](int e, float2 v) { nxt[slot(e, pad)] = v; };
    const int last = pl.npass - 1, R0 = pl.radix[0], T = g.T;
    // every thread of the row runs a pass before any runs the next
    auto all = [&](auto&& pass) {
      for (int j = 0; j < T; ++j) pass(j);
    };
    if (last == 0) {
      all([&](int j) {
        any_pass<INV>(R0, j, T, pass_args(n, R0, 1), tw.data(), from_global,
                      to_global);
      });
    } else {
      all([&](int j) {
        any_pass<INV>(R0, j, T, pass_args(n, R0, 1), tw.data(), from_global,
                      to_smem);
      });
      int S = R0;
      for (int p = 1; p < last; ++p) {
        std::swap(cur, nxt);
        const int R = pl.radix[p];
        all([&](int j) {
          any_pass<INV>(R, j, T, pass_args(n, R, S), tw.data(), from_smem,
                        to_smem);
        });
        S *= R;
      }
      cur = nxt;
      const int R = pl.radix[last];
      all([&](int j) {
        if (pl.generic)
          generic_pass<INV>(j, T, R, S, tw.data(), from_smem, to_global);
        else
          any_pass<INV>(R, j, T, pass_args(n, R, S), tw.data(), from_smem,
                        to_global);
      });
    }
    for (int k = 0; k < n; ++k) {
      double re = 0, im = 0;
      for (int t = 0; t < n; ++t) {
        const double ang = (INV ? 2 : -2) * PI * ((long long)k * t % n) / n;
        const double c = std::cos(ang), sn = std::sin(ang);
        re += xr[base + t] * c - xi[base + t] * sn;
        im += xr[base + t] * sn + xi[base + t] * c;
      }
      if (INV) re /= n, im /= n;
      worst = std::fmax(worst, std::fmax(std::fabs(re - rr[base + k]),
                                         std::fabs(im - ii[base + k])));
      top = std::fmax(top, std::fmax(std::fabs(re), std::fabs(im)));
    }
  }
  return worst / top;
}

int main(int argc, char** argv) {
  if (argc < 4) return 2;
  const int pad = std::atoi(argv[1]);
  int bad = 0;
  for (int at = 2; at < argc;) {
    Plan pl;
    pl.n = std::atoi(argv[at++]);
    pl.generic = std::atoi(argv[at++]);
    pl.npass = 0;
    for (int p = 0; p < MAX_PASSES; ++p) pl.radix[p] = 1;
    while (at < argc && std::strcmp(argv[at], "/") != 0) {
      if (pl.npass == MAX_PASSES) return 2;
      pl.radix[pl.npass++] = std::atoi(argv[at++]);
    }
    ++at;
    if (!plan_ok(pl)) {
      std::printf("n=%d: plan refused\n", pl.n);
      bad = 1;
      continue;
    }
    const double f = run<false>(pl, pad), i = run<true>(pl, pad);
    std::printf("n=%d passes=%d generic=%d fwd %.3e inv %.3e\n", pl.n,
                pl.npass, pl.generic, f, i);
    if (!(f <= 1e-5 && i <= 1e-5)) bad = 1;
  }
  return bad;
}
