// Host check of ipp_tpu_torch/csrc/rdft_y.cuh: the pair packing, the
// geometry, the untangle / tangle folds and dft_fft.cuh's passes in the
// middle-axis layout.
//
//   g++ -std=c++17 -O2 -I tests/torch_dft_fft_host -I ipp_tpu_torch/csrc
//       tests/torch_rdft_y_host/check.cpp -o check      (one command)
//   ./check NY GENERIC R0 R1 ... [/ NY GENERIC R0 ...]
//
// For each plan (as ops/dft_mats.dft_fft_plan gives it) it runs both kernels'
// step sequence on the host, block by block, thread by thread and step by
// step, with the header's own functions and two buffers, on a (nb, nz, ny, nx)
// = (2, 2, ny, 6) volume whose columns differ in scale (nx = 6 is ragged
// against every tile), with and without the fused ratio / |mul * y|, with
// junk in the spectrum's padded rows and in im at k = 0, ny/2, and compares
// with a naive float64 real DFT.  Prints one line per plan; exits 1 if a plan
// is refused, a padded row or an edge's imaginary part is not exactly 0, or
// an error exceeds 1e-5 of the reference's max.

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <utility>
#include <vector>

#include "rdft_y.cuh"

using namespace ipprdft;

static const double PI = 3.14159265358979323846;
static const int NB = 2, NZ = 2, NX = 6;

struct Case {
  Plan pl;
  Geo g;
  int kp, tiles;
  std::vector<float2> tw;
};

// every thread of the block runs a step before any runs the next
template <class F>
static void all_threads(const Geo& g, F&& step) {
  for (int t = 0; t < g.T * g.P; ++t) step(t & (g.P - 1), t >> g.lp);
}

static void forward(const Case& cs, const std::vector<float>& num,
                    const float* den, std::vector<float>& re,
                    std::vector<float>& im) {
  const Plan& pl = cs.pl;
  const Geo& g = cs.g;
  const int n = pl.n, kp = cs.kp, half = n / 2;
  for (int a = 0; a < NB * NZ; ++a)
    for (int tile = 0; tile < cs.tiles; ++tile) {
      const int b = a / NZ, z = a % NZ;
      std::vector<float2> bufa(n * g.P), bufb(n * g.P);
      float2 *cur = bufa.data(), *nxt = bufb.data();
      int pc = 0;
      auto col = [&]() { return (tile * g.P + pc) * 2; };
      auto from_global = [&](int e) {
        const int c = col();
        if (c >= NX) return make_float2(0.f, 0.f);
        const size_t o = ((size_t)a * n + e) * NX + c;
        return make_float2(num[o], num[o + 1]);
      };
      // the prologue hook of the first pass, as the kernel's `ratio`
      auto ratio = [&](int i, int NB, auto& v) {
        constexpr int R = sizeof(v) / sizeof(v[0]);
        const int c = col();
        if (!den || c >= NX) return;
        for (int k = 0; k < R; ++k) {
          const size_t o = ((size_t)a * n + i + k * NB) * NX + c;
          v[k].x = v[k].x / std::fmax(den[o], FLT_EPSILON);
          v[k].y = v[k].y / std::fmax(den[o + 1], FLT_EPSILON);
        }
      };
      auto from_smem = [&](int e) {
        return cur[(e << g.lp) + pc];
      };
      auto to_smem = [&](int e, float2 v) {
        nxt[(e << g.lp) + pc] = v;
      };
      const int R0 = pl.radix[0];
      all_threads(g, [&](int p_, int j) {
        pc = p_;
        if (R0 == 16)
          fft_pass<16, false>(j, g.T, pass_args(n, 16, 1), cs.tw.data(),
                              from_global, to_smem, ratio);
        else
          fft_pass<8, false>(j, g.T, pass_args(n, 8, 1), cs.tw.data(),
                             from_global, to_smem, ratio);
      });
      int S = R0;
      std::swap(cur, nxt);
      for (int p = 1; p < pl.npass; ++p) {
        const int R = pl.radix[p];
        all_threads(g, [&](int p_, int j) {
          pc = p_;
          if (pl.generic && p == pl.npass - 1)
            generic_pass<false>(j, g.T, R, S, cs.tw.data(), from_smem,
                                to_smem);
          else
            any_pass<false>(R, j, g.T, pass_args(n, R, S), cs.tw.data(),
                            from_smem, to_smem);
        });
        S *= R;
        std::swap(cur, nxt);
      }
      all_threads(g, [&](int p_, int j) {
        pc = p_;
        const int c = col();
        for (int k = j; k < kp; k += g.T) {
          float2 vr = make_float2(0.f, 0.f), vi = vr;
          if (k <= half)
            untangle(from_smem(k), from_smem(k == 0 ? 0 : n - k), vr, vi);
          if (c < NX) {
            const size_t o = (((size_t)b * kp + k) * NZ + z) * NX + c;
            re[o] = vr.x, re[o + 1] = vr.y;
            im[o] = vi.x, im[o + 1] = vi.y;
          }
        }
      });
    }
}

static void inverse(const Case& cs, const std::vector<float>& re,
                    const std::vector<float>& im, const float* mul,
                    std::vector<float>& out) {
  const Plan& pl = cs.pl;
  const Geo& g = cs.g;
  const int n = pl.n, kp = cs.kp, half = n / 2;
  const float scale = 1.f / (float)n;
  for (int a = 0; a < NB * NZ; ++a)
    for (int tile = 0; tile < cs.tiles; ++tile) {
      const int b = a / NZ, z = a % NZ;
      std::vector<float2> bufa(n * g.P), bufb(n * g.P);
      float2 *cur = bufa.data(), *nxt = bufb.data();
      int pc = 0;
      auto col = [&]() { return (tile * g.P + pc) * 2; };
      auto from_smem = [&](int e) {
        return cur[(e << g.lp) + pc];
      };
      auto to_smem = [&](int e, float2 v) {
        nxt[(e << g.lp) + pc] = v;
      };
      auto finish = [&](float2 v, size_t o) {
        v.x *= scale, v.y *= scale;
        if (mul) {
          v.x = std::fabs(mul[o] * v.x);
          v.y = std::fabs(mul[o + 1] * v.y);
        }
        return v;
      };
      auto store = [&](int e, float2 v) {
        const int c = col();
        if (c >= NX) return;
        const size_t o = ((size_t)a * n + e) * NX + c;
        out[o] = v.x, out[o + 1] = v.y;
      };
      auto to_global = [&](int e, float2 v) {   // the generic pass
        const int c = col();
        if (c < NX) store(e, finish(v, ((size_t)a * n + e) * NX + c));
      };
      // the epilogue hook of the last pass, as the kernel's `finish_all`
      auto finish_all = [&](int base, int S, auto& v) {
        constexpr int R = sizeof(v) / sizeof(v[0]);
        const int c = col();
        if (c >= NX) return;
        for (int k = 0; k < R; ++k)
          v[k] = finish(v[k], ((size_t)a * n + base + S * k) * NX + c);
      };
      all_threads(g, [&](int p_, int j) {
        pc = p_;
        const int c = col();
        for (int k0 = j; k0 <= half; k0 += TANGLE_ROWS * g.T) {
          float2 vr[TANGLE_ROWS], vi[TANGLE_ROWS];
          for (int u = 0; u < TANGLE_ROWS; ++u) {
            const int k = k0 + u * g.T;
            vr[u] = vi[u] = make_float2(0.f, 0.f);
            if (c < NX && k <= half) {
              const size_t o = (((size_t)b * kp + k) * NZ + z) * NX + c;
              vr[u] = make_float2(re[o], re[o + 1]);
              vi[u] = make_float2(im[o], im[o + 1]);
            }
          }
          for (int u = 0; u < TANGLE_ROWS; ++u) {
            const int k = k0 + u * g.T;
            if (k > half) break;
            const bool edge = k == 0 || k == half;
            float2 zk, zm;
            tangle(vr[u], vi[u], edge, zk, zm);
            to_smem(k, zk);
            if (!edge) to_smem(n - k, zm);
          }
        }
      });
      std::swap(cur, nxt);
      const int last = pl.npass - 1;
      int S = 1;
      for (int p = 0; p < last; ++p) {
        const int R = pl.radix[p];
        all_threads(g, [&](int p_, int j) {
          pc = p_;
          any_pass<true>(R, j, g.T, pass_args(n, R, S), cs.tw.data(),
                         from_smem, to_smem);
        });
        S *= R;
        std::swap(cur, nxt);
      }
      const int R = pl.radix[last];
      all_threads(g, [&](int p_, int j) {
        pc = p_;
        if (pl.generic)
          generic_pass<true>(j, g.T, R, S, cs.tw.data(), from_smem,
                             to_global);
        else
          any_pass<true>(R, j, g.T, pass_args(n, R, S), cs.tw.data(),
                         from_smem, store, finish_all);
      });
    }
}

static unsigned seed_ = 1u;
static float rnd() {   // [0, 1)
  seed_ = seed_ * 1664525u + 1013904223u;
  return (float)(seed_ >> 8) / (1 << 24);
}

// worst |got - want| / max |want| over both kernels and both fused forms;
// < 0 when an exact-zero rule is broken
static double run(const Case& cs) {
  const int n = cs.pl.n, kp = cs.kp, half = n / 2, kx = half + 1;
  const size_t vox = (size_t)NB * NZ * n * NX, spec = (size_t)NB * kp * NZ * NX;
  seed_ = 777u + n;
  std::vector<double> ct(n), st(n);   // cos, sin of 2 pi m / n
  for (int m = 0; m < n; ++m) {
    ct[m] = std::cos(2 * PI * m / n);
    st[m] = std::sin(2 * PI * m / n);
  }
  std::vector<float> x(vox), den(vox), mul(vox);
  const float colscale[NX] = {1.f, 1e-3f, 40.f, 1.f, 1.f, 1e-4f};
  for (size_t o = 0; o < vox; ++o) {
    x[o] = (rnd() - 0.3f) * colscale[o % NX];
    den[o] = 0.5f + rnd();
    mul[o] = rnd() - 0.5f;
  }
  double worst = 0;
  for (int fused = 0; fused < 2; ++fused) {
    std::vector<float> re(spec, 7.f), im(spec, 7.f);
    forward(cs, x, fused ? den.data() : nullptr, re, im);
    double err = 0, top = 0;
    for (int a = 0; a < NB * NZ; ++a)
      for (int c = 0; c < NX; ++c) {
        const int b = a / NZ, z = a % NZ;
        for (int k = 0; k < kp; ++k) {
          const size_t o = (((size_t)b * kp + k) * NZ + z) * NX + c;
          if (k >= kx) {
            if (re[o] != 0.f || im[o] != 0.f) return -1;
            continue;
          }
          if ((k == 0 || k == half) && im[o] != 0.f) return -2;
          double sr = 0, si = 0;
          for (int t = 0; t < n; ++t) {
            const size_t i = ((size_t)a * n + t) * NX + c;
            const double v =
                fused ? (double)(x[i] / std::fmax(den[i], FLT_EPSILON)) : x[i];
            const int m = (int)((long long)k * t % n);
            sr += v * ct[m];
            si -= v * st[m];
          }
          err = std::fmax(err, std::fmax(std::fabs(sr - re[o]),
                                         std::fabs(si - im[o])));
          top = std::fmax(top, std::fmax(std::fabs(sr), std::fabs(si)));
        }
      }
    worst = std::fmax(worst, err / top);
  }
  // the inverse on a random spectrum with junk where the fold ignores it
  std::vector<float> re(spec), im(spec);
  for (size_t o = 0; o < spec; ++o) re[o] = rnd() - 0.5f, im[o] = rnd() - 0.5f;
  for (int fused = 0; fused < 2; ++fused) {
    std::vector<float> out(vox, 7.f);
    inverse(cs, re, im, fused ? mul.data() : nullptr, out);
    double err = 0, top = 0;
    for (int a = 0; a < NB * NZ; ++a)
      for (int c = 0; c < NX; ++c) {
        const int b = a / NZ, z = a % NZ;
        for (int t = 0; t < n; ++t) {
          double y = 0;
          for (int k = 0; k < kx; ++k) {
            const size_t o = (((size_t)b * kp + k) * NZ + z) * NX + c;
            const bool edge = k == 0 || k == half;
            const int m = (int)((long long)k * t % n);
            y += (edge ? 1.0 : 2.0) *
                 (re[o] * ct[m] - (edge ? 0.0 : im[o]) * st[m]);
          }
          y /= n;
          const size_t i = ((size_t)a * n + t) * NX + c;
          if (fused) y = std::fabs(mul[i] * y);
          err = std::fmax(err, std::fabs(y - out[i]));
          top = std::fmax(top, std::fabs(y));
        }
      }
    worst = std::fmax(worst, err / top);
  }
  return worst;
}

int main(int argc, char** argv) {
  if (argc < 4) return 2;
  int bad = 0;
  for (int at = 1; at < argc;) {
    Case cs;
    Plan& pl = cs.pl;
    pl.n = std::atoi(argv[at++]);
    pl.generic = std::atoi(argv[at++]);
    pl.npass = 0;
    for (int p = 0; p < ippdft::MAX_PASSES; ++p) pl.radix[p] = 1;
    while (at < argc && std::strcmp(argv[at], "/") != 0) {
      if (pl.npass == ippdft::MAX_PASSES) return 2;
      pl.radix[pl.npass++] = std::atoi(argv[at++]);
    }
    ++at;
    if (!plan_ok(pl) || pl.n > MAX_NY) {
      std::printf("ny=%d: plan refused\n", pl.n);
      bad = 1;
      continue;
    }
    const int n = pl.n;
    cs.g = geometry(pl, 0, 0);
    cs.kp = (n / 2 + 1 + 7) / 8 * 8;
    cs.tiles = (NX / 2 + cs.g.P - 1) / cs.g.P;
    cs.tw.resize(n);
    for (int k = 0; k < n; ++k)
      cs.tw[k] = make_float2((float)std::cos(2 * PI * k / n),
                             (float)-std::sin(2 * PI * k / n));
    double worst = run(cs);
    // a tile of two pairs: three tiles of the six columns, one ragged
    Case small = cs;
    small.g = geometry(pl, 0, 2);
    small.tiles = (NX / 2 + 1) / 2;
    const double w2 = run(small);
    worst = (worst < 0 || w2 < 0) ? std::fmin(worst, w2) : std::fmax(worst, w2);
    std::printf("ny=%d passes=%d generic=%d T=%d P=%d smem=%d worst %.3e\n", n,
                pl.npass, pl.generic, cs.g.T, cs.g.P, cs.g.smem, worst);
    if (!(worst >= 0 && worst <= 1e-5)) bad = 1;
  }
  return bad;
}
