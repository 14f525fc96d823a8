// Host check of ipp_tpu_torch/csrc/stage_mixed.cuh: its plan rule, both
// geometries, the middle-axis slot map and the permuted index maps, run
// through dft_fft.cuh's own passes.
//
//   g++ -std=c++17 -O2 -I tests/torch_dft_fft_host -I ipp_tpu_torch/csrc
//       tests/torch_stage_mixed_host/check.cpp -o check     (one command)
//   ./check N GENERIC R0 R1 ... [/ N GENERIC R0 ...]
//
// For each plan (as ops/dft_mats.dft_fft_plan gives it):
// - `stage_plan_ok`; the last-axis geometry (K7's) and the middle-axis one
//   (`col_geometry`) within 227 KB of shared memory and 512 threads, T a
//   multiple of G; `col_slot` a bijection of [0, n);
// - one block of the middle-axis form (all COLS columns of a plane, thread
//   (j, c) at index j * COLS + c, elements at col_slot(e) * COLS + c of one
//   buffer), forward with the permuted store and inverse with the permuted
//   load, pass by pass with the header's in-place passes (dit_first_any,
//   dit_any, generic_pass), against a naive float64 DFT; and
//   the last-axis inverse with the OTF product of an OTF row taken modulo a
//   period of 3 rows, through dft_fft.cuh's Stockham passes;
// - the bank conflicts of the middle-axis form: every shared-memory access
//   of the block's threads, recorded per thread in program order, grouped
//   into half-warps (16 lanes of 8-byte accesses cover the 32 banks once);
//   an access's degree is the most distinct slots of its lanes on one bank.
// Prints one line per plan: COLS, T, the shared memory, the errors, and the
// worst and mean degree; exits 1 if a plan or geometry is refused, an error
// exceeds 1e-5 of the reference's max or any access conflicts (degree > 1).

#include <algorithm>
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <map>
#include <vector>

#include "stage_mixed.cuh"

using namespace ippsmix;

static const double PI = 3.14159265358979323846;

static std::vector<float> noise(size_t count, unsigned seed) {
  std::vector<float> v(count);
  for (auto& f : v) {
    seed = seed * 1664525u + 1013904223u;
    f = (float)(seed >> 8) / (1 << 24) - 0.5f;
  }
  return v;
}

// The n-point DFT of column x (natural order), float64; INV with 1/n.
static void naive(const std::vector<double>& xr, const std::vector<double>& xi,
                  bool inv, std::vector<double>& yr, std::vector<double>& yi) {
  const int n = (int)xr.size();
  std::vector<double> cs(n), sn(n);
  for (int m = 0; m < n; ++m) {
    cs[m] = std::cos(2 * PI * m / n);
    sn[m] = (inv ? 1 : -1) * std::sin(2 * PI * m / n);
  }
  yr.assign(n, 0);
  yi.assign(n, 0);
  for (int k = 0; k < n; ++k) {
    double re = 0, im = 0;
    for (int t = 0, m = 0; t < n; ++t, m = m + k < n ? m + k : m + k - n) {
      re += xr[t] * cs[m] - xi[t] * sn[m];
      im += xr[t] * sn[m] + xi[t] * cs[m];
    }
    yr[k] = inv ? re / n : re;
    yi[k] = inv ? im / n : im;
  }
}

// The pass sequence of run_passes (dft_fft.cuh), each pass run by every
// thread before the next: thread(tid, j, col) gives a thread's index j and
// column, load/store its device-memory maps, at(col, e) a slot.
template <bool INV, class Load, class Store, class At>
static void passes(const Plan& pl, int nthreads, int T, const float2* tw,
                   std::vector<float2>& a, std::vector<float2>& b, int cols,
                   Load load, Store store, At at,
                   std::vector<std::vector<int>>& trace) {
  const int n = pl.n, last = pl.npass - 1;
  float2 *cur = a.data(), *nxt = b.data();
  auto all = [&](auto&& pass) {
    for (int tid = 0; tid < nthreads; ++tid) pass(tid, tid / cols, tid % cols);
  };
  auto from = [&](int tid, int c) {
    return [&, tid, c](int e) {
      trace[tid].push_back(at(c, e));
      return cur[at(c, e)];
    };
  };
  auto to = [&](int tid, int c) {
    return [&, tid, c](int e, float2 v) {
      trace[tid].push_back(at(c, e));
      nxt[at(c, e)] = v;
    };
  };
  const int R0 = pl.radix[0];
  all([&](int tid, int j, int c) {
    any_pass<INV>(R0, j, T, pass_args(n, R0, 1), tw,
                  [&](int e) { return load(c, e); }, to(tid, c));
  });
  int S = R0;
  for (int p = 1; p < last; ++p) {
    std::swap(cur, nxt);
    const int R = pl.radix[p];
    all([&](int tid, int j, int c) {
      any_pass<INV>(R, j, T, pass_args(n, R, S), tw, from(tid, c), to(tid, c));
    });
    S *= R;
  }
  cur = nxt;
  const int R = pl.radix[last];
  all([&](int tid, int j, int c) {
    auto st = [&](int e, float2 v) { store(c, e, v); };
    if (pl.generic)
      generic_pass<INV>(j, T, R, S, tw, from(tid, c), st);
    else
      any_pass<INV>(R, j, T, pass_args(n, R, S), tw, from(tid, c), st);
  });
}

// The middle-axis passes of the kernel (stage_mixed.cuh: in place,
// decimation in time), each pass run by every thread before the next, on one
// buffer of `cols` interleaved columns.
template <bool INV, class Load, class Store, class At>
static void dit_passes(const Plan& pl, int nthreads, int T, const float2* tw,
                       std::vector<float2>& buf, int cols, Load load,
                       Store store, At at,
                       std::vector<std::vector<int>>& trace) {
  const int n = pl.n, last = pl.npass - 1;
  auto all = [&](auto&& pass) {
    for (int tid = 0; tid < nthreads; ++tid) pass(tid, tid / cols, tid % cols);
  };
  auto get = [&](int tid, int c) {
    return [&, tid, c](int e) {
      trace[tid].push_back(at(c, e));
      return buf[at(c, e)];
    };
  };
  auto put = [&](int tid, int c) {
    return [&, tid, c](int e, float2 v) {
      trace[tid].push_back(at(c, e));
      buf[at(c, e)] = v;
    };
  };
  all([&](int tid, int j, int c) {
    dit_first_any<INV>(pl.radix[0], pl, j, T,
                       [&](int e) { return load(c, e); }, put(tid, c));
  });
  const int R = pl.radix[last];
  int Lp = pl.radix[0];
  for (int p = 1; p < last; ++p) {
    all([&](int tid, int j, int c) {
      dit_any<INV>(pl.radix[p], j, T, n, Lp,
                   p + 1 == last && pl.generic ? R : 0, tw, get(tid, c),
                   put(tid, c));
    });
    Lp *= pl.radix[p];
  }
  all([&](int tid, int j, int c) {
    auto st = [&](int e, float2 v) { store(c, e, v); };
    if (pl.generic)
      generic_pass<INV>(j, T, R, Lp, tw, get(tid, c), st);
    else
      dit_any<INV>(R, j, T, n, Lp, 0, tw, get(tid, c), st);
  });
}

// Worst and summed degree over the recorded accesses, half-warp by
// half-warp (lanes in thread order), the k-th access of each lane together.
static void degrees(const std::vector<std::vector<int>>& trace, int& worst,
                    long& sum, long& count) {
  const int nthreads = (int)trace.size();
  for (int h = 0; h < nthreads; h += 16) {
    size_t most = 0;
    for (int l = h; l < h + 16 && l < nthreads; ++l)
      most = std::max(most, trace[l].size());
    for (size_t k = 0; k < most; ++k) {
      std::map<int, std::vector<int>> bank;
      for (int l = h; l < h + 16 && l < nthreads; ++l) {
        if (k >= trace[l].size()) continue;
        auto& slots = bank[trace[l][k] % 16];
        if (std::find(slots.begin(), slots.end(), trace[l][k]) == slots.end())
          slots.push_back(trace[l][k]);
      }
      int d = 0;
      for (auto& kv : bank) d = std::max(d, (int)kv.second.size());
      worst = std::max(worst, d);
      sum += d;
      ++count;
    }
  }
}

static double rel(double err, double top) { return err / (top > 0 ? top : 1); }

int main(int argc, char** argv) {
  int bad = 0;
  for (int at = 1; at < argc;) {
    Plan pl;
    pl.n = std::atoi(argv[at++]);
    pl.generic = at < argc ? std::atoi(argv[at++]) : 0;
    pl.npass = 0;
    for (int p = 0; p < MAX_PASSES; ++p) pl.radix[p] = 1;
    while (at < argc && std::strcmp(argv[at], "/") != 0) {
      if (pl.npass == MAX_PASSES) return 2;
      pl.radix[pl.npass++] = std::atoi(argv[at++]);
    }
    ++at;
    const int n = pl.n;
    if (!stage_plan_ok(pl)) {
      std::printf("n=%d: plan refused\n", n);
      bad = 1;
      continue;
    }
    const Geo lg = geometry(pl, 1, 0, 0);
    const ColGeo cg = col_geometry(pl, 0, 0);
    if (lg.smem > SMEM_LIMIT || lg.T * lg.cols > MAX_THREADS || cg.T < 1 ||
        cg.smem > SMEM_LIMIT || cg.T * cg.cols > MAX_THREADS ||
        cg.T % cg.G) {
      std::printf("n=%d: geometry refused\n", n);
      bad = 1;
      continue;
    }
    std::vector<char> seen(n, 0);
    bool bij = true;
    for (int e = 0; e < n; ++e) {
      const int s = col_slot(e, cg.G, cg.sh);
      if (s < 0 || s >= n || seen[s]) bij = false;
      else seen[s] = 1;
    }
    std::vector<float2> tw(n);
    for (int k = 0; k < n; ++k)
      tw[k] = make_float2((float)std::cos(2 * PI * k / n),
                          (float)-std::sin(2 * PI * k / n));

    // the middle-axis form: one plane of X = COLS columns, (n, X) row-major
    const int X = cg.cols, nthr = cg.T * cg.cols;
    const std::vector<float> xr = noise((size_t)n * X, 7u + n);
    const std::vector<float> xi = noise((size_t)n * X, 11u + n);
    std::vector<float> rr((size_t)n * X), ii((size_t)n * X);
    std::vector<float2> tile((size_t)n * X);
    auto slot_at = [&](int c, int e) { return col_slot(e, cg.G, cg.sh) * X + c; };
    double worst_err = 0;
    int worst_deg = 0;
    long deg_sum = 0, deg_count = 0;
    for (int inv = 0; inv < 2; ++inv) {
      std::vector<std::vector<int>> trace(nthr);
      auto load = [&](int c, int e) {
        const int pos = inv ? permuted(e, n) : e;
        return make_float2(xr[(size_t)pos * X + c], xi[(size_t)pos * X + c]);
      };
      auto store = [&](int c, int e, float2 v) {
        const int pos = inv ? e : permuted(e, n);
        rr[(size_t)pos * X + c] = inv ? v.x / n : v.x;
        ii[(size_t)pos * X + c] = inv ? v.y / n : v.y;
      };
      if (inv)
        dit_passes<true>(pl, nthr, cg.T, tw.data(), tile, X, load, store,
                         slot_at, trace);
      else
        dit_passes<false>(pl, nthr, cg.T, tw.data(), tile, X, load, store,
                          slot_at, trace);
      degrees(trace, worst_deg, deg_sum, deg_count);
      for (int c = 0; c < X; ++c) {
        // the natural-order input and output of column c
        std::vector<double> zr(n), zi(n), yr, yi;
        for (int e = 0; e < n; ++e) {
          const int pos = inv ? permuted(e, n) : e;
          zr[e] = xr[(size_t)pos * X + c];
          zi[e] = xi[(size_t)pos * X + c];
        }
        naive(zr, zi, inv, yr, yi);
        double err = 0, top = 0;
        for (int f = 0; f < n; ++f) {
          const int pos = inv ? f : permuted(f, n);
          err = std::fmax(err, std::fmax(std::fabs(yr[f] - rr[(size_t)pos * X + c]),
                                         std::fabs(yi[f] - ii[(size_t)pos * X + c])));
          top = std::fmax(top, std::fmax(std::fabs(yr[f]), std::fabs(yi[f])));
        }
        worst_err = std::fmax(worst_err, rel(err, top));
      }
    }

    // the last-axis inverse with the OTF: 4 rows, OTF rows taken modulo 3
    const int rows = 4, orows = 3;
    const std::vector<float> lr = noise((size_t)rows * n, 13u + n);
    const std::vector<float> li = noise((size_t)rows * n, 17u + n);
    const std::vector<float> o_r = noise((size_t)orows * n, 19u + n);
    const std::vector<float> o_i = noise((size_t)orows * n, 23u + n);
    double otf_err = 0;
    for (int row = 0; row < rows; ++row) {
      const float osign = row % 2 ? -1.f : 1.f;   // conj on odd rows
      const size_t base = (size_t)row * n, obase = (size_t)(row % orows) * n;
      std::vector<float2> la(lg.pitch), lb(lg.pitch);
      std::vector<std::vector<int>> trace(lg.T);
      std::vector<float> out_r(n), out_i(n);
      auto load = [&](int, int e) {
        const int pos = permuted(e, n);
        const float2 v = make_float2(lr[base + pos], li[base + pos]);
        const float2 w = make_float2(o_r[obase + pos], osign * o_i[obase + pos]);
        return make_float2(v.x * w.x - v.y * w.y, v.x * w.y + v.y * w.x);
      };
      auto store = [&](int, int e, float2 v) {
        out_r[e] = v.x / n;
        out_i[e] = v.y / n;
      };
      passes<true>(pl, lg.T, lg.T, tw.data(), la, lb, 1, load, store,
                   [&](int, int e) { return slot(e, 1); }, trace);
      std::vector<double> zr(n), zi(n), yr, yi;
      for (int e = 0; e < n; ++e) {
        const int pos = permuted(e, n);
        const double vr = lr[base + pos], vi = li[base + pos];
        const double wr = o_r[obase + pos], wi = osign * o_i[obase + pos];
        zr[e] = vr * wr - vi * wi;
        zi[e] = vr * wi + vi * wr;
      }
      naive(zr, zi, true, yr, yi);
      double err = 0, top = 0;
      for (int f = 0; f < n; ++f) {
        err = std::fmax(err, std::fmax(std::fabs(yr[f] - out_r[f]),
                                       std::fabs(yi[f] - out_i[f])));
        top = std::fmax(top, std::fmax(std::fabs(yr[f]), std::fabs(yi[f])));
      }
      otf_err = std::fmax(otf_err, rel(err, top));
    }

    const double mean = deg_count ? (double)deg_sum / deg_count : 0;
    std::printf("n=%d passes=%d generic=%d cols=%d T=%d smem=%d last_T=%d "
                "last_rows=%d last_smem=%d bijective=%d err %.3e otf_err "
                "%.3e degree worst %d mean %.3f\n",
                n, pl.npass, pl.generic, cg.cols, cg.T, cg.smem, lg.T, lg.cols,
                lg.smem, (int)bij, worst_err, otf_err, worst_deg, mean);
    if (!bij || !(worst_err <= 1e-5) || !(otf_err <= 1e-5) || worst_deg > 1)
      bad = 1;
  }
  return bad;
}
