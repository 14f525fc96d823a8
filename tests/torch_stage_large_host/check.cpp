// Host check of ipp_tpu_torch/csrc/stage_large.cuh: its plan rule, the
// geometry of both forms, the slot maps and the index maps, run through the
// header's own passes, and the bank conflicts of every shared-memory access.
//
//   g++ -std=c++17 -Og -I tests/torch_dft_fft_host -I ipp_tpu_torch/csrc
//       tests/torch_stage_large_host/check.cpp -o check     (one command)
//   ./check N LAST G1 R... : G2 R... [/ N LAST ...]
//
// Per case, an n-point transform along the last axis (LAST 1: rows of n)
// or the middle one (LAST 0: one plane of n x 3 columns), plan 1 (G1: its
// last pass is the generic one) and plan 2 (empty: Form A), as
// ops/dft_mats.stage_large_plan gives them:
// - `large_plan_ok`, the geometry within 227 KB and 512 threads, `slot_a`
//   and `slot1` bijections, `dit_group` the inverse of `dit_source`;
// - the kernel's blocks, thread by thread and pass by pass (every thread
//   finishes a pass before the next starts), for the stage forward, the
//   inverse with a conjugated OTF (last axis; both rows take one OTF row)
//   or without (middle axis) and, on the last axis, K7's natural inverse,
//   each against a float64 DFT at <= 1e-5 of the reference's max (at ~110
//   outputs a column);
//   Form B through a scratch of n float2 per column, every scratch value
//   written once and read once;
// - the bank conflicts: every access of a block's threads in program order,
//   grouped into half-warps (16 lanes of 8-byte accesses cover the 32
//   banks); an access's degree is the most distinct slots of its lanes on
//   one bank.  Form A's first pass (source order, digit-reversed stores) is
//   reported apart from the rest.
// Prints one line per case; exits 1 if a plan or geometry is refused, a map
// is no bijection, an error exceeds 1e-5 or a Form B access conflicts.

#include <algorithm>
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <map>
#include <vector>

#include "stage_large.cuh"

using namespace ipplarge;

static const double PI = 3.14159265358979323846;

static std::vector<float> noise(size_t count, unsigned seed) {
  std::vector<float> v(count);
  for (auto& f : v) {
    seed = seed * 1664525u + 1013904223u;
    f = (float)(seed >> 8) / (1 << 24) - 0.5f;
  }
  return v;
}

static std::vector<float2> table(int n) {
  std::vector<float2> tw(n);
  for (int k = 0; k < n; ++k)
    tw[k] = make_float2((float)std::cos(2 * PI * k / n),
                        (float)-std::sin(2 * PI * k / n));
  return tw;
}

// Output k of the n-point DFT (INV: with +i and 1/n) of a natural-order
// sequence, in float64.
static void naive_at(const std::vector<double>& xr,
                     const std::vector<double>& xi, bool inv, int k,
                     double& yr, double& yi) {
  const int n = (int)xr.size();
  double re = 0, im = 0;
  for (long t = 0; t < n; ++t) {
    const double a = 2 * PI * (double)((t * k) % n) / n;
    const double c = std::cos(a), s = (inv ? 1 : -1) * std::sin(a);
    re += xr[t] * c - xi[t] * s;
    im += xr[t] * s + xi[t] * c;
  }
  yr = inv ? re / n : re;
  yi = inv ? im / n : im;
}

typedef std::vector<std::vector<int>> Trace;

// Worst and summed degree over the recorded accesses, half-warp by
// half-warp (lanes in thread order), the k-th access of each lane together.
static void degrees(const Trace& trace, int& worst, long& sum, long& count) {
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

struct Deg {
  int worst = 0;
  long sum = 0, count = 0;
  void add(const Trace& t) { degrees(t, worst, sum, count); }
  double mean() const { return count ? (double)sum / count : 0; }
};

// The in-place passes after the first (stage_large.cuh `rest_passes`), each
// run by every thread before the next: thread tid is (j, c) by `jc`.
template <bool INV, class JC, class Get, class Put, class Store>
static void rest(const Plan& pl, int nthr, int T, int H, const float2* tw,
                 JC jc, Get get, Put put, Store store, bool pair = false) {
  const int n = pl.n, last = pl.npass - 1;
  if (last == 0) return;
  int Lp = pl.radix[0];
  for (int p = 1; p <= last; ++p) {
    const int gnext = p + 1 == last && pl.generic ? pl.radix[last] : 0;
    for (int tid = 0; tid < nthr; ++tid) {
      int j, c;
      jc(tid, j, c);
      // the paired last pass: thread j on half j & 1, as thread j >> 1
      const bool pl_pair = pair && p == last;
      const int j_run = pl_pair ? j >> 1 : j, T_run = pl_pair ? T >> 1 : T;
      for (int hl = 0; hl < (pl_pair ? 1 : H); ++hl) {
        const int h = pl_pair ? j & 1 : hl;
        auto g = [&](int e) { return get(tid, c, h, e); };
        auto s = [&](int e, float2 v) { put(tid, c, h, e, v); };
        auto st = [&](int e, float2 v) { store(tid, c, h, e, v); };
        if (p < last)
          dit_any<INV>(pl.radix[p], j, T, n, Lp, gnext, tw, g, s);
        else if (pl.generic)
          generic_blocked<INV, GENERIC_KB>(j_run, T_run, pl.radix[last], Lp,
                                           tw, g, st);
        else
          dit_any<INV>(pl.radix[last], j_run, T_run, n, Lp, 0, tw, g, st);
      }
    }
    Lp *= pl.radix[p];
  }
}

struct Case {
  int n;
  bool last;
  Plan p1, p2;
};

struct Data {
  int P, X;   // planes (rows on the last axis) and columns
  std::vector<float> xr, xi, otr, oti, rr, ii;
};

// One transform of the whole data through the kernel's blocks (MODE,
// NATURAL), recording the conflicts; returns false when a scratch value is
// not written and read exactly once.
template <int MODE, bool NATURAL>
static bool run(const Case& cs, Data& d, int orows, float osign, Deg& first,
                Deg& other) {
  constexpr bool INVERSE = MODE != FWD;
  const int n = cs.n, m = n / 2;
  const float scale = 1.f / n;
  const std::vector<float2> twn = table(n), tw1 = table(cs.p1.n);
  const int P = d.P, X = d.X;
  d.rr.assign((size_t)P * n * X, 0.f);
  d.ii.assign((size_t)P * n * X, 0.f);
  auto store_out = [&](i64 a, float2 v) {
    d.rr[a] = INVERSE ? v.x * scale : v.x;
    d.ii[a] = INVERSE ? v.y * scale : v.y;
  };
  if (cs.p2.npass == 0) {   // Form A: one row a block
    const GeoA g = geometry_a(cs.p1, 0);
    const int sh = cs.p1.radix[0] == 16 ? 4 : 3;
    for (int row = 0; row < P; ++row) {
      std::vector<float2> smem(n);
      Trace t1(g.T), t2(g.T);
      const i64 base = (i64)row * n;
      const Load2<MODE, NATURAL> load2{
          d.xr.data(), d.xi.data(), d.otr.data(), d.oti.data(), twn.data(),
          base, 1, (i64)(row % std::max(orows, 1)) * n, m, 1, 0, osign, true};
      for (int tid = 0; tid < g.T; ++tid)
        first_pair_any<INVERSE, true>(
            cs.p1, tid, g.T, load2, [&](int h, int e, float2 v) {
              t1[tid].push_back(slot_a(h, e, m, sh));
              smem[slot_a(h, e, m, sh)] = v;
            });
      rest<INVERSE>(
          cs.p1, g.T, g.T, 2, tw1.data(),
          [](int tid, int& j, int& c) { j = tid, c = 0; },
          [&](int tid, int, int h, int e) {
            t2[tid].push_back(slot_a(h, e, m, sh));
            return smem[slot_a(h, e, m, sh)];
          },
          [&](int tid, int, int h, int e, float2 v) {
            t2[tid].push_back(slot_a(h, e, m, sh));
            smem[slot_a(h, e, m, sh)] = v;
          },
          [&](int, int, int h, int e, float2 v) {
            store_out(base + out_pos<MODE, NATURAL>(h, e, m), v);
          },
          INVERSE || NATURAL);
      first.add(t1);
      other.add(t2);
    }
    return true;
  }
  // Form B
  const int m1 = cs.p1.n, m2 = cs.p2.n;
  const std::vector<float2> tw2 = table(m2);
  const Geo1 g1 = geometry_1(cs.p1, 0, 0);
  const ColGeo g2 = col_geometry(cs.p2, 0, 0);
  std::vector<float2> scratch((size_t)P * n * X);
  std::vector<int> written(scratch.size(), 0), read(scratch.size(), 0);
  const bool last = cs.last;
  const i64 n1 = (i64)P * m2 * X, n2 = (i64)P * 2 * m1 * X;
  const int nthr1 = g1.T * g1.cols;
  for (i64 b = 0; b * g1.cols < n1; ++b) {   // pass 1
    std::vector<float2> buf(2 * m1 * g1.cols);
    std::vector<i64> colbase(g1.cols);
    std::vector<int> coli2(g1.cols);
    std::vector<Load2<MODE, NATURAL>> loads;
    for (int c = 0; c < g1.cols; ++c) {
      const i64 col = b * g1.cols + c;
      const bool ok = col < n1;
      const i64 t = ok ? col / X : 0;
      const int x = ok ? (int)(col - t * X) : 0;
      const int i2 = (int)(t % m2);
      const i64 p = t / m2;
      const i64 base = p * n * X + x;
      colbase[c] = base + (last ? (i64)i2 * m1 : (i64)i2 * X);
      coli2[c] = ok ? i2 : -1;
      loads.push_back(Load2<MODE, NATURAL>{
          d.xr.data(), d.xi.data(), d.otr.data(), d.oti.data(), twn.data(),
          base, X, MODE == INV_OTF && ok ? (p % orows) * n : 0, m, m2, i2,
          osign, ok});
    }
    Trace tr(nthr1);
    auto at = [&](int h, int e, int c) {
      return slot1(h, e, c, m1, g1.cols, g1.s);
    };
    for (int tid = 0; tid < nthr1; ++tid) {
      const int c = tid % g1.cols, j = tid / g1.cols;
      first_pair_any<INVERSE, false>(cs.p1, j, g1.T, loads[c],
                                     [&](int h, int e, float2 v) {
                                       tr[tid].push_back(at(h, e, c));
                                       buf[at(h, e, c)] = v;
                                     });
    }
    auto get = [&](int tid, int c, int h, int e) {
      tr[tid].push_back(at(h, e, c));
      return buf[at(h, e, c)];
    };
    auto put = [&](int tid, int c, int h, int e, float2 v) {
      tr[tid].push_back(at(h, e, c));
      buf[at(h, e, c)] = v;
    };
    rest<INVERSE>(cs.p1, nthr1, g1.T, 2, tw1.data(),
                  [&](int tid, int& j, int& c) {
                    c = tid % g1.cols, j = tid / g1.cols;
                  },
                  get, put, put);
    const i64 hs = (i64)m * X, ks = last ? 1 : (i64)m2 * X;
    const int total = 2 * m1 * g1.cols;
    for (int w = 0; w < total; ++w) {
      int k1, cc;
      if (last) {
        k1 = w % m1;
        cc = (w / m1) % g1.cols;
      } else {
        cc = w % g1.cols;
        k1 = (w / g1.cols) % m1;
      }
      const int h = w / (m1 * g1.cols);
      if (coli2[cc] < 0) continue;
      tr[w % nthr1].push_back(at(h, k1, cc));
      float2 tw = twn[2 * k1 * coli2[cc]];
      if (INVERSE) tw.y = -tw.y;
      const i64 a = colbase[cc] + h * hs + k1 * ks;
      scratch[a] = cmul(buf[at(h, k1, cc)], tw);
      ++written[a];
    }
    other.add(tr);
  }
  const int nthr2 = g2.T * g2.cols;
  for (i64 b = 0; b * g2.cols < n2; ++b) {   // pass 2
    std::vector<float2> buf((size_t)m2 * g2.cols);
    Trace tr(nthr2);
    struct Col {
      bool ok;
      i64 sbase, se, obase;
      int k1, h;
    };
    std::vector<Col> cols(g2.cols);
    for (int c = 0; c < g2.cols; ++c) {
      const i64 col = b * g2.cols + c;
      Col& k = cols[c];
      k.ok = col < n2;
      const i64 t = k.ok ? col / X : 0;
      const int x = k.ok ? (int)(col - t * X) : 0;
      k.k1 = (int)(t % m1);
      const i64 q = t / m1;
      k.h = (int)(q & 1);
      const i64 p = q >> 1;
      k.sbase = p * n * X + (i64)k.h * m * X + x +
                (last ? (i64)k.k1 : (i64)k.k1 * m2 * X);
      k.se = last ? m1 : X;
      k.obase = p * n * X + x;
    }
    auto at = [&](int c, int e) {
      return col_slot(e, g2.G, g2.sh) * g2.cols + c;
    };
    auto load = [&](int c, int e) -> float2 {
      if (!cols[c].ok) return make_float2(0.f, 0.f);
      const i64 a = cols[c].sbase + e * cols[c].se;
      ++read[a];
      return scratch[a];
    };
    auto store = [&](int c, int e, float2 v) {
      if (!cols[c].ok) return;
      const Col& k = cols[c];
      store_out(k.obase + (i64)out_pos<MODE, NATURAL>(k.h, k.k1 + m1 * e, m) *
                              X,
                v);
    };
    for (int tid = 0; tid < nthr2; ++tid) {
      const int c = tid % g2.cols, j = tid / g2.cols;
      auto ld = [&](int e) { return load(c, e); };
      if (cs.p2.npass == 1)
        dit_first_any<INVERSE>(cs.p2.radix[0], cs.p2, j, g2.T, ld,
                               [&](int e, float2 v) { store(c, e, v); });
      else
        dit_first_any<INVERSE>(cs.p2.radix[0], cs.p2, j, g2.T, ld,
                               [&](int e, float2 v) {
                                 tr[tid].push_back(at(c, e));
                                 buf[at(c, e)] = v;
                               },
                               cs.p2.npass == 2 && cs.p2.generic
                                   ? cs.p2.radix[1] : 0,
                               tw2.data());
    }
    if (cs.p2.npass > 1)
      rest<INVERSE>(
          cs.p2, nthr2, g2.T, 1, tw2.data(),
          [&](int tid, int& j, int& c) {
            c = tid % g2.cols, j = tid / g2.cols;
          },
          [&](int tid, int c, int, int e) {
            tr[tid].push_back(at(c, e));
            return buf[at(c, e)];
          },
          [&](int tid, int c, int, int e, float2 v) {
            tr[tid].push_back(at(c, e));
            buf[at(c, e)] = v;
          },
          [&](int, int c, int, int e, float2 v) { store(c, e, v); });
    other.add(tr);
  }
  for (size_t a = 0; a < scratch.size(); ++a)
    if (written[a] != 1 || read[a] != 1) return false;
  return true;
}

// The largest error of column (p, x) of d's output over the reference's
// max: the stage's forward (permuted out), its inverse (permuted in, times
// the OTF row p % orows, conjugated), or K7's natural inverse.
static double column_err(const Case& cs, const Data& d, int mode, bool natural,
                         int orows, int p, int x) {
  const int n = cs.n, X = d.X;
  auto perm = [&](int f) { return (f & 1) * (n / 2) + (f >> 1); };
  std::vector<double> zr(n), zi(n);
  for (int f = 0; f < n; ++f) {
    const int pos = mode == FWD || natural ? f : perm(f);
    const size_t a = ((size_t)p * n + pos) * X + x;
    double vr = d.xr[a], vi = d.xi[a];
    if (mode == INV_OTF) {   // conjugated OTF
      const size_t o = (size_t)(p % orows) * n + pos;
      const double wr = d.otr[o], wi = -d.oti[o];
      const double tr = vr * wr - vi * wi;
      vi = vr * wi + vi * wr;
      vr = tr;
    }
    zr[f] = vr;
    zi[f] = vi;
  }
  // ~100 outputs spread over the spectrum, and the first 16: the maximum
  // of the reference over them, which is of the order of its whole max
  double err = 0, top = 0;
  const int step = std::max(1, n / 97);
  for (int k = 0; k < n; k += k < 16 ? 1 : step) {
    double yr, yi;
    naive_at(zr, zi, mode != FWD, k, yr, yi);
    const int pos = mode == FWD && !natural ? perm(k) : k;
    const size_t a = ((size_t)p * n + pos) * X + x;
    err = std::fmax(err, std::fmax(std::fabs(yr - d.rr[a]),
                                   std::fabs(yi - d.ii[a])));
    top = std::fmax(top, std::fmax(std::fabs(yr), std::fabs(yi)));
  }
  return err / (top > 0 ? top : 1);
}

static bool read_plan(char** argv, int argc, int& at, Plan& pl, int gen) {
  pl.npass = 0;
  pl.generic = gen;
  pl.n = 1;
  for (int p = 0; p < MAX_PASSES; ++p) pl.radix[p] = 1;
  while (at < argc && std::strcmp(argv[at], ":") != 0 &&
         std::strcmp(argv[at], "/") != 0) {
    if (pl.npass == MAX_PASSES) return false;
    pl.radix[pl.npass] = std::atoi(argv[at++]);
    pl.n *= pl.radix[pl.npass++];
  }
  if (pl.npass == 0) pl.n = 0;
  return true;
}

int main(int argc, char** argv) {
  int bad = 0;
  for (int at = 1; at < argc;) {
    Case cs;
    cs.n = std::atoi(argv[at++]);
    cs.last = std::atoi(argv[at++]) != 0;
    const int g1 = std::atoi(argv[at++]);
    if (!read_plan(argv, argc, at, cs.p1, g1)) return 2;
    int g2 = 0;
    if (at < argc && std::strcmp(argv[at], ":") == 0) {
      ++at;
      g2 = at < argc && std::strcmp(argv[at], "/") ? std::atoi(argv[at++]) : 0;
    }
    if (!read_plan(argv, argc, at, cs.p2, g2)) return 2;
    ++at;   // the "/"
    const int n = cs.n, m = n / 2;
    if (!large_plan_ok(n, cs.p1, cs.p2, cs.last)) {
      std::printf("n=%d: plan refused\n", n);
      bad = 1;
      continue;
    }
    const bool formA = cs.p2.npass == 0;
    bool bij = true;
    int smem = 0, threads = 0, cols = 0, smem2 = 0, threads2 = 0, cols2 = 0;
    {   // dit_group inverts dit_source
      const Plan& pl = cs.p1;
      for (int g = 0; g < pl.n / pl.radix[0]; ++g)
        if (dit_group(pl, dit_source(pl, g)) != g) bij = false;
    }
    if (formA) {
      const GeoA g = geometry_a(cs.p1, 0);
      smem = g.smem, threads = g.T, cols = 1;
      const int sh = cs.p1.radix[0] == 16 ? 4 : 3;
      std::vector<char> seen(n, 0);
      for (int h = 0; h < 2; ++h)
        for (int e = 0; e < m; ++e) {
          const int s = slot_a(h, e, m, sh);
          if (s < 0 || s >= n || seen[s]) bij = false;
          else seen[s] = 1;
        }
    } else {
      const Geo1 g = geometry_1(cs.p1, 0, 0);
      const ColGeo g2c = col_geometry(cs.p2, 0, 0);
      smem = g.smem, threads = g.T * g.cols, cols = g.cols;
      smem2 = g2c.smem, threads2 = g2c.T * g2c.cols, cols2 = g2c.cols;
      if (g.T < 1 || g2c.T < 1 || threads2 > MAX_THREADS ||
          g2c.smem > SMEM_LIMIT) {
        std::printf("n=%d: geometry refused\n", n);
        bad = 1;
        continue;
      }
      const int m1 = cs.p1.n, size = 2 * m1 * g.cols;
      std::vector<char> seen(size, 0);
      for (int h = 0; h < 2; ++h)
        for (int e = 0; e < m1; ++e)
          for (int c = 0; c < g.cols; ++c) {
            const int s = slot1(h, e, c, m1, g.cols, g.s);
            if (s < 0 || s >= size || seen[s]) bij = false;
            else seen[s] = 1;
          }
      std::vector<char> seen2(cs.p2.n, 0);
      for (int e = 0; e < cs.p2.n; ++e) {
        const int s = col_slot(e, g2c.G, g2c.sh);
        if (s < 0 || s >= cs.p2.n || seen2[s]) bij = false;
        else seen2[s] = 1;
      }
    }
    if (smem > SMEM_LIMIT || threads < 1 || threads > MAX_THREADS) {
      std::printf("n=%d: geometry refused\n", n);
      bad = 1;
      continue;
    }

    // two rows on the last axis, one plane of three columns elsewhere
    Data d;
    d.P = cs.last ? 2 : 1;
    d.X = cs.last ? 1 : 3;
    const size_t size = (size_t)d.P * n * d.X;
    d.xr = noise(size, 7u + n);
    d.xi = noise(size, 11u + n);
    const int orows = 1;   // rows 0 and 1 share the OTF row
    d.otr = noise((size_t)orows * n, 19u + n);
    d.oti = noise((size_t)orows * n, 23u + n);
    Deg first, other;
    double err = 0;
    bool once = run<FWD, false>(cs, d, orows, 1.f, first, other);
    for (int p = 0; p < d.P; ++p)
      for (int x = 0; x < d.X; ++x)
        err = std::fmax(err, column_err(cs, d, FWD, false, orows, p, x));
    if (cs.last) {
      once &= run<INV_OTF, false>(cs, d, orows, -1.f, first, other);
      for (int p = 0; p < d.P; ++p)
        err = std::fmax(err, column_err(cs, d, INV_OTF, false, orows, p, 0));
      once &= run<INV, true>(cs, d, orows, 1.f, first, other);
      for (int p = 0; p < d.P; ++p)
        err = std::fmax(err, column_err(cs, d, INV, true, orows, p, 0));
    } else {
      once &= run<INV, false>(cs, d, orows, 1.f, first, other);
      for (int x = 0; x < d.X; ++x)
        err = std::fmax(err, column_err(cs, d, INV, false, orows, 0, x));
    }
    std::printf("n=%d last=%d form=%s m1=%d m2=%d threads=%d cols=%d "
                "smem=%d threads2=%d cols2=%d smem2=%d bijective=%d "
                "scratch_once=%d err %.3e first_degree worst %d mean %.3f "
                "degree worst %d mean %.3f\n",
                n, (int)cs.last, formA ? "A" : "B", cs.p1.n,
                formA ? 0 : cs.p2.n, threads, cols, smem, threads2, cols2,
                smem2, (int)bij, (int)once, err, first.worst, first.mean(),
                other.worst, other.mean());
    if (!bij || !once || !(err <= 1e-5) || (!formA && other.worst > 1))
      bad = 1;
  }
  return bad;
}
