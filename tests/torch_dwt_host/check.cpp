// Host check of ipp_tpu_torch/csrc/dwt.cuh: the geometry and the copy,
// tap-loop and store steps of both K5 kernels, run item by item and thread
// by thread with the header's own functions, every thread through one step
// before any runs the next (the kernels' barriers; cp.async is a plain copy
// here).
//
//   g++ -std=c++17 -O2 -I tests/torch_dft_fft_host -I ipp_tpu_torch/csrc
//       tests/torch_dwt_host/check.cpp -o check      (one command)
//   ./check AXIS B N S L R THREADS ALIGNED [/ AXIS B N S L R ...]
//
// AXIS -1: x (B, N) along the last axis (S ignored); -2: x (B, N, S) along
// axis -2.  L taps (even), R outputs a thread (4, 8, 16), THREADS the most a
// block takes (0: the default), ALIGNED 0 makes axis -1 copy 8 bytes a
// lane and axis -2 4 bytes.  For each case both tap loops run
// where the kernel has two (R = 8 and H = 3, 9 or 45: compile-time and
// generic), on random data and taps, against a naive float64 DWT.  Prints one line per case with the geometry;
// exits 1 if a geometry is refused, an output is left unwritten, a write
// lands outside the outputs, the two loops differ in any bit, or an error
// exceeds 1e-5 of the reference's max.

#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <random>
#include <string>
#include <vector>

#include "dwt.cuh"

using namespace ippdwt;

static const int GUARD = 64;

struct Out {
  std::vector<float> a, d;   // GUARD sentinels on both sides
  explicit Out(size_t n)
      : a(n + 2 * GUARD, NAN), d(n + 2 * GUARD, NAN) {
    for (int i = 0; i < GUARD; ++i) {
      a[i] = d[i] = a[a.size() - 1 - i] = d[d.size() - 1 - i] = 12345.f;
    }
  }
  float* pa() { return a.data() + GUARD; }
  float* pd() { return d.data() + GUARD; }
  bool guards_intact() const {
    for (int i = 0; i < GUARD; ++i)
      if (a[i] != 12345.f || d[i] != 12345.f ||
          a[a.size() - 1 - i] != 12345.f || d[d.size() - 1 - i] != 12345.f)
        return false;
    return true;
  }
};

// Every item in turn, every thread through one step before any runs the
// next; the columns' items alternate between the two windows, as a
// block's do.
template <int R, int HT>
static void run_rows(const RowsGeo& g, const float* x, const float* taps,
                     Out& o) {
  std::vector<float4> buf((g.smem + 15) / 16);
  float* smem = reinterpret_cast<float*>(buf.data());
  for (i64 k = 0; k < g.nwork; ++k) {
    std::fill(buf.begin(), buf.end(), make_float4(NAN, NAN, NAN, NAN));
    for (int t = 0; t < g.threads; ++t) {
      stage_taps(taps, buf.data(), g.H, t, g.threads);
      rows_copy(x, rows_copy_buf(smem), g, k, t);
    }
    for (int t = 0; t < g.threads; ++t)
      rows_relayout(rows_copy_buf(smem), rows_window(smem, g), g, k, t);
    for (int t = 0; t < g.threads; ++t)
      rows_compute<R, HT>(o.pa(), o.pd(), buf.data(), rows_window(smem, g),
                          g, k, t);
  }
}

template <int R, int HT>
static void run_cols(const ColsGeo& g, const float* x, const float* taps,
                     Out& o) {
  std::vector<float4> buf((g.smem + 15) / 16);
  float* smem = reinterpret_cast<float*>(buf.data());
  for (i64 k = 0; k < g.nwork; ++k) {
    std::fill(buf.begin(), buf.end(), make_float4(NAN, NAN, NAN, NAN));
    float* win = cols_window(smem, g, (int)(k % 2));
    for (int t = 0; t < g.threads; ++t) {
      stage_taps(taps, buf.data(), g.H, t, g.threads);
      cols_copy(x, win, g, k, t);
    }
    for (int t = 0; t < g.threads; ++t)
      cols_compute<R, HT>(o.pa(), o.pd(), buf.data(), win, g, k, t);
  }
}

// the loop forms the kernel has at this (R, H): generic (HT = 0) always,
// compile-time where launch_r has it
template <int R, class Geo, class Run0, class Run3, class Run9, class Run45>
static int forms(const Geo& g, Run0 r0, Run3 r3, Run9 r9, Run45 r45) {
  r0();
  if (R == 8 && g.H == 3) return r3(), 2;
  if (R == 8 && g.H == 9) return r9(), 2;
  if (R == 8 && g.H == 45) return r45(), 2;
  return 1;
}

template <int R>
static int run(int axis, i64 B, int n, int S, int L, int threads,
               bool aligned, const std::vector<float>& x,
               const std::vector<float>& taps, std::vector<Out>& outs,
               char* geo, size_t geo_len) {
  const size_t m_el = (size_t)B * (n / 2) * (axis == -1 ? 1 : S);
  if (axis == -1) {
    RowsGeo g;
    if (!rows_geometry(B, n, L, R, threads, aligned, g)) return -1;
    snprintf(geo, geo_len,
             "rows tpr %d seg %d tiles %d rows %d threads %d smem %d "
             "vec4 %d items %lld",
             g.tpr, g.seg, g.tiles, g.rows, g.threads, g.smem, g.vec4,
             g.nwork);
    outs.emplace_back(m_el);
    outs.emplace_back(m_el);
    return forms<R>(
        g, [&] { run_rows<R, 0>(g, x.data(), taps.data(), outs[0]); },
        [&] { run_rows<R, 3>(g, x.data(), taps.data(), outs[1]); },
        [&] { run_rows<R, 9>(g, x.data(), taps.data(), outs[1]); },
        [&] { run_rows<R, 45>(g, x.data(), taps.data(), outs[1]); });
  }
  ColsGeo g;
  if (!cols_geometry(B, n, S, L, R, threads, aligned, g)) return -1;
  snprintf(geo, geo_len,
           "cols TI %d warps %d tiles_i %d tiles_s %d threads %d smem %d "
           "vec4 %d items %lld",
           g.TI, g.warps, g.tiles_i, g.tiles_s, g.threads, g.smem, g.vec4,
           g.nwork);
  outs.emplace_back(m_el);
  outs.emplace_back(m_el);
  return forms<R>(
      g, [&] { run_cols<R, 0>(g, x.data(), taps.data(), outs[0]); },
      [&] { run_cols<R, 3>(g, x.data(), taps.data(), outs[1]); },
      [&] { run_cols<R, 9>(g, x.data(), taps.data(), outs[1]); },
      [&] { run_cols<R, 45>(g, x.data(), taps.data(), outs[1]); });
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
  std::uniform_real_distribution<float> uni(-1.f, 1.f);
  int bad = 0;
  for (const auto& c : cases) {
    if (c.size() != 8) {
      printf("usage: AXIS B N S L R THREADS ALIGNED [/ ...]\n");
      return 2;
    }
    const int axis = atoi(c[0].c_str());
    const i64 B = atoll(c[1].c_str());
    const int n = atoi(c[2].c_str()), S = axis == -1 ? 1 : atoi(c[3].c_str());
    const int L = atoi(c[4].c_str()), R = atoi(c[5].c_str());
    const int threads = atoi(c[6].c_str());
    const bool aligned = atoi(c[7].c_str()) != 0;
    const int m = n / 2, H = L / 2;
    std::vector<float> x((size_t)B * n * S), taps(2 * L);
    for (auto& v : x) v = uni(gen);
    for (auto& v : taps) v = uni(gen);
    std::vector<Out> outs;
    char geo[256] = "";
    int nforms = -1;
    if (R == 4)
      nforms = run<4>(axis, B, n, S, L, threads, aligned, x, taps, outs, geo,
                      sizeof geo);
    else if (R == 8)
      nforms = run<8>(axis, B, n, S, L, threads, aligned, x, taps, outs, geo,
                      sizeof geo);
    else if (R == 16)
      nforms = run<16>(axis, B, n, S, L, threads, aligned, x, taps, outs, geo,
                       sizeof geo);
    if (nforms < 0) {
      printf("axis %d B %lld n %d S %d L %d R %d: refused\n", axis, B, n, S,
             L, R);
      bad = 1;
      continue;
    }
    // naive float64 DWT, index by index
    double scale = 0, err = 0;
    bool unwritten = false, differ = false;
    for (i64 b = 0; b < B; ++b)
      for (int i = 0; i < m; ++i)
        for (int s = 0; s < S; ++s) {
          double ra = 0, rd = 0;
          for (int k = 0; k < L; ++k) {
            const double v = x[((size_t)b * n + (2 * i + k) % n) * S + s];
            ra += (double)taps[k] * v;
            rd += (double)taps[L + k] * v;
          }
          const size_t o = ((size_t)b * m + i) * S + s;
          scale = std::fmax(scale, std::fmax(std::fabs(ra), std::fabs(rd)));
          for (int f = 0; f < nforms; ++f) {
            const float ga = outs[f].pa()[o], gd = outs[f].pd()[o];
            if (std::isnan(ga) || std::isnan(gd)) unwritten = true;
            err = std::fmax(err, std::fmax(std::fabs(ga - ra),
                                           std::fabs(gd - rd)));
          }
          if (nforms == 2 &&
              (std::memcmp(&outs[0].pa()[o], &outs[1].pa()[o], 4) ||
               std::memcmp(&outs[0].pd()[o], &outs[1].pd()[o], 4)))
            differ = true;
        }
    bool guards = true;
    for (int f = 0; f < nforms; ++f) guards = guards && outs[f].guards_intact();
    const double rel = err / std::fmax(scale, 1e-30);
    const bool ok = !unwritten && !differ && guards && rel <= 1e-5;
    printf("axis %d B %lld n %d S %d L %d R %d H %d forms %d: %s; rel %.2e%s%s"
           "%s\n",
           axis, B, n, S, L, R, H, nforms, geo, rel,
           unwritten ? " UNWRITTEN" : "", differ ? " FORMS DIFFER" : "",
           guards ? "" : " WRITE OUTSIDE");
    if (!ok) bad = 1;
  }
  return bad;
}
