// Host check of ipp_tpu_torch/csrc/rdft_dense.cuh: the dense K1 / K2
// kernels' operand addressing, masks and TF32 split, the producer's loads
// and swizzled stores of the matrix tile (16-byte and 4-byte loads), each
// consumer thread's copies of its data tile and its A-fragment reads and
// split, the flush schedule and the epilogue, run block by block and
// thread by thread with the header's own functions.
//
//   g++ -std=c++17 -O2 -I tests/torch_dft_fft_host -I ipp_tpu_torch/csrc
//       tests/torch_rdft_dense_host/check.cpp -o check      (one command)
//   ./check MODE NB NZ NY NX KP [/ MODE NB NZ NY NX KP ...]
//
// MODE: 0 K1d, 1 K1d with the ratio, 2 K2d, 3 K2d with |mul * y|.  For each
// case the matrix tiles the producer stores are read back the way wgmma
// reads a K-major B operand with the 128-byte swizzle (its own model below:
// 8-row core blocks 1024 bytes apart, rows 128 bytes apart, the 16-byte
// chunk index XORed with address bits 7-9, a k8 step 32 bytes further),
// the consumers' staged data tiles (their copies) and fragment registers
// (read from those tiles) placed by wgmma's TF32 A fragment
// layout and their accumulators by its f32 D fragment layout (CUTLASS's
// ALayout_64x8 ((4,8,4),(2,2)):((64,1,16),(8,256)) and CLayout_64xN
// ((4,8,4),(2,2,N/8)):((128,1,16),(64,8,512))), and the product formed as
// the kernel orders it (per k8 step hi.hi, lo.hi, hi.lo, each added to an
// f32 accumulator, which `flush_after` adds into the f32 sum).  Checks:
// every tile element and fragment register equals the split of the element
// it stands for (zero outside), a_frag and acc_slot equal the fragment
// layouts, every output written exactly once, the matrix's zero rows give
// exactly 0, the result within 1e-5 of max of a float64 product, and the
// producer's stores free of bank conflicts (check_banks).  Prints one line
// per case; exits 1 on any failure.

#include <algorithm>
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <random>
#include <vector>

#include "rdft_dense.cuh"

using namespace ippdense;

static int failures = 0;

static void fail(const char* what, int a, int b) {
  if (failures++ < 20) std::printf("FAIL %s (%d, %d)\n", what, a, b);
}

// wgmma's read of element (row, k) of a swizzled K-major tile at float
// offset `base` (1024-byte aligned): the hardware's address model
static int hw_offset(int base, int row, int k) {
  const int kk = k / 8, j = k % 8;
  const int start = base * 4 + 32 * kk;
  const int logical = start + (row / 8) * 1024 + (row % 8) * 128 + j * 4;
  return (logical ^ (((logical >> 7) & 7) << 4)) / 4;
}

// (m, k) of A-fragment register i of warpgroup thread t (CUTLASS's
// ALayout_64x8 for TF32)
static void frag_a(int t, int i, int& m, int& k) {
  const int t0 = t % 4, t1 = (t / 4) % 8, t2 = t / 32;
  const int v0 = i % 2, v1 = i / 2;
  const int off = 64 * t0 + t1 + 16 * t2 + 8 * v0 + 256 * v1;
  m = off % 64;
  k = off / 64;
}

// (m, n) of accumulator v of warpgroup thread t (CUTLASS's CLayout_64xN)
static void frag_mn(int t, int v, int& m, int& n) {
  const int t0 = t % 4, t1 = (t / 4) % 8, t2 = t / 32;
  const int v0 = v % 2, v1 = (v / 2) % 2, v2 = v / 4;
  const int off = 128 * t0 + t1 + 16 * t2 + 64 * v0 + 8 * v1 + 512 * v2;
  m = off % 64;
  n = off / 64;
}

template <int MODE, bool VEC>
static void run(int nb, int nz, int ny, int nx, int kp, std::mt19937& gen) {
  const bool fwdk = MODE <= FWD_RATIO;
  const int R = fwdk ? 2 * kp : ny, K = fwdk ? ny : 2 * kp;
  const int kx = ny / 2 + 1;
  std::uniform_real_distribution<float> u(-1.f, 1.f), pos(0.5f, 2.f);
  const size_t vol = (size_t)nb * nz * ny * nx, spec = (size_t)nb * kp * nz * nx;
  std::vector<float> s0(fwdk ? vol : spec), s1(fwdk ? vol : spec), mul(vol);
  std::vector<float> mat((size_t)R * K);
  for (auto& v : s0) v = fwdk ? pos(gen) : u(gen);
  for (auto& v : s1) v = fwdk ? pos(gen) : u(gen);
  for (auto& v : mul) v = u(gen);
  for (auto& v : mat) v = u(gen);
  if (fwdk)   // K1d's fold rows kx..kp-1 of both halves are zero
    for (int r = 0; r < R; ++r)
      if (r % kp >= kx)
        for (int k = 0; k < K; ++k) mat[(size_t)r * K + k] = 0.f;
  std::vector<float> d0(fwdk ? spec : vol, NAN), d1(fwdk ? spec : 0, NAN);
  std::vector<int> hits(d0.size() + d1.size(), 0);
  std::vector<float> tile(SLOT_FLOATS);
  // a data row's copies must stay inside its padded row
  static_assert(RP >= 64 && RP % 32 == 8, "staged row pitch");
  double worst = 0.0, scale = 0.0;
  std::vector<double> ref;

  for (int a = 0; a < nb * nz; ++a) {
    const int b = a / nz;
    const int z = a - b * nz;
    const Plane<MODE> p{s0.data(), MODE == FWD ? nullptr : s1.data(), nz, ny,
                        nx, kp, b, z, a};
    // data element (k, c) of this plane and its den, from the layouts
    auto data_at = [&](int k, int c, float& den) -> float {
      if (fwdk) {
        const size_t off = ((size_t)a * ny + k) * nx + c;
        den = s1[off];
        return s0[off];
      }
      const size_t row = (((size_t)b * kp + k % kp) * nz + z) * nx;
      return (k < kp ? s0 : s1)[row + c];
    };
    // the float64 product of this plane: C[r][c]
    ref.assign((size_t)R * nx, 0.0);
    for (int r = 0; r < R; ++r)
      for (int k = 0; k < K; ++k) {
        const double w = mat[(size_t)r * K + k];
        for (int c = 0; c < nx; ++c) {
          float den = 1.f;
          double x = data_at(k, c, den);
          if (MODE == FWD_RATIO) x = (float)(x / std::fmax(den, FLT_EPSILON));
          ref[(size_t)r * nx + c] += w * x;
        }
      }
    for (int c0 = 0; c0 < nx; c0 += BM)
      for (int r0 = 0; r0 < R; r0 += NT) {
        std::vector<float> acc(2 * 64 * NT, 0.f);   // [wg][m][n]
        std::vector<float> sums(2 * 64 * NT, 0.f);
        // A (hi, lo) of the current k8 step: [wg][m][k]
        std::vector<float> ahi(2 * 64 * 8), alo(2 * 64 * 8);
        const int ntiles = std::max(1, (K + BK - 1) / BK);
        for (int kt = 0; kt < ntiles; ++kt) {
          std::fill(tile.begin(), tile.end(), NAN);
          for (int ptid = 0; ptid < WG; ++ptid) {
            float4 w[MAT_CHUNKS];
            load_mat<VEC>(mat.data(), R, K, kt, r0, ptid, w);
            store_mat(tile.data(), ptid, w);
          }
          // every tile element, read as wgmma reads it, is the split of
          // the element it stands for
          const int BHI = 0, BLO = NT * BK;
          for (int row = 0; row < NT; ++row)
            for (int k = 0; k < BK; ++k) {
              const int r = r0 + row, kg = kt * BK + k;
              const float w = (r < R && kg < K) ? mat[(size_t)r * K + kg] : 0.f;
              float h, l;
              split_tf32(w, h, l);
              if (tile[hw_offset(BHI, row, k)] != h ||
                  tile[hw_offset(BLO, row, k)] != l)
                fail("matrix tile", row, k);
            }
          // the consumers' staged data tiles and fragments of this stage
          std::vector<float> raw(2 * 2 * RAW_FLOATS, NAN);   // [wg][stream]
          for (int wg = 0; wg < 2; ++wg)
            for (int t = 0; t < WG; ++t)
              stage_data<MODE, VEC>(p, kt, c0 + 64 * wg, t,
                                    &raw[(2 * wg) * RAW_FLOATS],
                                    &raw[(2 * wg + 1) * RAW_FLOATS]);
          for (int kk = 0; kk < KSTEPS; ++kk) {
            for (int wg = 0; wg < 2; ++wg)
              for (int t = 0; t < WG; ++t) {
                uint32_t hi[4], lo[4];
                split_data<MODE>(&raw[(2 * wg) * RAW_FLOATS],
                                 &raw[(2 * wg + 1) * RAW_FLOATS], t, kk, hi,
                                 lo);
                for (int i = 0; i < 4; ++i) {
                  const AFrag f = a_frag(t, i);
                  int m, k;
                  frag_a(t, i, m, k);
                  if (f.c != m || f.k != k) fail("a_frag", t, i);
                  const int c = c0 + 64 * wg + m, kg = kt * BK + 8 * kk + k;
                  float x = 0.f, den = 1.f;
                  if (c < nx && kg < K) x = data_at(kg, c, den);
                  if (MODE == FWD_RATIO) x = x / std::fmax(den, FLT_EPSILON);
                  float h, l;
                  split_tf32(x, h, l);
                  if (float_of(hi[i]) != h || float_of(lo[i]) != l)
                    fail("fragment", c, kg);
                  ahi[((size_t)wg * 64 + m) * 8 + k] = float_of(hi[i]);
                  alo[((size_t)wg * 64 + m) * 8 + k] = float_of(lo[i]);
                }
              }
            // the products of k8 step kk, in the kernel's order
            for (int wg = 0; wg < 2; ++wg)
              for (int m = 0; m < 64; ++m)
                for (int n = 0; n < NT; ++n) {
                  const float* as[3] = {&ahi[((size_t)wg * 64 + m) * 8],
                                        &alo[((size_t)wg * 64 + m) * 8],
                                        &ahi[((size_t)wg * 64 + m) * 8]};
                  const int bs[3] = {BHI, BHI, BLO};
                  float& d = acc[((size_t)wg * 64 + m) * NT + n];
                  for (int q = 0; q < 3; ++q) {
                    double sum = 0.0;
                    for (int j = 0; j < 8; ++j)
                      sum += (double)as[q][j] *
                             tile[hw_offset(bs[q], n, 8 * kk + j)];
                    d = (float)(d + sum);
                  }
                }
          }
          for (int wg = 0; wg < 2; ++wg)
            if (flush_after(kt, wg, ntiles))
              for (int i = 64 * NT * wg; i < 64 * NT * (wg + 1); ++i) {
                sums[i] += acc[i];
                acc[i] = 0.f;
              }
        }
        for (float v : acc)
          if (v != 0.f) fail("accumulator left unflushed", 0, 0);
        // the epilogue, by acc_slot, checked against the fragment layout
        for (int wg = 0; wg < 2; ++wg)
          for (int t = 0; t < 128; ++t)
            for (int v = 0; v < NT / 2; ++v) {
              const AccSlot sl = acc_slot(t, v);
              int m, n;
              frag_mn(t, v, m, n);
              if (sl.c != m || sl.r != n) fail("acc_slot", t, v);
              const int c = c0 + 64 * wg + sl.c, r = r0 + sl.r;
              if (c >= nx || r >= R) continue;
              p.store(d0.data(), d1.data(), mul.data(), r, c,
                      sums[((size_t)wg * 64 + m) * NT + n]);
            }
      }
    // this plane's outputs against the float64 product
    for (int r = 0; r < R; ++r)
      for (int c = 0; c < nx; ++c) {
        double want = ref[(size_t)r * nx + c];
        float got;
        size_t idx;
        if (fwdk) {
          const bool lo = r < kp;
          idx = (size_t)p.spec_row(lo ? r : r - kp) + c;
          got = (lo ? d0 : d1)[idx];
          ++hits[lo ? idx : d0.size() + idx];
          if (r % kp >= kx && got != 0.f) fail("zero row", r, c);
        } else {
          idx = ((size_t)a * ny + r) * nx + c;
          got = d0[idx];
          ++hits[idx];
          if (MODE == INV_MUL) want = std::fabs(mul[idx] * want);
        }
        worst = std::max(worst, std::fabs(got - want));
        scale = std::max(scale, std::fabs(want));
      }
  }
  for (size_t i = 0; i < hits.size(); ++i)
    if (hits[i] != 1) fail("output written", (int)i, hits[i]);
  const double rel = worst / std::max(scale, 1e-30);
  if (!(rel <= 1e-5)) fail("error over 1e-5 of max", (int)(rel * 1e9), 0);
  std::printf("mode %d (nb %d, nz %d, ny %d, nx %d, kp %d): R %d K %d %s "
              "loads, rel %.3e\n", MODE, nb, nz, ny, nx, kp, R, K,
              VEC ? "16-byte" : "4-byte", rel);
}

// The producer's shared-memory stores are free of bank conflicts: the 8
// lanes of a quarter-warp storing a matrix chunk hit 8 distinct 16-byte
// bank groups.
static void check_banks() {
  for (int quarter = 0; quarter < WG / 8; ++quarter)
    for (int i = 0; i < MAT_CHUNKS; ++i) {
      if (mat_chunk(8 * quarter, i).r >= NT) continue;
      unsigned seen = 0;
      for (int pt = 8 * quarter; pt < 8 * quarter + 8; ++pt)
        seen |= 1u << (swz(mat_chunk(pt, i).r, mat_chunk(pt, i).k) % 32 / 4);
      if (seen != 0xFFu) fail("matrix store bank conflict", quarter, i);
    }
}

// both widths of copies and loads where nx and the matrix's row length
// allow 16-byte ones, as the kernel takes them; 4-byte ones alone otherwise
template <int MODE>
static void run_mode(int nb, int nz, int ny, int nx, int kp,
                     std::mt19937& gen) {
  const int depth = MODE <= FWD_RATIO ? ny : 2 * kp;
  if (nx % 4 == 0 && depth % 4 == 0) run<MODE, true>(nb, nz, ny, nx, kp, gen);
  run<MODE, false>(nb, nz, ny, nx, kp, gen);
}

int main(int argc, char** argv) {
  check_banks();
  std::mt19937 gen(12);
  int i = 1;
  while (i + 5 < argc) {
    const int mode = std::atoi(argv[i]), nb = std::atoi(argv[i + 1]),
              nz = std::atoi(argv[i + 2]), ny = std::atoi(argv[i + 3]),
              nx = std::atoi(argv[i + 4]), kp = std::atoi(argv[i + 5]);
    i += 6;
    if (i < argc && std::strcmp(argv[i], "/") == 0) ++i;
    switch (mode) {
      case FWD: run_mode<FWD>(nb, nz, ny, nx, kp, gen); break;
      case FWD_RATIO: run_mode<FWD_RATIO>(nb, nz, ny, nx, kp, gen); break;
      case INV: run_mode<INV>(nb, nz, ny, nx, kp, gen); break;
      case INV_MUL: run_mode<INV_MUL>(nb, nz, ny, nx, kp, gen); break;
      default: std::printf("FAIL unknown mode %d\n", mode); return 1;
    }
  }
  return failures ? 1 : 0;
}
