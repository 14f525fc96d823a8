// Host check of ipp_tpu_torch/csrc/cplx_dense.cuh: K7d's operand
// addressing, masks of ragged M, K and N, the TF32 split, the producer's
// matrix loads and transposed swizzled stores, each consumer thread's
// copies of its data tiles and its fragment reads and splits, the flush
// schedule with Karatsuba's fold, and the epilogue, run block by block and
// thread by thread with the header's own functions.
//
//   g++ -std=c++17 -O2 -I tests/torch_dft_fft_host -I ipp_tpu_torch/csrc
//       tests/torch_cplx_dense_host/check.cpp -o check      (one command)
//   ./check M K N KIND [/ M K N KIND ...]
//
// KIND: 0 the forward DFT matrices of length K (K == N), 1 random
// matrices.  For each case the matrix tiles the producer stores are read
// back the way wgmma reads a K-major B operand with the 128-byte swizzle
// (its own model below: 8-row core blocks 1024 bytes apart, rows 128 bytes
// apart, the 16-byte chunk index XORed with address bits 7-9, a k8 step
// 32 bytes further), the consumers' fragment registers (read from their
// staged tiles) placed by wgmma's TF32 A fragment layout and their
// accumulators by its f32 D fragment layout (CUTLASS's ALayout_64x8
// ((4,8,4),(2,2)):((64,1,16),(8,256)) and CLayout_64xN
// ((4,8,4),(2,2,N/8)):((128,1,16),(64,8,512))), and the products formed as
// the kernel orders them (per k8 step the terms hi.hi, lo.hi, hi.lo of t1,
// t2, t3, each added to an f32 accumulator, folded by `flush_after`).
// Checks: every tile element written exactly once and equal to the split
// of the element it stands for (zero outside), every fragment register
// likewise, a_frag and acc_slot equal to the fragment layouts, every
// output written exactly once, and the result within 1e-5 of max of a
// float64 product.  Reports the bank-conflict degree (most wavefronts a
// request needs over the fewest it could) of the producer's stores, the
// consumers' copies and their fragment reads.  Prints one line per case;
// exits 1 on any failure.

#include <algorithm>
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <random>
#include <set>
#include <vector>

#include "cplx_dense.cuh"

using namespace ippcplx;

static int failures = 0;

static void fail(const char* what, long long a, long long b) {
  if (failures++ < 20) std::printf("FAIL %s (%lld, %lld)\n", what, a, b);
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

// Wavefronts of one shared-memory request of `bytes` a lane at the given
// float offsets (one per lane; a 16-byte request goes a quarter-warp at a
// time, a 4-byte one the whole warp at once): the most distinct words one
// bank serves, summed over the phases.
static int wavefronts(const std::vector<int>& offs, int bytes) {
  const int lanes = bytes == 16 ? 8 : 32;
  int total = 0;
  for (size_t p = 0; p < offs.size(); p += lanes) {
    std::vector<std::set<int>> words(32);
    for (size_t l = p; l < std::min(offs.size(), p + lanes); ++l)
      for (int j = 0; j < bytes / 4; ++j)
        words[(offs[l] + j) % 32].insert(offs[l] + j);
    size_t most = 0;
    for (auto& w : words) most = std::max(most, w.size());
    total += (int)most;
  }
  return total;
}

// the conflict degree of each shared-memory access pattern of the kernel,
// over every warp of a warpgroup (1 = none)
struct Banks {
  int store = 0, copy16 = 0, copy4 = 0, frag = 0;
};

static Banks check_banks() {
  Banks b;
  for (int warp = 0; warp < WG / 32; ++warp) {
    for (int i = 0; i < MAT_CHUNKS; ++i) {
      std::vector<int> offs;
      for (int l = 0; l < 32; ++l) {
        const MatChunk ch = mat_chunk(32 * warp + l, i);
        offs.push_back(swz(ch.n, ch.k));
      }
      b.store = std::max(b.store, wavefronts(offs, 16) / 4);
    }
    for (int i = 0; i < copies<true>(); ++i) {
      std::vector<int> offs;
      for (int l = 0; l < 32; ++l) {
        const Copy cp = data_copy<true>(32 * warp + l, i);
        offs.push_back(swz(cp.m, cp.k));
      }
      b.copy16 = std::max(b.copy16, wavefronts(offs, 16) / 4);
    }
    for (int i = 0; i < copies<false>(); ++i) {
      std::vector<int> offs;
      for (int l = 0; l < 32; ++l) {
        const Copy cp = data_copy<false>(32 * warp + l, i);
        offs.push_back(swz(cp.m, cp.k));
      }
      b.copy4 = std::max(b.copy4, wavefronts(offs, 4));
    }
    for (int kk = 0; kk < KSTEPS; ++kk)
      for (int i = 0; i < 4; ++i) {
        std::vector<int> offs;
        for (int l = 0; l < 32; ++l) {
          const ippdense::AFrag f = ippdense::a_frag(32 * warp + l, i);
          offs.push_back(swz(f.c, 8 * kk + f.k));
        }
        b.frag = std::max(b.frag, wavefronts(offs, 4));
      }
  }
  return b;
}

template <bool VEC>
static void run(long long M, int K, int N, int kind, std::mt19937& gen) {
  std::uniform_real_distribution<float> u(-0.5f, 0.5f);
  std::vector<float> re((size_t)M * K), im((size_t)M * K);
  std::vector<float> mr((size_t)K * N), mi((size_t)K * N), mri((size_t)K * N);
  for (auto& v : re) v = u(gen);
  for (auto& v : im) v = u(gen);
  for (int k = 0; k < K; ++k)
    for (int n = 0; n < N; ++n) {
      const size_t o = (size_t)k * N + n;
      if (kind == 0) {
        const double a = -2 * M_PI * (double)((long long)k * n % K) / K;
        mr[o] = (float)std::cos(a);
        mi[o] = (float)std::sin(a);
      } else {
        mr[o] = u(gen);
        mi[o] = u(gen);
      }
      mri[o] = mr[o] + mi[o];
    }
  std::vector<float> rr((size_t)M * N, NAN), ii((size_t)M * N, NAN);
  const Operands op{re.data(), im.data(), mr.data(), mi.data(), mri.data(),
                    rr.data(),  ii.data(), M,         K,         N};
  // tag buffers with a guard of BM rows behind the outputs
  std::vector<float> trr((size_t)(M + BM) * N, 0.f), tii(trr);
  Operands tags = op;
  tags.rr = trr.data();
  tags.ii = tii.data();
  const float* mats[MATS] = {mr.data(), mi.data(), mri.data()};
  std::vector<float> slot(SLOT_FLOATS);
  std::vector<int> written(SLOT_FLOATS);
  const int ntiles = std::max(1, (K + BK - 1) / BK);
  const int ntn = (N + NT - 1) / NT;

  for (long long rt = 0; rt < (M + BM - 1) / BM; ++rt)
    for (int tn = 0; tn < ntn; ++tn) {
      const long long row0 = rt * BM;
      const int n0 = tn * NT;
      // [wg][product][m][n] accumulators, [wg][rr / ii][m][n] sums
      std::vector<float> acc(2 * PRODUCTS * 64 * NT, 0.f);
      std::vector<float> sums(2 * 2 * 64 * NT, 0.f);
      auto A = [&](int wg, int p, int m, int n) -> float& {
        return acc[(((size_t)wg * PRODUCTS + p) * 64 + m) * NT + n];
      };
      auto S = [&](int wg, int q, int m, int n) -> float& {
        return sums[(((size_t)wg * 2 + q) * 64 + m) * NT + n];
      };
      for (int kt = 0; kt < ntiles; ++kt) {
        // the producer: every tile element written once, with the split of
        // the matrix element it stands for
        std::fill(slot.begin(), slot.end(), NAN);
        std::fill(written.begin(), written.end(), 0);
        for (int ptid = 0; ptid < WG; ++ptid) {
          float4 w[MATS][MAT_CHUNKS];
          load_mats(op, kt, n0, ptid, w);
          store_mats(slot.data(), ptid, w);
          for (int m = 0; m < MATS; ++m)
            for (int i = 0; i < MAT_CHUNKS; ++i) {
              const MatChunk ch = mat_chunk(ptid, i);
              for (int half = 0; half < 2; ++half)
                for (int j = 0; j < 4; ++j)
                  ++written[(2 * m + half) * TILE + swz(ch.n, ch.k) + j];
            }
        }
        for (int e = 0; e < SLOT_FLOATS; ++e)
          if (written[e] != 1) fail("tile element written", e, written[e]);
        for (int m = 0; m < MATS; ++m)
          for (int row = 0; row < NT; ++row)
            for (int k = 0; k < BK; ++k) {
              const int n = n0 + row, kg = kt * BK + k;
              const float v =
                  (n < N && kg < K) ? mats[m][(size_t)kg * N + n] : 0.f;
              float h, l;
              split_tf32(v, h, l);
              if (slot[hw_offset(2 * m * TILE, row, k)] != h ||
                  slot[hw_offset((2 * m + 1) * TILE, row, k)] != l)
                fail("matrix tile", n, kg);
            }
        for (int wg = 0; wg < 2; ++wg) {
          const long long crow0 = row0 + ROWS * wg;
          std::vector<float> rre(RAW_FLOATS, NAN), rim(RAW_FLOATS, NAN);
          for (int t = 0; t < WG; ++t)
            stage_data<VEC>(op, crow0, kt, t, rre.data(), rim.data());
          for (int kk = 0; kk < KSTEPS; ++kk) {
            // [p][hi / lo][m][k] of this warpgroup's k8 step
            std::vector<float> frag(PRODUCTS * 2 * 64 * 8, NAN);
            for (int t = 0; t < WG; ++t) {
              uint32_t a[PRODUCTS][2][4];
              split_data(rre.data(), rim.data(), t, kk, a);
              for (int i = 0; i < 4; ++i) {
                const ippdense::AFrag f = ippdense::a_frag(t, i);
                int m, k;
                frag_a(t, i, m, k);
                if (f.c != m || f.k != k) fail("a_frag", t, i);
                const long long row = crow0 + m;
                const int kg = kt * BK + 8 * kk + k;
                const bool in = row < M && kg < K;
                const float x = in ? re[(size_t)row * K + kg] : 0.f;
                const float y = in ? im[(size_t)row * K + kg] : 0.f;
                const float v[PRODUCTS] = {x, y, x + y};
                for (int p = 0; p < PRODUCTS; ++p) {
                  float h, l;
                  split_tf32(v[p], h, l);
                  if (ippdense::float_of(a[p][0][i]) != h ||
                      ippdense::float_of(a[p][1][i]) != l)
                    fail("fragment", row, kg);
                  frag[((p * 2 + 0) * 64 + m) * 8 + k] =
                      ippdense::float_of(a[p][0][i]);
                  frag[((p * 2 + 1) * 64 + m) * 8 + k] =
                      ippdense::float_of(a[p][1][i]);
                }
              }
            }
            // the wgmmas of k8 step kk, in the kernel's order
            for (int term = 0; term < 3; ++term)
              for (int p = 0; p < PRODUCTS; ++p) {
                const int fa = term_a(term);
                const int tb = (2 * p + term_b(term)) * TILE;
                for (int m = 0; m < 64; ++m)
                  for (int n = 0; n < NT; ++n) {
                    double s = 0.0;
                    for (int j = 0; j < 8; ++j)
                      s += (double)frag[((p * 2 + fa) * 64 + m) * 8 + j] *
                           slot[hw_offset(tb, n, 8 * kk + j)];
                    A(wg, p, m, n) = (float)(A(wg, p, m, n) + s);
                  }
              }
          }
          if (ippdense::flush_after(kt, wg, ntiles))
            for (int m = 0; m < 64; ++m)
              for (int n = 0; n < NT; ++n) {
                fold(A(wg, 0, m, n), A(wg, 1, m, n), A(wg, 2, m, n),
                     S(wg, 0, m, n), S(wg, 1, m, n));
                for (int p = 0; p < PRODUCTS; ++p) A(wg, p, m, n) = 0.f;
              }
        }
      }
      for (float v : acc)
        if (v != 0.f) fail("accumulator left unflushed", rt, tn);
      // the epilogue, by acc_slot, checked against the fragment layout:
      // first with tags (each output's own index + 1, placed by the
      // independent layout) into tag buffers, then with the sums
      for (int wg = 0; wg < 2; ++wg)
        for (int t = 0; t < WG; ++t)
          for (int v = 0; v < NACC; v += 2) {
            float tag[2];
            for (int q = 0; q < 2; ++q) {
              const ippdense::AccSlot sl = ippdense::acc_slot(t, v + q);
              int m, n;
              frag_mn(t, v + q, m, n);
              if (sl.c != m || sl.r != n) fail("acc_slot", t, v + q);
              tag[q] = (float)(1 + (row0 + ROWS * wg + m) * N + n0 + n);
            }
            const ippdense::AccSlot sl = ippdense::acc_slot(t, v);
            const long long row = row0 + ROWS * wg + sl.c;
            const int n = n0 + sl.r;
            store_pair(tags, row, n, tag[0], tag[1], tag[0], tag[1]);
            store_pair(op, row, n, S(wg, 0, sl.c, sl.r),
                       S(wg, 0, sl.c, sl.r + 1), S(wg, 1, sl.c, sl.r),
                       S(wg, 1, sl.c, sl.r + 1));
          }
    }
  // every output written once: its own tag, the guard behind it untouched
  for (size_t o = 0; o < trr.size(); ++o) {
    const float want = o < (size_t)(M * N) ? (float)(1 + o) : 0.f;
    if (trr[o] != want || tii[o] != want)
      fail("output written", (long long)o, (long long)trr[o]);
  }
  double worst = 0.0, scale = 0.0;
  for (long long row = 0; row < M; ++row)
    for (int n = 0; n < N; ++n) {
      double wr = 0.0, wi = 0.0;
      for (int k = 0; k < K; ++k) {
        const double a = re[(size_t)row * K + k], b = im[(size_t)row * K + k];
        const double c = mr[(size_t)k * N + n], d = mi[(size_t)k * N + n];
        wr += a * c - b * d;
        wi += a * d + b * c;
      }
      const size_t o = (size_t)row * N + n;
      worst = std::max({worst, std::fabs(rr[o] - wr), std::fabs(ii[o] - wi)});
      scale = std::max({scale, std::fabs(wr), std::fabs(wi)});
    }
  const double rel = worst / std::max(scale, 1e-30);
  if (!(rel <= 1e-5)) fail("error over 1e-5 of max", (long long)(rel * 1e9), 0);
  std::printf("M %lld K %d N %d %s: %s copies, %d x %d tiles, %d stages, "
              "rel %.3e\n", M, K, N, kind == 0 ? "dft" : "random",
              VEC ? "16-byte" : "4-byte", (int)((M + BM - 1) / BM), ntn,
              ntiles, rel);
}

int main(int argc, char** argv) {
  const Banks b = check_banks();
  std::printf("bank-conflict degree: matrix stores %d, data copies %d "
              "(16-byte) / %d (4-byte), fragment reads %d\n",
              b.store, b.copy16, b.copy4, b.frag);
  if (b.store != 1 || b.frag != 1) fail("bank conflicts", b.store, b.frag);
  std::mt19937 gen(15);
  int i = 1;
  while (i + 3 < argc) {
    const long long M = std::atoll(argv[i]);
    const int K = std::atoi(argv[i + 1]), N = std::atoi(argv[i + 2]),
              kind = std::atoi(argv[i + 3]);
    i += 4;
    if (i < argc && std::strcmp(argv[i], "/") == 0) ++i;
    if (kind == 0 && K != N) {
      std::printf("FAIL the DFT matrices need K == N\n");
      return 1;
    }
    // both widths of copies where K allows 16-byte ones, as the kernel
    // takes them; 4-byte ones alone otherwise
    if (K % 4 == 0) run<true>(M, K, N, kind, gen);
    run<false>(M, K, N, kind, gen);
  }
  return failures ? 1 : 0;
}
