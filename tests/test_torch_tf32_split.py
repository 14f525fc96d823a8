"""The arithmetic of K1d / K2d, the dense y real-DFT GEMMs on the tensor
cores (ipp_tpu_torch/csrc/rdft_dense.cu), held on the CPU.

The CUDA kernels run only on a card.  What is held here:
- `emulate_dense`, the kernels' arithmetic in PyTorch: each operand split
  into TF32 hi (round to nearest even, by integer masking of the 13 low
  mantissa bits) and lo (the rest, cut to TF32 toward zero); per k8 step
  the products hi.hi, lo.hi, hi.lo, each a wgmma whose 8-term dot product
  is added to the tensor-core accumulator rounding toward zero (the model
  that reproduces the card's errors: 2.3e-5 of max emulated, 2.2e-5
  measured on an H100 for one accumulator over K = 2576); the accumulator
  added into an f32 sum (round to nearest) after every FLUSH stages of BK,
  on each consumer warpgroup's schedule (`flush_after`);
- that arithmetic against the float64 product, <= 1e-5 of max, for the
  real-DFT fold (`dft_mats.rfft_fold_mats`) and a random matrix, K1d with
  and without the ratio, K2d with and without |mul * y|, at ny = 24, 1056
  (the CLI block's) and 2560 (above the real-FFT route), and K = 4096;
- why the flushes: one truncating accumulator over K = 2576 misses 1e-5;
- bf16 x 3 (the TPU's split) in the same arithmetic: within 1e-5 too, with
  less than half the margin of 3 x TF32, which the kernels keep;
- the emulation against the Pallas kernels it stands for, in interpret
  mode, within 1e-4 (the JAX walk's own bound for its 3-pass bf16 products);
- the header's index maps, masks and per-thread loads and stores, built
  with the host compiler (tests/torch_rdft_dense_host/check.cpp);
- on a card (marked `gpu`): the kernels at shapes off the real-FFT route
  against the plain versions, with exact launch counts.
"""

import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from ipp_tpu_torch.ops import cuda_fft as cf
from ipp_tpu_torch.ops.dft_mats import rfft_fold_mats
from ipp_tpu_torch.ops.matmul_fft import _kp

TOL = 1e-5
ROOT = Path(__file__).resolve().parent.parent
HEADER = (ROOT / "ipp_tpu_torch" / "csrc" / "rdft_dense.cuh").read_text()


def _const(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", HEADER).group(1))


BM, BK, FLUSH = _const("BM"), _const("BK"), _const("FLUSH")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


# -- the arithmetic ----------------------------------------------------------

def _round(a, drop):
    """f32 -> its top 32 - drop bits, round to nearest even (finite)."""
    b = a.contiguous().view(torch.int32)
    b = b + ((1 << (drop - 1)) - 1) + ((b >> drop) & 1)
    return (b & ~((1 << drop) - 1)).view(torch.float32)


def _cut(a, drop):
    """f32 -> its top 32 - drop bits, toward zero."""
    return (a.contiguous().view(torch.int32) & ~((1 << drop) - 1)).view(
        torch.float32)


def split_tf32(a):
    """rdft_dense.cuh `split_tf32`: hi = tf32(a) to nearest even, lo =
    a - hi (exact) cut to TF32 toward zero."""
    hi = _round(a, 13)
    return hi, _cut(a - hi, 13)


def split_bf16(a):
    """The TPU kernels' split (pallas_fft `_split3`): bf16 hi and lo, each
    to nearest even."""
    hi = _round(a, 16)
    return hi, _round(a - hi, 16)


def _f32_toward_zero(d):
    f = d.float()
    over = f.double().abs() > d.abs()
    return torch.where(over, torch.nextafter(f, torch.zeros_like(f)), f)


def flush_after(kt, cw, ntiles):
    """rdft_dense.cuh `flush_after`."""
    return kt % FLUSH == (FLUSH - 1 if cw else FLUSH // 2 - 1) or \
        kt == ntiles - 1


def emulate_dense(w, x, cols=None, split=split_tf32, flush=True):
    """C = w (R, K) @ x (K, N) as K1d / K2d compute it (see the module
    docstring).  `cols`: the data columns' indices, whose place in a block
    of BM picks the consumer warpgroup and so the flush schedule (default
    0..N-1); flush=False keeps one accumulator over the whole K."""
    n = x.shape[1]
    cols = torch.arange(n) if cols is None else torch.as_tensor(cols)
    cw = (cols % BM) // (BM // 2)
    (wh, wl), (xh, xl) = split(w), split(x)
    acc = torch.zeros(w.shape[0], n)
    sums = torch.zeros_like(acc)
    k = w.shape[1]
    ntiles = max(1, -(-k // BK))
    for kt in range(ntiles):
        for k0 in range(kt * BK, min(k, (kt + 1) * BK), 8):
            s = slice(k0, min(k, k0 + 8))
            for a, b in ((wh, xh), (wh, xl), (wl, xh)):
                acc = _f32_toward_zero(acc.double()
                                       + a[:, s].double() @ b[s].double())
        if flush:
            due = torch.where(cw == 1, flush_after(kt, 1, ntiles),
                              flush_after(kt, 0, ntiles))
            sums = torch.where(due, (sums.double() + acc.double()).float(),
                               sums)
            acc = torch.where(due, torch.zeros_like(acc), acc)
    return sums if flush else acc


def err_of_max(got, ref):
    return float((got.double() - ref).abs().max() / ref.abs().max())


def fold(ny):
    kp = _kp(ny)
    return kp, tuple(torch.tensor(m) for m in rfft_fold_mats(ny, kp))


# the data columns: eight of each consumer warpgroup of a block
COLS = list(range(8)) + list(range(64, 72))


def operands(kind, ny, rng):
    """(matrix, data, den or None, mul or None) of a form at length ny, the
    data as the walk sees it: volumes in [0, 1) with den in [0.5, 1.5) for
    K1d, spectra in [-1, 1) for K2d."""
    kp, (fwd, inv) = fold(ny)
    n = len(COLS)
    if kind.startswith("fwd"):
        x = torch.from_numpy(rng.random((ny, n), dtype=np.float32))
        den = (torch.from_numpy(rng.random((ny, n), dtype=np.float32)) + 0.5
               if kind == "fwd_ratio" else None)
        return fwd, x, den, None
    x = torch.from_numpy(rng.random((2 * kp, n), dtype=np.float32) * 2 - 1)
    mul = (torch.from_numpy(rng.random((ny, n), dtype=np.float32))
           if kind == "inv_mul" else None)
    return inv, x, None, mul


def form(kind, ny, rng, split=split_tf32, flush=True):
    """(emulated result, float64 reference) of a form."""
    w, x, den, mul = operands(kind, ny, rng)
    if den is not None:   # the kernel's IEEE f32 division, as the plain one
        x = x / torch.clamp(den, min=cf.EPS)
    got = emulate_dense(w, x, COLS, split, flush)
    ref = w.double() @ x.double()
    if mul is not None:
        got, ref = torch.abs(mul * got), torch.abs(mul.double() * ref)
    return got, ref


# -- the split ------------------------------------------------------------------

def test_the_split_keeps_22_bits_and_rounds_ties_to_even():
    rng = np.random.default_rng(3)
    v = torch.from_numpy(
        (rng.standard_normal(4096) * 10.0 ** rng.integers(-8, 8, 4096))
        .astype(np.float32))
    hi, lo = split_tf32(v)
    bits = lambda a: a.view(torch.int32)   # noqa: E731
    assert bool(((bits(hi) & 0x1FFF) == 0).all())
    assert bool(((bits(lo) & 0x1FFF) == 0).all())
    assert bool(((v.double() - hi.double()).abs()
                 <= 2.0 ** -11 * v.double().abs()).all())
    assert bool(((v.double() - hi.double() - lo.double()).abs()
                 <= 2.0 ** -21 * v.double().abs()).all())
    # exact ties: 1 + 2^-11 goes down to 1 (even), 1 + 3 * 2^-11 up
    one = torch.tensor([1 + 2.0 ** -11, 1 + 3 * 2.0 ** -11])
    assert split_tf32(one)[0].tolist() == [1.0, 1 + 4 * 2.0 ** -11]


# -- against the float64 product ---------------------------------------------

@pytest.mark.parametrize("ny", [24, 1056, 2560])
@pytest.mark.parametrize("kind", ["fwd", "fwd_ratio", "inv", "inv_mul"])
def test_the_kernel_arithmetic_meets_the_bound_on_the_fold(kind, ny):
    got, ref = form(kind, ny, np.random.default_rng(ny))
    assert err_of_max(got, ref) <= TOL, (kind, ny)


@pytest.mark.parametrize("orient", ["fwd", "inv"])
def test_the_kernel_arithmetic_meets_the_bound_on_a_random_matrix(orient):
    # any matrix, K = 4096: (64, 4096) against data like K1d's, or a matrix
    # as wide as K2d's against signed spectra
    rng = np.random.default_rng(11)
    w = torch.from_numpy(rng.random((64, 4096), dtype=np.float32) * 2 - 1)
    x = torch.from_numpy(rng.random((4096, len(COLS)), dtype=np.float32))
    if orient == "inv":
        x = x * 2 - 1
    got = emulate_dense(w, x, COLS)
    assert err_of_max(got, w.double() @ x.double()) <= TOL


def test_one_truncating_accumulator_would_miss_the_bound():
    # why the kernels flush: K2d at ny = 2560 (K = 2576), one accumulator
    rng = np.random.default_rng(5)
    w, x, _, _ = operands("inv", 2560, rng)
    ref = w.double() @ x.double()
    assert err_of_max(emulate_dense(w, x, COLS, flush=False), ref) > TOL
    assert err_of_max(emulate_dense(w, x, COLS), ref) <= TOL / 2


def test_bf16x3_would_meet_the_bound_with_less_margin():
    # the TPU's split at the CLI block (ny = 1056, both forms) and at
    # K = 4096: within 1e-5, but 3 x TF32 keeps more than twice the margin
    rng = np.random.default_rng(9)
    worst = {}
    for split in (split_tf32, split_bf16):
        errs = [err_of_max(*form(kind, 1056, np.random.default_rng(1), split))
                for kind in ("fwd", "inv")]
        w = torch.from_numpy(rng.random((64, 4096), dtype=np.float32) * 2 - 1)
        x = torch.from_numpy(rng.random((4096, len(COLS)), dtype=np.float32))
        errs.append(err_of_max(emulate_dense(w, x, COLS, split),
                               w.double() @ x.double()))
        worst[split.__name__] = max(errs)
    assert worst["split_bf16"] <= TOL, worst
    assert 2 * worst["split_tf32"] < worst["split_bf16"], worst


# -- against the Pallas twins ---------------------------------------------------

@pytest.mark.parametrize("case", ["rfft", "rfft_ratio", "irfft", "irfft_mul"])
def test_the_emulation_matches_the_pallas_twins(case):
    from ipp_tpu.ops import pallas_fft as pf

    rng = np.random.default_rng(7)
    nz, ny, nx, kp = 16, 16, 256, 16
    (fhi, flo), (ihi, ilo) = pf.prep_v2_rfft_mats(ny, kp)
    fwd, inv = (torch.tensor(m) for m in rfft_fold_mats(ny, kp))

    def vol(*shape, lo=0.0):
        return torch.from_numpy((rng.random(shape) * (1 - lo) + lo)
                                .astype(np.float32))

    x, den, mul = vol(nz, ny, nx), vol(nz, ny, nx, lo=0.5), vol(nz, ny, nx)
    sr, si = vol(kp, nz, nx, lo=-1), vol(kp, nz, nx, lo=-1)
    cols = torch.arange(nx).repeat(nz)            # each plane's columns
    n = np.asarray
    if case.startswith("rfft"):
        xin = x / torch.clamp(den, min=cf.EPS) if case == "rfft_ratio" else x
        planes = xin.transpose(0, 1).reshape(ny, nz * nx)   # (ny, z * x)
        c = emulate_dense(fwd, planes, cols).reshape(2 * kp, nz, nx)
        got = (c[:kp], c[kp:])
        ref = (pf._v2_rfft_call_t(n(x), fhi, flo, interpret=True)
               if case == "rfft" else
               pf._v2_rfft_ratio_call_t(n(x), n(den), fhi, flo,
                                        interpret=True))
    else:
        both = torch.cat([sr, si], 0).reshape(2 * kp, nz * nx)
        y = emulate_dense(inv, both, cols).reshape(ny, nz, nx).transpose(0, 1)
        got = (torch.abs(mul * y) if case == "irfft_mul" else y,)
        ref = ((pf._v2_irfft_call_t(n(sr), n(si), ihi, ilo, ny,
                                    interpret=True),)
               if case == "irfft" else
               (pf._v2_irfft_mul_call_t(n(sr), n(si), n(mul), ihi, ilo, ny,
                                        interpret=True),))
    ref = tuple(torch.from_numpy(np.array(r)) for r in ref)
    err = max(float((g.double() - r.double()).abs().max())
              for g, r in zip(got, ref))
    assert err / max(float(r.abs().max()) for r in ref) <= 1e-4, case


# -- the header on the host ----------------------------------------------------

def test_header_index_maps_on_the_host(tmp_path):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    exe = tmp_path / "check"
    subprocess.run(
        [gxx, "-std=c++17", "-O2", "-I",
         str(ROOT / "tests" / "torch_dft_fft_host"), "-I",
         str(ROOT / "ipp_tpu_torch" / "csrc"),
         str(ROOT / "tests" / "torch_rdft_dense_host" / "check.cpp"), "-o",
         str(exe)], check=True, capture_output=True, text=True)
    # (mode, nb, nz, ny, nx, kp): every form; odd nx, ny off 8 * j, kp odd
    # and even, rows and K ragged against NT = 136 and BK = 32, both load
    # widths, a zero row block
    cases = [(0, 1, 2, 24, 150, 16), (1, 2, 1, 100, 132, 56),
             (2, 1, 2, 100, 130, 56), (3, 1, 2, 24, 72, 16),
             (0, 1, 1, 200, 40, 108), (3, 1, 1, 430, 20, 216),
             (1, 1, 1, 24, 33, 16), (2, 1, 1, 200, 255, 101)]
    args = []
    for case in cases:
        args += [*map(str, case), "/"]
    out = subprocess.run([str(exe), *args], capture_output=True, text=True)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "FAIL" not in out.stdout
    assert len(out.stdout.splitlines()) >= len(cases)


# -- on the card ---------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("ny,nx,random", [(2560, 64, False), (1100, 255, False),
                                          (300, 130, True)])
def test_the_tensor_core_kernels_match_plain_on_the_card(cuda, ny, nx, random):
    gen = torch.Generator(device=cuda)
    gen.manual_seed(ny)
    kp = _kp(ny)
    if random:
        fwd = torch.rand(2 * kp, ny, generator=gen, device=cuda) - 0.5
        inv = torch.rand(ny, 2 * kp, generator=gen, device=cuda) - 0.5
    else:
        fwd, inv = (m.to(cuda) for m in fold(ny)[1])

    def d(*shape, lo=0.0):
        return torch.rand(shape, generator=gen, device=cuda) * (1 - lo) + lo

    x, den, mul = d(2, 3, ny, nx), d(2, 3, ny, nx, lo=0.5), d(2, 3, ny, nx)
    sr, si = d(2, kp, 3, nx, lo=-1), d(2, kp, 3, nx, lo=-1)
    cf.reset_launch_counts()
    for extra_f, extra_i in ((None, None), (den, mul)):
        got = cf.rdft_y_fwd_batched(x, fwd, extra_f, fold=not random)
        ref = cf.rdft_y_fwd_plain(x, fwd, extra_f)
        assert max(float((g - r).abs().max()) for g, r in zip(got, ref)) <= \
            TOL * max(float(r.abs().max()) for r in ref)
        out = cf.rdft_y_inv_batched(sr, si, inv, extra_i, fold=not random)
        ref = cf.rdft_y_inv_plain(sr, si, inv, extra_i)
        assert float((out - ref).abs().max()) <= TOL * float(ref.abs().max())
    assert {k: v for k, v in cf.LAUNCHES.items() if v} == {
        "rdft_y_fwd_batched_dense": 2, "rdft_y_inv_batched_dense": 2}
