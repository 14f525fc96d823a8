"""The arithmetic of K7d, the dense complex product on the tensor cores
(ipp_tpu_torch/csrc/cplx_dense.cu), held on the CPU.

The CUDA kernel runs only on a card.  What is held here:
- `emulate_cplx`, the kernel's arithmetic in PyTorch: re, im, re + im (the
  sum formed in f32) and mr, mi, mri each split into TF32 hi (round to
  nearest even) and lo (the rest, cut to TF32 toward zero); per k8 step
  the terms hi.hi, lo.hi, hi.lo of Karatsuba's three products t1 = re.mr,
  t2 = im.mi, t3 = (re + im).mri, each a wgmma whose 8-term dot product is
  added to its tensor-core accumulator rounding toward zero (the model
  that reproduced the card's errors for K1d / K2d,
  tests/test_torch_tf32_split.py); every FLUSH stages of BK, on each
  consumer warpgroup's schedule (`flush_after`), the three folded into two
  f32 sums (rr += t1 - t2, ii += t3 - t1 - t2, round to nearest);
- that arithmetic within 1e-5 of max of the float64 product and of the
  Pallas kernel it replaces (`fused_cplx_matmul`, in interpret mode), for
  the DFT matrices at K = N = 30, 50, 136 and 300 (no FFT plan), a random
  non-square matrix (K = 200, N = 72) and K = 600, which crosses flushes;
- why the flushes: one truncating accumulator over K = 2600 misses 1e-5;
- bf16 x 3 (the TPU's split, on k16 wgmma steps) in the same arithmetic:
  within 1e-5 on these rows too, with less than half the margin of
  3 x TF32 (scripts/cplx_dense_bench.py --precision runs both at the
  chip_smoke shapes on a card, every row, against the kernel's own error);
- the header's index maps, masks, per-thread loads and stores and its
  shared-memory bank conflicts, built with the host compiler
  (tests/torch_cplx_dense_host/check.cpp);
- on a card (marked `gpu`): the kernel against the plain version with
  exact `cplx_matmul_dense` counts.

`emulate_cplx` runs on any device: the bench imports this module (JAX is
imported only by the test that runs the Pallas kernel).
"""

import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from ipp_tpu_torch.ops import cuda_fft as cf
from ipp_tpu_torch.ops.dft_mats import cplx_triple

TOL = 1e-5
ROOT = Path(__file__).resolve().parent.parent
CSRC = ROOT / "ipp_tpu_torch" / "csrc"


def _const(header, name):
    text = (CSRC / header).read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


BM = _const("cplx_dense.cuh", "BM")
BK, FLUSH = _const("rdft_dense.cuh", "BK"), _const("rdft_dense.cuh", "FLUSH")
# the data rows: eight of each consumer warpgroup of a block
ROWS = list(range(8)) + list(range(BM // 2, BM // 2 + 8))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda", 0)


# -- the arithmetic ----------------------------------------------------------

def _round(a, bits):
    """f32 a to nearest even with its `bits` low mantissa bits cleared."""
    b = a.contiguous().view(torch.int32)
    up = (1 << (bits - 1)) - 1 + ((b >> bits) & 1)
    return ((b + up) & ~((1 << bits) - 1)).view(torch.float32)


def split_tf32(a):
    """rdft_dense.cuh `split_tf32`: hi = tf32(a) to nearest even, lo =
    a - hi (exact) cut to TF32 toward zero."""
    hi = _round(a, 13)
    lo = ((a - hi).contiguous().view(torch.int32) & ~0x1FFF).view(
        torch.float32)
    return hi, lo


def split_bf16(a):
    """The TPU kernel's split (pallas_fft `_split3`): bf16 hi and lo, each
    to nearest even."""
    hi = _round(a, 16)
    return hi, _round(a - hi, 16)


# the depth of one wgmma of each split's type: TF32 k8, bf16 k16
K_STEP = {split_tf32: 8, split_bf16: 16}


def _f32_toward_zero(d):
    f = d.float()
    over = f.double().abs() > d.abs()
    return torch.where(over, torch.nextafter(f, torch.zeros_like(f)), f)


def flush_after(kt, cw, ntiles):
    """rdft_dense.cuh `flush_after`."""
    return kt % FLUSH == (FLUSH - 1 if cw else FLUSH // 2 - 1) or \
        kt == ntiles - 1


def emulate_cplx(re_, im, mr, mi, mri, rows=None, flush=True,
                 split=split_tf32):
    """(rr, ii) = (re + i im) @ (mr + i mi) as K7d computes it (see the
    module docstring), on the operands' device.  `rows`: the data rows'
    indices, whose place in a block of BM picks the consumer warpgroup and
    so the flush schedule (default 0..M-1); flush=False keeps one
    accumulator a product over the whole K; split=split_bf16: the TPU's
    split on bf16 wgmmas instead."""
    m, k = re_.shape
    dev, step = re_.device, K_STEP[split]
    rows = (torch.arange(m, device=dev) if rows is None
            else torch.as_tensor(rows, device=dev))
    cw = ((rows % BM) // (BM // 2))[:, None]
    ops = [(split(re_), split(mr)), (split(im), split(mi)),
           (split(re_ + im), split(mri))]
    acc = [torch.zeros(m, mr.shape[1], device=dev) for _ in ops]
    rr, ii = torch.zeros_like(acc[0]), torch.zeros_like(acc[0])
    ntiles = max(1, -(-k // BK))
    for kt in range(ntiles):
        for k0 in range(kt * BK, min(k, (kt + 1) * BK), step):
            s = slice(k0, min(k, k0 + step))
            for term in range(3):            # hi.hi, lo.hi, hi.lo
                for p, ((ah, al), (bh, bl)) in enumerate(ops):
                    a, b = ((ah, bh), (al, bh), (ah, bl))[term]
                    acc[p] = _f32_toward_zero(
                        acc[p].double() + a[:, s].double() @ b[s].double())
        if flush:
            due = torch.where(cw == 1, flush_after(kt, 1, ntiles),
                              flush_after(kt, 0, ntiles))
            d_rr, d_ii = _fold(acc)
            rr = torch.where(due, rr + d_rr, rr)
            ii = torch.where(due, ii + d_ii, ii)
            acc = [torch.where(due, torch.zeros_like(a), a) for a in acc]
    return (rr, ii) if flush else _fold(acc)


def _fold(acc):
    """The accumulators' (rr, ii) share, in f32: Karatsuba's t1 - t2 and
    t3 - t1 - t2 (cplx_dense.cuh `fold`)."""
    t1, t2, t3 = acc
    return t1 - t2, (t3 - t1) - t2


def err_of_max(got, ref):
    """max |got - ref| / max |ref| over re and im together."""
    scale = max(float(r.abs().max()) for r in ref)
    return max(float((g.double() - r.double()).abs().max())
               for g, r in zip(got, ref)) / scale


def operands(k, n, kind, rng):
    """(re, im, mr, mi, mri) for the ROWS data rows: data in [-0.5, 0.5),
    the forward DFT triple of length k (k == n) or random matrices."""
    re_, im = (torch.from_numpy(rng.random((len(ROWS), k), dtype=np.float32)
                                - 0.5) for _ in range(2))
    if kind == "dft":
        mats = tuple(torch.from_numpy(np.array(m)) for m in cplx_triple(k, True))
    else:
        mr, mi = (torch.from_numpy(rng.random((k, n), dtype=np.float32) - 0.5)
                  for _ in range(2))
        mats = (mr, mi, mr + mi)
    return (re_, im) + mats


def float64_product(re_, im, mr, mi, _mri):
    c = torch.complex(re_.double(), im.double()) @ torch.complex(
        mr.double(), mi.double())
    return c.real, c.imag


CASES = [(30, 30, "dft"), (50, 50, "dft"), (136, 136, "dft"),
         (300, 300, "dft"), (200, 72, "random"), (600, 96, "random")]


def test_the_split_keeps_22_bits():
    rng = np.random.default_rng(3)
    v = torch.from_numpy((rng.standard_normal(4096)
                          * 10.0 ** rng.integers(-8, 8, 4096))
                         .astype(np.float32))
    hi, lo = split_tf32(v)
    assert bool(((hi.view(torch.int32) & 0x1FFF) == 0).all())
    assert bool(((lo.view(torch.int32) & 0x1FFF) == 0).all())
    assert bool(((v.double() - hi.double() - lo.double()).abs()
                 <= 2.0 ** -21 * v.double().abs()).all())


@pytest.mark.parametrize("k,n,kind", CASES)
def test_the_kernel_arithmetic_meets_the_bound(k, n, kind):
    # 1e-5 of max against the float64 product; a K above 256 flushes
    ops = operands(k, n, kind, np.random.default_rng(k + n))
    got = emulate_cplx(*ops, rows=ROWS)
    assert err_of_max(got, float64_product(*ops)) <= TOL, (k, n, kind)


@pytest.mark.parametrize("k,n,kind", CASES)
def test_the_emulation_matches_the_pallas_kernel(k, n, kind):
    # the Pallas kernel K7d replaces, in interpret mode (f32 products on
    # the CPU): 1e-5 of max
    import jax.numpy as jnp

    from ipp_tpu.ops import pallas_fft as pf

    ops = operands(k, n, kind, np.random.default_rng(7 * k + n))
    re_, im = ops[:2]
    ref = pf.fused_cplx_matmul(jnp.asarray(re_.numpy()),
                               jnp.asarray(im.numpy()),
                               tuple(jnp.asarray(m.numpy()) for m in ops[2:]),
                               interpret=True)
    ref = tuple(torch.from_numpy(np.array(r)) for r in ref)
    got = emulate_cplx(*ops, rows=ROWS)
    assert err_of_max(got, ref) <= TOL, (k, n, kind)
    # and the plain version, which the card's kernel is held to
    assert err_of_max(cf.cplx_matmul_plain(*ops), ref) <= TOL


def test_one_truncating_accumulator_would_miss_the_bound():
    # why the kernel flushes: K = 2600, one accumulator a product
    ops = operands(2600, 40, "random", np.random.default_rng(5))
    ref = float64_product(*ops)
    assert err_of_max(emulate_cplx(*ops, rows=ROWS, flush=False), ref) > TOL
    assert err_of_max(emulate_cplx(*ops, rows=ROWS), ref) <= TOL / 2


def test_bf16x3_would_meet_the_bound_with_less_margin():
    # the TPU's split on bf16 wgmmas, at the CLI-size DFT and at a K that
    # crosses ten flushes: within 1e-5 on these rows, but 3 x TF32 keeps
    # more than twice the margin
    for k, n, kind in ((1152, 1152, "dft"), (2600, 40, "random")):
        ops = operands(k, n, kind, np.random.default_rng(k))
        if kind == "dft":   # a few columns: the error is per column
            ops = ops[:2] + tuple(m[:, ::24].contiguous() for m in ops[2:])
        ref = float64_product(*ops)
        tf32 = err_of_max(emulate_cplx(*ops, rows=ROWS), ref)
        bf16 = err_of_max(emulate_cplx(*ops, rows=ROWS, split=split_bf16),
                          ref)
        assert bf16 <= TOL, (k, tf32, bf16)
        assert 2 * tf32 < bf16, (k, tf32, bf16)


# -- the header on the host ----------------------------------------------------

def test_header_index_maps_on_the_host(tmp_path):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    exe = tmp_path / "check"
    subprocess.run(
        [gxx, "-std=c++17", "-O2", "-I",
         str(ROOT / "tests" / "torch_dft_fft_host"), "-I", str(CSRC),
         str(ROOT / "tests" / "torch_cplx_dense_host" / "check.cpp"), "-o",
         str(exe)], check=True, capture_output=True, text=True)
    # (M, K, N, kind): phase 11's lengths, rows ragged against BM = 128,
    # N against NT = 64, K against BK = 32 and the flushes, both copy
    # widths, one element
    cases = [(30, 30, 30, 0), (200, 50, 50, 0), (300, 136, 136, 0),
             (130, 200, 72, 1), (129, 300, 65, 1), (1, 1, 1, 1),
             (64, 1100, 70, 1)]
    args = []
    for case in cases:
        args += [*map(str, case), "/"]
    out = subprocess.run([str(exe), *args], capture_output=True, text=True)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "FAIL" not in out.stdout
    lines = out.stdout.splitlines()
    assert lines[0] == ("bank-conflict degree: matrix stores 1, data copies "
                        "1 (16-byte) / 1 (4-byte), fragment reads 1")
    assert len(lines) >= 1 + len(cases)


# -- on the card ---------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n,dft", [(300, 30, 30, True), (257, 50, 50, False),
                                       (1000, 136, 136, None),
                                       (500, 200, 72, None),
                                       (700, 300, 300, True)])
def test_the_tensor_core_kernel_matches_plain_on_the_card(cuda, m, k, n, dft):
    gen = torch.Generator(device=cuda)
    gen.manual_seed(m + k)
    re_ = torch.rand(m, k, generator=gen, device=cuda) - 0.5
    im = torch.rand(m, k, generator=gen, device=cuda) - 0.5
    if dft is None:
        mr = torch.rand(k, n, generator=gen, device=cuda) - 0.5
        mi = torch.rand(k, n, generator=gen, device=cuda) - 0.5
        mats = (mr, mi, mr + mi)
    else:
        mats = tuple(torch.tensor(a, device=cuda) for a in cplx_triple(n, dft))
    cf.reset_launch_counts()
    got = cf.cplx_matmul(re_, im, *mats, dft=dft)
    ref = cf.cplx_matmul_plain(re_, im, *mats)
    torch.cuda.synchronize()
    assert err_of_max(got, ref) <= TOL
    assert {k_: v for k_, v in cf.LAUNCHES.items() if v} == {
        "cplx_matmul_dense": 1}
