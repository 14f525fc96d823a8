"""K7 as a mixed-radix FFT (ipp_tpu_torch/csrc/dft_fft.cuh), on the CPU.

The CUDA kernel runs only on a card.  What is held here:
- `dft_fft_plan(n)`: the radices multiply to n, come from the kernel's
  specialised set but for at most one generic odd radix, which is last, at
  the lengths the paths run and over every multiple of 8 up to 2688;
- `emulate_dft_fft`, a pass-by-pass PyTorch emulation of the kernel (the
  same plan, the same twiddle table, the same index maps, the generic pass
  with its roots from the table) against `cplx_matmul_plain` with
  `cplx_triple(n, forward)` and against torch.fft;
- the header's own pass templates, compiled with the host compiler against
  a stand-in `cuda_runtime.h` and run pass by pass against a naive float64
  DFT (tests/torch_dft_fft_host/check.cpp);
- the kernel choice by n, the launch counter names, the CPU path;
- on a card (marked `gpu`): both K7 kernels against the plain version.

Tolerance: 1e-5 of the reference's max, the bound the chip smoke holds the
kernels to (f32 sums of up to 1152 terms on the dense side).
"""

import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from ipp_tpu_torch.ops import cuda_fft as cf
from ipp_tpu_torch.ops.dft_mats import (DFT_FFT_MAX_N, DFT_FFT_RADICES,
                                        cplx_triple, dft_fft_plan,
                                        stage_twiddles)

# the dense axes of today's paths: taper slabs, FNT cubes, the v1 RL block
LENGTHS = (40, 48, 136, 264, 280, 528, 1072, 1120, 1152)
TOL = 1e-5
ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture
def rng():
    return np.random.default_rng(6)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


def triple(n, forward, device="cpu"):
    return tuple(torch.tensor(m, device=device)
                 for m in cplx_triple(n, forward))


def rel(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def emulate_dft_fft(re, im, forward):
    """The FFT kernel's arithmetic on (rows, n) f32 tensors, pass by pass
    as csrc/dft_fft.cuh runs it: the Stockham passes of `dft_fft_plan(n)`,
    butterfly i reading i + k * n/R and writing q + S * (R * p + k) with
    the twiddle w^(p k S) from `stage_twiddles(n)`; the roots of a
    specialised radix are constants, those of the generic last pass come
    from the table at ((j k) % r) * S; the inverse conjugates and scales by
    1/n.  Complex64 throughout."""
    rows, n = re.shape
    tab = torch.from_numpy(stage_twiddles(n).copy())
    w = torch.complex(tab[:, 0], tab[:, 1])
    if not forward:
        w = w.conj()
    buf = torch.complex(re, im)
    plan = dft_fft_plan(n)
    stride = 1
    for at, radix in enumerate(plan):
        nb = n // radix
        i = torch.arange(nb)
        k = torch.arange(radix)
        a = buf[:, i[:, None] + k[None, :] * nb]           # (rows, nb, R)
        jk = (k[:, None] * k[None, :]) % radix
        if radix in DFT_FFT_RADICES:
            ang = (-2 if forward else 2) * np.pi * jk.numpy() / radix
            roots = torch.from_numpy(np.exp(1j * ang).astype(np.complex64))
        else:
            assert at == len(plan) - 1 and stride * radix == n
            roots = w[jk * stride]
        b = a @ roots                                      # sum_j a_j wR^jk
        q, p = i % stride, i // stride
        b = b * w[p[:, None] * k[None, :] * stride]        # 1 where p == 0
        out = torch.empty_like(buf)
        out[:, q[:, None] + stride * (radix * p[:, None] + k[None, :])] = b
        buf, stride = out, stride * radix
    assert stride == n
    if not forward:
        buf = buf / n
    return buf.real.contiguous(), buf.imag.contiguous()


# -- the plan ------------------------------------------------------------------

def check_plan(n):
    plan = dft_fft_plan(n)
    assert int(np.prod(plan)) == n
    assert plan[0] in (8, 16)
    assert all(r in DFT_FFT_RADICES for r in plan[:-1])
    last = plan[-1]
    if last not in DFT_FFT_RADICES:      # the one generic radix: odd, last
        assert len(plan) > 1 and last % 2 == 1 and last >= 17
        assert all(last % f for f in (3, 5, 7, 11, 13))
    # powers of two first, so every stride up to the first odd pass is one
    odd = [r % 2 == 1 for r in plan]
    assert odd == sorted(odd)
    return plan


@pytest.mark.parametrize("n,plan", [
    (40, (8, 5)), (48, (16, 3)), (136, (8, 17)), (264, (8, 3, 11)),
    (280, (8, 5, 7)), (528, (16, 3, 11)), (1072, (16, 67)),
    (1120, (8, 4, 5, 7)), (1152, (8, 16, 9))])
def test_plan_at_the_lengths_of_the_paths(n, plan):
    assert check_plan(n) == plan


def test_plan_factors_every_multiple_of_8_up_to_2688():
    generic = 0
    for n in range(8, 2688 + 1, 8):
        plan = check_plan(n)
        generic += plan[-1] not in DFT_FFT_RADICES
    assert generic > 0
    assert dft_fft_plan(8) == (8,) and dft_fft_plan(16) == (16,)
    assert dft_fft_plan(32) == (8, 4) and dft_fft_plan(2048) == (8, 16, 16)
    assert dft_fft_plan(8 * 331) == (8, 331)          # a large prime
    assert dft_fft_plan(8 * 11 * 13) == (8, 11, 13)   # both specialised
    assert dft_fft_plan(8 * 17 * 19) == (8, 323)      # what is left, whole


@pytest.mark.parametrize("n", [0, 4, 12, 100, 1148, DFT_FFT_MAX_N + 8])
def test_no_plan_outside_the_multiples_of_8_up_to_the_limit(n):
    with pytest.raises(ValueError):
        dft_fft_plan(n)


# -- the emulation of the kernel's passes ---------------------------------------

@pytest.mark.parametrize("forward", [True, False])
@pytest.mark.parametrize("n", LENGTHS)
def test_emulated_passes_equal_the_plain_product(rng, n, forward):
    re, im = (t(rng.standard_normal((5, n))) for _ in range(2))
    got = emulate_dft_fft(re, im, forward)
    ref = cf.cplx_matmul_plain(re, im, *triple(n, forward))
    for g, r in zip(got, ref):
        assert rel(g.numpy(), r.numpy()) <= TOL


@pytest.mark.parametrize("forward", [True, False])
@pytest.mark.parametrize("n", LENGTHS)
def test_emulated_passes_equal_torch_fft(rng, n, forward):
    x = rng.standard_normal((3, n)) + 1j * rng.standard_normal((3, n))
    rr, ii = emulate_dft_fft(t(x.real), t(x.imag), forward)
    c = torch.from_numpy(x.astype(np.complex64))
    ref = (torch.fft.fft if forward else torch.fft.ifft)(c, dim=-1).numpy()
    assert rel(rr.numpy(), ref.real) <= TOL
    assert rel(ii.numpy(), ref.imag) <= TOL


@pytest.mark.parametrize("n", [8, 16, 32, 72, 2520, 8 * 331, 4096])
def test_emulated_passes_at_other_plans(rng, n):
    x = rng.standard_normal((2, n)) + 1j * rng.standard_normal((2, n))
    for forward in (True, False):
        rr, ii = emulate_dft_fft(t(x.real), t(x.imag), forward)
        ref = (np.fft.fft if forward else np.fft.ifft)(
            x.astype(np.complex64), axis=-1)
        assert rel(rr.numpy(), ref.real) <= TOL
        assert rel(ii.numpy(), ref.imag) <= TOL


# -- the header's templates on the host ----------------------------------------

@pytest.mark.parametrize("pad", [0, 1, 2])
def test_header_passes_match_a_naive_dft_on_the_host(tmp_path, pad):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    exe = tmp_path / "check"
    subprocess.run(
        [gxx, "-std=c++17", "-O1", "-I",
         str(ROOT / "tests" / "torch_dft_fft_host"), "-I",
         str(ROOT / "ipp_tpu_torch" / "csrc"),
         str(ROOT / "tests" / "torch_dft_fft_host" / "check.cpp"), "-o",
         str(exe)], check=True, capture_output=True, text=True)
    args = []
    lengths = LENGTHS + (8, 16, 32, 72, 2048, 2520, 8 * 331)
    for n in lengths:
        plan = dft_fft_plan(n)
        args += [str(n), str(int(plan[-1] not in DFT_FFT_RADICES)),
                 *map(str, plan), "/"]
    out = subprocess.run([str(exe), str(pad), *args], capture_output=True,
                         text=True)
    assert out.returncode == 0, out.stdout + out.stderr
    assert len(out.stdout.splitlines()) == len(lengths)


# -- the kernel choice -----------------------------------------------------------

@pytest.mark.parametrize("n", LENGTHS + (8, 2688, DFT_FFT_MAX_N))
def test_route_is_fft_at_multiples_of_8_up_to_the_limit(n):
    assert cf.dft_route(n) == "fft"


@pytest.mark.parametrize("n", [12, 4, 100, 1150, DFT_FFT_MAX_N + 8, 16384])
def test_route_is_dense_at_every_other_length(n):
    # a multiple of 64 above the limit takes the large-axis FFT kernel
    # (csrc/stage_large.cuh); every other length the dense one
    large = n % 64 == 0 and n > DFT_FFT_MAX_N
    assert cf.dft_route(n) == ("large" if large else "dense")


def test_both_k7_kernels_have_a_counter():
    assert "cplx_matmul" in cf.LAUNCHES
    assert "cplx_matmul_dense" in cf.LAUNCHES


@pytest.mark.parametrize("dft", [None, True, False])
def test_the_cpu_takes_the_plain_product_and_counts_nothing(rng, dft):
    n = 40
    re, im = (t(rng.standard_normal((4, n))) for _ in range(2))
    mats = triple(n, dft is not False)
    cf.reset_launch_counts()
    got = cf.cplx_matmul(re, im, *mats, dft=dft)
    ref = cf.cplx_matmul_plain(re, im, *mats)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    assert set(cf.LAUNCHES.values()) == {0}


def test_a_dft_call_needs_a_square_matrix(rng):
    re, im = (t(rng.standard_normal((4, 40))) for _ in range(2))
    mats = tuple(m[:, :32].contiguous() for m in triple(40, True))
    cf.cplx_matmul(re, im, *mats)                  # any matrix: fine
    for dft in (True, False):
        with pytest.raises(ValueError):
            cf.cplx_matmul(re, im, *mats, dft=dft)


def test_the_fft_kernel_refuses_cpu_planes(rng):
    re, im = (t(rng.standard_normal((4, 40))) for _ in range(2))
    with pytest.raises(ValueError):
        cf.dft_last_fft(re, im, True)


# -- on the card -------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("forward", [True, False])
@pytest.mark.parametrize("n", LENGTHS + (8, 16, 2048, 2520, 8 * 331, 12))
def test_k7_kernels_match_plain_on_the_card(cuda, n, forward):
    gen = torch.Generator(device=cuda)
    gen.manual_seed(n)
    rows = 301                                  # ragged against every block
    re = torch.rand((rows, n), generator=gen, device=cuda) - 0.5
    im = torch.rand((rows, n), generator=gen, device=cuda) - 0.5
    mats = triple(n, forward, cuda)
    ref = cf.cplx_matmul_plain(re, im, *mats)
    cf.reset_launch_counts()
    fft = cf.cplx_matmul(re, im, *mats, dft=forward)
    dense = cf.cplx_matmul(re, im, *mats)
    want = {"cplx_matmul": int(n != 12), "cplx_matmul_dense": 1 + (n == 12)}
    assert {k: v for k, v in cf.LAUNCHES.items() if v} == \
        {k: v for k, v in want.items() if v}
    for got in (fft, dense):
        for g, r in zip(got, ref):
            err = float((g - r).abs().max() / r.abs().max())
            assert err <= TOL, (n, forward, err)
