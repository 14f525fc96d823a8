"""The radix-2 stage as an FFT (ipp_tpu_torch/csrc/stage_fft.cuh), on the CPU.

The CUDA kernels run only on a card.  What is held here:
- the function itself, free of the stage matrices: `radix2_stage_plain`
  and `radix2_stage_inv_otf_plain` against torch.fft in float64 with the
  walk's permutation (X[f] at (f & 1) * n/2 + (f >> 1)), at every length
  the FFT kernels cover;
- the twiddle table against numpy float64;
- `emulate_stage_fft`, a step-by-step PyTorch emulation of the kernel's
  passes (the same radix plan, the same table, the same index maps)
  against the plain versions;
- the kernel choice by n and the launch counter names;
- on a card (marked `gpu`): the kernels against the plain versions.

Tolerance: 1e-5 of the reference's max, the bound the chip smoke holds the
kernels to (f32 sums of up to 2048 terms).
"""

import numpy as np
import pytest
import torch

from ipp_tpu_torch.ops import cuda_fft as cf
from ipp_tpu_torch.ops.dft_mats import (STAGE_FFT_LENGTHS, stage_fft_plan,
                                        stage_mats_t, stage_twiddles)

LENGTHS = (256, 512, 768, 1024, 1280, 1536, 1792, 2048)
TOL = 1e-5


@pytest.fixture
def rng():
    return np.random.default_rng(5)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


def mats(n, forward, device="cpu"):
    return tuple(torch.tensor(m, device=device)
                 for m in stage_mats_t(n, forward))


def permutation(n):
    """pos[f]: where the walk stores frequency f."""
    f = np.arange(n)
    return (f & 1) * (n // 2) + (f >> 1)


def rel(got, ref):
    got = np.asarray(got, np.float64)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def reference_stage(x, forward, axis):
    """The stage's definition in float64: x complex, the transform along
    `axis`; forward gives the permuted spectrum, inverse takes it."""
    n = x.shape[axis]
    pos = permutation(n)
    x = np.moveaxis(x.astype(np.complex128), axis, -1)
    if forward:
        out = np.empty_like(x)
        out[..., pos] = np.fft.fft(x, axis=-1)
    else:
        out = np.fft.ifft(x[..., pos], axis=-1)
    return np.moveaxis(out, -1, axis)


def emulate_stage_fft(re, im, forward, otf=None, conj=False):
    """The FFT kernel's arithmetic on (rows, n) f32 tensors, pass by pass
    as csrc/stage_fft.cuh runs it: the permuted load (inverse) with the
    OTF product, the Stockham passes of `stage_fft_plan(n)` with twiddles
    and odd-radix roots from `stage_twiddles(n)`, the 1/n (inverse) and
    the permuted store (forward).  Complex64 throughout."""
    rows, n = re.shape
    pos = torch.from_numpy(permutation(n))
    tab = torch.from_numpy(stage_twiddles(n).copy())
    w = torch.complex(tab[:, 0], tab[:, 1])
    if not forward:
        w = w.conj()
    x = torch.complex(re, im)
    if otf is not None:
        o_re, o_im = otf
        r = torch.arange(rows) % o_re.shape[0]
        x = x * torch.complex(o_re[r], -o_im[r] if conj else o_im[r])
    buf = x if forward else x[:, pos]            # natural order
    stride = 1
    for radix in stage_fft_plan(n):
        nb = n // radix
        i = torch.arange(nb)
        k = torch.arange(radix)
        a = buf[:, i[:, None] + k[None, :] * nb]           # (rows, nb, R)
        roots = w[((k[:, None] * k[None, :]) % radix) * (n // radix)]
        b = a @ roots                                      # sum_j a_j wR^jk
        q, p = i % stride, i // stride
        if stride * radix < n:
            b = b * w[p[:, None] * k[None, :] * stride]
        out = torch.empty_like(buf)
        out[:, q[:, None] + stride * (radix * p[:, None] + k[None, :])] = b
        buf, stride = out, stride * radix
    assert stride == n
    if forward:
        out = torch.empty_like(buf)
        out[:, pos] = buf
    else:
        out = buf / n
    return out.real.contiguous(), out.imag.contiguous()


# -- the function, free of the matrices ---------------------------------------

@pytest.mark.parametrize("axis", [1, -1])
@pytest.mark.parametrize("forward", [True, False])
@pytest.mark.parametrize("n", LENGTHS)
def test_plain_stage_is_the_permuted_dft(rng, n, forward, axis):
    shape = (2, n, 5) if axis == 1 else (6, n)
    re = rng.standard_normal(shape).astype(np.float32)
    im = rng.standard_normal(shape).astype(np.float32)
    rr, ii = cf.radix2_stage_plain(t(re), t(im), *mats(n, forward), forward,
                                   axis)
    ref = reference_stage(re + 1j * im, forward, axis)
    assert rr.shape == re.shape and ii.shape == re.shape
    assert rel(rr.numpy(), ref.real) <= TOL
    assert rel(ii.numpy(), ref.imag) <= TOL


@pytest.mark.parametrize("conj", [False, True])
@pytest.mark.parametrize("n", LENGTHS)
def test_plain_otf_stage_is_ifft_of_the_otf_product(rng, n, conj):
    rows, orows = 6, 3                       # an OTF period of 3 rows
    re, im = (rng.standard_normal((rows, n)).astype(np.float32)
              for _ in range(2))
    o_re, o_im = (rng.standard_normal((orows, n)).astype(np.float32)
                  for _ in range(2))
    rr, ii = cf.radix2_stage_inv_otf_plain(t(re), t(im), t(o_re), t(o_im),
                                           *mats(n, False), conj)
    otf = (o_re + 1j * (-o_im if conj else o_im)).astype(np.complex128)
    prod = (re + 1j * im).astype(np.complex128) * np.tile(otf, (2, 1))
    ref = reference_stage(prod, False, -1)
    assert rel(rr.numpy(), ref.real) <= TOL
    assert rel(ii.numpy(), ref.imag) <= TOL


# -- the table and the plan ----------------------------------------------------

@pytest.mark.parametrize("n", LENGTHS)
def test_twiddle_table_is_float64_rounded_once(n):
    tab = stage_twiddles(n)
    assert tab.shape == (n, 2) and tab.dtype == np.float32
    assert not tab.flags.writeable
    w = np.exp(-2j * np.pi * np.arange(n, dtype=np.float64) / n)
    ref = np.stack([w.real, w.imag], -1)
    # within one f32 rounding of the float64 value (half an ulp of 1.0 at
    # most, as |w| <= 1)
    assert np.abs(tab.astype(np.float64) - ref).max() <= 2.0 ** -24
    assert tab[0, 0] == 1.0 and tab[0, 1] == 0.0
    assert stage_twiddles(n) is tab            # cached


@pytest.mark.parametrize("n", LENGTHS)
def test_plan_factors_n_with_the_odd_radix_last(n):
    plan = stage_fft_plan(n)
    assert int(np.prod(plan)) == n
    assert plan[:2] == (8, 8) and len(plan) in (3, 4)
    assert all(r in (4, 8) for r in plan[:-1])
    assert plan[-1] in (3, 4, 5, 7, 8)


def test_no_plan_outside_the_lengths():
    for n in (128, 384, 2304, 250):
        with pytest.raises(ValueError):
            stage_fft_plan(n)


# -- the emulation of the kernel's passes --------------------------------------

@pytest.mark.parametrize("forward", [True, False])
@pytest.mark.parametrize("n", LENGTHS)
def test_emulated_passes_equal_the_plain_stage(rng, n, forward):
    re, im = (t(rng.standard_normal((5, n))) for _ in range(2))
    got = emulate_stage_fft(re, im, forward)
    ref = cf.radix2_stage_plain(re, im, *mats(n, forward), forward, -1)
    for g, r in zip(got, ref):
        assert rel(g.numpy(), r.numpy().astype(np.float64)) <= TOL


@pytest.mark.parametrize("conj", [False, True])
@pytest.mark.parametrize("n", LENGTHS)
def test_emulated_otf_passes_equal_the_plain_otf_stage(rng, n, conj):
    re, im = (t(rng.standard_normal((6, n))) for _ in range(2))
    otf = tuple(t(rng.standard_normal((2, n))) for _ in range(2))
    got = emulate_stage_fft(re, im, False, otf=otf, conj=conj)
    ref = cf.radix2_stage_inv_otf_plain(re, im, *otf, *mats(n, False), conj)
    for g, r in zip(got, ref):
        assert rel(g.numpy(), r.numpy().astype(np.float64)) <= TOL


@pytest.mark.parametrize("n", LENGTHS)
def test_emulated_passes_equal_the_definition(rng, n):
    x = rng.standard_normal((3, n)) + 1j * rng.standard_normal((3, n))
    for forward in (True, False):
        rr, ii = emulate_stage_fft(t(x.real), t(x.imag), forward)
        ref = reference_stage(x.astype(np.complex64), forward, -1)
        assert rel(rr.numpy(), ref.real) <= TOL
        assert rel(ii.numpy(), ref.imag) <= TOL


# -- the kernel choice ----------------------------------------------------------

def test_lengths_are_the_walks_256_multiples():
    assert STAGE_FFT_LENGTHS == LENGTHS


@pytest.mark.parametrize("n", LENGTHS)
def test_route_is_fft_at_the_covered_lengths(n):
    assert cf.stage_route(n) == "fft"


@pytest.mark.parametrize("n", [128, 384, 640, 896, 2304, 2560, 4096])
def test_route_is_dense_at_every_other_length(n):
    # every other multiple of 128 up to 12288 takes the mixed-radix FFT
    # kernel (csrc/stage_mixed.cuh); the dense one only lengths above it
    assert cf.stage_route(n) == "mixed"


@pytest.mark.parametrize("n", [12416, 16384])
def test_route_is_dense_above_12288(n):
    # above 12288 the large-axis FFT kernel (csrc/stage_large.cuh) takes
    # every multiple of 128 with a plan; the dense one only lengths without
    assert cf.stage_route(n) == "large"


def test_dense_launches_count_under_their_own_names():
    stages = ["radix2_stage", "radix2_stage_inv_last", "radix2_stage_inv_otf",
              "radix2_stage_inv_otf_batched"]
    for name in stages:
        assert name in cf.LAUNCHES and name + "_dense" in cf.LAUNCHES
    # the stages' dense kernels, K7's (tests/test_torch_dft_fft.py) and
    # those of K1 and K2 (tests/test_torch_rdft_y.py)
    dense = {k for k in cf.LAUNCHES if k.endswith("_dense")}
    others = ["cplx_matmul", "rdft_y_fwd", "rdft_y_inv",
              "rdft_y_fwd_batched", "rdft_y_inv_batched"]
    assert dense == {name + "_dense" for name in stages + others}


def test_the_cpu_takes_the_plain_stage_and_counts_nothing(rng):
    n = 256
    re, im = (t(rng.standard_normal((4, n))) for _ in range(2))
    cf.reset_launch_counts()
    got = cf.radix2_stage(re, im, *mats(n, True), True, -1)
    ref = cf.radix2_stage_plain(re, im, *mats(n, True), True, -1)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    got = cf.radix2_stage_inv_otf_batched(re, im, re[:2], im[:2],
                                          *mats(n, False), True)
    ref = cf.radix2_stage_inv_otf_plain(re, im, re[:2], im[:2],
                                        *mats(n, False), True)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    assert set(cf.LAUNCHES.values()) == {0}


# -- on the card -----------------------------------------------------------------

def _card_cases(n, dev, gen):
    def d(*shape):
        return torch.rand(shape, generator=gen, device=dev) - 0.5

    fwd, inv = mats(n, True, dev), mats(n, False, dev)
    zr, zi = d(3, n, 40), d(3, n, 40)       # ragged against both tile widths
    xr, xi = d(21, n), d(21, n)             # ragged against the row tile
    pr, pi = d(21, n), d(21, n)
    br, bi, o_r, o_i = d(128, n), d(128, n), d(64, n), d(64, n)
    return [
        ("fwd z", cf.radix2_stage(zr, zi, *fwd, True, 1),
         cf.radix2_stage_plain(zr, zi, *fwd, True, 1)),
        ("inv z", cf.radix2_stage(zr, zi, *inv, False, 1),
         cf.radix2_stage_plain(zr, zi, *inv, False, 1)),
        ("fwd x", cf.radix2_stage(xr, xi, *fwd, True, -1),
         cf.radix2_stage_plain(xr, xi, *fwd, True, -1)),
        ("inv x", cf.radix2_stage(xr, xi, *inv, False, -1),
         cf.radix2_stage_plain(xr, xi, *inv, False, -1)),
        ("otf", cf.radix2_stage_inv_otf(xr, xi, pr, pi, *inv, False),
         cf.radix2_stage_inv_otf_plain(xr, xi, pr, pi, *inv, False)),
        ("otf batched conj",
         cf.radix2_stage_inv_otf_batched(br, bi, o_r, o_i, *inv, True),
         cf.radix2_stage_inv_otf_plain(br, bi, o_r, o_i, *inv, True)),
    ]


@pytest.mark.gpu
@pytest.mark.parametrize("n", LENGTHS + (384,))
def test_stage_kernels_match_plain_on_the_card(cuda, n):
    gen = torch.Generator(device=cuda)
    gen.manual_seed(n)
    cf.reset_launch_counts()
    for what, got, ref in _card_cases(n, cuda, gen):
        for g, r in zip(got, ref):
            err = float((g - r).abs().max() / r.abs().max())
            assert err <= TOL, (n, what, err)
    dense = sum(v for k, v in cf.LAUNCHES.items() if k.endswith("_dense"))
    fft = sum(v for k, v in cf.LAUNCHES.items() if not k.endswith("_dense"))
    # n = 384 runs the mixed-radix FFT kernel, counted under the same names
    assert (dense, fft) == (0, 6)
    mixed = cf.ENTRY_LAUNCHES.get("ipp_stage_mixed", 0)
    assert mixed == (6 if n == 384 else 0)
