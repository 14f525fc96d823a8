"""K1 and K2 as real-FFT kernels (ipp_tpu_torch/csrc/rdft_y.cuh), on the CPU.

The CUDA kernels run only on a card.  What is held here:
- `emulate_rdft_y_fwd` / `emulate_rdft_y_inv`, a step-by-step PyTorch
  emulation of both kernels (two columns packed into one complex sequence,
  the passes of `dft_fft_plan(ny)` as tests/test_torch_dft_fft.py emulates
  them, the untangle step; the tangle step with its mirrored rows, the
  inverse passes, the unpacking through 1/ny and |mul * y|) against
  `rdft_y_fwd_plain` / `rdft_y_inv_plain` with `rfft_fold_mats(ny, kp)` and
  against torch.fft.rfft / irfft, at every ny = 8 * j up to 2048 on a tiny
  (nz, nx), with the ratio and the mul, a batch, one bright column, junk in
  the rows and imaginary parts the Hermitian fold ignores, K1's padded rows
  and edge imaginary parts exactly 0;
- the emulation against the Pallas kernels it stands for, in interpret mode;
- the header itself, compiled with the host compiler against a stand-in
  `cuda_runtime.h` and run block by block, thread by thread against a naive
  float64 real DFT (tests/torch_rdft_y_host/check.cpp);
- the kernel choice by shape, the launch counter names, the CPU path, the
  shape checks;
- on a card (marked `gpu`): both kernels of K1 and of K2 against the plain
  versions, a batch against its single calls bit for bit.

Tolerance: 1e-5 of the reference's max (re and im of one spectrum share one
scale), the bound the chip smoke holds the kernels to; the Pallas twins:
1e-4, the bound of the JAX walk's own tests (3-pass bf16 products).
"""

import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from ipp_tpu_torch.ops import cuda_fft as cf
from ipp_tpu_torch.ops.dft_mats import (DFT_FFT_RADICES, dft_fft_plan,
                                        rfft_fold_mats)
from ipp_tpu_torch.ops.matmul_fft import MatmulFFT3, _kp
from tests.test_torch_dft_fft import emulate_dft_fft

TOL = 1e-5
ROOT = Path(__file__).resolve().parent.parent
# every radix of the plan: 8 and 16 alone, 4, 2, 3, 5, 7, 9, 11, 13 and the
# generic pass at 17, 67, 251; 1056 and 512 are the main paths' lengths
RADIX_SET = (8, 16, 24, 40, 64, 88, 104, 136, 512, 536, 1056, 1120, 1152,
             2008, 2048)


@pytest.fixture
def rng():
    return np.random.default_rng(7)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def t(a):
    return torch.from_numpy(np.array(a, np.float32))


def fold(ny, kp, device="cpu"):
    return tuple(torch.tensor(m, device=device)
                 for m in rfft_fold_mats(ny, kp))


def err_of_max(got, ref):
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    err = max(float((g.double() - r.double()).abs().max())
              for g, r in zip(got, ref))
    return err / max(float(r.abs().max()) for r in ref)


# -- the emulation of the kernels' steps ------------------------------------------

def emulate_rdft_y_fwd(x, kp, den=None):
    """K1's arithmetic on (..., nz, ny, nx) f32 tensors, step by step as
    csrc/rdft_y.cuh runs it: the ratio formed in the load, columns (2j,
    2j + 1) packed as re + i im, the forward passes, then for k <= ny/2
    A = (Z[k] + conj Z[ny-k]) / 2 and B = (Z[k] - conj Z[ny-k]) / 2i to
    columns 2j and 2j + 1 of rows k of re and im; rows kx..kp-1 zero."""
    if den is not None:
        x = x / torch.clamp(den, min=cf.EPS)
    lead, (ny, nx) = x.shape[:-2], x.shape[-2:]
    pairs = x.reshape(-1, ny, nx // 2, 2).permute(0, 2, 1, 3)   # (a, pc, y, 2)
    zr, zi = emulate_dft_fft(pairs[..., 0].reshape(-1, ny).contiguous(),
                             pairs[..., 1].reshape(-1, ny).contiguous(), True)
    k = torch.arange(ny // 2 + 1)
    mirror = (ny - k) % ny
    yr, yi = zr[:, mirror], zi[:, mirror]
    zr, zi = zr[:, k], zi[:, k]
    halves = [0.5 * (zr + yr), 0.5 * (zi + yi),      # re A, re B
              0.5 * (zi - yi), 0.5 * (yr - zr)]      # im A, im B
    out = []
    for a, b in (halves[:2], halves[2:]):
        both = torch.stack([a, b], -1).reshape(-1, nx // 2, len(k), 2)
        plane = both.permute(0, 2, 1, 3).reshape(lead + (len(k), nx))
        pad = torch.zeros(lead + (kp - len(k), nx))
        out.append(torch.cat([plane, pad], -2).transpose(-3, -2).contiguous())
    return out[0], out[1]


def emulate_rdft_y_inv(re, im, ny, mul=None):
    """K2's arithmetic on (..., kp, nz, nx) spectra: rows 0..ny/2 loaded
    once, im dropped at k = 0 and ny/2, Z[k] = A + i B and Z[ny-k] = conj A
    + i conj B for the columns (2j, 2j + 1), the inverse passes with 1/ny,
    re z to column 2j and im z to column 2j + 1, |mul * y| at the store."""
    half = ny // 2
    re, im = re.transpose(-3, -2), im.transpose(-3, -2)   # (..., nz, kp, nx)
    lead, nx = re.shape[:-2], re.shape[-1]
    re, im = re[..., :half + 1, :], im[..., :half + 1, :].clone()
    im[..., 0, :] = 0
    im[..., half, :] = 0

    def split(a):   # (planes, pc, k) of columns 2j and of columns 2j + 1
        p = a.reshape(-1, half + 1, nx // 2, 2).permute(0, 2, 1, 3)
        return p[..., 0], p[..., 1]

    (ar, br), (ai, bi) = split(re), split(im)
    zr = torch.empty(ar.shape[:-1] + (ny,))
    zi = torch.empty_like(zr)
    zr[..., :half + 1], zi[..., :half + 1] = ar - bi, ai + br
    k = torch.arange(1, half)
    zr[..., ny - k], zi[..., ny - k] = (ar + bi)[..., k], (br - ai)[..., k]
    yr, yi = emulate_dft_fft(zr.reshape(-1, ny), zi.reshape(-1, ny), False)
    y = torch.stack([yr, yi], -1).reshape(-1, nx // 2, ny, 2)
    y = y.permute(0, 2, 1, 3).reshape(lead + (ny, nx))
    return torch.abs(mul * y) if mul is not None else y


def volume(rng, *shape, lo=0.0):
    return t(rng.random(shape) * (1 - lo) + lo)


@pytest.mark.parametrize("ny", range(8, 2048 + 1, 8))
def test_emulated_kernels_equal_plain_and_torch_fft_at_every_length(ny):
    rng = np.random.default_rng(ny)
    nz, nx, kp = 2, 4, _kp(ny)
    kx = ny // 2 + 1
    fwd, inv = fold(ny, kp)
    x, den, mul = (volume(rng, nz, ny, nx), volume(rng, nz, ny, nx, lo=0.5),
                   volume(rng, nz, ny, nx, lo=-1))
    for d in (None, den):
        got = emulate_rdft_y_fwd(x, kp, d)
        assert err_of_max(got, cf.rdft_y_fwd_plain(x, fwd, d)) <= TOL
        assert all(bool((g[kx:] == 0).all()) for g in got)
        assert bool((got[1][0] == 0).all() and (got[1][ny // 2] == 0).all())
    ref = torch.fft.rfft((x / torch.clamp(den, min=cf.EPS)).double(), dim=-2)
    ref = ref.transpose(0, 1)
    assert err_of_max((got[0][:kx], got[1][:kx]), (ref.real, ref.imag)) <= TOL
    sr, si = volume(rng, kp, nz, nx, lo=-1), volume(rng, kp, nz, nx, lo=-1)
    for m in (None, mul):
        out = emulate_rdft_y_inv(sr, si, ny, m)
        assert err_of_max(out, cf.rdft_y_inv_plain(sr, si, inv, m)) <= TOL
    spec = torch.complex(sr[:kx].double(), si[:kx].double()).transpose(0, 1)
    spec[:, 0].imag.zero_()       # the fold ignores them; irfft must not
    spec[:, -1].imag.zero_()      # be asked what it does with them
    ref = torch.abs(mul * torch.fft.irfft(spec, n=ny, dim=-2))
    assert err_of_max(out, ref) <= TOL


@pytest.mark.parametrize("ny", RADIX_SET)
def test_emulated_kernels_on_a_batch_equal_the_single_calls(rng, ny):
    nb, nz, nx, kp = 3, 2, 6, _kp(ny) + 8      # more padded rows than needed
    x, den = volume(rng, nb, nz, ny, nx), volume(rng, nb, nz, ny, nx, lo=0.5)
    fwd, inv = fold(ny, kp)
    re, im = emulate_rdft_y_fwd(x, kp, den)
    assert re.shape == (nb, kp, nz, nx)
    assert err_of_max((re, im), cf.rdft_y_fwd_plain(x, fwd, den)) <= TOL
    out = emulate_rdft_y_inv(re, im, ny, x)
    assert err_of_max(out, cf.rdft_y_inv_plain(re, im, inv, x)) <= TOL
    for b in range(nb):
        one = emulate_rdft_y_fwd(x[b], kp, den[b])
        assert torch.equal(re[b], one[0]) and torch.equal(im[b], one[1])
        assert torch.equal(out[b], emulate_rdft_y_inv(*one, ny, x[b]))


@pytest.mark.parametrize("ny", RADIX_SET)
def test_one_bright_column_stays_within_the_tolerance_of_the_max(rng, ny):
    # the bright column's partner in its pair is six orders darker: its
    # error is bounded by the tensor's max, not by its own
    nz, nx, kp = 2, 8, _kp(ny)
    x = volume(rng, nz, ny, nx) * 1e-3
    x[:, :, 5] *= 1e6
    fwd, inv = fold(ny, kp)
    got = emulate_rdft_y_fwd(x, kp)
    assert err_of_max(got, cf.rdft_y_fwd_plain(x, fwd)) <= TOL
    assert err_of_max(emulate_rdft_y_inv(*got, ny), x) <= TOL
    # and the dark columns that share no pair with it keep their own scale
    dark = [0, 1, 2, 3, 6, 7]
    ref = cf.rdft_y_fwd_plain(x, fwd)
    assert err_of_max(tuple(g[..., dark] for g in got),
                      tuple(r[..., dark] for r in ref)) <= TOL


@pytest.mark.parametrize("ny", RADIX_SET)
def test_the_inverse_ignores_what_the_fold_ignores(rng, ny):
    nz, nx, kp = 2, 4, _kp(ny) + 8
    kx = ny // 2 + 1
    sr, si = volume(rng, kp, nz, nx, lo=-1), volume(rng, kp, nz, nx, lo=-1)
    clean = emulate_rdft_y_inv(sr, si, ny)
    jr, ji = sr.clone(), si.clone()
    jr[kx:], ji[kx:] = 1e6, -1e6
    ji[0], ji[ny // 2] = 3e5, -7e5
    assert torch.equal(emulate_rdft_y_inv(jr, ji, ny), clean)
    inv = fold(ny, kp)[1]
    assert err_of_max(clean, cf.rdft_y_inv_plain(jr, ji, inv)) <= TOL


# -- the emulation against the Pallas kernels ---------------------------------------

@pytest.mark.parametrize("case", ["rfft", "rfft_ratio", "irfft", "irfft_mul",
                                  "rfft_batch", "irfft_mul_batch"])
def test_emulated_kernels_match_the_pallas_twins(case, rng):
    from ipp_tpu.ops import pallas_fft as pf

    nz, ny, nx, kp = 16, 16, 256, 16
    (fhi, flo), (ihi, ilo) = pf.prep_v2_rfft_mats(ny, kp)
    x, den, mul = (volume(rng, nz, ny, nx), volume(rng, nz, ny, nx, lo=0.5),
                   volume(rng, nz, ny, nx))
    sr, si = volume(rng, kp, nz, nx, lo=-1), volume(rng, kp, nz, nx, lo=-1)
    n = np.asarray
    if case == "rfft":
        ref = pf._v2_rfft_call_t(n(x), fhi, flo, interpret=True)
        got = emulate_rdft_y_fwd(x, kp)
    elif case == "rfft_ratio":
        ref = pf._v2_rfft_ratio_call_t(n(x), n(den), fhi, flo, interpret=True)
        got = emulate_rdft_y_fwd(x, kp, den)
    elif case == "irfft":
        ref = (pf._v2_irfft_call_t(n(sr), n(si), ihi, ilo, ny,
                                   interpret=True),)
        got = (emulate_rdft_y_inv(sr, si, ny),)
    elif case == "irfft_mul":
        ref = (pf._v2_irfft_mul_call_t(n(sr), n(si), n(mul), ihi, ilo, ny,
                                       interpret=True),)
        got = (emulate_rdft_y_inv(sr, si, ny, mul),)
    elif case == "rfft_batch":
        # the batched Pallas kernel writes plane-major (nb*nz, kp, nx)
        xb = torch.stack([x, den])
        ref = pf._v2_rfft_call(n(xb.reshape(-1, ny, nx)), fhi, flo,
                               interpret=True)
        ref = tuple(np.asarray(r).reshape(2, nz, kp, nx).transpose(0, 2, 1, 3)
                    for r in ref)
        got = emulate_rdft_y_fwd(xb, kp)
    else:
        rb = torch.stack([sr, si]).transpose(1, 2).reshape(-1, kp, nx)
        ib = torch.stack([si, sr]).transpose(1, 2).reshape(-1, kp, nx)
        mb = torch.stack([mul, x])
        ref = (np.asarray(pf._v2_irfft_mul_call(
            n(rb), n(ib), n(mb.reshape(-1, ny, nx)), ihi, ilo, ny,
            interpret=True)).reshape(2, nz, ny, nx),)
        got = (emulate_rdft_y_inv(torch.stack([sr, si]), torch.stack([si, sr]),
                                  ny, mb),)
    for g, r in zip(got, ref):
        assert g.shape == tuple(r.shape)
    assert err_of_max(got, tuple(t(np.asarray(r)) for r in ref)) <= 1e-4, case


# -- the header on the host ----------------------------------------------------------

def test_header_matches_a_naive_real_dft_on_the_host(tmp_path):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    exe = tmp_path / "check"
    subprocess.run(
        [gxx, "-std=c++17", "-O2", "-I",
         str(ROOT / "tests" / "torch_dft_fft_host"), "-I",
         str(ROOT / "ipp_tpu_torch" / "csrc"),
         str(ROOT / "tests" / "torch_rdft_y_host" / "check.cpp"), "-o",
         str(exe)], check=True, capture_output=True, text=True)
    args = []
    for ny in RADIX_SET + (32, 72, 280, 768, 1536):
        plan = dft_fft_plan(ny)
        args += [str(ny), str(int(plan[-1] not in DFT_FFT_RADICES)),
                 *map(str, plan), "/"]
    out = subprocess.run([str(exe), *args], capture_output=True, text=True)
    assert out.returncode == 0, out.stdout + out.stderr
    assert len(out.stdout.splitlines()) == len(RADIX_SET) + 5


# -- the kernel choice, the counters, the CPU path -------------------------------------

@pytest.mark.parametrize("ny,nx", [(8, 2), (1056, 256), (512, 512),
                                   (2048, 256), (2008, 6), (24, 768)])
def test_route_is_fft_on_the_v2_domain(ny, nx):
    assert cf.rdft_route(ny, nx) == "fft"


@pytest.mark.parametrize("ny,nx", [(12, 256), (4, 256), (0, 256), (2056, 256),
                                   (4096, 256), (1056, 255), (1056, 1),
                                   (1056, 0)])
def test_route_is_dense_on_every_other_shape(ny, nx):
    assert cf.rdft_route(ny, nx) == "dense"


def test_the_v2_domain_lies_inside_the_fft_route():
    for ny in range(8, 2048 + 1, 8):
        for nz in (256, 512):
            plan_ok = (_kp(ny) * nz) % 512 == 0
            assert cf.rdft_route(ny, 256) == "fft", (ny, plan_ok)


def test_every_kernel_of_k1_and_k2_has_a_counter():
    for name in ("rdft_y_fwd", "rdft_y_inv", "rdft_y_fwd_batched",
                 "rdft_y_inv_batched"):
        assert name in cf.LAUNCHES and name + "_dense" in cf.LAUNCHES


@pytest.mark.parametrize("stated", [False, True])
def test_the_cpu_takes_the_plain_version_and_counts_nothing(rng, stated):
    nz, ny, nx, kp = 3, 24, 6, 16
    fwd, inv = fold(ny, kp)
    x, den = volume(rng, 2, nz, ny, nx), volume(rng, 2, nz, ny, nx, lo=0.5)
    cf.reset_launch_counts()
    re, im = cf.rdft_y_fwd_batched(x, fwd, den, fold=stated)
    ref = cf.rdft_y_fwd_plain(x, fwd, den)
    assert torch.equal(re, ref[0]) and torch.equal(im, ref[1])
    one = cf.rdft_y_fwd(x[0], fwd, fold=stated)
    assert torch.equal(one[0], cf.rdft_y_fwd_plain(x[0], fwd)[0])
    out = cf.rdft_y_inv_batched(re, im, inv, x, fold=stated)
    assert torch.equal(out, cf.rdft_y_inv_plain(re, im, inv, x))
    assert torch.equal(cf.rdft_y_inv(re[1], im[1], inv, fold=stated),
                       cf.rdft_y_inv_plain(re[1], im[1], inv))
    assert set(cf.LAUNCHES.values()) == {0}


def test_the_walk_states_the_fold(rng, monkeypatch):
    # MatmulFFT3's v2 walk passes fold=True to all four wrappers
    seen = []

    def spy(name):
        real = getattr(cf, name)

        def call(*a, **kw):
            seen.append((name, kw.get("fold")))
            return real(*a, **kw)
        monkeypatch.setattr(cf, name, call)

    for name in ("rdft_y_fwd", "rdft_y_fwd_batched", "rdft_y_inv",
                 "rdft_y_inv_batched"):
        spy(name)
    shape = (256, 8, 256)
    plan = MatmulFFT3(shape, "cpu")
    x = volume(rng, *shape)
    otf = plan.otf_packed(x)
    plan.convolve(x, otf)
    plan.convolve(torch.stack([x, x]), otf, ratio_num=torch.stack([x, x]),
                  mul_abs=torch.stack([x, x]))
    assert {n for n, _ in seen} == {"rdft_y_fwd", "rdft_y_fwd_batched",
                                    "rdft_y_inv", "rdft_y_inv_batched"}
    assert all(stated is True for _, stated in seen)


def test_a_wrong_matrix_shape_raises(rng):
    nz, ny, nx, kp = 2, 24, 4, 16
    fwd, inv = fold(ny, kp)
    x = volume(rng, nz, ny, nx)
    sr = volume(rng, kp, nz, nx)
    for stated in (False, True):
        with pytest.raises(ValueError):
            cf.rdft_y_fwd(x, fwd[:, :16].contiguous(), fold=stated)
        with pytest.raises(ValueError):
            cf.rdft_y_fwd_batched(x[None], fwd[:, :16].contiguous(),
                                  fold=stated)
        with pytest.raises(ValueError):
            cf.rdft_y_inv(sr, sr, inv[:, :24].contiguous(), fold=stated)
        with pytest.raises(ValueError):
            cf.rdft_y_inv_batched(sr[None], sr[None],
                                  inv[:, :16].contiguous(), fold=stated)


def test_a_stated_fold_needs_room_for_the_half_spectrum(rng):
    nz, ny, nx, kp = 2, 24, 4, 8          # kx = 13 > kp
    x, sr = volume(rng, nz, ny, nx), volume(rng, kp, nz, nx)
    fwd, inv = t(rng.random((2 * kp, ny))), t(rng.random((ny, 2 * kp)))
    cf.rdft_y_fwd(x, fwd)                  # any matrix: fine
    cf.rdft_y_inv(sr, sr, inv)
    with pytest.raises(ValueError):
        cf.rdft_y_fwd(x, fwd, fold=True)
    with pytest.raises(ValueError):
        cf.rdft_y_inv(sr, sr, inv, fold=True)


def test_the_fft_kernels_refuse_cpu_tensors(rng):
    x = volume(rng, 1, 2, 24, 4)
    with pytest.raises(ValueError):
        cf.rdft_y_fwd_fft(x, 16)
    with pytest.raises(ValueError):
        cf.rdft_y_inv_fft(volume(rng, 1, 16, 2, 4), volume(rng, 1, 16, 2, 4),
                          24)


# -- on the card ---------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("ny", RADIX_SET + (12,))
def test_k1_and_k2_kernels_match_plain_on_the_card(cuda, ny):
    gen = torch.Generator(device=cuda)
    gen.manual_seed(ny)
    nb, nz, nx = 2, 5, 70                       # ragged against every tile
    kp = _kp(ny) + 8
    fwd, inv = fold(ny, kp, cuda)
    fft = ny != 12

    def d(*shape, lo=0.0):
        return torch.rand(shape, generator=gen, device=cuda) * (1 - lo) + lo

    x, den, mul = (d(nb, nz, ny, nx), d(nb, nz, ny, nx, lo=0.5),
                   d(nb, nz, ny, nx, lo=-1))
    sr, si = d(nb, kp, nz, nx, lo=-1), d(nb, kp, nz, nx, lo=-1)
    sr[:, ny // 2 + 1:], si[:, 0], si[:, ny // 2] = 1e6, 3e5, -7e5
    cf.reset_launch_counts()
    for extra_f, extra_i in ((None, None), (den, mul)):
        ref_f = cf.rdft_y_fwd_plain(x, fwd, extra_f)
        ref_i = cf.rdft_y_inv_plain(sr, si, inv, extra_i)
        for stated in (True, False):
            got = cf.rdft_y_fwd_batched(x, fwd, extra_f, fold=stated)
            assert err_of_max(got, ref_f) <= TOL, (ny, stated)
            if stated and fft:
                kx = ny // 2 + 1
                assert all(bool((g[:, kx:] == 0).all()) for g in got)
                assert bool((got[1][:, 0] == 0).all())
                assert bool((got[1][:, ny // 2] == 0).all())
            out = cf.rdft_y_inv_batched(sr, si, inv, extra_i, fold=stated)
            assert err_of_max(out, ref_i) <= TOL, (ny, stated)
    one = cf.rdft_y_fwd(x[1], fwd, den[1], fold=True)
    assert torch.equal(one[0], cf.rdft_y_fwd_batched(x, fwd, den,
                                                     fold=True)[0][1])
    back = cf.rdft_y_inv(sr[1], si[1], inv, mul[1], fold=True)
    assert torch.equal(back, cf.rdft_y_inv_batched(sr, si, inv, mul,
                                                   fold=True)[1])
    want = {"rdft_y_fwd_batched": 3 if fft else 0,
            "rdft_y_inv_batched": 3 if fft else 0,
            "rdft_y_fwd_batched_dense": 2 if fft else 5,
            "rdft_y_inv_batched_dense": 2 if fft else 5,
            "rdft_y_fwd" if fft else "rdft_y_fwd_dense": 1,
            "rdft_y_inv" if fft else "rdft_y_inv_dense": 1}
    assert {k: v for k, v in cf.LAUNCHES.items() if v} == \
        {k: v for k, v in want.items() if v}


@pytest.mark.gpu
def test_an_odd_nx_takes_the_dense_kernels_on_the_card(cuda, rng):
    nz, ny, nx, kp = 4, 24, 33, 16
    fwd, inv = fold(ny, kp, cuda)
    x = volume(rng, nz, ny, nx).to(cuda)
    cf.reset_launch_counts()
    got = cf.rdft_y_fwd(x, fwd, fold=True)
    back = cf.rdft_y_inv(*got, inv, fold=True)
    assert {k: v for k, v in cf.LAUNCHES.items() if v} == {
        "rdft_y_fwd_dense": 1, "rdft_y_inv_dense": 1}
    assert err_of_max(got, cf.rdft_y_fwd_plain(x, fwd)) <= TOL
    assert err_of_max(back, x) <= TOL


@pytest.mark.gpu
def test_a_misaligned_volume_is_refused_on_the_card(cuda, rng):
    # column pairs move as 8-byte values: a view that starts on an odd
    # float raises, it is not silently sent to another kernel
    nz, ny, nx, kp = 2, 24, 6, 16
    fwd = fold(ny, kp, cuda)[0]
    flat = volume(rng, nz * ny * nx + 1).to(cuda)
    x = flat[1:].view(nz, ny, nx)
    assert x.is_contiguous() and x.data_ptr() % 8 == 4
    with pytest.raises(ValueError):
        cf.rdft_y_fwd(x, fwd, fold=True)
    cf.rdft_y_fwd(x, fwd)            # the dense kernel takes any alignment
