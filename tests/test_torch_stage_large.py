"""The radix-2 stage and K7's DFT above 12288 as FFT kernels
(ipp_tpu_torch/csrc/stage_large.cuh), on the CPU.

The kernel runs only on a card.  What is held here:
- `emulate_large`, a PyTorch emulation of the kernel's index maps and
  passes: the radix-2 butterfly at the first load (the forward's
  frequency halves, the inverse's time halves from the permuted or natural
  order, the OTF product of data row r with OTF row r % orows), the
  in-place decimation-in-time passes of each half (`emulate_dit`, digit-
  reversed first loads, the generic pass's twiddles and roots from
  `stage_twiddles`), and for Form B the four-step's twiddle, the scratch
  addresses pass 1 writes and pass 2 reads (each from its own formula), and
  the final store; with the plan's limits as parameters, so that both
  forms' maps run at n = 256-1088 against the plain versions
  (`radix2_stage_plain`, `cplx_matmul_plain`), and at the real lengths
  12416 and 24832 (2-4 rows) against numpy's FFT in permuted order;
- the plan and the route at every multiple of 128 (64 for K7) from 12416
  to 65536, and at lengths with none;
- the stage-matrix rule: None for mr_t, mi_t where the kernel reads none,
  refused where the plain version or the dense kernel needs them;
- the header built by the host compiler (tests/torch_stage_large_host/):
  plans, geometry, slot maps, the kernel's blocks pass by pass against a
  float64 DFT, and the bank conflicts;
- on a card (marked `gpu`): every form against its plain version with one
  launch on `ipp_stage_large`, and the plan of an RL block holding no stage
  matrix.

Tolerance: 1e-5 of the reference's max, the bound the chip smoke holds the
stage kernels to.
"""

import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from ipp_tpu_torch.ops import cuda_fft as cf
from ipp_tpu_torch.ops import matmul_fft as mf
from ipp_tpu_torch.ops.dft_mats import (DFT_FFT_MAX_N, DFT_FFT_RADICES,
                                        LARGE_A_MAX_N, cplx_triple,
                                        stage_large_plan, stage_mats_t,
                                        stage_twiddles)
from tests.test_torch_stage_mixed import dit_source

TOL = 1e-5
ROOT = Path(__file__).resolve().parent.parent
# small limits that put both forms' maps at n = 256-1088: Form A up to
# 512, m2 at most 32 (so m1 > 8 and the four-step's twiddles vary)
SMALL = dict(lo=256, a_max=512, m2_max=32)


@pytest.fixture
def rng():
    return np.random.default_rng(14)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


def rel(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def table(n, forward=True):
    tab = torch.from_numpy(stage_twiddles(n).copy())
    w = torch.complex(tab[:, 0], tab[:, 1])
    return w if forward else w.conj()


def emulate_dit(x, plan, forward):
    """The in-place passes of one transform of length L = prod(plan) on
    (rows, L) complex64, natural order in and out, unnormalised: the first
    pass reads digit-reversed inputs (`dit_source`) and writes group g to
    g R0 + k; pass p turns element g L' + j + k Lp by w^(j k L / L') and
    transforms the R values in place (a generic radix's roots from the
    table)."""
    n = int(np.prod(plan))
    w = table(n, forward)

    def roots(r, stride):
        jk = (np.arange(r)[:, None] * np.arange(r)[None, :]) % r
        if r in DFT_FFT_RADICES:
            ang = (-2 if forward else 2) * np.pi * jk / r
            return torch.from_numpy(np.exp(1j * ang).astype(np.complex64))
        return w[torch.from_numpy(jk * stride)]

    r0 = plan[0]
    nb = n // r0
    g = np.arange(nb)
    src = np.array([dit_source(plan, int(i)) for i in g])
    k = np.arange(r0)
    a = x[:, torch.from_numpy(src[:, None] + k[None] * nb)]
    buf = torch.empty_like(x)
    buf[:, torch.from_numpy(g[:, None] * r0 + k[None])] = a @ roots(r0, 0)
    lp = r0
    for r in plan[1:]:
        i = np.arange(n // r)
        k = np.arange(r)
        j, g = i % lp, i // lp
        idx = torch.from_numpy((g * lp * r + j)[:, None] + k[None] * lp)
        v = buf[:, idx] * w[torch.from_numpy(
            (n // (lp * r)) * j[:, None] * k[None])]
        buf[:, idx] = v @ roots(r, n // r)
        lp *= r
    return buf


def emulate_large(re, im, forward, axis, plan, otf=None, conj=False,
                  natural=False):
    """The large-axis kernel's arithmetic on (R, n) (axis -1) or (P, n, X)
    (axis 1) f32 tensors with `plan` = (plan1, plan2) as
    `stage_large_plan` gives it; complex64 throughout, every device-memory
    and scratch access through the kernel's own address formulas."""
    if axis == 1:
        p_, n, x_ = re.shape
    else:
        (p_, n), x_ = re.shape, 1
    m = n // 2
    last = axis == -1
    flat = torch.complex(re, im).reshape(-1)
    i = np.arange(m)
    if forward or natural:
        p0, p1 = i, i + m
    else:
        p0 = (i & 1) * m + (i >> 1)
        p1 = p0 + m // 2
    pp = np.arange(p_)[:, None, None]
    xx = np.arange(x_)[None, :, None]
    y0 = flat[torch.from_numpy(pp * n * x_ + p0 * x_ + xx)]   # (P, X, m)
    y1 = flat[torch.from_numpy(pp * n * x_ + p1 * x_ + xx)]
    if otf is not None:
        o = torch.complex(otf[0], -otf[1] if conj else otf[1])
        rows = torch.from_numpy(np.arange(p_) % o.shape[0])[:, None, None]
        y0 = y0 * o[rows, torch.from_numpy(p0)]
        y1 = y1 * o[rows, torch.from_numpy(p1)]
    w = table(n, forward)[:m]
    c = torch.stack([y0 + y1, (y0 - y1) * w], 2)              # (P, X, 2, m)
    plan1, plan2 = plan
    if not plan2:                                             # Form A
        z = emulate_dit(c.reshape(-1, m), plan1, forward).reshape(c.shape)
    else:                                                     # Form B
        m1, m2 = int(np.prod(plan1)), int(np.prod(plan2))
        ci = c.reshape(p_, x_, 2, m1, m2).transpose(-1, -2)   # [.., i2, i1]
        t1 = emulate_dit(ci.reshape(-1, m1), plan1, forward).reshape(
            p_, x_, 2, m2, m1)                                # [.., i2, k1]
        i2 = np.arange(m2)[:, None]
        k1 = np.arange(m1)[None]
        t1 = t1 * table(n, forward)[torch.from_numpy(2 * k1 * i2)]
        # pass 1's stores: (p n + h m + k1 sk + i2 se) X + x
        p5, x5 = pp[..., None, None], xx[..., None, None]
        h5 = np.arange(2)[None, None, :, None, None]
        if last:
            a1 = p5 * n + h5 * m + k1 + i2 * m1
        else:
            a1 = (p5 * n + h5 * m + k1 * m2 + i2) * x_ + x5
        a1 = np.broadcast_to(a1, t1.shape)
        assert np.array_equal(np.sort(a1.reshape(-1)), np.arange(p_ * n * x_))
        scratch = torch.zeros(p_ * n * x_, dtype=torch.complex64)
        scratch[torch.from_numpy(a1.reshape(-1).copy())] = t1.reshape(-1)
        # pass 2's loads, from its column col = ((p 2 + h) m1 + k1) X + x
        col = np.arange(p_ * 2 * m1 * x_)
        tq, xc = col // x_, col % x_
        kc, q = tq % m1, tq // m1
        hc, pc = q & 1, q >> 1
        sbase = pc * n * x_ + hc * m * x_ + xc + (kc if last else
                                                  kc * m2 * x_)
        se = m1 if last else x_
        a2 = sbase[:, None] + np.arange(m2)[None] * se        # [col, i2]
        t2 = emulate_dit(scratch[torch.from_numpy(a2)], plan2, forward)
        # back to (P, X, 2, m) with k = k1 + m1 k2
        z = t2.reshape(p_, 2, m1, x_, m2).permute(0, 3, 1, 4, 2).reshape(
            p_, x_, 2, m)
    k = np.arange(m)
    h = np.arange(2)[:, None]
    pos = h * m + k if forward and not natural else 2 * k + h  # (2, m)
    out = torch.empty(p_ * n * x_, dtype=torch.complex64)
    addr = pp[..., None] * n * x_ + pos[None, None] * x_ + xx[..., None]
    out[torch.from_numpy(addr.reshape(-1))] = (
        z if forward else z / n).reshape(-1)
    out = out.reshape(re.shape)
    return out.real.contiguous(), out.imag.contiguous()


def mats(n, forward):
    return tuple(torch.tensor(m) for m in stage_mats_t(n, forward))


def permuted(spec):
    """numpy's spectrum (rows, n) in the walk's order: X[f] at (f & 1) n/2 +
    (f >> 1)."""
    n = spec.shape[-1]
    f = np.arange(n)
    out = np.empty_like(spec)
    out[..., (f & 1) * (n // 2) + (f >> 1)] = spec
    return out


# -- the emulation at small lengths, against the plain versions ------------------

# n, axis: Form A at 512 (last axis); Form B with m1 = 8 ... 64 on both
# axes, a generic pass of 17 in pass 2 (1088 = 64 * 17), m1 = 4 (K7 below)
SMALL_CASES = [(512, -1), (768, -1), (1024, -1), (1024, 1), (1088, 1),
               (1088, -1), (384, 1)]


@pytest.mark.parametrize("forward", [True, False])
@pytest.mark.parametrize("n,axis", SMALL_CASES)
def test_emulated_large_equals_the_plain_stage(rng, n, axis, forward):
    plan = stage_large_plan(n, axis == -1, **SMALL)
    assert plan is not None and bool(plan[1]) == (axis == 1 or n > 512)
    shape = (2, n, 3) if axis == 1 else (4, n)
    re, im = (t(rng.standard_normal(shape)) for _ in range(2))
    got = emulate_large(re, im, forward, axis, plan)
    ref = cf.radix2_stage_plain(re, im, *mats(n, forward), forward, axis)
    assert max(rel(g.numpy(), r.numpy()) for g, r in zip(got, ref)) <= TOL


@pytest.mark.parametrize("conj", [False, True])
@pytest.mark.parametrize("n", [512, 1024, 1088])
def test_emulated_large_otf_stage_equals_the_plain_otf_stage(rng, n, conj):
    plan = stage_large_plan(n, True, **SMALL)
    re, im = (t(rng.standard_normal((6, n))) for _ in range(2))
    otf = tuple(t(rng.standard_normal((3, n))) for _ in range(2))
    got = emulate_large(re, im, False, -1, plan, otf, conj)
    ref = cf.radix2_stage_inv_otf_plain(re, im, *otf, *mats(n, False), conj)
    assert max(rel(g.numpy(), r.numpy()) for g, r in zip(got, ref)) <= TOL


@pytest.mark.parametrize("forward", [True, False])
@pytest.mark.parametrize("n", [320, 448, 576, 1024])
def test_emulated_natural_dft_equals_the_plain_product(rng, n, forward):
    # 320 = 64 * 5 and 576 = 64 * 9: m1 = 4; 448 Form A
    plan = stage_large_plan(n, True, **SMALL)
    re, im = (t(rng.standard_normal((3, n))) for _ in range(2))
    got = emulate_large(re, im, forward, -1, plan, natural=True)
    ref = cf.cplx_matmul_plain(re, im, *map(torch.tensor,
                                            cplx_triple(n, forward)))
    assert max(rel(g.numpy(), r.numpy()) for g, r in zip(got, ref)) <= TOL


# -- the emulation at the real lengths, against numpy's FFT ------------------------

@pytest.mark.parametrize("n,axis", [(12416, -1), (12416, 1), (24832, -1),
                                    (24832, 1), (24576, -1)])
def test_emulated_large_equals_numpy_at_the_real_lengths(rng, n, axis):
    plan = stage_large_plan(n, axis == -1)
    form_a = axis == -1 and n <= LARGE_A_MAX_N
    assert bool(plan[1]) != form_a
    shape = (1, n, 2) if axis == 1 else (2, n)
    x = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    xc = np.moveaxis(x.astype(np.complex64), 1, -1)          # (.., n)
    for forward in (True, False):
        rr, ii = emulate_large(t(x.real), t(x.imag), forward, axis, plan)
        got = np.moveaxis(rr.numpy() + 1j * ii.numpy(), 1, -1)
        if forward:
            ref = permuted(np.fft.fft(xc.astype(np.complex128), axis=-1))
        else:
            f = np.arange(n)
            nat = xc[..., (f & 1) * (n // 2) + (f >> 1)]
            ref = np.fft.ifft(nat.astype(np.complex128), axis=-1)
        assert rel(got.real, ref.real) <= TOL
        assert rel(got.imag, ref.imag) <= TOL
    if axis == -1:   # K4 with a conjugated OTF of period 1, and K7's DFT
        o = rng.standard_normal((1, n)) + 1j * rng.standard_normal((1, n))
        rr, ii = emulate_large(t(x.real), t(x.imag), False, -1, plan,
                               (t(o.real), t(o.imag)), True)
        prod = xc * np.conj(o.astype(np.complex64))
        f = np.arange(n)
        ref = np.fft.ifft(prod[..., (f & 1) * (n // 2) + (f >> 1)].astype(
            np.complex128), axis=-1)
        assert rel(rr.numpy(), ref.real) <= TOL
        assert rel(ii.numpy(), ref.imag) <= TOL
        rr, ii = emulate_large(t(x.real), t(x.imag), True, -1, plan,
                               natural=True)
        ref = np.fft.fft(xc.astype(np.complex128), axis=-1)
        assert rel(rr.numpy(), ref.real) <= TOL
        assert rel(ii.numpy(), ref.imag) <= TOL


def test_dit_group_inverts_dit_source():
    # stage_large.cuh `dit_group`, here in Python, on Form A's plans
    def dit_group(plan, s):
        g, w, rest = 0, 1, int(np.prod(plan)) // plan[0]
        for r in plan[1:]:
            rest //= r
            d, s = divmod(s, rest)
            g += d * w
            w *= r
        return g

    for n in (12416, 12544, 24576):
        plan = stage_large_plan(n, True)[0]
        nb = int(np.prod(plan)) // plan[0]
        assert [dit_group(plan, dit_source(plan, g)) for g in range(nb)] == \
            list(range(nb))


# -- plans and routes --------------------------------------------------------------

def test_every_multiple_of_128_up_to_65536_has_a_large_plan():
    for n in range(DFT_FFT_MAX_N + 128, 65536 + 1, 128):
        for last in (True, False):
            p1, p2 = stage_large_plan(n, last)
            if last and n <= LARGE_A_MAX_N:
                assert p2 == () and int(np.prod(p1)) == n // 2
                continue
            m1, m2 = int(np.prod(p1)), int(np.prod(p2))
            assert m1 * m2 == n // 2 and m1 & (m1 - 1) == 0
            assert 4 <= m1 <= 512 and m2 % 8 == 0 and m2 <= DFT_FFT_MAX_N
            assert all(r in (2, 4, 8, 16) for r in p1) and p1[0] != 2


def test_route_is_large_above_12288():
    for n in range(DFT_FFT_MAX_N + 128, 65536 + 1, 128):
        assert cf.stage_route(n) == "large"
    for n in range(DFT_FFT_MAX_N + 64, 65536 + 1, 64):
        assert cf.dft_route(n) == "large"


@pytest.mark.parametrize("n", [12352, 196736, 262144 + 128])
def test_route_is_dense_for_a_stage_length_without_a_plan(n):
    # 12352: no multiple of 128; above 196608 a multiple of 128 may have
    # no plan (m2 > 12288)
    assert stage_large_plan(n, False) is None or n % 128
    assert cf.stage_route(n) == "dense"


@pytest.mark.parametrize("n", [12296, 12320, 98368])
def test_k7_route_is_dense_for_a_length_without_a_plan(n):
    assert cf.dft_route(n) == "dense"


# -- the stage-matrix rule ---------------------------------------------------------

def test_routes_without_matrices_take_none():
    for n in (256, 384, 12416, 24832):
        cf._stage_mats_ok("radix2_stage", n, None, None)
    with pytest.raises(ValueError, match="needs the stage matrices"):
        cf._stage_mats_ok("radix2_stage", 196736, None, None)
    with pytest.raises(ValueError, match="needs the stage matrices"):
        cf._stage_mats_ok("radix2_stage", 384, torch.zeros(2, 192, 192),
                          None)


def test_the_plain_versions_refuse_missing_matrices(rng):
    re, im = (t(rng.standard_normal((3, 384))) for _ in range(2))
    for call in (lambda: cf.radix2_stage(re, im, None, None, True, -1),
                 lambda: cf.radix2_stage_inv_otf(re, im, re, im, None, None,
                                                 False),
                 lambda: cf.radix2_stage_inv_otf_batched(re, im, re, im,
                                                         None, None, True)):
        with pytest.raises(ValueError, match="needs the stage matrices"):
            call()


def test_the_plan_holds_stage_matrices_only_where_a_kernel_reads_them():
    # no allocation: the device decides before any upload
    plan = mf.MatmulFFT3.__new__(mf.MatmulFFT3)
    plan.device = torch.device("cuda", 0)
    for n in (256, 2304, 12544):
        assert plan._stage_mats(n, True) == (None, None)
    plan.device = torch.device("cpu")
    got = plan._stage_mats(256, False)
    assert [tuple(g.shape) for g in got] == [(2, 128, 128)] * 2
    cpu = mf.MatmulFFT3((256, 16, 256), "cpu")
    assert all(m is not None for f in (True, False)
               for m in cpu._z[f] + cpu._x[f])


def test_the_large_kernel_refuses_cpu_tensors(rng):
    re, im = (t(rng.standard_normal((2, 12416))) for _ in range(2))
    with pytest.raises(ValueError):
        cf.stage_large(re, im, True, -1)
    with pytest.raises(ValueError):
        cf.stage_dense(re, im, re, im, True, -1)


# -- the header on the host --------------------------------------------------------

@pytest.fixture(scope="module")
def host_check(tmp_path_factory):
    """tests/torch_stage_large_host/check.cpp built by g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    exe = tmp_path_factory.mktemp("stage_large_host") / "check"
    subprocess.run(
        [gxx, "-std=c++17", "-Og", "-I",
         str(ROOT / "tests" / "torch_dft_fft_host"), "-I",
         str(ROOT / "ipp_tpu_torch" / "csrc"),
         str(ROOT / "tests" / "torch_stage_large_host" / "check.cpp"), "-o",
         str(exe)], check=True, capture_output=True, text=True)
    return exe


def host_args(n, last, plan):
    p1, p2 = plan
    g1 = int(not p2 and p1[-1] not in DFT_FFT_RADICES)
    g2 = [str(int(p2[-1] not in DFT_FFT_RADICES)), *map(str, p2)] if p2 \
        else []
    return [str(n), str(int(last)), str(g1), *map(str, p1), ":", *g2, "/"]


HOST_CASES = [(12416, True), (12416, False), (12544, True), (24576, True),
              (24832, True)]


def test_header_maps_geometry_and_conflicts_on_the_host(host_check):
    args, small = [], [(1024, False), (1088, True), (768, True)]
    for n, last in HOST_CASES:
        args += host_args(n, last, stage_large_plan(n, last))
    for n, last in small:
        args += host_args(n, last, stage_large_plan(n, last, **SMALL))
    out = subprocess.run([str(host_check), *args], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    lines = out.stdout.splitlines()
    assert len(lines) == len(HOST_CASES) + len(small)
    for (n, last), line in zip(HOST_CASES + small, lines):
        fields = dict(f.split("=") for f in line.split() if "=" in f)
        assert int(fields["n"]) == n and int(fields["bijective"]) == 1
        assert int(fields["smem"]) <= 227 * 1024
        assert int(fields["scratch_once"]) == 1
        form_a = last and n <= LARGE_A_MAX_N and (n, last) not in small
        assert fields["form"] == ("A" if form_a else "B"), line


def test_the_host_check_refuses_a_plan_off_the_rule(host_check):
    # Form A above 24576; a pass-1 length with a generic pass
    for args in (["24832", "1", "0", "8", "8", "194", ":", "/"],
                 ["24832", "0", "1", "8", "97", ":", "0", "16", "/"]):
        out = subprocess.run([str(host_check), *args], capture_output=True,
                             text=True, timeout=60)
        assert out.returncode == 1 and "refused" in out.stdout


# -- on the card ---------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [12416, 24832])
def test_large_kernel_matches_plain_on_the_card(cuda, n):
    gen = torch.Generator(device=cuda)
    gen.manual_seed(n)

    def d(*shape):
        return torch.rand(shape, generator=gen, device=cuda) - 0.5

    fwd = tuple(m.to(cuda) for m in mats(n, True))
    inv = tuple(m.to(cuda) for m in mats(n, False))
    zr, zi, xr, xi = d(2, n, 40), d(2, n, 40), d(3, n), d(3, n)
    o_r, o_i = d(1, n), d(1, n)
    cf.reset_launch_counts()
    cases = [
        (cf.radix2_stage(zr, zi, None, None, True, 1),
         cf.radix2_stage_plain(zr, zi, *fwd, True, 1)),
        (cf.radix2_stage(zr, zi, None, None, False, 1),
         cf.radix2_stage_plain(zr, zi, *inv, False, 1)),
        (cf.radix2_stage(xr, xi, None, None, True, -1),
         cf.radix2_stage_plain(xr, xi, *fwd, True, -1)),
        (cf.radix2_stage(xr, xi, None, None, False, -1),
         cf.radix2_stage_plain(xr, xi, *inv, False, -1)),
        (cf.radix2_stage_inv_otf_batched(xr, xi, o_r, o_i, None, None, True),
         cf.radix2_stage_inv_otf_plain(xr, xi, o_r, o_i, *inv, True)),
    ]
    for got, ref in cases:
        err = max(float((g - r).abs().max()) for g, r in zip(got, ref)) / \
            max(float(r.abs().max()) for r in ref)
        assert err <= TOL, (n, err)
    assert cf.ENTRY_LAUNCHES == {"ipp_stage_large": 5}
    assert not any(v for k, v in cf.LAUNCHES.items() if k.endswith("_dense"))


@pytest.mark.gpu
def test_plan_of_a_large_block_holds_no_stage_matrix_on_the_card(cuda):
    plan = mf.MatmulFFT3((256, 16, 12544), cuda)
    assert plan._x[True] == (None, None) and plan._z[False] == (None, None)
