"""The v1 FFT walk of ipp_tpu_torch against the JAX v1 walk.

The reference runs its v1 walk (mxu_fft.MatmulFFT3 outside the v2 domain)
with the Pallas stage kernels on 256-multiple axes and, with
IPP_TPU_FFT_FUSED=1, the Pallas complex matmul on the others; here both
run in interpret mode on JAX-CPU, as tests/test_deconv.py:247-266,312-334
run them.  Held against them: the plain versions of K6 (the inverse stage
over the last axis) and K7 (the complex matmul), the DFT matrices and the
plan rules, the v1 `otf_packed` / `convolve` (numpy too), the edge taper
and `richardson_lucy` on the "walk1" route, and the three-way routing.
On a CUDA card only: K6 and K7 against their plain versions and the v1
convolve through the kernels.

Tolerances: the Pallas complex matmul multiplies in f32 (1e-4, the bound
of test_deconv.py:264); the Pallas stages in 3-pass bf16: rel <= 1e-5 of
the largest value for one stage, 1e-4 for a whole convolve
(test_deconv.py:330-334); RL within rtol=2e-3, atol=2e-1 on the inner
region, the bound the JAX package uses between its walk and its XLA FFT
(test_deconv.py:217); kernel vs plain on the card 1e-5 (both f32)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ipp_tpu.ops import deconv as dj
from ipp_tpu.ops import mxu_fft
from ipp_tpu.ops import pallas_fft as pf
from ipp_tpu.ops.psf import gaussian_psf
from ipp_tpu_torch.ops import cuda_fft as cf
from ipp_tpu_torch.ops import deconv as dp
from ipp_tpu_torch.ops.dft_mats import (cplx_triple, idft_mats, rfft_x_mats,
                                        stage_mats_t)
from ipp_tpu_torch.ops.matmul_fft import (MatmulFFT3, load_packed_otf,
                                          plan_shape, stage_axes)

# (z is a radix-2 axis, y dense: K7 on y), (both radix-2: K4 on y),
# (all dense)
SHAPES = [(256, 64, 40), (256, 256, 16), (40, 24, 32)]
INNER = (slice(4, -4),) * 3


def rel(a, ref):
    a, ref = np.asarray(a), np.asarray(ref)
    return float(np.abs(a - ref).max() / np.abs(ref).max())


def t(a):
    return torch.from_numpy(np.array(a, np.float32))


@pytest.fixture()
def jax_v1(monkeypatch):
    """The reference's v1 walk with its Pallas kernels in interpret mode:
    the stage kernels (IPP_TPU_FFT_KERNEL=1 interprets them off the TPU)
    and the complex matmul (IPP_TPU_FFT_FUSED=1, whose call in `_cplx_last`
    names no interpret flag, so the module attribute it imports at call
    time is wrapped to interpret)."""
    monkeypatch.setenv("IPP_TPU_FFT_KERNEL", "1")
    monkeypatch.setenv("IPP_TPU_FFT_FUSED", "1")
    monkeypatch.setenv("IPP_TPU_FFT_V2", "0")
    fused = pf.fused_cplx_matmul
    monkeypatch.setattr(pf, "fused_cplx_matmul",
                        lambda re, im, mats: fused(re, im, mats,
                                                   interpret=True))


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


# -- constants and rules --------------------------------------------------------

@pytest.mark.parametrize("n", [8, 40, 136, 1072])
def test_dense_mats_bit_equal(n):
    for a, b in zip(idft_mats(n), mxu_fft._idft_mats(n)):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    for forward in (True, False):
        ref = mxu_fft._dft_mats(n) if forward else mxu_fft._idft_mats(n)
        mr, mi, mri = cplx_triple(n, forward)
        np.testing.assert_array_equal(mr, ref[0])
        np.testing.assert_array_equal(mi, ref[1])
        np.testing.assert_array_equal(
            mri, np.asarray(jnp.asarray(ref[0]) + jnp.asarray(ref[1])))


@pytest.mark.parametrize("shape", SHAPES + [(48, 1072, 272), (136, 136, 136)])
def test_x_mats_and_stage_axes_equal_the_jax_plan(shape, jax_v1):
    jplan = mxu_fft.MatmulFFT3(shape, precision=jax.lax.Precision.HIGHEST)
    assert jplan._v2 is None
    plan = MatmulFFT3(shape, "cpu")
    assert not plan.v2 and plan.kxp == jplan.kxp
    fx, ix = rfft_x_mats(shape[2], plan.kxp)
    np.testing.assert_array_equal(fx, np.asarray(jplan._fx_p))
    np.testing.assert_array_equal(ix, np.asarray(jplan._ix_p))
    kx = shape[2] // 2 + 1
    for block in (fx[:, kx:plan.kxp], fx[:, plan.kxp + kx:],
                  ix[kx:plan.kxp], ix[plan.kxp + kx:]):
        assert not block.any()   # the padded frequencies are exact zeros
    z, y = stage_axes(shape)
    assert {n for n, on in zip(shape[:2], (z, y)) if on} == set(jplan._kern)


@pytest.mark.parametrize("shape,psf", [
    ((248, 1100, 1100), (9, 9, 9)), ((128, 128, 128), (9, 5, 5)),
    ((100, 101, 97), (11, 11, 11)), ((250, 60, 7), (5, 5, 5)),
])
def test_plan_shape_and_fft_shape_for_equal_jax(shape, psf, monkeypatch):
    assert plan_shape(shape, psf) == mxu_fft.plan_shape(shape, psf)
    monkeypatch.setattr(dj, "_RESOLVED_FFT", "mxu")
    mxu = tuple(dj.fft_shape_for(shape, psf))
    assert dp.fft_shape_for(shape, psf, "cpu", route="walk1") == mxu
    assert dp.fft_shape_for(shape, psf, torch.device("cuda"),
                            route="walk1") == mxu
    monkeypatch.setattr(dj, "_RESOLVED_FFT", "xla")
    xla = tuple(dj.fft_shape_for(shape, psf))
    assert dp.fft_shape_for(shape, psf, "cpu") == xla
    # the reference's non-TPU rule holds on the card too
    assert dp.fft_shape_for(shape, psf, torch.device("cuda")) == xla
    assert dp.fft_shape_for(shape, psf, torch.device("cuda"),
                            route="fft") == xla


@pytest.mark.parametrize("shape,cpu,cuda_", [
    ((256, 16, 256), "walk", "walk"), ((48, 1072, 272), "fft", "fft"),
    ((136, 136, 136), "fft", "fft"), ((256, 1152, 1152), "fft", "fft"),
])
def test_three_routes(shape, cpu, cuda_):
    assert dp.conv_route(shape, torch.device("cpu")) == cpu
    assert dp.conv_route(shape, torch.device("cuda")) == cuda_
    assert dp.conv_route(shape, torch.device("cpu"), route="walk1") == "walk1"
    assert dp.conv_route(shape, torch.device("cuda"), route="fft") == "fft"
    with pytest.raises(ValueError):
        dp.conv_route(shape, torch.device("cpu"), route="walk2")


# -- kernels' plain versions vs the Pallas kernels -------------------------------

@pytest.mark.parametrize("n,forward", [(40, True), (40, False), (136, True),
                                       (24, False)])
def test_cplx_matmul_plain_matches_fused_call(n, forward, rng):
    re = rng.random((6, 8, n)).astype(np.float32)
    im = rng.random((6, 8, n)).astype(np.float32)
    mats = cplx_triple(n, forward)
    ref = pf.fused_cplx_matmul(jnp.asarray(re), jnp.asarray(im),
                               tuple(jnp.asarray(m) for m in mats),
                               interpret=True)
    got = cf.cplx_matmul(t(re.reshape(-1, n)), t(im.reshape(-1, n)),
                         *map(t, mats))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy().reshape(6, 8, n), np.asarray(r),
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("n", [256, 512])
def test_inverse_last_axis_stage_plain_matches_pallas(n, rng):
    re = (rng.random((512, n)) - 0.5).astype(np.float32)
    im = (rng.random((512, n)) - 0.5).astype(np.float32)
    hi, lo = pf.prep_stage_mats(n)[1]
    ref = pf._fused_stage_call(re, im, hi, lo, False, interpret=True)
    cf.reset_launch_counts()
    got = cf.radix2_stage(t(re), t(im), *map(t, stage_mats_t(n, False)),
                          False, -1)
    assert set(cf.LAUNCHES.values()) == {0}    # the CPU takes the plain form
    for g, r in zip(got, ref):
        assert rel(g.numpy(), r) <= 1e-5


# -- the v1 walk ------------------------------------------------------------------

def _numpy_conv(x, k, conj=False, num=None, mul=None):
    if num is not None:
        x = num / np.maximum(x, np.finfo(np.float32).eps)
    fk = np.fft.rfftn(k)
    out = np.fft.irfftn((np.conj(fk) if conj else fk) * np.fft.rfftn(x),
                        s=x.shape, axes=(0, 1, 2))
    return np.abs(mul * out) if mul is not None else out


@pytest.mark.parametrize("shape", SHAPES)
def test_v1_convolve_matches_jax_and_numpy(shape, rng, jax_v1):
    x = (rng.random(shape) * 100 + 1).astype(np.float32)
    num = (rng.random(shape) * 100 + 1).astype(np.float32)
    mul = rng.random(shape).astype(np.float32)
    k = rng.random(shape).astype(np.float32)
    jplan = mxu_fft.MatmulFFT3(shape, precision=jax.lax.Precision.HIGHEST)
    jotf = jplan.otf_packed(jnp.asarray(k))
    plan = MatmulFFT3(shape, "cpu")
    otf = plan.otf_packed(t(k))
    assert otf[0].shape == tuple(jotf[0].shape)
    assert otf[0].dtype == torch.float32
    # re and im together, against the spectrum's largest value (the
    # stages' bf16 error scales with it)
    assert rel(np.stack([o.numpy() for o in otf]), np.stack(jotf)) <= 1e-4
    forms = [dict(), dict(conj=True),
             dict(conj=True, ratio_num=num, mul_abs=mul)]
    for kw in forms:
        got = plan.convolve(t(x), otf, **{
            k_: (t(v) if isinstance(v, np.ndarray) else v)
            for k_, v in kw.items()}).numpy()
        twin = np.asarray(jplan.convolve(jnp.asarray(x), jotf, **{
            k_: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
            for k_, v in kw.items()}))
        ref = _numpy_conv(x, k, conj=kw.get("conj", False),
                          num=kw.get("ratio_num"), mul=kw.get("mul_abs"))
        assert rel(got, ref) <= 1e-4, kw.keys()
        assert rel(got, twin) <= 1e-4, kw.keys()
    # the reference's packed OTF drives the port's convolve
    otf_j = load_packed_otf(np.asarray(jotf[0]), np.asarray(jotf[1]), "cpu")
    for conj in (False, True):
        assert rel(plan.convolve(t(x), otf_j, conj=conj).numpy(),
                   plan.convolve(t(x), otf, conj=conj).numpy()) <= 1e-4


@pytest.mark.parametrize("shape", SHAPES)
def test_v1_batch_equals_the_per_block_walk(shape, rng):
    x = (rng.random((2,) + shape) * 100 + 1).astype(np.float32)
    k = rng.random(shape).astype(np.float32)
    plan = MatmulFFT3(shape, "cpu")
    otf = plan.otf_packed(t(k))
    got = plan.convolve(t(x), otf, conj=True, ratio_num=t(x), mul_abs=t(x))
    for b in range(2):
        one = plan.convolve(t(x[b]), otf, conj=True, ratio_num=t(x[b]),
                            mul_abs=t(x[b]))
        assert rel(got[b].numpy(), one.numpy()) <= 1e-6


def test_edge_taper_on_the_v1_walk_matches_jax(rng, jax_v1, monkeypatch):
    """The face-slab taper as the CUDA device runs it: every slab blur on
    the v1 walk, against the reference's MXU branch."""
    vol = (rng.random((48, 56, 64)) * 1000).astype(np.float32)
    psf = gaussian_psf((7, 9, 9), (1.5, 2.0, 2.0))
    monkeypatch.setattr(dj, "_RESOLVED_FFT", "mxu")
    ref = np.asarray(dj.edge_taper_3d(vol, psf))
    routes = []

    def walk1(shape, device, route=None):
        routes.append(tuple(shape))
        return "walk1"

    monkeypatch.setattr(dp, "conv_route", walk1)
    got = dp.edge_taper_3d(t(vol), t(psf)).numpy()
    assert len(routes) == 6
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=0.05)


@pytest.mark.parametrize("route,taper", [
    (None, None), ("walk", None), ("walk1", "walk1"), ("fft", "fft")])
def test_rl_route_reaches_the_taper_blurs(route, taper, rng, monkeypatch):
    """A forced "fft" or "walk1" holds for the edge taper's blurs too (so
    a forced torch.fft run shares no kernel with the walks); "walk" and
    the default leave the blurs to their own work shapes."""
    seen = []
    real = dp.conv_route

    def spy(shape, device, route=None):
        seen.append(route)
        return real(shape, device, route)

    monkeypatch.setattr(dp, "conv_route", spy)
    vol = (rng.random((248, 8, 248)) * 1000).astype(np.float32)
    psf = gaussian_psf((5, 5, 5), (1.0, 1.0, 1.0))
    out = dp.richardson_lucy(vol, psf, niter=1, fft_shape=(256, 16, 256),
                             device="cpu", route=route)
    assert out.shape == vol.shape
    assert len(seen) >= 2 and seen[-1] == route   # the last: the RL loop's
    assert set(seen[:-1]) == {taper}


@pytest.mark.parametrize("classic", [True, False], ids=["classic", "reference"])
def test_richardson_lucy_walk1_matches_jax_mxu(classic, rng, jax_v1,
                                                monkeypatch):
    vol = (rng.random((248, 56, 24)) * 1000).astype(np.float32)
    psf = gaussian_psf((5, 5, 5), (1.0, 1.0, 1.0))
    monkeypatch.setattr(dj, "_RESOLVED_FFT", "mxu")
    shape = dj.fft_shape_for(vol.shape, psf.shape)
    assert tuple(shape) == (256, 64, 32)
    assert stage_axes(shape) == (True, False)   # K3/K6 on z, K7 on y
    ref = np.asarray(dj.richardson_lucy(vol, psf, niter=4, classic=classic))
    got = dp.richardson_lucy(vol, psf, niter=4, classic=classic,
                             device="cpu", route="walk1").numpy()
    assert got.shape == vol.shape
    np.testing.assert_allclose(got[INNER], ref[INNER], rtol=2e-3, atol=2e-1)


# -- on the card --------------------------------------------------------------------

@pytest.mark.gpu
def test_k6_and_k7_match_plain_on_the_card(cuda, rng):
    def d(*s):
        return t(rng.random(s) - 0.5).to(cuda)

    cf.reset_launch_counts()
    pairs = []
    for rows, n in ((1536, 256), (4096, 512)):
        re, im = d(rows, n), d(rows, n)
        mats = [m.to(cuda) for m in map(t, stage_mats_t(n, False))]
        pairs.append((cf.radix2_stage(re, im, *mats, False, -1),
                      cf.radix2_stage_plain(re, im, *mats, False, -1)))
    for rows, n, forward in ((6912, 40, True), (1000, 136, False),
                             (333, 1072, True)):
        re, im = d(rows, n), d(rows, n)
        mats = [m.to(cuda) for m in map(t, cplx_triple(n, forward))]
        ref = cf.cplx_matmul_plain(re, im, *mats)
        pairs.append((cf.cplx_matmul(re, im, *mats, dft=forward), ref))
        pairs.append((cf.cplx_matmul(re, im, *mats), ref))   # any matrix
    torch.cuda.synchronize()
    assert cf.LAUNCHES["radix2_stage_inv_last"] == 2
    assert cf.LAUNCHES["cplx_matmul"] == 3           # the FFT kernel
    assert cf.LAUNCHES["cplx_matmul_dense"] == 3     # the dense kernel
    for got, ref in pairs:
        for g, r in zip(got, ref):
            assert rel(g.cpu().numpy(), r.cpu().numpy()) <= 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("shape", SHAPES)
def test_v1_convolve_on_the_card_matches_numpy(shape, cuda, rng):
    x = (rng.random(shape) * 100 + 1).astype(np.float32)
    k = rng.random(shape).astype(np.float32)
    plan = MatmulFFT3(shape, cuda)
    cf.reset_launch_counts()
    got = plan.convolve(t(x).to(cuda), plan.otf_packed(t(k).to(cuda)))
    z, y = stage_axes(shape)
    assert cf.LAUNCHES["cplx_matmul"] == 3 * ((not z) + (not y))
    assert cf.LAUNCHES["cplx_matmul_dense"] == 0
    assert cf.LAUNCHES["radix2_stage_inv_last"] == int(z)
    assert cf.LAUNCHES["radix2_stage_inv_otf"] == int(y)
    assert cf.LAUNCHES["radix2_stage"] == 2 * (z + y)
    assert rel(got.cpu().numpy(), _numpy_conv(x, k)) <= 1e-4
