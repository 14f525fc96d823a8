"""The FFT walk of ipp_tpu_torch against the JAX Pallas walk.

Plain versions of the four CUDA kernels against their Pallas twins (run in
interpret mode, as tests/test_deconv.py runs them), the port's convolve
against numpy FFT convolution and the JAX v2 walk, the OTF hand-over, the
shape routing, and (on a CUDA card only) each kernel against its plain
version.  Tolerances: rel <= 1e-4 of the largest reference value, the
bound of the JAX walk's own tests (the Pallas kernels multiply in 3-pass
bf16, ~1e-5); kernel vs plain on the card: 1e-5 (both f32)."""

import jax
import numpy as np
import pytest
import torch

from ipp_tpu.ops import pallas_fft as pf
from ipp_tpu_torch.ops import cuda_fft as cf
from ipp_tpu_torch.ops import deconv as dc
from ipp_tpu_torch.ops.dft_mats import rfft_fold_mats, stage_mats_t
from ipp_tpu_torch.ops.matmul_fft import (MatmulFFT3, in_kernel_domain,
                                          load_packed_otf)


def rel(a, ref):
    a, ref = np.asarray(a), np.asarray(ref)
    return float(np.abs(a - ref).max() / np.abs(ref).max())


def t(a):
    return torch.from_numpy(np.array(a, np.float32))


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


# -- plain versions vs Pallas twins -------------------------------------------

NZ, NY, NX = 16, 16, 256          # t-layout shape: kp = 16, stage m = 8
KP = 16
ROWS, N = 512, 256                # last-axis stage: one STAGE_TM row tile


def _vol(rng, *shape, lo=0.0):
    return (rng.random(shape) + lo).astype(np.float32)


CASES = ["rfft", "rfft_ratio", "irfft", "irfft_mul", "stage_z_fwd",
         "stage_z_inv", "stage_x_fwd", "stage_x_inv_otf",
         "stage_x_inv_otf_conj"]


@pytest.mark.parametrize("case", CASES)
def test_plain_matches_pallas_twin(case, rng):
    x, den, mul = (_vol(rng, NZ, NY, NX), _vol(rng, NZ, NY, NX, lo=0.5),
                   _vol(rng, NZ, NY, NX))
    sr, si = _vol(rng, KP, NZ, NX, lo=-0.5), _vol(rng, KP, NZ, NX, lo=-0.5)
    r2, i2, o_r, o_i = (_vol(rng, ROWS, N, lo=-0.5) for _ in range(4))
    fwd, inv = rfft_fold_mats(NY, KP)
    (fhi, flo), (ihi, ilo) = pf.prep_v2_rfft_mats(NY, KP)
    if case.startswith("rfft"):
        if case == "rfft":
            ref = pf._v2_rfft_call_t(x, fhi, flo, interpret=True)
            got = cf.rdft_y_fwd(t(x), t(fwd))
        else:
            ref = pf._v2_rfft_ratio_call_t(x, den, fhi, flo, interpret=True)
            got = cf.rdft_y_fwd(t(x), t(fwd), den=t(den))
    elif case.startswith("irfft"):
        if case == "irfft":
            ref = (pf._v2_irfft_call_t(sr, si, ihi, ilo, NY, interpret=True),)
            got = (cf.rdft_y_inv(t(sr), t(si), t(inv)),)
        else:
            ref = (pf._v2_irfft_mul_call_t(sr, si, mul, ihi, ilo, NY,
                                           interpret=True),)
            got = (cf.rdft_y_inv(t(sr), t(si), t(inv), mul=t(mul)),)
    elif case.startswith("stage_z"):
        fwd_ = case.endswith("fwd")
        hi, lo = pf.prep_v2_stage_mats(NZ)[0 if fwd_ else 1]
        ref = pf._v2_stage_call(sr, si, hi, lo, fwd_, interpret=True)
        got = cf.radix2_stage(t(sr), t(si), *map(t, stage_mats_t(NZ, fwd_)),
                              fwd_, 1)
    elif case == "stage_x_fwd":
        hi, lo = pf.prep_stage_mats(N)[0]
        ref = pf._fused_stage_call(r2, i2, hi, lo, True, interpret=True)
        got = cf.radix2_stage(t(r2), t(i2), *map(t, stage_mats_t(N, True)),
                              True, -1)
    else:
        conj = case.endswith("conj")
        hi, lo = pf.prep_stage_mats(N)[1]
        ref = pf._fused_stage_otf_call(r2, i2, o_r, o_i, hi, lo, conj,
                                       interpret=True)
        got = cf.radix2_stage_inv_otf(t(r2), t(i2), t(o_r), t(o_i),
                                      *map(t, stage_mats_t(N, False)), conj)
    for g, r in zip(got, ref):
        assert g.shape == tuple(r.shape)
        assert rel(g.numpy(), r) <= 1e-4, case


# -- the walk --------------------------------------------------------------------

def _numpy_conv(x, k, conj=False, num=None, mul=None):
    shape = x.shape
    if num is not None:
        x = num / np.maximum(x, np.finfo(np.float32).eps)
    fk = np.fft.rfftn(k)
    out = np.fft.irfftn((np.conj(fk) if conj else fk) * np.fft.rfftn(x),
                        s=shape, axes=(0, 1, 2))
    return np.abs(mul * out) if mul is not None else out


@pytest.mark.parametrize("shape", [(256, 16, 256), (256, 8, 768)])
def test_convolve_matches_numpy_and_jax_walk(shape, rng, monkeypatch):
    import jax.numpy as jnp

    from ipp_tpu.ops.mxu_fft import MatmulFFT3 as JaxPlan

    monkeypatch.setenv("IPP_TPU_FFT_V2", "1")
    x = (rng.random(shape) * 100 + 1).astype(np.float32)
    num = (rng.random(shape) * 100 + 1).astype(np.float32)
    mul = rng.random(shape).astype(np.float32)
    k = rng.random(shape).astype(np.float32)
    jplan = JaxPlan(shape, precision=jax.lax.Precision.HIGHEST)
    assert jplan._v2 is not None and jplan._v2["t"]
    jotf = jplan.otf_packed(jnp.asarray(k))
    plan = MatmulFFT3(shape, "cpu")
    otf = plan.otf_packed(t(k))
    forms = [dict(), dict(conj=True),
             dict(conj=True, ratio_num=num, mul_abs=mul)]
    for kw in forms:
        got = plan.convolve(t(x), otf, **{
            k_: (t(v) if isinstance(v, np.ndarray) else v)
            for k_, v in kw.items()}).numpy()
        ref = _numpy_conv(x, k, conj=kw.get("conj", False),
                          num=kw.get("ratio_num"), mul=kw.get("mul_abs"))
        twin = np.asarray(jplan.convolve(jnp.asarray(x), jotf, **{
            k_: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
            for k_, v in kw.items()}))
        assert rel(got, ref) <= 1e-4, kw.keys()
        assert rel(got, twin) <= 1e-4, kw.keys()


def test_jax_otf_drives_the_port_convolve(rng, monkeypatch):
    import jax.numpy as jnp

    from ipp_tpu.ops.mxu_fft import MatmulFFT3 as JaxPlan

    monkeypatch.setenv("IPP_TPU_FFT_V2", "1")
    shape = (256, 16, 256)
    x = (rng.random(shape) * 100 + 1).astype(np.float32)
    k = rng.random(shape).astype(np.float32)
    jre, jim = JaxPlan(shape, precision=jax.lax.Precision.HIGHEST
                       ).otf_packed(jnp.asarray(k))
    plan = MatmulFFT3(shape, "cpu")
    otf_j = load_packed_otf(np.asarray(jre), np.asarray(jim), "cpu")
    own = plan.otf_packed(t(k))
    assert otf_j[0].shape == own[0].shape == (plan.kp,) + shape[:1] + shape[2:]
    assert rel(otf_j[0].numpy(), own[0].numpy()) <= 1e-4
    for conj in (False, True):
        a = plan.convolve(t(x), otf_j, conj=conj).numpy()
        b = plan.convolve(t(x), own, conj=conj).numpy()
        assert rel(a, b) <= 1e-4


# -- routing and wrapper rules -------------------------------------------------

@pytest.mark.parametrize("shape,inside", [
    ((256, 16, 256), True), ((256, 8, 768), True), ((512, 1056, 256), True),
    ((256, 2048, 256), True), ((256, 2056, 256), False),
    ((128, 16, 256), False), ((256, 16, 200), False), ((256, 12, 256), False),
    ((72, 72, 80), False),
])
def test_route_by_shape(shape, inside):
    assert in_kernel_domain(shape) is inside
    assert dc.conv_route(shape, torch.device("cpu")) == \
        ("walk" if inside else "fft")
    if not inside:
        with pytest.raises(ValueError):
            dc.conv_route(shape, torch.device("cpu"), route="walk")
    # any shape builds a plan: the v2 walk inside the domain, v1 outside
    assert MatmulFFT3(shape, "cpu").v2 is inside


def test_cpu_calls_take_plain_versions_and_count_nothing(rng):
    cf.reset_launch_counts()
    x = t(_vol(rng, NZ, NY, NX))
    fwd, _ = rfft_fold_mats(NY, KP)
    re, im = cf.rdft_y_fwd(x, t(fwd))
    ref = cf.rdft_y_fwd_plain(x, t(fwd))
    assert torch.equal(re, ref[0]) and torch.equal(im, ref[1])
    assert set(cf.LAUNCHES.values()) == {0}


def test_wrappers_refuse_devices_they_cannot_launch_on():
    x = torch.empty((NZ, NY, NX), device="meta")
    fwd = torch.empty((2 * KP, NY), device="meta")
    with pytest.raises(ValueError):
        cf.rdft_y_fwd(x, fwd)
    with pytest.raises(ValueError):
        cf.radix2_stage(x, x, fwd, fwd, True, axis=2)


# -- on the card ------------------------------------------------------------------

@pytest.mark.gpu
def test_kernels_match_plain_on_the_card(cuda, rng):
    shape = (256, 24, 256)
    plan = MatmulFFT3(shape, cuda)
    nz, ny, nx = shape
    kp = plan.kp

    def d(*s, lo=0.0):
        return t(_vol(rng, *s, lo=lo)).to(cuda)

    x, den, mul = d(nz, ny, nx), d(nz, ny, nx, lo=0.5), d(nz, ny, nx)
    sr, si = d(kp, nz, nx, lo=-0.5), d(kp, nz, nx, lo=-0.5)
    r2, i2, o_r, o_i = (d(kp * nz, nx, lo=-0.5) for _ in range(4))
    # the plan holds no stage matrices on the card (its stage kernels read
    # none); the plain versions get their own
    mz, mx = ({f: tuple(t(m).to(cuda) for m in stage_mats_t(n, f))
               for f in (True, False)} for n in (nz, nx))
    pairs = [
        (cf.rdft_y_fwd(x, plan._rfwd, den, fold=True),
         cf.rdft_y_fwd_plain(x, plan._rfwd, den)),
        ((cf.rdft_y_inv(sr, si, plan._rinv, mul, fold=True),),
         (cf.rdft_y_inv_plain(sr, si, plan._rinv, mul),)),
        (cf.radix2_stage(sr, si, *plan._z[True], True, 1),
         cf.radix2_stage_plain(sr, si, *mz[True], True, 1)),
        (cf.radix2_stage(sr, si, *plan._z[False], False, 1),
         cf.radix2_stage_plain(sr, si, *mz[False], False, 1)),
        (cf.radix2_stage(r2, i2, *plan._x[True], True, -1),
         cf.radix2_stage_plain(r2, i2, *mx[True], True, -1)),
        (cf.radix2_stage_inv_otf(r2, i2, o_r, o_i, *plan._x[False], True),
         cf.radix2_stage_inv_otf_plain(r2, i2, o_r, o_i, *mx[False],
                                       True)),
    ]
    torch.cuda.synchronize()
    for got, ref in pairs:
        for g, r in zip(got, ref):
            assert rel(g.cpu().numpy(), r.cpu().numpy()) <= 1e-5


@pytest.mark.gpu
def test_walk_convolve_on_the_card_matches_numpy(cuda, rng):
    shape = (256, 16, 512)
    x = (rng.random(shape) * 100 + 1).astype(np.float32)
    k = rng.random(shape).astype(np.float32)
    plan = MatmulFFT3(shape, cuda)
    cf.reset_launch_counts()
    got = plan.convolve(t(x).to(cuda), plan.otf_packed(t(k).to(cuda)))
    assert cf.LAUNCHES == {"rdft_y_fwd": 2, "rdft_y_inv": 1,
                           "radix2_stage": 5, "radix2_stage_inv_otf": 1,
                           "rdft_y_fwd_batched": 0, "rdft_y_inv_batched": 0,
                           "radix2_stage_inv_otf_batched": 0,
                           "radix2_stage_inv_last": 0, "cplx_matmul": 0,
                           "radix2_stage_dense": 0,
                           "radix2_stage_inv_otf_dense": 0,
                           "radix2_stage_inv_otf_batched_dense": 0,
                           "radix2_stage_inv_last_dense": 0,
                           "cplx_matmul_dense": 0, "rdft_y_fwd_dense": 0,
                           "rdft_y_inv_dense": 0,
                           "rdft_y_fwd_batched_dense": 0,
                           "rdft_y_inv_batched_dense": 0}
    assert rel(got.cpu().numpy(), _numpy_conv(x, k)) <= 1e-4
