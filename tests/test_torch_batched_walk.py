"""The batched FFT walk of ipp_tpu_torch against the JAX Pallas walk.

The plain versions of the batched kernel forms (K1, K2 on a batch; K4 with
one OTF wrapped over the batch) against the reference's non-`t` Pallas
kernels in interpret mode, as tests/test_deconv.py runs them; the port's
batched convolve against the JAX v2 walk with a leading batch dim, numpy,
and the port's own per-block walk; and (on a CUDA card only) each batched
kernel form against its plain version.  The JAX kernels write plane-major
(B*nz, kp, X) spectra; they are brought to the port's per-block kp-major
(B, kp, nz, X) layout before the comparison.  Tolerances: rel <= 1e-4 of
the largest reference value, the bound of the JAX walk's own tests (its
Pallas kernels multiply in 3-pass bf16, ~1e-5); the port's batched walk
against its per-block walk: rel <= 1e-6 (the same f32 arithmetic per
block); kernel vs plain on the card: 1e-5 (both f32)."""

import numpy as np
import pytest
import torch

from ipp_tpu.ops import pallas_fft as pf
from ipp_tpu_torch.ops import cuda_fft as cf
from ipp_tpu_torch.ops.dft_mats import rfft_fold_mats, stage_mats_t
from ipp_tpu_torch.ops.matmul_fft import MatmulFFT3

B, NZ, NY, NX = 2, 256, 16, 256     # A = B * NZ = 512 planes
KP = 16
ROWS, N = 512, 256                  # one block's OTF rows: one STAGE_TM tile


def rel(a, ref):
    a, ref = np.asarray(a), np.asarray(ref)
    return float(np.abs(a - ref).max() / np.abs(ref).max())


def t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _vol(rng, *shape, lo=0.0):
    return (rng.random(shape) + lo).astype(np.float32)


def to_port(a):
    """(B*nz, kp, X) plane-major -> (B, kp, nz, X) kp-major per block."""
    a = np.asarray(a)
    return a.reshape(B, NZ, a.shape[1], a.shape[2]).swapaxes(1, 2)


def to_jax(a):
    """(B, kp, nz, X) -> (B*nz, kp, X)."""
    return np.ascontiguousarray(np.swapaxes(a, 1, 2)).reshape(
        B * NZ, a.shape[1], a.shape[3])


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


# -- plain batched forms vs the non-`t` Pallas kernels ---------------------

@pytest.mark.parametrize("case", ["rfft", "rfft_ratio", "irfft", "irfft_mul"])
def test_batched_plain_matches_pallas_twin(case, rng):
    x = _vol(rng, B, NZ, NY, NX)
    den = _vol(rng, B, NZ, NY, NX, lo=0.5)
    mul = _vol(rng, B, NZ, NY, NX)
    sr, si = _vol(rng, B, KP, NZ, NX, lo=-0.5), _vol(rng, B, KP, NZ, NX,
                                                     lo=-0.5)
    fwd, inv = rfft_fold_mats(NY, KP)
    (fhi, flo), (ihi, ilo) = pf.prep_v2_rfft_mats(NY, KP)
    planes = (B * NZ, NY, NX)
    if case == "rfft":
        ref = [to_port(r) for r in pf._v2_rfft_call(
            x.reshape(planes), fhi, flo, interpret=True)]
        got = cf.rdft_y_fwd_batched(t(x), t(fwd))
    elif case == "rfft_ratio":
        ref = [to_port(r) for r in pf._v2_rfft_ratio_call(
            x.reshape(planes), den.reshape(planes), fhi, flo,
            interpret=True)]
        got = cf.rdft_y_fwd_batched(t(x), t(fwd), den=t(den))
    elif case == "irfft":
        ref = [np.asarray(pf._v2_irfft_call(
            to_jax(sr), to_jax(si), ihi, ilo, NY,
            interpret=True)).reshape(B, NZ, NY, NX)]
        got = (cf.rdft_y_inv_batched(t(sr), t(si), t(inv)),)
    else:
        ref = [np.asarray(pf._v2_irfft_mul_call(
            to_jax(sr), to_jax(si), mul.reshape(planes), ihi, ilo, NY,
            interpret=True)).reshape(B, NZ, NY, NX)]
        got = (cf.rdft_y_inv_batched(t(sr), t(si), t(inv), mul=t(mul)),)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        assert rel(g.numpy(), r) <= 1e-4, case


@pytest.mark.parametrize("conj", [False, True], ids=["otf", "conj"])
def test_batched_k4_wraps_one_otf_like_the_pallas_twin(conj, rng):
    r2, i2 = (_vol(rng, B * ROWS, N, lo=-0.5) for _ in range(2))
    o_r, o_i = (_vol(rng, ROWS, N, lo=-0.5) for _ in range(2))
    kern = pf.prep_stage_mats(N)
    ref = pf.fused_stage_inv_otf(r2.reshape(B, ROWS, N),
                                 i2.reshape(B, ROWS, N), o_r, o_i, kern,
                                 conj, interpret=True)
    got = cf.radix2_stage_inv_otf_batched(
        t(r2), t(i2), t(o_r), t(o_i), *map(t, stage_mats_t(N, False)), conj)
    for g, r in zip(got, ref):
        assert rel(g.numpy(), np.asarray(r).reshape(B * ROWS, N)) <= 1e-4
    # and each block equals the unbatched K4 with that block's rows
    for b in range(B):
        one = cf.radix2_stage_inv_otf(
            t(r2[b * ROWS:(b + 1) * ROWS]), t(i2[b * ROWS:(b + 1) * ROWS]),
            t(o_r), t(o_i), *map(t, stage_mats_t(N, False)), conj)
        for g, o in zip(got, one):
            assert rel(g[b * ROWS:(b + 1) * ROWS].numpy(), o.numpy()) <= 1e-6


def test_batched_wrappers_check_their_shapes(rng):
    fwd, inv = rfft_fold_mats(NY, KP)
    x3 = t(_vol(rng, NZ, NY, NX))
    with pytest.raises(ValueError, match="nb, nz, ny, nx"):
        cf.rdft_y_fwd_batched(x3, t(fwd))
    with pytest.raises(ValueError, match="nz, ny, nx"):
        cf.rdft_y_fwd(x3[None], t(fwd))
    with pytest.raises(ValueError, match="nb, kp, nz, nx"):
        cf.rdft_y_inv_batched(t(_vol(rng, KP, NZ, NX)),
                              t(_vol(rng, KP, NZ, NX)), t(inv))
    meta = torch.empty((3 * 8, 256), device="meta")
    with pytest.raises(ValueError):
        cf.radix2_stage_inv_otf_batched(meta, meta, meta[:8], meta[:8],
                                        meta, meta, False)


# -- the batched walk ---------------------------------------------------------

def _numpy_conv(x, k, conj=False, num=None, mul=None):
    shape = x.shape[-3:]
    if num is not None:
        x = num / np.maximum(x, np.finfo(np.float32).eps)
    fk = np.fft.rfftn(k)
    out = np.fft.irfftn((np.conj(fk) if conj else fk)
                        * np.fft.rfftn(x, axes=(-3, -2, -1)),
                        s=shape, axes=(-3, -2, -1))
    return np.abs(mul * out) if mul is not None else out


FORMS = {"conv": {}, "conj_ratio": dict(conj=True, ratio=True),
         "mul_abs": dict(conj=True, ratio=True, mul=True)}


@pytest.mark.parametrize("form", list(FORMS))
def test_batched_convolve_matches_jax_walk_numpy_and_per_block(
        form, rng, monkeypatch):
    import jax
    import jax.numpy as jnp

    from ipp_tpu.ops.mxu_fft import MatmulFFT3 as JaxPlan

    monkeypatch.setenv("IPP_TPU_FFT_V2", "1")
    monkeypatch.setenv("IPP_TPU_FFT_KERNEL", "1")
    shape = (NZ, NY, NX)
    x = (rng.random((B,) + shape) * 100 + 1).astype(np.float32)
    num = (rng.random((B,) + shape) * 100 + 1).astype(np.float32)
    mul = rng.random((B,) + shape).astype(np.float32)
    k = rng.random(shape).astype(np.float32)
    f = FORMS[form]
    conj = f.get("conj", False)
    kw = dict(conj=conj, ratio_num=num if f.get("ratio") else None,
              mul_abs=mul if f.get("mul") else None)

    jplan = JaxPlan(shape, precision=jax.lax.Precision.HIGHEST)
    assert jplan._v2 is not None
    twin = np.asarray(jplan.convolve(
        jnp.asarray(x), jplan.otf_packed(jnp.asarray(k)),
        **{a: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
           for a, v in kw.items()}))

    plan = MatmulFFT3(shape, "cpu")
    otf = plan.otf_packed(t(k))
    assert otf[0].shape == (plan.kp, NZ, NX)        # one block's OTF
    cf.reset_launch_counts()
    got = plan.convolve(t(x), otf, **{
        a: (t(v) if isinstance(v, np.ndarray) else v)
        for a, v in kw.items()}).numpy()
    assert set(cf.LAUNCHES.values()) == {0}       # CPU: plain versions
    ref = _numpy_conv(x, k, conj=conj, num=kw["ratio_num"],
                      mul=kw["mul_abs"])
    assert got.shape == (B,) + shape
    assert rel(got, ref) <= 1e-4
    assert rel(got, twin) <= 1e-4
    for b in range(B):
        one = plan.convolve(t(x[b]), otf, **{
            a: (t(v[b]) if isinstance(v, np.ndarray) else v)
            for a, v in kw.items()}).numpy()
        assert rel(got[b], one) <= 1e-6, b


def test_walk_takes_any_leading_batch_dims(rng):
    shape = (NZ, NY, NX)
    x = t(rng.random((2, 1) + shape))
    k = t(rng.random(shape))
    plan = MatmulFFT3(shape, "cpu")
    otf = plan.otf_packed(k)
    got = plan.convolve(x, otf)
    assert got.shape == (2, 1) + shape
    flat = plan.convolve(x.reshape((2,) + shape), otf)
    assert torch.equal(got.reshape(flat.shape), flat)


# -- on the card ----------------------------------------------------------------

@pytest.mark.gpu
def test_batched_kernels_match_plain_on_the_card(cuda, rng):
    shape = (256, 24, 256)
    plan = MatmulFFT3(shape, cuda)
    nz, ny, nx = shape
    kp, nb = plan.kp, 3

    def d(*s, lo=0.0):
        return t(_vol(rng, *s, lo=lo)).to(cuda)

    x, den, mul = (d(nb, nz, ny, nx), d(nb, nz, ny, nx, lo=0.5),
                   d(nb, nz, ny, nx))
    sr, si = d(nb, kp, nz, nx, lo=-0.5), d(nb, kp, nz, nx, lo=-0.5)
    r2, i2 = sr.view(-1, nx), si.view(-1, nx)
    o_r, o_i = d(kp * nz, nx, lo=-0.5), d(kp * nz, nx, lo=-0.5)
    # the plan holds no stage matrices on the card; the plain version's
    ix = tuple(t(m).to(cuda) for m in stage_mats_t(nx, False))
    cf.reset_launch_counts()
    pairs = [
        (cf.rdft_y_fwd_batched(x, plan._rfwd, den, fold=True),
         cf.rdft_y_fwd_plain(x, plan._rfwd, den)),
        (cf.rdft_y_fwd_batched(x, plan._rfwd, fold=True),
         cf.rdft_y_fwd_plain(x, plan._rfwd)),
        ((cf.rdft_y_inv_batched(sr, si, plan._rinv, mul, fold=True),),
         (cf.rdft_y_inv_plain(sr, si, plan._rinv, mul),)),
        ((cf.rdft_y_inv_batched(sr, si, plan._rinv, fold=True),),
         (cf.rdft_y_inv_plain(sr, si, plan._rinv),)),
    ] + [
        (cf.radix2_stage_inv_otf_batched(r2, i2, o_r, o_i, *plan._x[False],
                                         conj),
         cf.radix2_stage_inv_otf_plain(r2, i2, o_r, o_i, *ix, conj))
        for conj in (False, True)]
    torch.cuda.synchronize()
    assert cf.LAUNCHES["rdft_y_fwd_batched"] == 2
    assert cf.LAUNCHES["rdft_y_inv_batched"] == 2
    assert cf.LAUNCHES["radix2_stage_inv_otf_batched"] == 2
    for got, ref in pairs:
        for g, r in zip(got, ref):
            assert rel(g.cpu().numpy(), r.cpu().numpy()) <= 1e-5


@pytest.mark.gpu
def test_batched_walk_on_the_card_equals_the_per_block_walk(cuda, rng):
    shape = (256, 16, 512)
    x = t(rng.random((2,) + shape) * 100 + 1).to(cuda)
    k = t(rng.random(shape)).to(cuda)
    plan = MatmulFFT3(shape, cuda)
    otf = plan.otf_packed(k)
    cf.reset_launch_counts()
    got = plan.convolve(x, otf, conj=True, ratio_num=x, mul_abs=x)
    assert cf.LAUNCHES == {
        "rdft_y_fwd": 0, "rdft_y_inv": 0, "radix2_stage": 3,
        "radix2_stage_inv_otf": 0, "rdft_y_fwd_batched": 1,
        "rdft_y_inv_batched": 1, "radix2_stage_inv_otf_batched": 1,
        "radix2_stage_inv_last": 0, "cplx_matmul": 0,
        "radix2_stage_dense": 0, "radix2_stage_inv_otf_dense": 0,
        "radix2_stage_inv_otf_batched_dense": 0,
        "radix2_stage_inv_last_dense": 0,
        "cplx_matmul_dense": 0, "rdft_y_fwd_dense": 0, "rdft_y_inv_dense": 0,
        "rdft_y_fwd_batched_dense": 0, "rdft_y_inv_batched_dense": 0}
    for b in range(2):
        one = plan.convolve(x[b], otf, conj=True, ratio_num=x[b],
                            mul_abs=x[b])
        assert torch.equal(got[b], one)   # the same arithmetic per block
