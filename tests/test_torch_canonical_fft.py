"""The port's canonical transforms (`MatmulFFT3.rfftn`, `.irfftn`, `.otf`)
and `gauss3d_batched` against the JAX package's on JAX-CPU.

Same numpy-seeded inputs through both.  Tolerances are those of the JAX
package's own test of these methods (tests/test_deconv.py
`test_matmul_fft_matches_numpy`): spectra within 2e-3 absolute of numpy's,
the round trip within 1e-5; the twins agree to 1e-5 of the largest value.
On the CPU K7 takes its plain version, so nothing is counted.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ipp_tpu.ops import deconv as JD
from ipp_tpu.ops.mxu_fft import MatmulFFT3 as JaxFFT3
from ipp_tpu_torch.ops import cuda_fft as cf
from ipp_tpu_torch.ops import deconv as PD
from ipp_tpu_torch.ops.matmul_fft import MatmulFFT3

CPU = torch.device("cpu")
# the JAX test's shape, an odd x, a shape in the v2 domain's y (the plan's
# walk does not matter to these methods), and axes that are not multiples
# of 8
SHAPES = [(16, 24, 40), (8, 16, 15), (6, 10, 12), (24, 8, 256)]


@pytest.fixture
def rng():
    return np.random.default_rng(14)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


@pytest.mark.parametrize("shape", SHAPES)
def test_rfftn_matches_jax_and_numpy(shape, rng):
    x = rng.random(shape).astype(np.float32)
    cf.reset_launch_counts()
    re, im = MatmulFFT3(shape, CPU).rfftn(t(x))
    kx = shape[2] // 2 + 1
    assert re.shape == shape[:2] + (kx,) and im.shape == re.shape
    assert re.is_contiguous() and im.is_contiguous()
    ref = np.fft.rfftn(x)
    np.testing.assert_allclose(re.numpy(), ref.real, atol=2e-3)
    np.testing.assert_allclose(im.numpy(), ref.imag, atol=2e-3)
    jre, jim = JaxFFT3(shape).rfftn(jnp.asarray(x))
    scale = np.abs(ref).max()
    np.testing.assert_allclose(re.numpy(), np.asarray(jre), atol=1e-5 * scale)
    np.testing.assert_allclose(im.numpy(), np.asarray(jim), atol=1e-5 * scale)
    assert set(cf.LAUNCHES.values()) == {0}


@pytest.mark.parametrize("shape", SHAPES)
def test_irfftn_matches_jax_and_round_trips(shape, rng):
    x = rng.random(shape).astype(np.float32)
    spec = np.fft.rfftn(x)
    re = spec.real.astype(np.float32)
    im = spec.imag.astype(np.float32)
    plan = MatmulFFT3(shape, CPU)
    got = plan.irfftn(t(re), t(im))
    assert got.shape == shape
    ref = JaxFFT3(shape).irfftn(jnp.asarray(re), jnp.asarray(im))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
    np.testing.assert_allclose(got.numpy(), x, atol=1e-5)
    back = plan.irfftn(*plan.rfftn(t(x)))
    np.testing.assert_allclose(back.numpy(), x, atol=1e-5)


def test_transforms_take_a_leading_batch(rng):
    shape = (8, 16, 24)
    x = rng.random((2, 3) + shape).astype(np.float32)
    plan = MatmulFFT3(shape, CPU)
    re, im = plan.rfftn(t(x))
    ref = np.fft.rfftn(x, axes=(-3, -2, -1))
    assert re.shape == (2, 3, 8, 16, 13)
    np.testing.assert_allclose(re.numpy(), ref.real, atol=2e-3)
    np.testing.assert_allclose(im.numpy(), ref.imag, atol=2e-3)
    np.testing.assert_allclose(plan.irfftn(re, im).numpy(), x, atol=1e-5)


def test_otf_is_rfftn_of_the_rolled_psf(rng):
    shape = (16, 24, 40)
    k = rng.random(shape).astype(np.float32)
    re, im = MatmulFFT3(shape, CPU).otf(t(k))
    jre, jim = JaxFFT3(shape).otf(jnp.asarray(k))
    scale = float(np.abs(np.asarray(jre)).max())
    np.testing.assert_allclose(re.numpy(), np.asarray(jre), atol=1e-5 * scale)
    np.testing.assert_allclose(im.numpy(), np.asarray(jim), atol=1e-5 * scale)
    # the canonical OTF convolves like numpy's: irfftn(rfftn(x) * otf)
    x = rng.random(shape).astype(np.float32)
    plan = MatmulFFT3(shape, CPU)
    xr, xi = plan.rfftn(t(x))
    conv = plan.irfftn(xr * re - xi * im, xr * im + xi * re).numpy()
    ref = np.fft.irfftn(np.fft.rfftn(k) * np.fft.rfftn(x), s=shape)
    assert np.abs(conv - ref).max() / np.abs(ref).max() < 1e-5


@pytest.mark.parametrize("sigma", [1.0, (0.0, 1.5, 0.8)])
def test_gauss3d_batched_matches_jax(sigma, rng):
    vols = (rng.random((3, 10, 12, 14)) * 100).astype(np.float32)
    got = PD.gauss3d_batched(t(vols), sigma)
    ref = JD.gauss3d_batched(jnp.asarray(vols), sigma)
    assert got.shape == vols.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               atol=1e-5 * vols.max())
    # each block as `gauss3d` filters it alone
    for b in range(3):
        one = PD.gauss3d(t(vols[b]), sigma)
        assert torch.equal(got[b], one)


def test_gauss3d_batched_needs_a_batch(rng):
    with pytest.raises(ValueError):
        PD.gauss3d_batched(t(rng.random((4, 5, 6))), 1.0)
    assert "gauss3d_batched" in PD.__all__


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(40, 136, 264), (30, 50, 70)])
def test_canonical_transforms_on_the_card(shape, rng):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    x = rng.random(shape).astype(np.float32)
    plan = MatmulFFT3(shape, dev)
    cf.reset_launch_counts()
    re, im = plan.rfftn(t(x).to(dev))
    back = plan.irfftn(re, im)
    fft = all(s % 8 == 0 for s in shape[:2])
    assert cf.LAUNCHES["cplx_matmul" if fft else "cplx_matmul_dense"] == 4
    ref = np.fft.rfftn(x)
    scale = np.abs(ref).max()
    np.testing.assert_allclose(re.cpu().numpy(), ref.real, atol=1e-5 * scale)
    np.testing.assert_allclose(im.cpu().numpy(), ref.imag, atol=1e-5 * scale)
    np.testing.assert_allclose(back.cpu().numpy(), x, atol=1e-5)
