"""The port's batched, Wiener and spatial Richardson-Lucy against the JAX
package's XLA-FFT twins.

The same numpy-seeded inputs run through both; cases follow the JAX
package's own tests (tests/test_deconv.py:73-145,
tests/test_supplements.py:117).  Tolerances, each with its reason:
- batched RL against the JAX batched RL: rtol=2e-3, atol=2e-1, the bound
  the JAX package uses between its MXU walk and its XLA FFT
  (tests/test_deconv.py:217), on the whole block with edge_taper=False and
  on the inner region with the taper;
- the port's batched RL against the port's single-block RL: rtol=1e-5,
  atol=1e-3, the JAX package's own batched-vs-single bound
  (tests/test_deconv.py:133);
- spatial RL: rtol=1e-4, atol=1e-3 of values up to ~1e3 (both f32;
  convolution sums in another order);
- Wiener RL: 1e-3 of the largest value for the estimate and 2e-3 for the
  PSF, at 3 and 4 iterations.  Blind PSF re-estimation divides by the
  estimate's power spectrum, so f32 FFT rounding grows ~10x per
  iteration (measured on this phantom: 5e-7 after one iteration, 7e-6
  after two, 3e-4 after three, 1.5e-3 after four)."""

import numpy as np
import pytest
import torch
from scipy.ndimage import convolve as ndi_convolve
from scipy.ndimage import gaussian_filter

from ipp_tpu.ops import deconv as dj
from ipp_tpu.ops.psf import gaussian_psf
from ipp_tpu_torch.ops import cuda_fft as cf
from ipp_tpu_torch.ops import deconv as dp

WALK = (256, 24, 256)     # in the kernel domain
INNER = (slice(None),) + (slice(4, -4),) * 3


@pytest.fixture(autouse=True)
def _xla_twin(monkeypatch):
    monkeypatch.setattr(dj, "_RESOLVED_FFT", "xla")


def t(a):
    return torch.from_numpy(np.array(a, np.float32))


# -- the torch.fft route over a batch ---------------------------------------

def test_fft_route_transforms_only_the_last_three_axes(rng):
    """A (2, D, H, W) batch through the torch.fft convolver equals each
    block's 3-D result: the transform must not run across blocks."""
    shape = (12, 14, 16)
    psf = t(gaussian_psf((5, 5, 5), (1.0, 1.0, 1.0)))
    x = t(rng.random((2,) + shape) * 100 + 1)
    num = t(rng.random((2,) + shape) * 100 + 1)
    assert dp.conv_route(shape, torch.device("cpu")) == "fft"
    conv, conv_conj_ratio, update = dp._make_convolver(psf, shape)
    for got, one in [
            (conv(x), lambda b: conv(x[b])),
            (conv_conj_ratio(num, x), lambda b: conv_conj_ratio(num[b], x[b])),
            (update(x, num, x), lambda b: update(x[b], num[b], x[b]))]:
        assert got.shape == x.shape
        for b in range(2):
            torch.testing.assert_close(got[b], one(b), rtol=1e-5, atol=1e-4)


def test_edge_taper_full_volume_blur_matches_jax(rng):
    vol = (rng.random((48, 56, 64)) * 1000).astype(np.float32)
    psf = gaussian_psf((7, 9, 9), (1.5, 2.0, 2.0))
    got = dp.edge_taper_3d(t(vol), t(psf), face_slabs=False).numpy()
    ref = np.asarray(dj.edge_taper_3d(vol, psf, face_slabs=False))
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=0.05)
    slabs = dp.edge_taper_3d(t(vol), t(psf)).numpy()
    np.testing.assert_allclose(got, slabs, rtol=1e-4, atol=0.05)


# -- richardson_lucy_batched ----------------------------------------------------

def _two_blocks(rng, shape, psf):
    """Block 0 near-flat (converges at once at a loose stop), block 1
    structured (keeps changing longer), as tests/test_deconv.py:109."""
    flat = np.full(shape, 100.0, np.float32)
    flat += rng.random(shape).astype(np.float32) * 0.1
    truth = np.zeros(shape, np.float32)
    c = tuple(slice(s // 4, 3 * s // 4) for s in shape)
    truth[c] = rng.random(truth[c].shape).astype(np.float32) * 500
    sharp = ndi_convolve(truth, psf, mode="constant").astype(np.float32)
    return np.stack([flat, sharp + 1.0])


@pytest.mark.parametrize("route_shape", [(20, 20, 20), WALK],
                         ids=["fft", "walk"])
def test_batched_reference_mode_regularisation_matches_jax(rng, route_shape):
    vol = rng.random((2,) + tuple(s - 4 for s in route_shape),
                     dtype=np.float32) * 100
    psf = gaussian_psf((5, 5, 5), (1.0, 1.0, 1.0))
    kw = dict(niter=6, lam=0.1, regularize_interval=2, classic=False,
              edge_taper=False, fft_shape=route_shape)
    got = dp.richardson_lucy_batched(vol, psf, device="cpu", **kw).numpy()
    ref = np.asarray(dj.richardson_lucy_batched(vol, psf, **kw))
    assert got.shape == vol.shape
    np.testing.assert_allclose(got, ref, rtol=2e-3, atol=2e-1)
    for b in range(2):
        one = dp.richardson_lucy(vol[b], psf, device="cpu", **kw).numpy()
        np.testing.assert_allclose(got[b], one, rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("classic", [True, False], ids=["classic", "reference"])
def test_batched_with_edge_taper_matches_jax(rng, classic):
    psf = gaussian_psf((5, 5, 5), (1.2, 1.2, 1.2))
    vols = _two_blocks(rng, (24, 28, 32), psf)
    kw = dict(niter=5, classic=classic)
    got = dp.richardson_lucy_batched(vols, psf, device="cpu", **kw).numpy()
    ref = np.asarray(dj.richardson_lucy_batched(vols, psf, **kw))
    np.testing.assert_allclose(got[INNER], ref[INNER], rtol=2e-3, atol=2e-1)


def _iterations(vols, psf, stop, niter=12):
    """(estimate, iterations run) of the RL loop on a block or a batch
    that is already at its work shape."""
    return dp._rl_fft_iterations(
        t(vols), t(psf / psf.sum()), niter=niter, fft_shape=vols.shape[-3:],
        lam=0.0, stop_criterion=stop, regularize_interval=0, classic=True)


def test_batched_early_stop_matches_single_blocks_and_jax(rng):
    psf = gaussian_psf((5, 5, 5), (1.2, 1.2, 1.2))
    vols = np.pad(_two_blocks(rng, (16, 16, 16), psf),
                  ((0, 0),) + ((2, 2),) * 3)
    kw = dict(niter=12, edge_taper=False, fft_shape=(20, 20, 20))
    got = dp.richardson_lucy_batched(vols, psf, stop_criterion=1.0,
                                     device="cpu", **kw)
    loop, iters = _iterations(vols, psf, 1.0)
    torch.testing.assert_close(loop, got, rtol=0, atol=0)
    singles = [_iterations(vols[b], psf, 1.0) for b in range(2)]
    assert iters == [k for _, k in singles]
    assert iters[0] != iters[1] and min(iters) < 12   # each its own stop
    for b, (one, _) in enumerate(singles):
        np.testing.assert_allclose(got[b].numpy(), one.numpy(), rtol=1e-5,
                                   atol=1e-3, err_msg=f"block {b}")
    ref = np.asarray(dj.richardson_lucy_batched(vols, psf,
                                                stop_criterion=1.0, **kw))
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-3, atol=2e-1)
    # an always-true criterion stops every block after iteration 2
    stopped2 = dp.richardson_lucy_batched(vols, psf, stop_criterion=1e6,
                                          device="cpu", **kw)
    assert _iterations(vols, psf, 1e6)[1] == [2, 2]
    two = dp.richardson_lucy_batched(vols, psf, device="cpu",
                                     **{**kw, "niter": 2})
    np.testing.assert_allclose(stopped2.numpy(), two.numpy(), rtol=1e-5,
                               atol=1e-3)
    full = dp.richardson_lucy_batched(vols, psf, device="cpu", **kw)
    assert not np.allclose(stopped2[1].numpy(), full[1].numpy(), rtol=1e-4)


def test_batched_walk_runs_the_batched_plain_forms(rng):
    vols = rng.random((2,) + tuple(s - 8 for s in WALK),
                      dtype=np.float32) * 1000
    psf = gaussian_psf((5, 5, 5), (1.0, 1.0, 1.0))
    cf.reset_launch_counts()
    got = dp.richardson_lucy_batched(vols, psf, niter=3, fft_shape=WALK,
                                     device="cpu", route="walk").numpy()
    assert set(cf.LAUNCHES.values()) == {0}
    ref = np.asarray(dj.richardson_lucy_batched(vols, psf, niter=3,
                                                fft_shape=WALK))
    np.testing.assert_allclose(got[INNER], ref[INNER], rtol=2e-3, atol=2e-1)


def test_batched_refuses_a_mesh_and_a_single_block(rng):
    vol = rng.random((8, 8, 8), dtype=np.float32)
    psf = gaussian_psf((3, 3, 3), (1.0, 1.0, 1.0))
    with pytest.raises(TypeError, match="Placement"):
        dp.richardson_lucy_batched(vol[None], psf, sharding=object(),
                                   device="cpu")
    with pytest.raises(ValueError, match="B, D, H, W"):
        dp.richardson_lucy_batched(vol, psf, device="cpu")


# -- Wiener and spatial RL ------------------------------------------------------

def _sparse_phantom(rng):
    truth = gaussian_filter(
        (rng.random((24, 24, 24)) > 0.99).astype(np.float32) * 1000, 0.8)
    psf_true = gaussian_psf((7, 7, 7), (1.5, 1.5, 1.5))
    return truth, ndi_convolve(truth, psf_true,
                               mode="constant").astype(np.float32)


@pytest.mark.parametrize("kw", [dict(niter=3),
                                dict(niter=4, lam=0.1, regularize_interval=2)],
                         ids=["plain", "regularised"])
def test_wiener_matches_jax(rng, kw):
    truth, blurred = _sparse_phantom(rng)
    psf_guess = gaussian_psf((7, 7, 7), (1.0, 1.0, 1.0))
    dec, psf_out = dp.richardson_lucy_wiener(blurred, psf_guess,
                                             device="cpu", **kw)
    ref, ref_psf = dj.richardson_lucy_wiener(blurred, psf_guess, **kw)
    assert dec.shape == truth.shape and psf_out.shape == psf_guess.shape
    ref, ref_psf = np.asarray(ref), np.asarray(ref_psf)
    assert np.abs(dec.numpy() - ref).max() <= 1e-3 * np.abs(ref).max()
    assert np.abs(psf_out.numpy() - ref_psf).max() <= 2e-3 * ref_psf.max()
    assert abs(float(psf_out.sum()) - 1.0) < 1e-3
    assert np.abs(psf_out.numpy() - psf_guess / psf_guess.sum()).sum() > 1e-3


@pytest.mark.parametrize("kw", [dict(niter=4),
                                dict(niter=6, lam=0.1, regularize_interval=2)],
                         ids=["plain", "regularised"])
def test_spatial_matches_jax(rng, kw):
    truth = gaussian_filter(rng.random((24, 24, 24)).astype(np.float32), 1.0)
    psf = gaussian_psf((5, 5, 5), (1.2, 1.2, 1.2))
    blurred = ndi_convolve(truth, psf, mode="constant").astype(np.float32)
    got = dp.richardson_lucy_spatial(blurred * 1000, psf, device="cpu",
                                     **kw).numpy()
    ref = np.asarray(dj.richardson_lucy_spatial(blurred * 1000, psf, **kw))
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-3)
