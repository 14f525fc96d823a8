"""ipp_tpu_torch.ops.deconv against the JAX package's XLA-FFT twins.

The same numpy-seeded inputs run through both.  RL results are compared on
the inner region with rtol=2e-3, atol=2e-1: the bound the JAX package uses
between its MXU walk and its XLA FFT (tests/test_deconv.py:217).  The port
runs both of its routes here: the kernel walk (plain versions on the CPU)
at an in-domain work shape, torch.fft elsewhere."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from scipy.ndimage import convolve as ndi_convolve

from ipp_tpu.ops import deconv as dj
from ipp_tpu.ops.psf import gaussian_psf
from ipp_tpu_torch.ops import deconv as dp

WALK = (256, 24, 256)     # in the kernel domain
FFT = (24, 28, 32)        # outside it
INNER = (slice(4, -4),) * 3


@pytest.fixture(autouse=True)
def _xla_twin(monkeypatch):
    monkeypatch.setattr(dj, "_RESOLVED_FFT", "xla")


def _beads(rng, shape, psf):
    """Blurred sparse beads on a floor: RL sharpens it gradually."""
    truth = np.full(shape, 10.0, np.float32)
    n = max(4, int(np.prod(shape) / 400))
    idx = tuple(rng.integers(0, s, n) for s in shape)
    truth[idx] += rng.uniform(500, 1000, n)
    return ndi_convolve(truth, psf, mode="wrap").astype(np.float32)


@pytest.mark.parametrize("sigma", [1.5, (0.5, 1.0, 2.0)])
def test_gauss3d_matches_jax(rng, sigma):
    vol = (rng.random((20, 24, 28)) * 1000).astype(np.float32)
    got = dp.gauss3d(torch.from_numpy(vol), sigma).numpy()
    ref = np.asarray(dj.gauss3d(vol, sigma))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-3)


def test_conv3d_zero_matches_jax(rng):
    vol = rng.random((12, 13, 14)).astype(np.float32)
    kern = dp._tikhonov_kernel()
    got = dp._conv3d_zero(torch.from_numpy(vol), torch.from_numpy(kern))
    ref = np.asarray(dj._conv3d_zero(vol, kern))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("shape,psf_shape", [
    ((48, 56, 64), (7, 9, 9)),      # face slabs
    ((20, 24, 28), (9, 9, 9)),      # slabs do not fit: full-volume blur
])
def test_edge_taper_matches_jax(rng, shape, psf_shape):
    vol = (rng.random(shape) * 1000).astype(np.float32)
    psf = gaussian_psf(psf_shape, (1.5, 2.0, 2.0))
    got = dp.edge_taper_3d(torch.from_numpy(vol), torch.from_numpy(psf))
    ref = np.asarray(dj.edge_taper_3d(vol, psf))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=0.05)


def test_pad_unpad_and_fft_shape_match_jax(rng):
    vol = rng.random((5, 6, 7)).astype(np.float32)
    got, pre, post = dp.pad_to_shape(torch.from_numpy(vol), (9, 8, 12))
    ref, rpre, rpost = dj.pad_to_shape(vol, (9, 8, 12))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert (pre, post) == (rpre, rpost)
    np.testing.assert_array_equal(dp.unpad(got, pre, post).numpy(), vol)
    assert dp.fft_shape_for((100, 101, 97), (11, 11, 11), "cpu") == \
        tuple(dj.fft_shape_for((100, 101, 97), (11, 11, 11)))


@pytest.mark.parametrize("shape", [WALK, FFT], ids=["walk", "fft"])
@pytest.mark.parametrize("classic", [True, False], ids=["classic", "reference"])
def test_richardson_lucy_matches_jax(rng, shape, classic):
    vol = (rng.random(tuple(s - 8 for s in shape)) * 1000).astype(np.float32)
    psf = gaussian_psf((5, 5, 5), (1.0, 1.0, 1.0))
    kw = dict(niter=5, fft_shape=shape, classic=classic)
    assert dp.conv_route(shape, torch.device("cpu")) == \
        ("walk" if shape == WALK else "fft")
    got = dp.richardson_lucy(vol, psf, device="cpu", **kw).numpy()
    ref = np.asarray(dj.richardson_lucy(vol, psf, **kw))
    assert got.shape == vol.shape
    np.testing.assert_allclose(got[INNER], ref[INNER], rtol=2e-3, atol=2e-1)


@pytest.mark.parametrize("shape", [WALK, FFT], ids=["walk", "fft"])
def test_early_stop_runs_the_twins_iteration_count(rng, shape):
    psf = gaussian_psf((5, 5, 5), (1.0, 1.0, 1.0))
    vol = _beads(rng, shape, psf)
    niter, stop = 12, 2.0
    kw = dict(fft_shape=shape, edge_taper=False)
    _, k = dp._rl_fft_iterations(
        torch.from_numpy(vol), torch.from_numpy(psf / psf.sum()),
        niter=niter, fft_shape=shape, lam=0.0, stop_criterion=stop,
        regularize_interval=0, classic=True)
    assert 2 < k < niter
    got = dp.richardson_lucy(vol, psf, niter=niter, stop_criterion=stop,
                             device="cpu", **kw).numpy()
    ref = np.asarray(dj.richardson_lucy(vol, psf, niter=niter,
                                        stop_criterion=stop, **kw))
    # the twin stopped after the same k iterations: it equals its own
    # k-iteration run and differs from its (k+1)-iteration run
    ref_k = np.asarray(dj.richardson_lucy(vol, psf, niter=k, **kw))
    ref_k1 = np.asarray(dj.richardson_lucy(vol, psf, niter=k + 1, **kw))
    np.testing.assert_allclose(ref, ref_k, rtol=1e-6, atol=1e-4)
    assert not np.allclose(ref, ref_k1, rtol=1e-3)
    np.testing.assert_allclose(got[INNER], ref[INNER], rtol=2e-3, atol=2e-1)


def _jax_rl_in_child(tmp_path, vol, psf, kws):
    """The JAX package's `richardson_lucy(vol, psf, **kw)` for each kw of
    kws, run in a child process (tests/_jax_rl_child.py) with XLA's CPU
    backend at optimisation level 0: at the walk shape its default
    optimisation segfaults on the regularised call, which would kill this
    worker.  Same inputs (by file), same keywords, XLA FFT."""
    inp, out = tmp_path / "rl_in.npz", tmp_path / "rl_out.npz"
    np.savez(inp, vol=vol, psf=psf)
    root = str(Path(__file__).resolve().parent.parent)
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS=(
        os.environ.get("XLA_FLAGS", "")
        + " --xla_backend_optimization_level=0").strip(),
        PYTHONPATH=os.pathsep.join(
            [root] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    res = subprocess.run(
        [sys.executable, str(Path(__file__).with_name("_jax_rl_child.py")),
         "--inp", str(inp), "--kwargs", json.dumps(kws), "--out", str(out)],
        env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    with np.load(out) as data:
        return [data[f"r{i}"] for i in range(len(kws))]


@pytest.mark.parametrize("shape", [WALK, FFT], ids=["walk", "fft"])
@pytest.mark.parametrize("classic", [True, False], ids=["classic", "reference"])
def test_regularised_richardson_lucy_matches_jax(rng, shape, classic,
                                                 tmp_path):
    """At the walk shape the JAX references run in a child process at
    XLA optimisation level 0 (`_jax_rl_in_child`); the port's side runs
    here."""
    psf = gaussian_psf((5, 5, 5), (1.0, 1.0, 1.0))
    vol = _beads(rng, shape, psf)
    kw = dict(niter=6, lam=0.1, regularize_interval=2, fft_shape=shape,
              classic=classic)
    got = dp.richardson_lucy(vol, psf, device="cpu", **kw).numpy()
    kws = [kw, {**kw, "lam": 0.0, "regularize_interval": 0}]
    if shape == WALK:
        ref, plain = _jax_rl_in_child(tmp_path, vol, psf, kws)
    else:
        ref, plain = (np.asarray(dj.richardson_lucy(vol, psf, **k))
                      for k in kws)
    assert not np.allclose(ref, plain, rtol=1e-3)  # regularisation acted
    np.testing.assert_allclose(got[INNER], ref[INNER], rtol=2e-3, atol=2e-1)


def test_numpy_input_without_cuda_needs_the_cpu_setting(monkeypatch, rng):
    monkeypatch.delenv("IPP_TPU_PLATFORM", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    vol = rng.random((8, 8, 8)).astype(np.float32)
    psf = gaussian_psf((3, 3, 3), (1.0, 1.0, 1.0))
    with pytest.raises(RuntimeError, match="IPP_TPU_PLATFORM=cpu"):
        dp.richardson_lucy(vol, psf, niter=1)
    monkeypatch.setenv("IPP_TPU_PLATFORM", "cpu")
    assert dp.richardson_lucy(vol, psf, niter=1).device.type == "cpu"
