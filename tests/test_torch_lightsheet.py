"""The port's lightsheet correction (ops/lightsheet.py) against the JAX
package's, on JAX-CPU, with the same numpy-seeded planes.

grid_percentile on both of the reference's counting searches (the K-ary
search for windows under 1024 samples, bisection above), on u16 and f32
planes: within 1e-5 of the plane's range.  correct_lightsheet: u16 within
1 count, f32 within 1e-5 of the range.  local_percentile_1d within 1e-5 of
the range.  process_img with lightsheet=True within 1 count plus the
difference the chain before the stage hands it (the destripe's)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ipp_tpu.ops import lightsheet as JL
from ipp_tpu.ops import process as JP
from ipp_tpu_torch.ops import lightsheet as PL
from ipp_tpu_torch.ops import process as PP
from ipp_tpu_torch.utils.transfer import HostArray, upload

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("IPP_TPU_PLATFORM", "cpu")


def _planes(dtype, shape=(2, 130, 170), seed=3):
    """A smooth background, a bright sheet artifact along x, beads and
    noise; integer-valued for u16, with fractions for f32."""
    rng = np.random.default_rng(seed)
    b, h, w = shape
    yy, xx = np.mgrid[:h, :w]
    img = 800 + 500 * np.exp(-((yy - h / 3) ** 2 + (xx - w / 2) ** 2)
                             / (0.2 * h * w))
    img = np.broadcast_to(img, shape) * (
        1 + 0.4 * (rng.random((b, h, 1)) < 0.1))        # sheet rows
    img = img + rng.normal(0, 30, shape)
    ys, xs = rng.integers(0, h, (b, 40)), rng.integers(0, w, (b, 40))
    for i in range(b):
        img[i, ys[i], xs[i]] += 6000
    if np.dtype(dtype) == np.uint16:
        return np.clip(np.rint(img), 0, 65535).astype(np.uint16)
    return img.astype(np.float32)


def _port(x, fn, *a, **kw):
    return np.asarray(HostArray(fn(upload(x, CPU), *a, **kw)))


# (selem, spacing, step): the lightsheet field's K-ary search (k = 40, 150),
# and the background field's bisection (k = 32 * 32 = 1024, 50 * 50)
FIELDS = [((1, 40), (1, 40), (1, 1)), ((1, 150), (1, 150), (1, 1)),
          ((64, 64), (16, 16), (2, 2)), ((100, 100), (25, 25), (2, 2)),
          ((9, 7), (5, 6), (1, 1))]


@pytest.mark.parametrize("dtype", [np.uint16, np.float32])
@pytest.mark.parametrize("selem,spacing,step", FIELDS)
@pytest.mark.parametrize("q", [0.25, 0.5])
def test_grid_percentile_equals_jax(dtype, selem, spacing, step, q):
    x = _planes(dtype)
    ref = np.asarray(JL.grid_percentile(jnp.asarray(x), selem, spacing,
                                        step, q))
    got = _port(x, PL.grid_percentile, selem, spacing, step, q)
    assert got.dtype == np.float32 and got.shape == ref.shape
    span = float(x.max()) - float(x.min())
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * span)


@pytest.mark.parametrize("kw", [
    dict(), dict(artifact_length=40, background_window_size=64,
                 background_spacing=(16, 16)),
    dict(percentile=0.5, artifact_length=30, lightsheet_vs_background=1.5)])
@pytest.mark.parametrize("dtype", [np.uint16, np.float32])
def test_correct_lightsheet_equals_jax(kw, dtype):
    x = _planes(dtype)
    ref = np.asarray(JL.correct_lightsheet(jnp.asarray(x), **kw))
    got = _port(x, PL.correct_lightsheet, **kw)
    assert got.dtype == ref.dtype == x.dtype and got.shape == ref.shape
    if dtype == np.uint16:
        assert np.abs(got.astype(np.int64) - ref.astype(np.int64)).max() <= 1
    else:
        span = float(x.max()) - float(x.min())
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * span)
    assert np.abs(got.astype(np.float64) - x).max() > 0   # it subtracted


@pytest.mark.parametrize("size,q,axis", [(15, 0.25, -1), (8, 0.5, -2),
                                         (31, 0.9, -1)])
def test_local_percentile_1d_equals_jax(size, q, axis):
    x = _planes(np.float32, (2, 40, 57))
    ref = np.asarray(JL.local_percentile_1d(jnp.asarray(x), size, q, axis))
    got = PL.local_percentile_1d(torch.from_numpy(x), size, q, axis).numpy()
    span = float(x.max()) - float(x.min())
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * span)


@pytest.mark.parametrize("kw", [
    dict(lightsheet=True, sigma=(40, 40), wavelet="db3",
         padding_mode="reflect", bidirectional=True, dark=100.0),
    dict(lightsheet=True, artifact_length=50, background_window_size=60,
         percentile=0.3, convert_to_8bit=True),
    dict(lightsheet=True, dark=100, lightsheet_vs_background=1.0)])
def test_process_img_with_lightsheet_equals_jax(kw):
    """Within 1 count, plus the difference of the chain before the stage:
    the destripe hands the lightsheet stage f32 planes that already differ
    (by up to 1 count, tests/test_torch_destripe.py), and the stage adds at
    most its own rounding to that."""
    x = _planes(np.uint16)
    ref = JP.process_img(x, JP.ProcessConfig(**kw))
    got = PP.process_img(x, PP.ProcessConfig(**kw), device=CPU)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    before = dict(kw, lightsheet=False, d_type="float32",
                  convert_to_8bit=False)
    upstream = np.abs(
        PP.process_img(x, PP.ProcessConfig(**before), device=CPU)
        - JP.process_img(x, JP.ProcessConfig(**before))).max()
    assert upstream <= 1
    diff = np.abs(got.astype(np.int64) - ref.astype(np.int64)).max()
    assert diff <= 1 + np.ceil(upstream), (diff, upstream)
