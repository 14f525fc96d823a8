"""The port's destriper (ops/destripe.py) against the JAX package's.

Same numpy-seeded striped u16 batch (3 x 96 x 150) through both
`filter_streaks`: u16 out within 1 count (rounding of f32 values that
differ in the last bits); f32 in/out within 1e-4 of the largest value.
The pad planner and notch are compared exactly, at the test tiles and at
the production presets 2000 x 2000 and 1600 x 2000."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ipp_tpu.ops import destripe as J
from ipp_tpu_torch.ops import destripe as P
from ipp_tpu_torch.ops.padding import pad_trailing
from ipp_tpu_torch.utils.transfer import HostArray, upload

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def striped():
    """Smooth field x multiplicative stripes along x and y, plus noise."""
    rng = np.random.default_rng(5)
    b, h, w = 3, 96, 150
    yy, xx = np.mgrid[:h, :w]
    base = 2000 + 800 * np.sin(yy / 13.0) + 500 * np.cos(xx / 17.0)
    rows = 1 + 0.2 * rng.standard_normal((b, h, 1))
    cols = 1 + 0.1 * rng.standard_normal((b, 1, w))
    img = base[None] * rows * cols + rng.normal(0, 30, (b, h, w))
    return np.clip(img, 0, 65535).astype(np.uint16)


def _port(img, **kw):
    return np.asarray(HostArray(P.filter_streaks(upload(img, CPU), **kw)))


@pytest.mark.parametrize("length,sigma", [(1, 0.5), (76, 40.0), (1345, 125)])
def test_notch_equal(length, sigma):
    np.testing.assert_array_equal(P.notch(length, sigma),
                                  J.notch(length, sigma))


@pytest.mark.parametrize("shape,sigma,level,wavelet", [
    ((96, 150), (30, 30), 0, "db3"), ((96, 150), (20, 40), 0, "db9"),
    ((2000, 2000), (250, 250), 0, "db9"), ((1600, 2000), (250, 250), 0, "db9"),
    ((2000, 2000), (250, 250), 0, "coif15"), ((10, 12), (5, 0), 3, "db2"),
])
def test_pad_plan_equal(shape, sigma, level, wavelet):
    assert P.calculate_pad_size(shape, max(sigma)) == \
        J.calculate_pad_size(shape, max(sigma))
    plan = P._plan_padding(shape, sigma, level, wavelet)
    assert plan == J._plan_padding(shape, sigma, level, wavelet)


def test_production_presets_pad_to_the_kernel_shapes():
    assert P._plan_padding((2000, 2000), (250, 250), 0, "db9")[2:] == \
        ((2688, 2688), 7)
    assert P._plan_padding((1600, 2000), (250, 250), 0, "db9")[2:] == \
        ((2304, 2688), 7)


@pytest.mark.parametrize("mode", ["wrap", "reflect", "symmetric", "edge",
                                  "constant"])
def test_pad_trailing_is_jnp_pad_for_any_size(mode):
    x = np.arange(2 * 5 * 7, dtype=np.float32).reshape(2, 5, 7)
    pads = [(12, 3), (0, 9)]
    got = pad_trailing(torch.from_numpy(x), pads, mode).numpy()
    ref = np.asarray(jnp.pad(jnp.asarray(x), [(0, 0)] + pads, mode=mode))
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("axis", [-1, -2])
def test_filter_coefficient_matches_jax(axis, rng):
    c = rng.standard_normal((2, 24, 40)).astype(np.float32)
    got = P.filter_coefficient(torch.from_numpy(c), 0.3, axis=axis).numpy()
    ref = np.asarray(J.filter_coefficient(jnp.asarray(c), 0.3, axis=axis))
    np.testing.assert_allclose(got, ref, atol=1e-4 * np.abs(ref).max())


CASES = {
    "wrap": dict(sigma=(30, 30), wavelet="db3", padding_mode="wrap"),
    "reflect_bidirectional": dict(sigma=(30, 30), wavelet="db9",
                                  padding_mode="reflect", bidirectional=True),
    "reflect_one_way_coif15": dict(sigma=(30, 30), wavelet="coif15",
                                   padding_mode="reflect"),
    "two_sigmas": dict(sigma=(20, 40), wavelet="db4", padding_mode="wrap",
                       bidirectional=True),
    "dual_band_threshold": dict(sigma=(20, 40), wavelet="db3", threshold=2100.0,
                                use_thresholding=True,
                                log1p_normalization_needed=False),
    "bleach": dict(sigma=(30, 30), wavelet="db4",
                   bleach_correction_frequency=0.01,
                   bleach_correction_clip_min=5.0,
                   bleach_correction_clip_med=7.0,
                   bleach_correction_clip_max=8.5),
    "bleach_max_method_only": dict(sigma=(0, 0), bleach_correction_frequency=0.02,
                                   bleach_correction_max_method=True,
                                   bleach_correction_clip_min=6.0,
                                   bleach_correction_clip_med=7.2,
                                   bleach_correction_clip_max=8.0),
    "level_3": dict(sigma=(30, 30), wavelet="db2", level=3),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_filter_streaks_u16_within_one_count(case, striped):
    kw = CASES[case]
    ref = np.asarray(J.filter_streaks(jnp.asarray(striped), **kw))
    got = _port(striped, **kw)
    assert got.dtype == ref.dtype == np.uint16 and got.shape == ref.shape
    assert np.abs(got.astype(np.int64) - ref.astype(np.int64)).max() <= 1


def test_filter_streaks_f32(striped):
    x = striped.astype(np.float32)
    ref = np.asarray(J.filter_streaks(jnp.asarray(x), sigma=(30, 30),
                                      wavelet="db9", bidirectional=True))
    got = P.filter_streaks(torch.from_numpy(x), sigma=(30, 30),
                           wavelet="db9", bidirectional=True)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4 * np.abs(ref).max())


def test_filter_streaks_removes_stripes(striped):
    def stripe_power(img):
        r = np.log1p(img.astype(np.float64)).mean(-1)
        k = np.ones(9) / 9
        smooth = np.stack([np.convolve(np.pad(v, 4, mode="edge"), k, "valid")
                           for v in r])
        return float(np.abs(r - smooth).mean())

    out = _port(striped, sigma=(30, 30), wavelet="db9", padding_mode="reflect",
                bidirectional=True)
    assert stripe_power(out) < stripe_power(striped) / 3


def test_filter_streaks_guards():
    x = upload(np.ones((8, 8), np.uint16), CPU)
    assert P.filter_streaks(x, sigma=0) is x
    with pytest.raises(ValueError, match="bleach"):
        P.filter_streaks(x, bleach_correction_frequency=0.1)
    with pytest.raises(ValueError, match="threshold"):
        P.filter_streaks(x, use_thresholding=True)
