"""The port's tile chain (ops/process.py) and the modules under it
(ops/intensity.py, ops/resample.py, ops/stats.py) against the JAX package.

Same numpy-seeded u16 batch through both: integer outputs within 1 count
(f32 values rounded to integers may differ by one), f32 outputs within
1e-4 of the largest value; the host-side statistics are copies and must be
equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ipp_tpu.ops import intensity as JI
from ipp_tpu.ops import process as JP
from ipp_tpu.ops import resample as JR
from ipp_tpu.ops import stats as JS
from ipp_tpu_torch.ops import intensity as PI
from ipp_tpu_torch.ops import process as PP
from ipp_tpu_torch.ops import resample as PR
from ipp_tpu_torch.ops import stats as PS
from ipp_tpu_torch.utils.transfer import HostArray, host_dtype, upload

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("IPP_TPU_PLATFORM", "cpu")


@pytest.fixture(scope="module")
def tiles():
    rng = np.random.default_rng(9)
    b, h, w = 3, 96, 150
    yy, xx = np.mgrid[:h, :w]
    base = 1500 + 900 * np.sin(yy / 11.0) * np.cos(xx / 23.0)
    rows = 1 + 0.15 * rng.standard_normal((b, h, 1))
    img = base[None] * rows + rng.normal(0, 40, (b, h, w))
    img[:, 10:14, 20:30] = 0          # a dark patch: the 8-bit "1" rule
    return np.clip(img, 0, 65535).astype(np.uint16)


def _close(got, ref, count=1):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == ref.dtype, \
        (got.shape, ref.shape, got.dtype, ref.dtype)
    if np.issubdtype(ref.dtype, np.integer):
        assert np.abs(got.astype(np.int64) - ref.astype(np.int64)).max() <= count
    else:
        np.testing.assert_allclose(got, ref, atol=1e-4 * np.abs(ref).max())


def _host(t):
    return np.asarray(HostArray(t))


# -- stats: copies, pinned equal ----------------------------------------------

def test_stats_equal(tiles):
    x = np.log1p(tiles[0].astype(np.float32))
    assert PS.threshold_otsu(x) == JS.threshold_otsu(x)
    assert PS.threshold_otsu(tiles[1]) == JS.threshold_otsu(tiles[1])
    np.testing.assert_array_equal(PS.threshold_multiotsu(x, classes=4),
                                  JS.threshold_multiotsu(x, classes=4))
    ub = float(JS.threshold_multiotsu(x, classes=4)[-1])
    assert PS.estimate_bit_shift(x, ub) == JS.estimate_bit_shift(x, ub)
    assert PS.estimate_image_params(list(tiles)) == \
        JS.estimate_image_params(list(tiles))


# -- intensity -----------------------------------------------------------------

@pytest.mark.parametrize("shift", [0, 3, 8])
def test_convert_to_8bit(tiles, shift):
    ref = JI.convert_to_8bit(jnp.asarray(tiles), shift)
    _close(_host(PI.convert_to_8bit(upload(tiles, CPU), shift)), ref, 0)
    f = tiles.astype(np.float32) * 1.7 - 300
    ref = JI.convert_to_8bit(jnp.asarray(f), shift)
    _close(_host(PI.convert_to_8bit(torch.from_numpy(f), shift)), ref, 0)


def test_convert_to_16bit_and_dark(tiles):
    f = tiles.astype(np.float32) * 40.5 - 900
    _close(_host(PI.convert_to_16bit(torch.from_numpy(f))),
           JI.convert_to_16bit(jnp.asarray(f)), 0)
    for dark in (100.5, 100):
        ref = JI.subtract_dark(jnp.asarray(tiles), dark)
        got = PI.subtract_dark(upload(tiles, CPU), dark)
        _close(_host(got), ref, 0)


def test_gaussian_blur_and_foreground_fraction(tiles):
    f = tiles.astype(np.float32)
    _close(PI.gaussian_blur2d(torch.from_numpy(f), 1.0, radius=2).numpy(),
           JI.gaussian_blur2d(jnp.asarray(f), 1.0, radius=2))
    _close(PI.foreground_fraction(torch.from_numpy(f), 1500.0, 10.0).numpy(),
           JI.foreground_fraction(jnp.asarray(f), 1500.0, 10.0))


@pytest.mark.parametrize("max_method", [False, True])
def test_filtfilt_and_bleach_correction(tiles, max_method):
    x = np.log1p(tiles.astype(np.float32))
    b, a = JI.butter_lowpass_coeffs(0.02)
    _close(PI.filtfilt1(torch.from_numpy(x), b, a).numpy(),
           JI.filtfilt1(jnp.asarray(x), b, a))
    _close(PI.correct_bleaching(torch.from_numpy(x), 0.02, 6.0, 7.2, 7.6,
                                max_method=max_method).numpy(),
           JI.correct_bleaching(jnp.asarray(x), 0.02, 6.0, 7.2, 7.6,
                                max_method=max_method))


@pytest.mark.parametrize("n", [150, 2000 + 2 * 6, 5])
def test_iir1_scan_matches_the_reference_scan(n):
    """`_iir1` (a scan by doubling) against the reference's associative
    scan and the sample-by-sample recurrence, at a production row length
    (2000 samples and filtfilt1's 6 + 6 of extension) as well as short
    ones."""
    rng = np.random.default_rng(n)
    x = (7.0 + 0.3 * rng.standard_normal((4, n))).astype(np.float32)
    b, a = JI.butter_lowpass_coeffs(0.02)
    b0, b1, a1 = float(b[0]), float(b[1]), float(a[1])
    zi = (b1 - b0 * a1) / (1.0 + a1)
    got = PI._iir1(torch.from_numpy(x), b0, b1, a1, zi).numpy()
    _close(got, JI._iir1(jnp.asarray(x), b0, b1, a1, zi))
    u = b0 * x.astype(np.float64)
    u[:, 1:] += b1 * x[:, :-1].astype(np.float64)
    u[:, 0] += zi * x[:, 0]
    ref = np.empty_like(u)
    ref[:, 0] = u[:, 0]
    for k in range(1, n):
        ref[:, k] = u[:, k] - a1 * ref[:, k - 1]
    _close(got, ref.astype(np.float32))


@pytest.mark.parametrize("max_method", [False, True])
def test_filtfilt_and_bleach_correction_at_a_production_row(max_method):
    rng = np.random.default_rng(3)
    h, w = 24, 2000
    yy, xx = np.mgrid[:h, :w]
    img = 1500 + 900 * np.sin(yy / 5.0) * np.cos(xx / 230.0) \
        + rng.normal(0, 40, (h, w))
    x = np.log1p(np.clip(img, 0, 65535).astype(np.float32))
    b, a = JI.butter_lowpass_coeffs(0.02)
    _close(PI.filtfilt1(torch.from_numpy(x), b, a).numpy(),
           JI.filtfilt1(jnp.asarray(x), b, a))
    _close(PI.correct_bleaching(torch.from_numpy(x), 0.02, 6.0, 7.2, 7.6,
                                max_method=max_method).numpy(),
           JI.correct_bleaching(jnp.asarray(x), 0.02, 6.0, 7.2, 7.6,
                                max_method=max_method))


def test_hist_match(tiles):
    src, tpl = tiles[0].astype(np.float32), tiles[1].astype(np.float32) * 2
    _close(PI.hist_match(torch.from_numpy(src), torch.from_numpy(tpl)).numpy(),
           JI.hist_match(jnp.asarray(src), jnp.asarray(tpl)))


# -- resample --------------------------------------------------------------------

@pytest.mark.parametrize("func", ["max", "min", "mean", "median"])
def test_block_reduce(tiles, func):
    ref = JR.block_reduce(jnp.asarray(tiles), (1, 4, 7), func)
    got = PR.block_reduce(upload(tiles, CPU), (1, 4, 7), func)
    _close(_host(got), ref, 0)


@pytest.mark.parametrize("out", [(40, 61), (130, 200), (96, 75)])
def test_resize(tiles, out):
    f = tiles.astype(np.float32)
    shape = (f.shape[0],) + out
    up = out > f.shape[1:]
    _close(PR.resize(torch.from_numpy(f), shape, anti_aliasing=not up).numpy(),
           JR.resize(jnp.asarray(f), shape, anti_aliasing=not up))


# -- process_img -----------------------------------------------------------------

CONFIGS = {
    "flat": dict(flat=np.linspace(0.5, 1.0, 96 * 150, dtype=np.float32
                                  ).reshape(96, 150)),
    "gaussian": dict(gaussian_filter_2d=True),
    "down_sample": dict(down_sample=(2, 3)),
    "new_size": dict(new_size=(64, 100)),
    "dark": dict(dark=120.0),
    "eight_bit": dict(convert_to_8bit=True, bit_shift_to_right=4),
    "rotate_flip": dict(rotate=90, flip_upside_down=True),
    "destripe_dark_16bit": dict(sigma=(30, 30), wavelet="db3",
                                padding_mode="reflect", bidirectional=True,
                                dark=100.0, convert_to_16bit=True),
    "destripe_default_coif15": dict(sigma=(30, 30)),
    "bleach_host_clips": dict(sigma=(30, 30), wavelet="db4",
                              bleach_correction_frequency=0.02),
    "f32_out": dict(sigma=(30, 30), wavelet="db3", d_type="float32"),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_process_img_matches_jax(tiles, name):
    kw = CONFIGS[name]
    cfg_j, cfg_p = JP.ProcessConfig(**kw), PP.ProcessConfig(**kw)
    ref = JP.process_img(tiles, cfg_j)
    got = PP.process_img(tiles, cfg_p)
    _close(got, ref)
    assert PP.needs_host_stats(cfg_p) == JP.needs_host_stats(cfg_j)
    if not PP.needs_host_stats(cfg_p):
        handle = PP.process_batch_fn(cfg_p)(tiles)
        assert isinstance(handle, HostArray)
        handle.copy_to_host_async()
        _close(np.asarray(handle), ref)


def test_uniform_tile_short_circuits_on_the_host():
    img = np.full((2, 40, 60), 7, np.uint16)
    for kw in [dict(sigma=(30, 30)), dict(down_sample=(3, 4), rotate=90),
               dict(new_size=(10, 12), convert_to_8bit=True)]:
        ref = JP.process_img(img, JP.ProcessConfig(**kw))
        got = PP.process_img(img, PP.ProcessConfig(**kw))
        assert isinstance(got, np.ndarray)
        _close(got, ref, 0)
        assert not got.any()


def test_lightsheet_is_not_ported_yet(tiles):
    """(Named when the stage raised.)  The lightsheet stage is ported now:
    process_img and the batch callable with lightsheet=True, on u16 and
    after a float dark subtraction, within 1 count of the JAX chain."""
    for kw in [dict(lightsheet=True),
               dict(lightsheet=True, dark=100.0, artifact_length=40,
                    background_window_size=50)]:
        ref = JP.process_img(tiles, JP.ProcessConfig(**kw))
        cfg = PP.ProcessConfig(**kw)
        _close(PP.process_img(tiles, cfg), ref)
        _close(PP.process_batch_fn(cfg, CPU)(tiles), ref)


def test_transfer_dtypes_round_trip():
    for dt in (np.uint8, np.uint16, np.int16, np.float32):
        a = (np.arange(24).reshape(2, 3, 4) * 2731 % 251).astype(dt)
        t = upload(a, CPU)
        assert host_dtype(t) == np.dtype(dt)
        back = np.asarray(HostArray(t))
        assert back.dtype == np.dtype(dt)
        np.testing.assert_array_equal(back, a)
    with pytest.raises(TypeError):
        upload(np.zeros(3, np.int32), CPU)
