"""The port's channel alignment and composite writer against the JAX
package's (which calls OpenCV on the host).

- ECC: the port's PyTorch `_ecc_translation` against OpenCV's
  findTransformECC (reached through the JAX package's `_ecc_translation`)
  on 8 seeded pairs of smooth textures, integer and sub-pixel shifts, odd
  and even sizes: the float translation within 0.02 px.  A pair of
  unrelated textures makes OpenCV raise, and the port's ECC must fail
  too; both then take phase correlation, which must agree within 0.02 px.
- The building blocks against OpenCV itself: Sobel magnitude, the optimal
  DFT sizes, phase correlation.
- get_offsets_ecc, align_volumes, align_big_channels: the same integers.
- write_composite_series: planes byte-equal for RGB, CMYK with a key
  channel, right_bit_shifts, unequal plane sizes, a shorter channel and
  resume.
- The align_channels CLI: the same alignments.txt and RGB series.
"""

import cv2
import numpy as np
import pytest
import torch
from scipy import ndimage

from ipp_tpu.io import tiff as tio
from ipp_tpu.pipeline import align_channels as J
from ipp_tpu_torch.pipeline import align_channels as P
from tests.synth import make_phantom

TOL_PX = 0.02


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("IPP_TPU_PLATFORM", "cpu")


def _pair(seed, shift, shape, sigma=2.5):
    """Two crops of one smooth random texture, the second shifted by
    `shift` (y, x) with cubic interpolation."""
    rng = np.random.default_rng(seed)
    big = ndimage.gaussian_filter(
        rng.random((shape[0] + 20, shape[1] + 20)), sigma) * 1000
    ref = big[10:10 + shape[0], 10:10 + shape[1]]
    mov = ndimage.shift(big, shift, order=3)[10:10 + shape[0],
                                             10:10 + shape[1]]
    return ref.astype(np.float32), mov.astype(np.float32)


def _cv2_ecc_raises(ref, mov):
    def grad(img):
        gx = cv2.Sobel(img, cv2.CV_32F, 1, 0, ksize=3)
        gy = cv2.Sobel(img, cv2.CV_32F, 0, 1, ksize=3)
        return cv2.magnitude(gx, gy)

    try:
        cv2.findTransformECC(
            grad(ref), grad(mov), np.eye(2, 3, dtype=np.float32),
            cv2.MOTION_TRANSLATION,
            (cv2.TERM_CRITERIA_EPS | cv2.TERM_CRITERIA_COUNT, 100, 1e-6))
    except cv2.error:
        return True
    return False


PAIRS = [(0, (1.3, -2.2), (64, 80)), (1, (0.0, 3.0), (64, 80)),
         (2, (-0.4, 0.7), (50, 70)), (3, (2.0, 5.5), (45, 77)),
         (4, (-7.2, 0.3), (61, 97)), (5, (0.25, 0.75), (33, 120)),
         (6, (-3.0, -3.0), (96, 96)), (7, (4.5, -1.5), (40, 56))]


@pytest.mark.parametrize("seed,shift,shape", PAIRS)
def test_ecc_translation_matches_opencv(seed, shift, shape):
    ref, mov = _pair(seed, shift, shape)
    assert not _cv2_ecc_raises(ref, mov)
    want = J._ecc_translation(ref, mov)
    got = P._ecc_translation(ref, mov)
    assert all(isinstance(v, float) for v in got)
    np.testing.assert_allclose(got, want, atol=TOL_PX, rtol=0)


def _unrelated(seed=9, shape=(64, 80)):
    rng = np.random.default_rng(seed)
    a, b = (ndimage.gaussian_filter(rng.random(shape), 2.5) * 1000
            for _ in range(2))
    return a.astype(np.float32), b.astype(np.float32)


@pytest.mark.parametrize("kind", ["unrelated", "flat"])
def test_ecc_failure_falls_back_to_phase_correlation(kind):
    """OpenCV raises (lambda_d <= 0 for unrelated textures, a NaN
    correlation for flat sections); the port's ECC fails on the same
    pair, and both fall back to phase correlation."""
    if kind == "unrelated":
        ref, mov = _unrelated()
    else:
        ref = mov = np.full((40, 50), 7.0, np.float32)
    assert _cv2_ecc_raises(ref, mov)
    g_ref = P._sobel_magnitude(torch.from_numpy(ref))
    g_mov = P._sobel_magnitude(torch.from_numpy(mov))
    assert P._ecc(g_ref, g_mov) is None
    np.testing.assert_allclose(P._ecc_translation(ref, mov),
                               J._ecc_translation(ref, mov),
                               atol=TOL_PX, rtol=0)


@pytest.mark.parametrize("seed,shape", [(0, (64, 80)), (3, (45, 77)),
                                        (4, (61, 97)), (5, (3, 7))])
def test_phase_correlate_and_sobel_match_opencv(seed, shape):
    ref, mov = _pair(seed, (1.7, -2.4), shape)
    for img in (ref, mov):
        want = cv2.magnitude(cv2.Sobel(img, cv2.CV_32F, 1, 0, ksize=3),
                             cv2.Sobel(img, cv2.CV_32F, 0, 1, ksize=3))
        got = P._sobel_magnitude(torch.from_numpy(img)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(want).max()))
    (x, y), _ = cv2.phaseCorrelate(ref, mov)
    np.testing.assert_allclose(
        P._phase_correlate(torch.from_numpy(ref), torch.from_numpy(mov)),
        (x, y), atol=TOL_PX, rtol=0)


def test_optimal_dft_sizes_match_opencv():
    for n in list(range(1, 400)) + [1021, 2047, 5603, 5613, 8191]:
        assert P._optimal_dft_size(n) == cv2.getOptimalDFTSize(n), n


def _beads(seed, shape=(16, 96, 96), n=200, sigma=1.5):
    """Sparse blurred beads: the texture ECC on Sobel gradients is made
    for (smooth random fields are degenerate for it; see below)."""
    rng = np.random.default_rng(seed)
    vol = np.zeros(shape, np.float32)
    vol[tuple(rng.integers(3, s - 3, n) for s in shape)] = 3000.0
    return ndimage.gaussian_filter(vol, sigma)


@pytest.mark.parametrize("seed,shift", [(1, (1, 4, -3)), (2, (0, 3, 0)),
                                        (3, (-2, -1, 2)), (4, (2, -3, 1))])
def test_align_volumes_same_integers(seed, shift):
    """The same integers as the JAX package, equal to the truth, and the
    same aligned volume."""
    vol = _beads(seed)
    moved = J.roll_pad(vol.copy(), shift)
    assert P.get_offsets_ecc(vol, moved) == J.get_offsets_ecc(vol, moved)
    got_vol, got = P.align_volumes(vol, moved, max_iter=8)
    want_vol, want = J.align_volumes(vol, moved, max_iter=8)
    assert got == want == tuple(-s for s in shift)
    np.testing.assert_array_equal(got_vol, want_vol)


def test_ecc_iterates_match_opencv_until_a_divergent_run_turns_chaotic():
    """Where OpenCV's ECC does not converge, its iterates jump by pixels
    from step to step and no other arithmetic reproduces where they end
    (OpenCV's own SIMD widths would not): on this section of the JAX
    package's smooth-phantom fixture (tests/test_pipeline.py, seed 42,
    shift (1, 4, -3), the sixth ECC call of align_volumes) OpenCV raises
    after 37 iterations.  The port takes the same steps — within 1e-4 px
    for the first 7 — until float rounding, amplified each step, parts
    the trajectories; align_volumes' best-visited-state guard exists for
    such sections.  The twin cases above converge."""
    vol = make_phantom(np.random.default_rng(42), (16, 96, 96),
                       smooth=5.0).astype(np.float32)
    moved = J.roll_pad(vol.copy(), (1, 4, -3))
    sections = []
    real = J._ecc_translation

    def spy(r, m):
        sections.append((r, m))
        return real(r, m)

    try:
        J._ecc_translation = spy
        J.align_volumes(vol, moved, max_iter=8)
    finally:
        J._ecc_translation = real
    ref, mov = sections[5]
    g_ref = P._sobel_magnitude(torch.from_numpy(np.asarray(ref, np.float32)))
    g_mov = P._sobel_magnitude(torch.from_numpy(np.asarray(mov, np.float32)))
    tmpl, img = g_ref.numpy(), g_mov.numpy()
    for k in range(1, 8):
        _, warp = cv2.findTransformECC(
            tmpl, img, np.eye(2, 3, dtype=np.float32),
            cv2.MOTION_TRANSLATION,
            (cv2.TERM_CRITERIA_EPS | cv2.TERM_CRITERIA_COUNT, k, 1e-6))
        np.testing.assert_allclose(P._ecc(g_ref, g_mov, iterations=k),
                                   (warp[0, 2], warp[1, 2]), atol=1e-4)
    assert _cv2_ecc_raises(np.asarray(ref, np.float32),
                           np.asarray(mov, np.float32))


def _write_series(d, vol, dtype=np.uint16):
    d.mkdir(parents=True, exist_ok=True)
    for z in range(vol.shape[0]):
        tio.imwrite(d / f"img_{z:06d}.tif", vol[z].astype(dtype))
    return d


def test_align_big_channels_same_integers(tmp_path):
    """Streamed sections of a dot phantom (the JAX package's own fixture
    kind for the streamed path)."""
    rng = np.random.default_rng(3)
    vol = np.zeros((24, 96, 96), np.float32)
    pts = rng.integers(6, 90, (300, 2))
    vol[rng.integers(3, 21, 300), pts[:, 0], pts[:, 1]] = 3000.0
    vol = ndimage.gaussian_filter(vol, 1.5)
    mov = J.roll_pad(vol.copy(), (2, -3, 4))
    ref_dir = _write_series(tmp_path / "ref", vol)
    mov_dir = _write_series(tmp_path / "mov", mov)
    got = P.align_big_channels(ref_dir, {"ch1": mov_dir})
    want = J.align_big_channels(ref_dir, {"ch1": mov_dir})
    assert got == want
    assert all(abs(o + t) <= 1 for o, t in zip(got["ch1"], (2, -3, 4)))
    a = P.write_aligned_series(mov_dir, tmp_path / "a_port", got["ch1"])
    b = J.write_aligned_series(mov_dir, tmp_path / "a_jax", got["ch1"])
    _same_files(a, b)


def _same_files(a_dir, b_dir, pattern="*.tif"):
    names = sorted(p.name for p in b_dir.glob(pattern))
    assert names and sorted(p.name for p in a_dir.glob(pattern)) == names
    for n in names:
        assert (a_dir / n).read_bytes() == (b_dir / n).read_bytes(), n


@pytest.fixture(scope="module")
def channels(tmp_path_factory):
    """Four u16 channel series: unequal plane sizes (one 2 px wider and
    taller, for pad_to_max) and one channel two planes shorter."""
    root = tmp_path_factory.mktemp("channels")
    rng = np.random.default_rng(21)
    dirs = {}
    for i, (shape, depth) in enumerate([((40, 52), 6), ((40, 52), 6),
                                        ((42, 54), 6), ((40, 52), 4)]):
        vol = rng.integers(0, 4000, (depth,) + shape).astype(np.uint16)
        dirs[f"ch{i}"] = _write_series(root / f"ch{i}", vol)
    return dirs


CASES = {
    "rgb": (dict(zip(["ch0", "ch1", "ch2"], "rgb")), None, None),
    "cmyk_key": (dict(zip(["ch0", "ch1", "ch2", "ch3"], "cmyk")), None,
                 None),
    "bit_shift": (dict(zip(["ch0", "ch1", "ch3"], "rbg")),
                  {"ch0": 4, "ch1": 8, "ch3": 6}, None),
    "offsets": (dict(zip(["ch0", "ch2", "ch3"], "gbr")), None,
                {"ch2": (1, -2, 3), "ch3": (-1, 2, 0)}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_write_composite_series_byte_equal(channels, tmp_path, case):
    colors, shifts, offsets = CASES[case]
    chans = {c: channels[c] for c in colors}
    outs = {}
    for name, mod in (("port", P), ("jax", J)):
        outs[name] = mod.write_composite_series(
            chans, colors, tmp_path / name, offsets=offsets,
            right_bit_shifts=shifts, dtype=np.uint16)
    _same_files(outs["port"], outs["jax"])
    first = tio.imread(outs["port"] / "composite_000000.tif")
    assert first.shape[:2] == ((42, 54) if "ch2" in colors else (40, 52))
    assert first.shape[2] == (
        4 if case == "cmyk_key" else 3)
    assert first.dtype == (np.uint8 if shifts else np.uint16)


def test_write_composite_series_resume(channels, tmp_path):
    """Resume keeps a plane that exists and writes the others, in both
    packages alike."""
    colors = {"ch0": "r", "ch1": "g"}
    sentinel = np.full((40, 52, 3), 7, np.uint16)
    outs = {}
    for name, mod in (("port", P), ("jax", J)):
        out = tmp_path / name
        out.mkdir()
        tio.imwrite(out / "composite_000002.tif", sentinel)
        outs[name] = mod.write_composite_series(
            {c: channels[c] for c in colors}, colors, out, resume=True)
    _same_files(outs["port"], outs["jax"])
    np.testing.assert_array_equal(
        tio.imread(outs["port"] / "composite_000002.tif"), sentinel)
    assert len(list(outs["port"].glob("composite_*.tif"))) == 6


def test_align_channels_cli_same_outputs(tmp_path):
    """The align_images.py-surface CLI of both packages: the same
    alignments.txt, aligned downsampled RGB series, singles and the
    original-resolution RGB series."""
    vol = _beads(5)
    moved = J.roll_pad(vol.copy(), (1, 3, -2))
    args = []
    for name, v in (("red", vol), ("green", moved)):
        big = np.repeat(np.repeat(v, 2, axis=1), 2, axis=2)
        d = _write_series(tmp_path / f"{name}_orig", big)
        stack = tmp_path / f"{name}_down.tif"
        tio.write_tiff_stack(stack, v.astype(np.uint16))
        args += [f"--{name}", str(d), str(stack)]
    args += ["--write_alignments", "--save_singles", "--dtype", "uint16",
             "--dx", "1", "2", "--dy", "1", "2", "--dz", "1", "1"]
    out = {}
    for name, mod in (("port", P), ("jax", J)):
        out[name] = tmp_path / f"out_{name}"
        assert mod.main(args + ["-o", str(out[name])]) == 0
    txt = (out["port"] / "alignments.txt").read_text()
    assert txt == (out["jax"] / "alignments.txt").read_text()
    assert "green: dz,dy,dx = (-1, -3, 2)" in txt
    for sub in ("downsampled/RGB", "downsampled/green", "original/green",
                "original/RGB"):
        _same_files(out["port"] / sub, out["jax"] / sub)
