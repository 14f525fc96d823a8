"""The port's converter CLI (pipeline/convert.py) against the JAX
package's, on a small striped u16 series.

- `--destripe` (DWT destripe of every plane, K5's plain version here) with
  an isotropic downsample (`-dt`): the planes within 1 count, the
  downsampled chunk TIFFs within 1 count (they reduce planes that may
  differ by 1), the npz within 1 count;
- an exact chain (rotation, flip, 8-bit) with the BigDataViewer,
  TeraFly and precomputed exports: planes, exports and the u8 downsample
  byte-equal; a resumed run rewrites nothing;
- `--movie`: the same frames from the same planes (OpenCV on the host,
  the one place the port imports it)."""

import cv2
import h5py
import numpy as np
import pytest

from ipp_tpu.io import tiff as tio
from ipp_tpu.pipeline import convert as J
from ipp_tpu_torch.pipeline import convert as P


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("IPP_TPU_PLATFORM", "cpu")
    monkeypatch.setenv("IPP_TPU_PROGRESS", "off")


@pytest.fixture(scope="module")
def series(tmp_path_factory):
    """12 striped u16 planes of 96 x 128 (vertical stripes on a smooth
    field, a few bright blobs), one uniform plane among them."""
    d = tmp_path_factory.mktemp("conv") / "in"
    d.mkdir()
    rng = np.random.default_rng(6)
    yy, xx = np.mgrid[0:96, 0:128].astype(np.float32)
    for z in range(12):
        img = 800 + 300 * np.sin(xx / 9.0 + z / 3.0) * np.cos(yy / 13.0)
        img *= 1.0 + 0.3 * (rng.random(128) > 0.8)[None, :]
        for _ in range(4):
            cy, cx = rng.integers(8, 88), rng.integers(8, 120)
            img += 3000 * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / 8.0)
        if z == 7:
            img[:] = 500
        tio.imwrite(d / f"img_{z:06d}.tif",
                    np.clip(img, 0, 65535).astype(np.uint16))
    return d


def _run(main, src, out, extra):
    assert main(["-i", str(src), "-o", str(out), *extra]) == 0
    return out


def _names(d, pattern="*.tif"):
    return sorted(p.name for p in d.glob(pattern))


def _within(a_dir, b_dir, atol):
    names = _names(b_dir)
    assert names and _names(a_dir) == names
    for n in names:
        a, b = tio.imread(a_dir / n), tio.imread(b_dir / n)
        assert a.dtype == b.dtype and a.shape == b.shape, n
        diff = np.abs(a.astype(np.float64) - b.astype(np.float64)).max()
        assert diff <= atol, (n, diff)


def _same_tree(a_dir, b_dir):
    files = sorted(p.relative_to(b_dir) for p in b_dir.rglob("*")
                   if p.is_file())
    assert files and files == sorted(p.relative_to(a_dir)
                                     for p in a_dir.rglob("*") if p.is_file())
    for f in files:
        assert (a_dir / f).read_bytes() == (b_dir / f).read_bytes(), f


DESTRIPE = ["--destripe", "--sigma1", "24", "--sigma2", "24", "--wavelet",
            "db3", "--voxel", "2", "1", "1", "-dt", "4", "-zl", "0"]


def test_destripe_and_downsample_within_one_count(series, tmp_path):
    out = {name: _run(main, series, tmp_path / name / "tif", DESTRIPE)
           for name, main in (("port", P.main), ("jax", J.main))}
    _within(out["port"], out["jax"], 1)
    plane = tio.imread(out["port"] / "img_000003.tif")
    assert plane.dtype == np.uint16 and plane.shape == (96, 128)
    assert tio.imread(out["port"] / "img_000007.tif").max() == 0  # uniform
    ds = {k: v.parent / "tif_downsampled_4.0um" for k, v in out.items()}
    _within(ds["port"], ds["jax"], 1)
    assert len(_names(ds["port"])) == 6
    npz = {k: np.load(v.parent / "tif_zyx4.0um.npz", allow_pickle=True)
           for k, v in out.items()}
    assert npz["port"]["I"].shape == npz["jax"]["I"].shape
    np.testing.assert_allclose(npz["port"]["I"], npz["jax"]["I"], atol=1.0)
    for xa, xb in zip(npz["port"]["xI"], npz["jax"]["xI"]):
        np.testing.assert_array_equal(xa, xb)


EXACT = ["-r", "90", "--flip_upside_down", "--convert-to-8bit", "-b", "4",
         "--bdv", "--terafly", "--precomputed", "--voxel", "2", "1", "1",
         "-dt", "4", "-dsdt", "uint8", "-zl", "0"]


def test_exact_chain_and_exports_byte_equal(series, tmp_path):
    out = {name: _run(main, series, tmp_path / name / "tif", EXACT)
           for name, main in (("port", P.main), ("jax", J.main))}
    _same_tree(out["port"], out["jax"])
    assert tio.imread(out["port"] / "img_000000.tif").shape == (128, 96)
    for sub in ("tif_terafly", "tif_precomputed", "tif_downsampled_4.0um"):
        _same_tree(out["port"].parent / sub, out["jax"].parent / sub)
    assert (out["port"].parent / "tif_bdv.xml").read_text() == \
        (out["jax"].parent / "tif_bdv.xml").read_text()
    with h5py.File(out["port"].parent / "tif_bdv.h5") as a, \
            h5py.File(out["jax"].parent / "tif_bdv.h5") as b:
        keys = []
        b.visit(keys.append)
        assert keys
        for k in keys:
            if isinstance(b[k], h5py.Dataset):
                np.testing.assert_array_equal(a[k][()], b[k][()])
    # a resumed run finds every plane and chunk and rewrites nothing
    before = {p: p.stat().st_mtime_ns for p in out["port"].glob("*.tif")}
    _run(P.main, series, out["port"], EXACT + ["--resume"])
    assert before == {p: p.stat().st_mtime_ns
                      for p in out["port"].glob("*.tif")}


def test_movie_same_frames(series, tmp_path):
    movies = {}
    for name, mod in (("port", P), ("jax", J)):
        movies[name] = mod.tif_series_to_movie(
            series, tmp_path / f"{name}.avi", fps=10, start=2, end=9)
    frames = {}
    for name, path in movies.items():
        cap = cv2.VideoCapture(str(path))
        frames[name] = []
        ok, f = cap.read()
        while ok:
            frames[name].append(f)
            ok, f = cap.read()
        cap.release()
    assert len(frames["port"]) == len(frames["jax"]) == 7
    for a, b in zip(frames["port"], frames["jax"]):
        np.testing.assert_array_equal(a, b)
