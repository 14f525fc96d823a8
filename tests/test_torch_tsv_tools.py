"""Every subcommand of the port's tsv_tools CLI against the JAX package's.

Each case builds its input once and runs `main` of both packages on its
own copy (several subcommands rename or fill their input in place), then
compares every file the two runs leave: byte-equal for the host tools and
the exact device reductions (downsample), within 1 count for the blends
(convert, simple) and the 3D resize, within 1e-4 of the volume's maximum
for the npz.  `justified_stitch` (a function, no subcommand) is held the
same way."""

import shutil

import numpy as np
import pytest

from ipp_tpu.io import tiff as tio
from ipp_tpu.io.ims import write_imaris
from ipp_tpu.pipeline import tsv_tools as J
from ipp_tpu_torch.pipeline import tsv_tools as P
from tests.synth import cut_tiles, make_phantom, write_tile_grid


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("IPP_TPU_PLATFORM", "cpu")
    monkeypatch.setenv("IPP_TPU_PROGRESS", "off")


def _series(d, vol):
    d.mkdir(parents=True, exist_ok=True)
    for z in range(vol.shape[0]):
        tio.imwrite(d / f"img_{z:06d}.tif", vol[z])
    return d


def _vol(seed=1, shape=(6, 40, 52)):
    return np.random.default_rng(seed).integers(
        0, 9000, shape).astype(np.uint16)


def _grid(src):
    rng = np.random.default_rng(2)
    vol = make_phantom(rng, (5, 100, 100), smooth=4.0)
    tiles, _ = cut_tiles(vol, 2, 2, (60, 60), 20, 0, rng)
    grid = write_tile_grid(src / "tiles", tiles, overlap_nominal_px=20,
                           voxel_um=(1.8, 1.8, 2.0))
    grid.to_xml(src / "step5.xml")


def _smartspim(src):
    rng = np.random.default_rng(3)
    base = (rng.random((3, 120, 130)) * 900).astype(np.uint16)
    for x in (12000, 12700):
        for y in (30000, 30650):
            d = src / "tree" / f"{x:06d}" / f"{x:06d}_{y:06d}"
            d.mkdir(parents=True)
            px, py = int((x - 12000) / 18.0), int((y - 30000) / 18.0)
            for z in range(3):
                tio.imwrite(d / f"{z:04d}.tif",
                            base[z, py:py + 40, px:px + 48])


def _holey_tree(src):
    """A microscope tree with missing planes; numeric names unpadded."""
    rng = np.random.default_rng(4)
    for x in ("100", "200"):
        for y in ("100", "300"):
            d = src / "tree" / x / f"{x}_{y}"
            d.mkdir(parents=True)
            for z in (0, 10, 20):
                if (x, y, z) in (("200", "100", 10), ("100", "300", 20)):
                    continue
                tio.imwrite(d / f"{z}.tiff",
                            rng.integers(0, 500, (8, 9)).astype(np.uint16))


def _negative_tree(src):
    for x, y in ((-20, -10), (-20, 30), (40, -10), (40, 30)):
        d = src / "tree" / f"{x}" / f"{x}_{y}"
        d.mkdir(parents=True)
        tio.imwrite(d / "0.tif", np.full((4, 4), x + 100, np.uint16))


def _gappy_series(src):
    d = src / "series"
    d.mkdir()
    for z in (0, 1, 4, 5, 8):
        tio.imwrite(d / f"img_{z:06d}.tif", np.full((6, 7), z, np.uint16))
    tio.imwrite(d / "img_000003.tiff", np.full((6, 7), 3, np.uint16))


def _ims(src):
    write_imaris(src / "v.ims", lambda z: _vol(5, (6, 40, 52))[z],
                 (6, 40, 52), np.uint16)


def _pfc(src):
    rng = np.random.default_rng(6)
    for z in ("Z001", "Z002"):
        for y in ("Y01", "Y02"):
            d = src / "pfc" / z / y
            d.mkdir(parents=True)
            for x in ("X1", "X10", "X2"):
                if (z, y, x) == ("Z002", "Y01", "X10"):
                    continue
                tio.imwrite(d / f"{z}_{y}_{x}.tif",
                            rng.integers(0, 99, (8, 8)).astype(np.uint16))


# name -> (input builder, argv with {src}/{out}, tolerance in counts of
# the TIFFs; an npz is always held to 1e-4 of its maximum)
CASES = {
    "convert": (_grid, ["convert", "--xml-path", "{src}/step5.xml",
                        "--output-pattern", "{out}/img_{{z:04d}}.tif",
                        "--compression", "3"], 1),
    "convert_mip_volume": (_grid, [
        "convert", "--xml-path", "{src}/step5.xml", "--output-pattern",
        "{out}/p_{{z:04d}}.tif", "--mipmap-level", "1", "--volume",
        "4,80,6,90,1,5", "--rotation", "90", "--cosine-blending"], 1),
    "downsample_sum": (lambda s: _series(s / "in", _vol()), [
        "downsample", "--src", "{src}/in", "--dest", "{out}"], 0),
    "downsample_mean_z": (lambda s: _series(s / "in", _vol()), [
        "downsample", "--input", "{src}/in", "--output", "{out}",
        "--factor", "3", "--method", "mean", "--z-factor", "2",
        "--compression", "0"], 0),
    "simple": (_smartspim, ["simple", "--path", "{src}/tree",
                            "--voxel-size-xy", "1.8", "--output-pattern",
                            "{out}/img_{{z:04d}}.tif"], 1),
    "fill-blanks": (_gappy_series, ["fill-blanks", "--dir",
                                    "{src}/series"], 0),
    "fill-blanks-tree": (_holey_tree, ["fill-blanks-tree", "--src",
                                       "{src}/tree", "--dest", "{out}"], 0),
    "renumber": (_gappy_series, ["renumber", "--dir", "{src}/series"], 0),
    "renumber-tree": (_holey_tree, ["renumber-tree", "{src}/tree",
                                    "--n-digits", "5"], 0),
    "renumber-directories": (_negative_tree, [
        "renumber-directories", "--path", "{src}/tree"], 0),
    "npz": (lambda s: _series(s / "in", _vol(7, (9, 48, 40))), [
        "npz", "-i", "{src}/in", "-o", "{out}.npz", "-dx", "1", "-dy",
        "1", "-dz", "2", "-dt", "4"], 0),
    "crop-series": (lambda s: _series(s / "in", _vol()), [
        "crop-series", "--input", "{src}/in", "--output", "{out}",
        "--roi", "3", "30", "5", "41", "--z", "1", "5"], 0),
    "resize3d": (lambda s: _series(s / "in", _vol(8, (6, 24, 30))), [
        "resize3d", "--input", "{src}/in", "--output", "{out}",
        "--shape", "4", "17", "45"], 1),
    "crop-ims": (_ims, ["crop-ims", "--ims", "{src}/v.ims", "--output",
                        "{out}", "--roi", "1", "5", "2", "30", "3", "40",
                        "--right-shift", "5"], 0),
    "pfc-to-ls": (_pfc, ["pfc-to-ls", "--root", "{src}/pfc", "--target",
                         "{out}", "--xy-step", "10", "--z-step", "20",
                         "--frame-shape", "8", "8"], 0),
    "precomputed": (lambda s: _series(s / "in", _vol(9, (20, 70, 66))), [
        "precomputed", "--input", "{src}/in", "--output", "{out}",
        "--voxel-nm", "2000", "1000", "1000", "--levels", "2"], 0),
}


def _files(d):
    return sorted(p.relative_to(d) for p in d.rglob("*") if p.is_file())


def _compare(a_dir, b_dir, tol):
    files = _files(b_dir)
    assert files and _files(a_dir) == files
    for f in files:
        a, b = a_dir / f, b_dir / f
        if f.suffix == ".npz":
            va, vb = np.load(a, allow_pickle=True), np.load(b,
                                                            allow_pickle=True)
            np.testing.assert_allclose(
                va["I"], vb["I"], atol=1e-4 * float(np.abs(vb["I"]).max()))
            for xa, xb in zip(va["xI"], vb["xI"]):
                np.testing.assert_array_equal(xa, xb)
        elif tol and f.suffix == ".tif":
            ia, ib = tio.imread(a), tio.imread(b)
            assert ia.dtype == ib.dtype and ia.shape == ib.shape, f
            assert np.abs(ia.astype(np.int64)
                          - ib.astype(np.int64)).max() <= tol, f
        else:
            assert a.read_bytes() == b.read_bytes(), f


@pytest.mark.parametrize("case", sorted(CASES))
def test_subcommand_same_files(case, tmp_path):
    build, argv, tol = CASES[case]
    src = tmp_path / "src"
    src.mkdir()
    build(src)
    work = {}
    for name, main in (("port", P.main), ("jax", J.main)):
        work[name] = tmp_path / name
        shutil.copytree(src, work[name] / "src")
        args = [a.format(src=work[name] / "src", out=work[name] / "out")
                for a in argv]
        assert main(args) == 0
    _compare(work["port"], work["jax"], tol)


def test_justified_stitch_within_one_count():
    rng = np.random.default_rng(10)
    a = rng.integers(0, 4000, (50, 60)).astype(np.uint16)
    b = rng.integers(0, 4000, (44, 58)).astype(np.uint16)
    for cosine in (True, False):
        got = P.justified_stitch(a, b, (-7, 41), cosine=cosine)
        want = J.justified_stitch(a, b, (-7, 41), cosine=cosine)
        assert got.dtype == want.dtype and got.shape == want.shape
        assert np.abs(got.astype(np.int64) - want.astype(np.int64)).max() <= 1
