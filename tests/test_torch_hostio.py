"""The port's copies of the reference's host IO behave like the originals.

ipp_tpu_torch imports nothing of ipp_tpu, so it keeps copies of the host
modules it needs (io/tiff.py, io/dcimg.py, io/nrrd.py, io/raw.py,
io/generic2d.py, io/terafly.py, io/vaa3draw.py, io/ims.py, native/ with
fastio.cpp, parallel/executor.py, parallel/sandbox.py, utils/iostat.py,
lagged.py, log.py, memory.py, progress.py, geometry/extent.py,
geometry/stacks.py, stitch/place.py, utils/tifstack.py, io/bdv.py,
io/precomputed.py, pipeline/scan_stitch.py, pipeline/flip.py,
pipeline/command_generator.py, utils/checkfiles.py, utils/cli.py,
utils/markers.py, utils/reconops.py).  Held here against the
originals: each copy's source equals its original up to the package's
name in imports and comments (and, in pipeline/command_generator.py, in
the `python -m` module paths of the commands it writes, which name the
port's CLIs); a TIFF written by each package is
byte-equal and reads back equal through the other; the native
`read_block` equals the numpy path; an NRRD round-trip; and
`run_tile_pipeline` on a few small tiles writes the same files."""

import re
from pathlib import Path

import numpy as np
import pytest

from ipp_tpu import native as native_j
from ipp_tpu.io import nrrd as nrrd_j
from ipp_tpu.io import tiff as tiff_j
from ipp_tpu.parallel import executor as exec_j
from ipp_tpu_torch import native as native_t
from ipp_tpu_torch.io import nrrd as nrrd_t
from ipp_tpu_torch.io import tiff as tiff_t
from ipp_tpu_torch.parallel import executor as exec_t

ROOT = Path(__file__).resolve().parent.parent
# copies whose code equals the original once the reference's absolute
# imports of its own package are read as the port's relative ones
VERBATIM = ["io/tiff.py", "io/dcimg.py", "io/nrrd.py", "parallel/executor.py",
            "parallel/sandbox.py", "utils/iostat.py", "utils/lagged.py",
            "utils/log.py", "utils/memory.py", "utils/progress.py",
            "geometry/extent.py", "geometry/stacks.py", "io/raw.py",
            "io/generic2d.py", "stitch/place.py", "io/terafly.py",
            "io/vaa3draw.py", "io/ims.py", "utils/tifstack.py",
            "pipeline/scan_stitch.py", "io/bdv.py", "io/precomputed.py",
            "pipeline/flip.py", "utils/checkfiles.py", "utils/cli.py",
            "utils/markers.py", "utils/reconops.py"]
# copies that equal the original once, besides the imports, each
# (pattern, replacement) is applied: the command generator writes
# `python -m <package>.pipeline.<cli>` commands, and the port's must run
# the port's CLIs, never the JAX package's
RENAMED = {"pipeline/command_generator.py":
           [(r"\bipp_tpu\.pipeline\.", "ipp_tpu_torch.pipeline.")]}


def _relative(src: str) -> str:
    """The reference's `from ipp_tpu.x import y` / `from ipp_tpu import x`
    inside its sub-packages, as the port writes them (`from ..x import y`,
    `from .. import x`)."""
    src = re.sub(r"from ipp_tpu\.(\w)", r"from ..\1", src)
    return re.sub(r"from ipp_tpu import", "from .. import", src)


@pytest.mark.parametrize("rel", VERBATIM + list(RENAMED))
def test_copy_equals_its_original(rel):
    expected = _relative((ROOT / "ipp_tpu" / rel).read_text())
    for pattern, repl in RENAMED.get(rel, []):
        expected = re.sub(pattern, repl, expected)
    assert (ROOT / "ipp_tpu_torch" / rel).read_text() == expected


def _code_lines(path: Path):
    return [ln for ln in path.read_text().splitlines()
            if not ln.lstrip().startswith("//")]


def test_fastio_source_equals_the_original_but_for_comments():
    assert _code_lines(ROOT / "ipp_tpu_torch/native/fastio.cpp") == \
        _code_lines(ROOT / "ipp_tpu/native/fastio.cpp")


def test_native_library_builds_into_the_build_tree():
    """The port builds its own library from its copy of fastio.cpp into
    build/ipp_tpu_torch/ and never loads the reference's."""
    assert native_t.available(), "g++ could not build fastio.cpp"
    path = native_t._library_path()
    assert path.parent == ROOT / "build" / "ipp_tpu_torch"
    assert path.exists()
    assert native_t._ABI_VERSION == native_j._ABI_VERSION


def _planes(rng, dtype, shape=(37, 53)):
    if np.dtype(dtype).kind == "f":
        return (rng.random(shape) * 1000 - 200).astype(dtype)
    info = np.iinfo(dtype)
    return rng.integers(info.min, info.max, shape, endpoint=True,
                        dtype=dtype)


@pytest.mark.parametrize("dtype", [np.uint16, np.uint8, np.float32])
@pytest.mark.parametrize("compression", [None, "zlib", "zlib:1"])
def test_tiff_written_by_each_package_is_byte_equal(tmp_path, rng, dtype,
                                                    compression):
    img = _planes(rng, dtype)
    pj, pt = tmp_path / "j.tif", tmp_path / "t.tif"
    tiff_j.imwrite(pj, img, compression=compression)
    tiff_t.imwrite(pt, img, compression=compression)
    assert pj.read_bytes() == pt.read_bytes()
    for read in (tiff_j.imread, tiff_t.imread):
        for p in (pj, pt):
            got = read(p)
            assert got.dtype == img.dtype
            np.testing.assert_array_equal(got, img)


def test_tiff_stack_python_codec_is_byte_equal(tmp_path, rng):
    vol = _planes(rng, np.uint16, (5, 24, 31))
    pj, pt = tmp_path / "j.tif", tmp_path / "t.tif"
    tiff_j.write_tiff_stack(pj, vol)
    tiff_t.write_tiff_stack(pt, vol)
    assert pj.read_bytes() == pt.read_bytes()
    np.testing.assert_array_equal(tiff_t.read_tiff_stack(pj), vol)
    np.testing.assert_array_equal(tiff_j.read_tiff_stack(pt), vol)


@pytest.mark.parametrize("dtype", [np.uint16, np.float32])
def test_native_read_block_equals_the_numpy_path(tmp_path, rng, dtype):
    planes = [_planes(rng, dtype, (48, 64)) for _ in range(6)]
    paths = []
    for i, p in enumerate(planes):
        paths.append(tmp_path / f"p{i:03d}.tif")
        tiff_t.imwrite(paths[-1], p, compression="zlib" if i % 2 else None)
    box = (7, 41, 3, 60)
    want = np.stack([tiff_t.imread(p)[7:41, 3:60] for p in paths])
    got = native_t.read_block(paths, *box, dtype=dtype)
    assert got is not None and got.dtype == np.dtype(dtype)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        native_j.read_block(paths, *box, dtype=dtype), got)


def test_native_read_block_zero_fills_a_missing_plane(tmp_path, rng):
    p = tmp_path / "a.tif"
    img = _planes(rng, np.uint16, (20, 20))
    tiff_t.imwrite(p, img)
    got = native_t.read_block([p, tmp_path / "missing.tif"], 0, 20, 0, 20)
    np.testing.assert_array_equal(got[0], img)
    assert not got[1].any()


@pytest.mark.parametrize("encoding", ["raw", "gzip"])
@pytest.mark.parametrize("dtype", [np.uint16, np.float32])
def test_nrrd_round_trip(tmp_path, rng, encoding, dtype):
    vol = _planes(rng, dtype, (6, 9, 11))
    pj, pt = tmp_path / "j.nrrd", tmp_path / "t.nrrd"
    nrrd_j.write_nrrd(pj, vol, encoding=encoding)
    nrrd_t.write_nrrd(pt, vol, encoding=encoding)
    if encoding == "raw":   # gzip stamps its own time into the stream
        assert pj.read_bytes() == pt.read_bytes()
    for p in (pj, pt):
        got, head = nrrd_t.read_nrrd(p)
        ref, ref_head = nrrd_j.read_nrrd(p)
        np.testing.assert_array_equal(got, vol)
        np.testing.assert_array_equal(ref, vol)
        assert head == ref_head


def test_run_tile_pipeline_writes_the_same_tiles(tmp_path, rng):
    """A few small tiles, one of them corrupt, through each executor with
    the same batch function: the same counters and byte-equal outputs."""
    src = tmp_path / "in"
    src.mkdir()
    names = []
    for i in range(11):
        names.append(f"t{i:02d}.tif")
        tiff_j.imwrite(src / names[-1], _planes(rng, np.uint16, (24, 40)))
    (src / names[5]).write_bytes(b"not a tiff")

    def batch(b):
        return (b.astype(np.uint32) * 3 // 4).astype(np.uint16)

    outs = {}
    for tag, ex in (("j", exec_j), ("t", exec_t)):
        dst = tmp_path / tag
        tasks = [ex.TileTask(src / n, dst / n) for n in names]
        counts = ex.run_tile_pipeline(tasks, batch, batch_size=4,
                                      reader_threads=2, writer_threads=2)
        assert counts == {"done": 10, "skipped": 0, "failed": 1}
        outs[tag] = dst
        again = ex.run_tile_pipeline(tasks, batch, resume=True)
        assert again == {"done": 0, "skipped": 11, "failed": 0}
    for n in names:
        assert (outs["j"] / n).read_bytes() == (outs["t"] / n).read_bytes()
    assert not tiff_t.imread(outs["t"] / names[5]).any()
    np.testing.assert_array_equal(tiff_t.imread(outs["t"] / names[0]),
                                  batch(tiff_t.imread(src / names[0])))


@pytest.fixture()
def series(tmp_path, rng):
    d = tmp_path / "series"
    d.mkdir()
    planes = rng.integers(0, 60000, (5, 40, 52)).astype(np.uint16)
    for z, p in enumerate(planes):
        tiff_j.imwrite(d / f"img_{z:06d}.tif", p)
    return d, planes


def test_terafly_export_of_each_package_is_byte_equal(tmp_path, series):
    """The TeraFly pyramids the two packages write are the same files,
    byte for byte, and read back through the other package's reader."""
    from ipp_tpu.io import terafly as tf_j
    from ipp_tpu_torch.io import terafly as tf_t

    src, planes = series
    tf_j.tif_series_to_terafly(src, tmp_path / "j", voxel_um=(2, 1, 1))
    tf_t.tif_series_to_terafly(src, tmp_path / "t", voxel_um=(2, 1, 1))
    files = sorted(p.relative_to(tmp_path / "j")
                   for p in (tmp_path / "j").rglob("*") if p.is_file())
    assert files and files == sorted(
        p.relative_to(tmp_path / "t")
        for p in (tmp_path / "t").rglob("*") if p.is_file())
    for f in files:
        assert (tmp_path / "t" / f).read_bytes() == \
            (tmp_path / "j" / f).read_bytes(), f
    vol = tf_j.TeraFlyVolume(tmp_path / "t")
    for z in range(len(planes)):
        np.testing.assert_array_equal(vol[z], planes[z])


def test_imaris_export_reads_back_through_the_other_package(tmp_path,
                                                             series):
    from ipp_tpu.io import ims as ims_j
    from ipp_tpu_torch.io import ims as ims_t

    src, planes = series
    ims_t.tif_series_to_imaris(src, tmp_path / "t.ims", voxel_um=(2, 1, 1))
    ims_j.tif_series_to_imaris(src, tmp_path / "j.ims", voxel_um=(2, 1, 1))
    for reader, path in ((ims_j.ImarisReader, "t.ims"),
                         (ims_t.ImarisReader, "j.ims")):
        with reader(tmp_path / path) as r:
            assert r.shape == planes.shape
            for z in range(len(planes)):
                np.testing.assert_array_equal(r[z], planes[z])


def test_raw_and_vaa3d_round_trip_through_the_other_package(tmp_path, rng):
    from ipp_tpu.io import raw as raw_j
    from ipp_tpu.io import vaa3draw as v3_j
    from ipp_tpu_torch.io import raw as raw_t
    from ipp_tpu_torch.io import vaa3draw as v3_t

    img = rng.integers(0, 60000, (33, 47)).astype(np.uint16)
    raw_t.raw_imsave(tmp_path / "a.raw", img)
    np.testing.assert_array_equal(raw_j.raw_imread(tmp_path / "a.raw"), img)
    vol = rng.integers(0, 60000, (3, 20, 25)).astype(np.uint16)
    v3_t.vaa3d_raw_write(tmp_path / "v.v3draw", vol)
    v3_j.vaa3d_raw_write(tmp_path / "w.v3draw", vol)
    assert (tmp_path / "v.v3draw").read_bytes() == \
        (tmp_path / "w.v3draw").read_bytes()
    np.testing.assert_array_equal(
        np.squeeze(v3_j.vaa3d_raw_read(tmp_path / "v.v3draw")),
        np.squeeze(v3_t.vaa3d_raw_read(tmp_path / "w.v3draw")))


def test_placement_xml_of_each_package_is_byte_equal(tmp_path, rng):
    from ipp_tpu.geometry.stacks import TileGrid as JGrid
    from ipp_tpu_torch.geometry.stacks import TileGrid as TGrid

    root = tmp_path / "tiles"
    for x in (0, 1000):
        for y in (0, 1500):
            d = root / f"{x:06d}" / f"{x:06d}_{y:06d}"
            d.mkdir(parents=True)
            for z in range(2):
                tiff_j.imwrite(d / f"{z * 20:06d}.tif",
                               rng.integers(0, 999, (30, 40)).astype(
                                   np.uint16))
    JGrid.from_directory(root, voxel_um=(1.0, 1.0, 2.0)).to_xml(
        tmp_path / "j.xml")
    TGrid.from_directory(root, voxel_um=(1.0, 1.0, 2.0)).to_xml(
        tmp_path / "t.xml")
    assert (tmp_path / "j.xml").read_bytes() == \
        (tmp_path / "t.xml").read_bytes()
    TGrid.from_xml(tmp_path / "j.xml").to_xml(tmp_path / "tj.xml")
    assert (tmp_path / "tj.xml").read_bytes() == \
        (tmp_path / "j.xml").read_bytes()
