"""The port's Imaris (.ims) and BigDataViewer (.h5 + .xml) exports, which
write through its own HDF5 module (io/hdf5.py), against the JAX
package's, which write through h5py.

- write_imaris (with a pyramid), write_imaris_timeseries (11 time points:
  a group of more than 8 children) and write_bdv (mean and max pooling):
  h5py sees equal trees, i.e. names, attribute values and dtypes, shapes,
  dtypes, chunks, compression and its level, and data; the BDV XML files
  are byte-equal; each package's readers read the other's files.
- The CLIs: `convert --imaris --bdv`, and `convert` from an .ims and a
  BDV source, in both packages, with equal outputs.
- With h5py blocked (`sys.modules["h5py"] = None`, as on the card's
  host), the port's `convert --imaris --bdv`, `align_channels
  --generate_ims` and `tsv_tools crop-ims` run, and h5py reads what they
  wrote equal to the JAX package's outputs.
"""

import os
import subprocess
import sys
from pathlib import Path

import h5py
import numpy as np
import pytest

from ipp_tpu.io import bdv as bdv_j
from ipp_tpu.io import ims as ims_j
from ipp_tpu.io import tiff as tio
from ipp_tpu_torch.io import bdv as bdv_t
from ipp_tpu_torch.io import ims as ims_t

ROOT = Path(__file__).resolve().parent.parent
SHAPE = (20, 300, 260)


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("IPP_TPU_PLATFORM", "cpu")
    monkeypatch.setenv("IPP_TPU_PROGRESS", "off")


@pytest.fixture(scope="module")
def planes():
    rng = np.random.default_rng(16)
    yy, xx = np.mgrid[0:SHAPE[1], 0:SHAPE[2]].astype(np.float32)
    base = 900 + 600 * np.sin(xx / 17.0) * np.cos(yy / 23.0)
    return np.stack([np.clip(base * (1 + 0.1 * z) + rng.integers(
        0, 400, SHAPE[1:]), 0, 65535).astype(np.uint16)
        for z in range(SHAPE[0])])


@pytest.fixture(scope="module")
def series(planes, tmp_path_factory):
    d = tmp_path_factory.mktemp("ims") / "tif"
    d.mkdir()
    for z, p in enumerate(planes):
        tio.imwrite(d / f"img_{z:06d}.tif", p)
    return d


def h5_tree(path):
    """Everything h5py shows of a file: name -> group or dataset record
    (attributes with their dtypes; shape, dtype, chunks, compression and
    data)."""
    out = {}

    def attrs(obj):
        return {k: (np.asarray(v).dtype.str, np.asarray(v).shape,
                    np.asarray(v).tobytes(), type(v).__name__)
                for k, v in obj.attrs.items()}

    def visit(name, obj):
        if isinstance(obj, h5py.Dataset):
            out[name] = ("dataset", attrs(obj), obj.shape, obj.dtype.str,
                         obj.chunks, obj.compression, obj.compression_opts,
                         obj[()].tobytes())
        else:
            out[name] = ("group", attrs(obj))

    with h5py.File(path, "r") as f:
        out["/"] = ("group", attrs(f))
        f.visititems(visit)
    return out


def assert_same_tree(a, b):
    ta, tb = h5_tree(a), h5_tree(b)
    assert list(ta) == list(tb)
    for name in tb:
        assert ta[name][:-1] == tb[name][:-1], name
        assert ta[name][-1] == tb[name][-1], name


@pytest.mark.parametrize("kw", [
    {}, {"n_levels": 3, "chunk": (8, 64, 64), "compression": 6,
         "channel_color": "Red", "voxel_um": (2.0, 0.5, 0.5)}])
def test_write_imaris_same_tree(tmp_path, planes, kw):
    paths = {}
    for name, mod in (("port", ims_t), ("jax", ims_j)):
        (tmp_path / name).mkdir()    # one file name: the attrs carry it
        paths[name] = mod.write_imaris(tmp_path / name / "v.ims",
                                       lambda z: planes[z], SHAPE,
                                       np.uint16, **kw)
    assert_same_tree(paths["port"], paths["jax"])
    levels = kw.get("n_levels", 1)
    for reader in (ims_t.ImarisReader, ims_j.ImarisReader):
        for path in paths.values():
            with reader(path) as r:
                assert r.shape == SHAPE
                np.testing.assert_array_equal(r[7], planes[7])
                np.testing.assert_array_equal(
                    r.read_roi(3, 11, 20, 290, 5, 100), planes[3:11, 20:290,
                                                               5:100])
            with reader(path, resolution_level=levels - 1) as r:
                assert len(r) == (SHAPE[0] // 4 if levels == 3 else SHAPE[0])


def test_write_imaris_timeseries_same_tree(tmp_path, planes):
    vol = planes[:4, :30, :40]
    paths = {}
    for name, mod in (("port", ims_t), ("jax", ims_j)):
        (tmp_path / name).mkdir()
        paths[name] = mod.write_imaris_timeseries(
            tmp_path / name / "t.ims",
            lambda t, z: (vol[z].astype(np.int64) + 37 * t).astype(np.uint16),
            (11, 4, 30, 40), np.uint16)
    assert_same_tree(paths["port"], paths["jax"])
    with h5py.File(paths["port"], "r") as f:
        assert list(f["DataSet/ResolutionLevel 0"]) == sorted(
            f"TimePoint {t}" for t in range(11))
    for path in paths.values():
        with ims_t.ImarisReader(path, timepoint=10) as r:
            np.testing.assert_array_equal(r[2], vol[2] + 370)


@pytest.mark.parametrize("halve", ["mean", "max"])
def test_write_bdv_same_tree_and_xml(tmp_path, planes, halve):
    xml = {}
    for name, mod in (("port", bdv_t), ("jax", bdv_j)):
        (tmp_path / name).mkdir()
        xml[name] = mod.write_bdv(lambda z: planes[z], SHAPE,
                                  tmp_path / name / "v.xml",
                                  voxel_um=(2.0, 0.5, 0.5), halve=halve)
    assert xml["port"].read_bytes() == xml["jax"].read_bytes()
    assert_same_tree(xml["port"].with_suffix(".h5"),
                     xml["jax"].with_suffix(".h5"))
    with h5py.File(xml["port"].with_suffix(".h5"), "r") as f:
        assert f["t00000/s00/0/cells"].dtype == np.int16
        assert len(f["t00000/s00"]) == 2 == len(f["s00/resolutions"])
    for reader in (bdv_t.BDVReader, bdv_j.BDVReader):
        for path in xml.values():
            r = reader(path)
            assert r.shape == SHAPE
            for z in (0, 13, 19):
                got = r[z]
                assert got.dtype == np.uint16
                np.testing.assert_array_equal(got, planes[z])
            r.close()


def _convert(main, argv):
    assert main([str(a) for a in argv]) == 0


def test_convert_exports_and_sources_in_both_packages(tmp_path, series,
                                                      planes):
    """`convert --imaris --bdv` writes equal files, and `convert` from the
    .ims and the BDV XML gives the same planes, in both packages."""
    from ipp_tpu.pipeline import convert as cj
    from ipp_tpu_torch.pipeline import convert as ct

    out = {}
    for name, mod in (("port", ct), ("jax", cj)):
        out[name] = tmp_path / name / "tif"
        _convert(mod.main, ["-i", series, "-o", out[name], "--imaris",
                            "--bdv", "--voxel", "2", "1", "1"])
    base = {k: v.parent for k, v in out.items()}
    assert_same_tree(base["port"] / "tif.ims", base["jax"] / "tif.ims")
    assert_same_tree(base["port"] / "tif_bdv.h5", base["jax"] / "tif_bdv.h5")
    assert (base["port"] / "tif_bdv.xml").read_bytes() == \
        (base["jax"] / "tif_bdv.xml").read_bytes()
    for src in ("tif.ims", "tif_bdv.xml", "tif_bdv.h5"):
        for name, mod in (("port", ct), ("jax", cj)):
            dst = tmp_path / f"{name}_{src.replace('.', '_')}"
            # the port reads the JAX package's file and the JAX package
            # the port's
            other = base["jax" if name == "port" else "port"]
            _convert(mod.main, ["-i", other / src, "-o", dst])
            names = sorted(p.name for p in dst.glob("*.tif"))
            assert len(names) == SHAPE[0]
            for z, n in enumerate(names):
                np.testing.assert_array_equal(tio.imread(dst / n), planes[z])


CHILD = """
import sys
sys.modules["h5py"] = None          # as on the card's host
from ipp_tpu_torch.pipeline import align_channels, convert, tsv_tools
work = sys.argv[1]
assert convert.main(["-i", work + "/tif", "-o", work + "/port/tif",
                     "--imaris", "--bdv", "--voxel", "2", "1", "1"]) == 0
assert align_channels.main(["--red", work + "/tif", work + "/down.tif",
                            "--generate_ims", "--dtype", "uint16",
                            "--dx", "1", "2", "--dy", "1", "2", "--dz", "1",
                            "1", "-o", work + "/port/align"]) == 0
assert tsv_tools.main(["crop-ims", "--ims", work + "/port/tif.ims",
                       "--output", work + "/port/crop", "--roi", "2", "9",
                       "10", "250", "30", "200"]) == 0
assert sys.modules["h5py"] is None
print("OK")
"""


def test_port_exports_run_without_h5py(tmp_path, series, planes):
    from ipp_tpu.pipeline import align_channels as aj
    from ipp_tpu.pipeline import convert as cj
    from ipp_tpu.pipeline import tsv_tools as tj

    work = tmp_path
    (work / "tif").symlink_to(series)
    tio.write_tiff_stack(work / "down.tif", planes[:, ::2, ::2])
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env.update(IPP_TPU_PLATFORM="cpu", IPP_TPU_PROGRESS="off",
               PYTHONPATH=str(ROOT) + os.pathsep + env.get("PYTHONPATH", ""))
    run = subprocess.run([sys.executable, "-c", CHILD, str(work)], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    assert run.stdout.strip().endswith("OK")
    _convert(cj.main, ["-i", work / "tif", "-o", work / "jax" / "tif",
                       "--imaris", "--bdv", "--voxel", "2", "1", "1"])
    _convert(aj.main, ["--red", work / "tif", work / "down.tif",
                       "--generate_ims", "--dtype", "uint16", "--dx", "1",
                       "2", "--dy", "1", "2", "--dz", "1", "1", "-o",
                       work / "jax" / "align"])
    _convert(tj.main, ["crop-ims", "--ims", work / "jax" / "tif.ims",
                       "--output", work / "jax" / "crop", "--roi", "2", "9",
                       "10", "250", "30", "200"])
    port, jax = work / "port", work / "jax"
    for f in ("tif.ims", "tif_bdv.h5", "align/downsampled/red.ims",
              "align/original/red.ims"):
        assert_same_tree(port / f, jax / f)
    assert (port / "tif_bdv.xml").read_bytes() == \
        (jax / "tif_bdv.xml").read_bytes()
    crops = sorted(p.name for p in (jax / "crop").iterdir())
    assert len(crops) == 2 and crops == sorted(
        p.name for p in (port / "crop").iterdir())
    for n in crops:
        assert (port / "crop" / n).read_bytes() == \
            (jax / "crop" / n).read_bytes()
    np.testing.assert_array_equal(
        tio.read_tiff_stack(port / "crop" / crops[0]),
        planes[2:9, 10:250, 30:200])
