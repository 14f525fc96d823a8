"""The port's reader of newer HDF5 files (ipp_tpu_torch/io/hdf5.py with
io/hdf5_v2.py) against h5py, the oracle here (the card's host has none).

- Under ``libver`` 'latest', ('v108', 'v108'), ('v110', 'v110') and
  'earliest' with ``track_order=True``: every chunk index (single chunk,
  implicit, fixed array paged and not, extensible array up to paged data
  blocks at 1080 and 4913 chunks, version 2 B-tree filtered and not, and
  partial edge chunks left unfiltered) read plane by plane and by ROI
  bit-equal to h5py, an ROI inflating the chunks it overlaps and a plane
  sweep each chunk once; every dtype under gzip 1/2/9, shuffle and
  fletcher32.
- Groups of 3, 11 and 300 children and 200 attributes (dense past 8)
  listed as h5py lists them, in name or creation order; ``str``
  attributes as h5py returns them; tiny fractal-heap objects.
- A flipped byte in an OHDR, FRHP, BTHD, FAHD or EAHD raises FormatError
  naming the checksum.
- Twins: a .ims and a BDV .h5 written by the JAX package, rewritten under
  libver='latest' with fixed or unlimited maximum shapes, give the port's
  ImarisReader, BDVReader, convert and tsv_tools crop-ims what the JAX
  package's give; the port's convert reads one with h5py blocked.
- The committed fixtures (tests/torch_hdf5_fixtures) hold the arrays
  make_fixtures.py regenerates from its seeds.
"""

import ctypes
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
from ipp_tpu_torch.io import hdf5 as H
from ipp_tpu_torch.io import hdf5_v2 as V
from ipp_tpu_torch.io import ims as ims_t
from tests.test_torch_hdf5 import DTYPES, _libhdf5, _values
from tests.torch_hdf5_fixtures import make_fixtures as MF

ROOT = Path(__file__).resolve().parent.parent
LIBVERS = {"latest": dict(libver="latest"),
           "v108": dict(libver=("v108", "v108")),
           "v110": dict(libver=("v110", "v110")),
           "track_order": dict(libver="earliest", track_order=True)}
# (shape, chunks) of 1080 and 4913 chunks
C1080, C4913 = ((37, 70, 90), (4, 8, 8)), ((33, 130, 130), (2, 8, 8))
# name: (shape, chunks, create_dataset options, index type under v110+)
INDEXES = {
    "single": ((5, 7, 9), (5, 7, 9), {"compression": "gzip"}, H.SINGLE),
    "implicit": (*C1080, {"alloc_early": True}, H.IMPLICIT),
    "fixed": ((5, 7, 9), (2, 4, 4), {"compression": "gzip"},
              H.FIXED_ARRAY),
    "fixed_paged_1080": (*C1080, {"compression": "gzip", "shuffle": True},
                         H.FIXED_ARRAY),
    "fixed_paged_4913": (*C4913, {}, H.FIXED_ARRAY),
    "edge_unfiltered": (*C1080, {"compression": "gzip",
                                 "edge_unfiltered": True}, H.FIXED_ARRAY),
    # a wide maximum x spreads the chunks' indexes into paged data blocks
    "extensible_1080": (*C1080, {"maxshape": (None, 70, 18000),
                                 "compression": "gzip"}, H.EXT_ARRAY),
    "extensible_4913": (*C4913, {"maxshape": (None, 130, 26000)},
                        H.EXT_ARRAY),
    "extensible_y": (*C1080, {"maxshape": (37, None, 90),
                              "fletcher32": True}, H.EXT_ARRAY),
    "btree2": (*C1080, {"maxshape": (None, None, 90)}, H.BTREE2),
    "btree2_filtered": (*C4913, {"maxshape": (None, None, None),
                                 "compression": "gzip", "fletcher32": True},
                        H.BTREE2),
}
FILTERS = {"gzip1": {"compression": "gzip", "compression_opts": 1},
           "gzip2": {"compression": "gzip", "compression_opts": 2},
           "gzip9": {"compression": "gzip", "compression_opts": 9},
           "shuffle": {"compression": "gzip", "shuffle": True},
           "fletcher32": {"fletcher32": True},
           "shuffle-fletcher32": {"shuffle": True, "fletcher32": True,
                                  "compression": "gzip"}}


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("IPP_TPU_PLATFORM", "cpu")
    monkeypatch.setenv("IPP_TPU_PROGRESS", "off")


def _dataset(f, name, data, chunks, opts, track_order=False):
    opts = dict(opts)
    early, edge = opts.pop("alloc_early", False), opts.pop("edge_unfiltered",
                                                           False)
    if early or edge:
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        dcpl.set_chunk(chunks)
        if early:
            dcpl.set_alloc_time(h5py.h5d.ALLOC_TIME_EARLY)
        if edge:   # H5D_CHUNK_DONT_FILTER_PARTIAL_CHUNKS
            assert _libhdf5().H5Pset_chunk_opts(ctypes.c_int64(dcpl.id),
                                                ctypes.c_uint(2)) >= 0
            dcpl.set_deflate(4)
        opts["dcpl"] = dcpl
    return f.create_dataset(name, chunks=chunks, data=data,
                            track_order=track_order or None, **opts)


def _index_type(d):
    """The chunk index type of a read dataset's version 4 layout, or the
    layout version below 4."""
    lay = next(x for t, _, x in d._messages() if t == H.LAYOUT)
    if lay[0] != 4:
        return f"v{lay[0]}"
    nd, width = lay[3], lay[4]
    return lay[5 + nd * width]


def _chunks_over(starts, stops, chunks):
    return int(np.prod([(b - 1) // c - a // c + 1
                        for a, b, c in zip(starts, stops, chunks)]))


@pytest.mark.parametrize("index", list(INDEXES))
@pytest.mark.parametrize("lib", list(LIBVERS))
def test_every_chunk_index_reads_as_h5py_reads_it(tmp_path, lib, index):
    shape, chunks, opts, itype = INDEXES[index]
    vol = _values("u2", shape, 3)
    p = tmp_path / "i.h5"
    kw = dict(LIBVERS[lib])
    with h5py.File(p, "w", **kw) as f:
        _dataset(f, "d", vol, chunks, opts, kw.get("track_order", False))
    roi = (slice(3, 9), slice(5, min(20, shape[1])), slice(2, 8))
    with h5py.File(p, "r") as f:
        want_roi = f["d"][roi]
        want = f["d"][()]
    np.testing.assert_array_equal(want, vol)
    with H.File(p) as f:
        d = f["d"]
        assert d.shape == shape and d.chunks == chunks
        assert _index_type(d) == (itype if lib in ("latest", "v110")
                                  else "v3")
        H.reset_read_counts()
        got = d[roi]
        np.testing.assert_array_equal(got, want_roi)
        starts = [r.start for r in roi]
        stops = [min(r.stop, n) for r, n in zip(roi, shape)]
        assert H.READ_COUNTS["chunks"] == _chunks_over(starts, stops, chunks)
    H.reset_read_counts()
    with H.File(p) as f:
        for z in range(shape[0]):                  # a plane sweep
            np.testing.assert_array_equal(f["d"][z], want[z])
    assert H.READ_COUNTS["chunks"] == _chunks_over((0,) * 3, shape, chunks)


@pytest.mark.parametrize("layout", list(FILTERS))
@pytest.mark.parametrize("dtype", DTYPES)
def test_every_dtype_and_filter(tmp_path, dtype, layout):
    """Fixed-array and version 2 B-tree indexes (filtered records)."""
    vol = _values(dtype, (5, 7, 9), 2)
    p = tmp_path / "f.h5"
    with h5py.File(p, "w", libver="latest") as f:
        f.create_dataset("fixed", data=vol, chunks=(2, 4, 4),
                         **FILTERS[layout])
        f.create_dataset("btree", data=vol, chunks=(3, 5, 2),
                         maxshape=(None, None, 9), **FILTERS[layout])
    with h5py.File(p, "r") as f, H.File(p) as g:
        for name in ("fixed", "btree"):
            a, b = f[name], g[name]
            assert (b.dtype, b.shape, b.chunks, b.compression) == \
                (a.dtype, a.shape, a.chunks, a.compression)
            if a.compression:
                assert b.compression_opts == a.compression_opts
            np.testing.assert_array_equal(b[...], a[()])
            np.testing.assert_array_equal(b[4, 1:6, 2:], a[4, 1:6, 2:])


def test_fill_values_and_unwritten_chunks_of_every_index(tmp_path):
    p = tmp_path / "u.h5"
    with h5py.File(p, "w", libver="latest") as f:
        for name, maxshape in (("fixed", (12, 10, 10)),
                               ("ext", (None, 10, 10)),
                               ("btree", (None, None, 10))):
            d = f.create_dataset(name, shape=(12, 10, 10), dtype="i4",
                                 chunks=(2, 5, 5), fillvalue=-7,
                                 maxshape=maxshape, compression="gzip")
            d[0:2, 0:5, 0:5] = 1
            d[9, 7] = 3
        f.create_dataset("empty", shape=(4, 4), dtype="f8", chunks=(2, 2))
    with h5py.File(p, "r") as f, H.File(p) as g:
        for name in ("fixed", "ext", "btree", "empty"):
            H.reset_read_counts()
            np.testing.assert_array_equal(g[name][...], f[name][()])
            assert H.READ_COUNTS["chunks"] == (0 if name == "empty" else 3)
        assert (g["ext"][5] == -7).all() and g["btree"][9, 7, 9] == 3


@pytest.mark.parametrize("track", [False, True])
@pytest.mark.parametrize("lib", ["latest", "v108"])
@pytest.mark.parametrize("n", [3, 11, 300])
def test_groups_list_as_h5py_lists_them(tmp_path, n, lib, track):
    """Compact link messages up to 8, dense ones (fractal heap, version 2
    B-tree) past that; name order, or creation order when tracked."""
    p = tmp_path / "g.h5"
    with h5py.File(p, "w", **LIBVERS[lib]) as f:
        g = f.create_group("R", track_order=track)
        for t in reversed(range(n)):
            g.create_group(f"TimePoint {t}/Channel 0").attrs["t"] = \
                np.int32(t)
        f.create_group("empty")
    with h5py.File(p, "r") as f, H.File(p) as g:
        assert list(g["R"]) == list(f["R"])
        assert list(g["R"].keys()) == (
            [f"TimePoint {t}" for t in reversed(range(n))] if track
            else sorted(f"TimePoint {t}" for t in range(n)))
        assert list(g["empty"]) == [] and len(g["R"]) == n
        for t in (0, n // 2, n - 1):
            assert g[f"R/TimePoint {t}/Channel 0"].attrs["t"] == t
        assert g.get("R/TimePoint x") is None and "R/TimePoint 0" in g


STR_ATTRS = {"text": "héllo wörld", "words": ["a", "bc", "déf"],
             "grid": np.array([["x", "yy"], ["zzz", ""]], dtype=object)}


def _same_attr(got, want):
    assert type(got) is type(want), (type(got), type(want))
    if isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.tolist() == want.tolist()
    else:
        assert got == want


@pytest.mark.parametrize("lib", list(LIBVERS))
def test_attributes_read_as_h5py_returns_them(tmp_path, lib):
    """200 numeric attributes (dense past 8 under v108 and later) and
    str ones (variable-length strings in the global heap)."""
    p = tmp_path / "a.h5"
    with h5py.File(p, "w", **LIBVERS[lib]) as f:
        g = f.create_group("g", track_order=LIBVERS[lib].get("track_order"))
        for i in reversed(range(200)):
            g.attrs[f"a{i}"] = np.arange(i % 7, dtype="i2")
        for k, v in STR_ATTRS.items():
            g.attrs[k] = v
        g.attrs.create("ascii", "plain", dtype=h5py.string_dtype("ascii"))
        f.attrs["scalar"] = np.float32(2.5)
    with h5py.File(p, "r") as f, H.File(p) as h:
        assert list(h["g"].attrs) == list(f["g"].attrs)
        assert len(h["g"].attrs) == 204
        for k in f["g"].attrs:
            _same_attr(h["g"].attrs[k], f["g"].attrs[k])
        assert h["g"].attrs["text"] == "héllo wörld"
        _same_attr(h.attrs["scalar"], np.float32(2.5))


def test_tiny_heap_objects(tmp_path):
    """A tiny heap ID carries its object: 1 + 4 bits of length in an ID of
    up to 17 bytes, 12 bits past that."""
    p = tmp_path / "t.h5"
    with h5py.File(p, "w", libver="latest") as f:
        for i in range(20):
            f.create_group(f"g{i}")
    with H.File(p) as f:
        info = next(d for t, _, d in f._messages() if t == H.LINK_INFO)
        heap = V.FractalHeap(f._reader, int.from_bytes(info[2:10], "little"))
    assert heap.id_len == 7 and not heap.tiny_ext
    assert heap.get(bytes([0x20 | 4]) + b"abcde") == b"abcde"
    heap.tiny_ext = True
    assert heap.get(bytes([0x20, 2]) + b"xyz") == b"xyz"
    with pytest.raises(H.FormatError, match="which has no huge-object "
                                            "B-tree"):
        heap.get(bytes([0x10]) + bytes(6))


def _with_every_structure(p):
    with h5py.File(p, "w", libver="latest") as f:
        g = f.create_group("g")
        for i in range(20):
            g.create_group(f"c{i}")
        vol = _values("u2", *C1080[:1])
        f.create_dataset("fixed", data=vol, chunks=C1080[1])
        f.create_dataset("ext", data=vol, chunks=C1080[1],
                         maxshape=(None, 70, 90))
    return p.read_bytes()


@pytest.mark.parametrize("sig,what", [
    (b"OHDR", lambda f: [f[k] for k in ("g", "fixed", "ext")]),
    (b"FRHP", lambda f: list(f["g"])),
    (b"BTHD", lambda f: list(f["g"])), (b"FAHD", lambda f: f["fixed"][0]),
    (b"EAHD", lambda f: f["ext"][0])])
def test_a_flipped_byte_raises_naming_the_checksum(tmp_path, sig, what):
    raw = bytearray(_with_every_structure(tmp_path / "c.h5"))
    # the last one: the root's OHDR comes first
    at = raw.rindex(sig)
    raw[at + 9] ^= 0x40
    p = tmp_path / "bad.h5"
    p.write_bytes(bytes(raw))
    with pytest.raises(H.FormatError, match=f"{sig.decode()} checksum "
                                            f"mismatch at {at}"):
        with H.File(p) as f:
            what(f)


# -- twins: the JAX package's files rewritten in the newest format ----------

SHAPE = (12, 200, 180)


@pytest.fixture(scope="module")
def planes():
    rng = np.random.default_rng(17)
    yy, xx = np.mgrid[0:SHAPE[1], 0:SHAPE[2]].astype(np.float32)
    base = 900 + 600 * np.sin(xx / 17.0) * np.cos(yy / 23.0)
    return np.stack([np.clip(base * (1 + 0.1 * z) + rng.integers(
        0, 400, SHAPE[1:]), 0, 65535).astype(np.uint16)
        for z in range(SHAPE[0])])


def rewrite_latest(src, dst, unlimited):
    """Copy an HDF5 tree into a libver='latest' file: groups, attributes
    with their dtypes, datasets with their chunks, filters and data; a
    chunked dataset's maximum shape fixed, or unlimited along axis 0."""
    def attrs(a, b):
        for k, v in a.attrs.items():
            b.attrs[k] = v

    with h5py.File(src, "r") as f, h5py.File(dst, "w", libver="latest") as g:
        attrs(f, g)

        def visit(name, obj):
            if isinstance(obj, h5py.Group):
                attrs(obj, g.require_group(name))
                return
            kw = {}
            if obj.chunks:
                kw = dict(chunks=obj.chunks, compression=obj.compression,
                          compression_opts=obj.compression_opts,
                          shuffle=obj.shuffle, fletcher32=obj.fletcher32,
                          maxshape=((None,) + obj.shape[1:] if unlimited
                                    else obj.shape))
            attrs(obj, g.create_dataset(name, data=obj[()], **kw))

        f.visititems(visit)
    return dst


def _twins(tmp_path, planes, unlimited):
    src = tmp_path / "jax"
    src.mkdir()
    ims = ims_j.write_imaris(src / "v.ims", lambda z: planes[z], SHAPE,
                             np.uint16, n_levels=2, chunk=(4, 64, 64))
    xml = bdv_j.write_bdv(lambda z: planes[z], SHAPE, src / "v.xml",
                          chunk=(4, 64, 64), n_resolutions=2)
    new = tmp_path / "latest"
    new.mkdir()
    rewrite_latest(ims, new / "v.ims", unlimited)
    rewrite_latest(xml.with_suffix(".h5"), new / "v.h5", unlimited)
    (new / "v.xml").write_bytes(xml.read_bytes())
    return new


def _series_equal(a, b, n):
    names = sorted(p.name for p in Path(a).glob("*.tif"))
    assert len(names) == n
    assert names == sorted(p.name for p in Path(b).glob("*.tif"))
    for name in names:
        np.testing.assert_array_equal(tio.imread(Path(a) / name),
                                      tio.imread(Path(b) / name))


@pytest.mark.parametrize("unlimited", [False, True],
                         ids=["fixed", "unlimited"])
def test_twins_read_as_the_jax_package_reads_them(tmp_path, planes,
                                                  unlimited):
    from ipp_tpu.pipeline import convert as cj
    from ipp_tpu.pipeline import tsv_tools as tj
    from ipp_tpu_torch.pipeline import convert as ct
    from ipp_tpu_torch.pipeline import tsv_tools as tt

    new = _twins(tmp_path, planes, unlimited)
    with H.File(new / "v.ims") as f:
        d = f["DataSet/ResolutionLevel 0/TimePoint 0/Channel 0/Data"]
        assert _index_type(d) == (H.EXT_ARRAY if unlimited
                                  else H.FIXED_ARRAY)
    for level in (0, 1):
        with ims_t.ImarisReader(new / "v.ims", resolution_level=level) as a, \
                ims_j.ImarisReader(new / "v.ims",
                                   resolution_level=level) as b:
            assert a.shape == b.shape
            np.testing.assert_array_equal(a[0:len(a)], b[0:len(b)])
            roi = (1, a.shape[0] - 2, 10, a.shape[1] - 7, 5, 80)
            np.testing.assert_array_equal(a.read_roi(*roi), b.read_roi(*roi))
        a = bdv_t.BDVReader(new / "v.xml", level=level)
        b = bdv_j.BDVReader(new / "v.xml", level=level)
        assert a.shape == b.shape
        for z in range(len(a)):
            np.testing.assert_array_equal(a[z], b[z])
        a.close()
        b.close()
    for src in ("v.ims", "v.xml"):
        for name, mod in (("port", ct), ("jax", cj)):
            assert mod.main(["-i", str(new / src), "-o",
                             str(tmp_path / f"{name}_{src}")]) == 0
        _series_equal(tmp_path / f"port_{src}", tmp_path / f"jax_{src}",
                      SHAPE[0])
    np.testing.assert_array_equal(
        tio.imread(tmp_path / "port_v.ims" / "img_000003.tif"), planes[3])
    for name, mod in (("port", tt), ("jax", tj)):
        assert mod.main(["crop-ims", "--ims", str(new / "v.ims"), "--output",
                         str(tmp_path / f"crop_{name}"), "--roi", "2", "9",
                         "10", "150", "30", "170"]) == 0
    crops = sorted(p.name for p in (tmp_path / "crop_jax").iterdir())
    assert len(crops) == 2
    assert crops == sorted(p.name for p in (tmp_path / "crop_port").iterdir())
    for n in crops:
        assert (tmp_path / "crop_port" / n).read_bytes() == \
            (tmp_path / "crop_jax" / n).read_bytes()


CHILD = """
import sys
sys.modules["h5py"] = None          # as on the card's host
from ipp_tpu_torch.pipeline import convert
assert convert.main(["-i", sys.argv[1], "-o", sys.argv[2]]) == 0
assert sys.modules["h5py"] is None
print("OK")
"""


def test_convert_reads_a_rewritten_ims_without_h5py(tmp_path, planes):
    new = _twins(tmp_path, planes, True)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env.update(IPP_TPU_PLATFORM="cpu", IPP_TPU_PROGRESS="off",
               PYTHONPATH=str(ROOT) + os.pathsep + env.get("PYTHONPATH", ""))
    run = subprocess.run([sys.executable, "-c", CHILD, str(new / "v.ims"),
                          str(tmp_path / "out")], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    assert run.stdout.strip().endswith("OK")
    names = sorted((tmp_path / "out").glob("*.tif"))
    assert len(names) == SHAPE[0]
    for z, name in enumerate(names):
        np.testing.assert_array_equal(tio.imread(name), planes[z])


# -- the committed fixtures --------------------------------------------------

def test_fixtures_hold_their_regenerated_arrays():
    """What make_fixtures.py writes from its seeds is what the committed
    files hold, through h5py and through the port."""
    data = MF.arrays()
    files = {"ims": MF.IMS, "bdv": MF.BDV}
    assert sum(p.stat().st_size for p in files.values()) <= 2 << 20
    for key, path in files.items():
        with h5py.File(path, "r") as f, H.File(path) as g:
            assert f.libver == ("latest", "latest") or \
                f.id.get_create_plist().get_version()[0] == 3
            for name, want in data[key].items():
                a = f[name][()]
                assert a.dtype == want.dtype
                np.testing.assert_array_equal(a, want)
                np.testing.assert_array_equal(g[name][...], want)
            assert list(g) == list(f)
            assert list(g.attrs) == list(f.attrs)
            for k in f.attrs:
                _same_attr(g.attrs[k], f.attrs[k])
    with h5py.File(MF.BDV, "r") as f:
        assert list(f["t00000"]) == [f"s{s:02d}" for s in
                                     reversed(range(MF.SETUPS))]
        assert len(f) == MF.SETUPS + 1 and len(f.attrs) == MF.ROOT_ATTRS
        assert isinstance(f.attrs["name"], str)
    with H.File(MF.IMS) as g:
        types = [_index_type(g[f"DataSet/ResolutionLevel {lv}/TimePoint 0/"
                               f"Channel 0/Data"]) for lv in (0, 1)]
    assert types == [H.FIXED_ARRAY, H.EXT_ARRAY]
    with H.File(MF.BDV) as g:
        assert _index_type(g["t00000/s00/0/cells"]) == H.BTREE2
