"""The port's HDF5 reader and writer (ipp_tpu_torch/io/hdf5.py) against
h5py, the oracle here (the card's host has no h5py).

- Writer: h5py reads its files equal to what was written: groups with
  more than 8 (and more than 256) children, whose names sort differently
  as bytes and as numbers; S1, scalar, array and empty attributes; every
  dtype contiguous and chunked; gzip levels 1, 2 and 9; shapes that are no
  multiple of the chunk; more than 64 and more than 4096 chunks (two- and
  three-level B-trees); plane-streamed writes in any order; two writes of
  one tree (and any thread count) give equal bytes; the superblock's end
  of file is the file's size; the HDF5 library itself can extend the file.
- Reader: files h5py writes, the same matrix plus shuffle, fletcher32
  and compact layouts, attributes in continuation blocks, fill values;
  an ROI read inflates only the chunks it overlaps; files of newer format
  versions (superblocks 2 and 3, version 2 object headers, link-message
  groups) read (tests/test_torch_hdf5_v2.py covers them in full); lzf,
  scaleoffset, the shared-message table, external links and huge
  fractal-heap objects read as h5py reads them
  (tests/test_torch_hdf5_structures.py covers them in full); what stays
  outside the read scope (szip, nbit on a compound type, 4-byte offsets,
  virtual datasets) and damaged files (truncated, a truncated version 4
  chunk index) raise FormatError naming the structure.
"""

import ctypes
import shutil
from pathlib import Path

import h5py
import numpy as np
import pytest

from ipp_tpu_torch.io import hdf5 as H

DTYPES = ["u1", "u2", "i2", "i4", "u4", "i8", "u8", "f4", "f8"]
WRITE_LAYOUTS = {"contiguous": {}, "chunked": {"chunks": (2, 4, 4)},
                 "gzip1": {"chunks": (2, 4, 4), "compression": "gzip",
                           "compression_opts": 1},
                 "gzip2": {"chunks": (2, 4, 4), "compression": "gzip",
                           "compression_opts": 2},
                 "gzip9": {"chunks": (3, 5, 2), "compression": "gzip",
                           "compression_opts": 9}}
READ_LAYOUTS = dict(WRITE_LAYOUTS, **{
    "shuffle": {"chunks": (2, 4, 4), "compression": "gzip",
                "compression_opts": 4, "shuffle": True},
    "fletcher32": {"chunks": (4, 3, 5), "fletcher32": True},
    "shuffle-fletcher32": {"chunks": (2, 7, 9), "shuffle": True,
                           "fletcher32": True, "compression": "gzip"}})
SHAPE = (5, 7, 9)


def _values(dtype, shape, seed=0):
    rng = np.random.default_rng(seed)
    dt = np.dtype(dtype)
    if dt.kind == "f":
        return (rng.standard_normal(shape) * 1e3).astype(dt)
    info = np.iinfo(dt)
    return rng.integers(info.min, info.max, shape, dtype=dt, endpoint=True)


@pytest.mark.parametrize("layout", list(WRITE_LAYOUTS))
@pytest.mark.parametrize("dtype", DTYPES)
def test_h5py_reads_what_the_writer_wrote(tmp_path, dtype, layout):
    opts = WRITE_LAYOUTS[layout]
    vol = _values(dtype, SHAPE)
    p = tmp_path / "a.h5"
    with H.File(p, "w") as f:
        if opts:
            d = f.create_dataset("g/d", shape=SHAPE, dtype=dtype, **opts)
            for z in range(SHAPE[0]):
                d[z] = vol[z]
        else:
            f.create_dataset("g/d", data=vol)
        f["g/d"].attrs["scale"] = vol.ravel()[:3]
    with h5py.File(p, "r") as f:
        d = f["g/d"]
        assert d.dtype == vol.dtype and d.shape == SHAPE
        assert d.chunks == opts.get("chunks")
        assert d.compression == opts.get("compression")
        assert d.compression_opts == opts.get("compression_opts")
        np.testing.assert_array_equal(d[()], vol)
        np.testing.assert_array_equal(d[3, 2:6, 1:8], vol[3, 2:6, 1:8])
        np.testing.assert_array_equal(d.attrs["scale"], vol.ravel()[:3])
    with H.File(p, "r") as f:
        np.testing.assert_array_equal(f["/g/d"][...], vol)
        assert f["g"]["d"].chunks == opts.get("chunks")


@pytest.mark.parametrize("n", [3, 11, 300])
def test_groups_with_many_children(tmp_path, n):
    """Names in byte order ("TimePoint 10" before "TimePoint 2") over
    SNODs of 8 links, and a two-level group B-tree above 256."""
    p = tmp_path / "g.h5"
    with H.File(p, "w") as f:
        for t in range(n):
            g = f.create_group(f"R/TimePoint {t}/Channel 0")
            g.attrs["t"] = np.int32(t)
        f.create_group("empty")
    want = sorted(f"TimePoint {t}" for t in range(n))
    with h5py.File(p, "r") as f:
        assert list(f["R"].keys()) == want
        assert list(f["empty"].keys()) == []
        for t in (0, n // 2, n - 1):
            assert f[f"R/TimePoint {t}/Channel 0"].attrs["t"] == t
    with H.File(p) as f:
        assert list(f["R"].keys()) == want
        assert f[f"R/TimePoint {n - 1}/Channel 0"].attrs["t"] == n - 1
        assert f.get("R/TimePoint x") is None and "R/TimePoint 0" in f


ATTRS = {"s1": np.frombuffer(b"ImarisDataSet", dtype="S1"),
         "empty_s1": np.frombuffer(b"", dtype="S1"),
         "s5": np.array([b"ab", b"cdefg"], dtype="S5"),
         "scalar_s": np.bytes_(b"abc"),
         **{f"scalar_{d}": np.array(7, d)[()] for d in DTYPES},
         **{f"array_{d}": _values(d, (2, 3), 1) for d in DTYPES}}


def _same_attr(got, want):
    assert type(got) is type(want), (type(got), type(want))
    assert np.asarray(got).dtype == np.asarray(want).dtype
    np.testing.assert_array_equal(got, want)


def test_attributes_read_back_as_h5py_gives_them(tmp_path):
    p, q = tmp_path / "mine.h5", tmp_path / "h5py.h5"
    with H.File(p, "w") as f, h5py.File(q, "w") as g:
        for name, value in ATTRS.items():
            f.attrs[name] = value
            g.attrs[name] = value
    for path in (p, q):
        with h5py.File(path, "r") as f, H.File(path) as g:
            assert sorted(f.attrs) == sorted(g.attrs) == sorted(ATTRS)
            for name, want in ATTRS.items():
                _same_attr(g.attrs[name], f.attrs[name])
                _same_attr(f.attrs[name], want)


def test_attributes_the_writer_refuses(tmp_path):
    with H.File(tmp_path / "a.h5", "w") as f:
        with pytest.raises(TypeError, match="str values"):
            f.attrs["u"] = "text"
        with pytest.raises(TypeError, match="complex"):
            f.attrs["c"] = np.complex64(1)
        with pytest.raises(TypeError, match="complex"):
            f.create_dataset("c", data=np.zeros(3, np.complex64))


@pytest.mark.parametrize("shape,chunks,levels", [
    ((37, 70, 90), (4, 8, 8), 2),        # 1080 chunks
    ((33, 130, 130), (2, 8, 8), 3)])     # 4913 chunks
def test_many_chunks_streamed_in_any_order(tmp_path, shape, chunks, levels):
    vol = _values("u2", shape, 3)
    p = tmp_path / "m.h5"
    with H.File(p, "w") as f:
        a = f.create_dataset("fwd", shape=shape, dtype="u2", chunks=chunks,
                             compression="gzip", compression_opts=2)
        b = f.create_dataset("rev", shape=shape, dtype="u2", chunks=chunks)
        c = f.create_dataset("blocks", shape=shape, dtype="u2",
                             chunks=chunks, compression="gzip")
        for z in range(shape[0]):
            a[z] = vol[z]
            b[shape[0] - 1 - z] = vol[shape[0] - 1 - z]
        for z0 in range(0, shape[0], 5):
            c[z0:z0 + 5] = vol[z0:z0 + 5]
        assert a.compression_opts == 2 and c.compression_opts == 4
    with h5py.File(p, "r") as f:
        for name in ("fwd", "rev", "blocks"):
            np.testing.assert_array_equal(f[name][()], vol)
        np.testing.assert_array_equal(f["fwd"][20, 5:67, 3:88],
                                      vol[20, 5:67, 3:88])
    with H.File(p) as f:
        d = f["fwd"]
        assert d._node(d._btree)[0] == levels - 1
        np.testing.assert_array_equal(d[...], vol)
        np.testing.assert_array_equal(d[5:30, 7, 1:80], vol[5:30, 7, 1:80])
        np.testing.assert_array_equal(d[-1], vol[-1])
        with pytest.raises(IndexError, match="step 1"):
            d[::2]


def test_unwritten_planes_read_as_zero(tmp_path):
    p = tmp_path / "z.h5"
    with H.File(p, "w") as f:
        d = f.create_dataset("d", shape=(10, 5, 6), dtype="i2", chunks=(4, 5,
                                                                         6))
        d[1] = np.full((5, 6), -3, np.int16)
        d[9] = np.full((5, 6), 4, np.int16)
        f.create_dataset("never", shape=(3, 3), dtype="f4", chunks=(2, 2))
    want = np.zeros((10, 5, 6), np.int16)
    want[1], want[9] = -3, 4
    with h5py.File(p, "r") as f:
        np.testing.assert_array_equal(f["d"][()], want)
        np.testing.assert_array_equal(f["never"][()], np.zeros((3, 3)))
    with H.File(p) as f:
        np.testing.assert_array_equal(f["d"][...], want)
        np.testing.assert_array_equal(f["never"][...], np.zeros((3, 3)))


def test_writes_the_stream_refuses(tmp_path):
    with H.File(tmp_path / "a.h5", "w") as f:
        d = f.create_dataset("d", shape=(4, 3, 3), dtype="u2", chunks=(2, 3,
                                                                        3))
        d[0] = np.ones((3, 3), np.uint16)
        d[1] = np.ones((3, 3), np.uint16)
        with pytest.raises(ValueError, match="written again"):
            d[1] = np.ones((3, 3), np.uint16)
        with pytest.raises(IndexError, match="whole planes"):
            d[2, :2] = np.ones((2, 3), np.uint16)
        with pytest.raises(TypeError, match="cast"):
            d[2] = np.ones((3, 3), np.float32)
        with pytest.raises(ValueError, match="already exists"):
            f.create_dataset("d", data=np.ones(2))
        with pytest.raises(ValueError, match="chunks"):
            f.create_dataset("e", shape=(2, 2), dtype="u1",
                             compression="gzip")


def _tree(path):
    vol = _values("u2", (21, 40, 50), 5)
    with H.File(path, "w") as f:
        f.attrs["v"] = np.frombuffer(b"5.5.0", "S1")
        for lv, step in enumerate((1, 2)):
            d = f.create_dataset(f"L {lv}/Data", dtype="u2", chunks=(4, 8, 8),
                                 shape=vol[::step, ::step, ::step].shape,
                                 compression="gzip", compression_opts=2)
            for z, plane in enumerate(vol[::step, ::step, ::step]):
                d[z] = plane
        f.create_dataset("Thumbnail/Data", data=vol[0, :8].astype("u1"))


def test_equal_trees_give_equal_bytes(tmp_path, monkeypatch):
    _tree(tmp_path / "a.h5")
    _tree(tmp_path / "b.h5")
    monkeypatch.setattr(H, "_threads", lambda: 1)
    _tree(tmp_path / "c.h5")
    data = (tmp_path / "a.h5").read_bytes()
    assert data == (tmp_path / "b.h5").read_bytes()
    assert data == (tmp_path / "c.h5").read_bytes()
    eof = int.from_bytes(data[40:48], "little")
    assert eof == len(data)


def test_the_library_extends_a_written_file(tmp_path):
    """h5py (the HDF5 library) opens a written file for update, adds
    groups, attributes and chunks; both readers see the result."""
    p = tmp_path / "a.h5"
    _tree(p)
    want = _values("u2", (21, 40, 50), 5)
    want[3:9, :16, :16] = 7
    with h5py.File(p, "r+") as f:
        for i in range(30):
            f.create_group(f"L 0/new {i}")
        f.attrs["more"] = np.arange(3)
        f["L 0/Data"][3:9, 0:16, 0:16] = 7
    for mod in (h5py, H):
        with mod.File(p, "r") as f:
            assert len(f["L 0"]) == 31
            np.testing.assert_array_equal(f["L 0/Data"][...], want)
            np.testing.assert_array_equal(f.attrs["more"], np.arange(3))


def _h5py_dataset(f, name, data, layout):
    if layout == "contiguous":
        return f.create_dataset(name, data=data)
    if layout == "compact":
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        dcpl.set_layout(h5py.h5d.COMPACT)
        space = h5py.h5s.create_simple(data.shape)
        tid = h5py.h5t.py_create(data.dtype)
        ds = h5py.h5d.create(f.id, name.encode(), tid, space, dcpl=dcpl)
        ds.write(h5py.h5s.ALL, h5py.h5s.ALL, np.ascontiguousarray(data))
        return f[name]
    return f.create_dataset(name, data=data, **READ_LAYOUTS[layout])


@pytest.mark.parametrize("layout", list(READ_LAYOUTS) + ["compact"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_reader_reads_h5py_files(tmp_path, dtype, layout):
    vol = _values(dtype, SHAPE, 2)
    p = tmp_path / "r.h5"
    with h5py.File(p, "w") as f:
        _h5py_dataset(f, "d", vol, layout)
    with H.File(p) as f:
        d = f["d"]
        assert d.dtype == vol.dtype and d.shape == SHAPE
        opts = READ_LAYOUTS.get(layout, {})
        assert d.chunks == opts.get("chunks")
        assert d.compression == opts.get("compression")
        np.testing.assert_array_equal(d[...], vol)
        np.testing.assert_array_equal(d[4, 1:6, 2:], vol[4, 1:6, 2:])


def test_roi_read_inflates_only_its_chunks(tmp_path):
    vol = _values("u2", (20, 50, 60), 4)
    p = tmp_path / "roi.h5"
    with h5py.File(p, "w") as f:
        f.create_dataset("d", data=vol, chunks=(4, 8, 8), compression="gzip")
    with H.File(p) as f:
        d = f["d"]
        H.reset_read_counts()
        np.testing.assert_array_equal(d[3:9, 5:20, 10:30],
                                      vol[3:9, 5:20, 10:30])
        assert H.READ_COUNTS["chunks"] == 3 * 3 * 3
        d[3:9, 5:20, 10:30]
        assert H.READ_COUNTS["chunks"] == 27          # all cached
    H.reset_read_counts()
    with H.File(p) as f:
        for z in range(20):                            # a plane sweep
            np.testing.assert_array_equal(f["d"][z], vol[z])
    assert H.READ_COUNTS["chunks"] == 5 * 7 * 8        # each chunk once


def test_fill_values_and_unwritten_chunks(tmp_path):
    p = tmp_path / "f.h5"
    with h5py.File(p, "w") as f:
        d = f.create_dataset("d", shape=(6, 10, 10), dtype="i4",
                             chunks=(2, 5, 5), fillvalue=-7)
        d[0:2, 0:5, 0:5] = 1
        f.create_dataset("z", shape=(4, 4), dtype="f8", chunks=(2, 2))
    with h5py.File(p, "r") as f, H.File(p) as g:
        np.testing.assert_array_equal(g["d"][...], f["d"][()])
        np.testing.assert_array_equal(g["z"][...], f["z"][()])
        assert (g["d"][5] == -7).all() and g["d"][0, 0, 0] == 1


def test_attributes_in_continuation_blocks(tmp_path):
    p = tmp_path / "many.h5"
    with h5py.File(p, "w") as f:
        g = f.create_group("g")
        for i in range(200):
            g.attrs[f"a{i}"] = np.arange(i % 7, dtype="i2")
        for i in range(40):
            g.create_group(f"c{i}")
    with H.File(p) as f:
        g = f["g"]
        assert len(g.attrs) == 200 and len(g) == 40
        np.testing.assert_array_equal(g.attrs["a13"], np.arange(6))
        assert list(g) == sorted(f"c{i}" for i in range(40))


def _libhdf5():
    """The HDF5 library h5py runs on, for the property setters h5py does
    not wrap."""
    libs = Path(h5py.__file__).parent.parent / "h5py.libs"
    found = sorted(libs.glob("libhdf5-*.so*"))
    return ctypes.CDLL(str(found[0]) if found else "libhdf5.so")


def _newer(tmp_path, kind):
    p = tmp_path / f"{kind}.h5"
    if kind == "latest":
        with h5py.File(p, "w", libver="latest") as f:
            f.create_dataset("d", data=np.arange(10))
    elif kind == "v108":
        with h5py.File(p, "w", libver=("v108", "v108")) as f:
            f.create_dataset("d", data=np.arange(10))
    elif kind == "track_order":
        with h5py.File(p, "w") as f:
            f.create_group("d", track_order=True).create_group("a")
    elif kind in ("lzf", "scaleoffset"):
        with h5py.File(p, "w") as f:
            f.create_dataset("d", data=np.arange(100), chunks=(10,),
                             **({"compression": "lzf"} if kind == "lzf"
                                else {"scaleoffset": 0}))
    elif kind == "layout4":
        # a version 4 layout whose fixed-array data block is cut short
        with h5py.File(p, "w", libver="latest") as f:
            f.create_dataset("d", data=np.arange(2000), chunks=(10,))
        raw = p.read_bytes()
        p.write_bytes(raw[:raw.index(b"FADB") + 40])
    elif kind == "shared":
        # every message kind shared through the shared-message table
        fcpl = h5py.h5p.create(h5py.h5p.FILE_CREATE)
        lib, pid = _libhdf5(), ctypes.c_int64(fcpl.id)
        assert lib.H5Pset_shared_mesg_nindexes(pid, ctypes.c_uint(1)) >= 0
        assert lib.H5Pset_shared_mesg_index(pid, ctypes.c_uint(0),
                                            ctypes.c_uint(0x1F),
                                            ctypes.c_uint(1)) >= 0
        fid = h5py.h5f.create(str(p).encode(), h5py.h5f.ACC_TRUNC, fcpl=fcpl)
        with h5py.File(fid) as f:
            f.create_dataset("d", data=np.arange(100), chunks=(10,))
            f.create_dataset("e", data=np.arange(100), chunks=(10,))
    elif kind == "external":
        with h5py.File(tmp_path / "other.h5", "w") as f:
            f.create_dataset("d", data=np.arange(10), chunks=(4,))
        with h5py.File(p, "w", libver="latest") as f:
            f["d"] = h5py.ExternalLink("other.h5", "/d")
    elif kind == "szip":
        with h5py.File(p, "w") as f:
            f.create_dataset("d", data=np.arange(100), chunks=(10,),
                             compression="szip")
    elif kind == "offsets4":
        fcpl = h5py.h5p.create(h5py.h5p.FILE_CREATE)
        fcpl.set_sizes(4, 4)
        fid = h5py.h5f.create(str(p).encode(), h5py.h5f.ACC_TRUNC, fcpl=fcpl)
        with h5py.File(fid) as f:
            f.create_dataset("d", data=np.arange(10))
    elif kind == "nbit_compound":
        cdt = np.dtype([("a", "<i2"), ("b", "<f4")])
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        dcpl.set_chunk((10,))
        dcpl.set_filter(5)           # H5Z_FILTER_NBIT
        with h5py.File(p, "w") as f:
            ds = h5py.h5d.create(f.id, b"d", h5py.h5t.py_create(cdt),
                                 h5py.h5s.create_simple((30,)), dcpl=dcpl)
            ds.write(h5py.h5s.ALL, h5py.h5s.ALL, np.zeros(30, cdt))
    elif kind == "virtual":
        with h5py.File(tmp_path / "src.h5", "w") as f:
            f.create_dataset("d", data=np.arange(10))
        lay = h5py.VirtualLayout(shape=(10,), dtype="i8")
        lay[:] = h5py.VirtualSource(tmp_path / "src.h5", "d", shape=(10,))
        with h5py.File(p, "w", libver="latest") as f:
            f.create_virtual_dataset("d", lay)
    elif kind == "huge_attribute":
        # dense storage (more than 8 attributes) and one over 64 KiB
        with h5py.File(p, "w", libver="latest") as f:
            g = f.create_group("d")
            for i in range(10):
                g.attrs[f"a{i}"] = i
            g.attrs["big"] = np.zeros(9000, "f8")
    elif kind == "truncated":
        _tree(p)
        p.write_bytes(p.read_bytes()[:-600])
    return p


@pytest.mark.parametrize("kind", ["latest", "v108", "track_order"])
def test_newer_formats_read(tmp_path, kind):
    """Superblocks 3 and 2, and a version 2 object header with link
    messages under superblock 0."""
    p = _newer(tmp_path, kind)
    with H.File(p) as f, h5py.File(p, "r") as g:
        if kind == "track_order":
            assert list(f["d"]) == list(g["d"]) == ["a"]
            assert f["d/a"].name == "/d/a" and list(f["d/a"]) == []
        else:
            np.testing.assert_array_equal(f["d"][...], np.arange(10))
            np.testing.assert_array_equal(f["d"][3:7], g["d"][3:7])


@pytest.mark.parametrize("kind", ["lzf", "scaleoffset", "shared", "external",
                                  "huge_attribute"])
def test_structures_read_like_h5py(tmp_path, kind):
    """Structures that raised before the reader took them in: the same
    values, dtypes and attributes (in order) as h5py's."""
    p = _newer(tmp_path, kind)
    with h5py.File(p, "r") as f, H.File(p) as g:
        a, b = f["d"], g["d"]
        assert b.name == a.name and b.file.filename == a.file.filename
        if isinstance(a, h5py.Dataset):
            assert b.dtype == a.dtype and b.shape == a.shape
            np.testing.assert_array_equal(b[...], a[()])
            np.testing.assert_array_equal(g["e" if kind == "shared"
                                            else "d"][3:9], a[3:9])
        assert list(b.attrs) == list(a.attrs)
        for k in a.attrs:
            _same_attr(b.attrs[k], a.attrs[k])


@pytest.mark.parametrize("kind,match", [
    ("layout4", "past the end of the file"),
    ("virtual", r"virtual dataset \(layout class 3\)"),
    ("truncated", "past the end of the file"),
    ("szip", r"filter 4 \(szip\)"),
    ("offsets4", "4-byte offsets"),
    ("nbit_compound", r"filter 5 \(nbit\) on a compound type")])
def test_structures_outside_the_read_scope_raise(tmp_path, kind, match):
    p = _newer(tmp_path, kind)
    with pytest.raises(H.FormatError, match=match):
        with H.File(p) as f:
            d = f["d"] if kind != "truncated" else f["L 1/Data"]
            if isinstance(d, H.Dataset):
                d[...]
            else:
                dict(d.attrs)


def test_fletcher32_mismatch_raises(tmp_path):
    p = tmp_path / "c.h5"
    with h5py.File(p, "w") as f:
        f.create_dataset("d", data=np.arange(400, dtype="u2"), chunks=(400,),
                         fletcher32=True)
    raw = bytearray(p.read_bytes())
    at = raw.index(np.arange(400, dtype="u2").tobytes())
    raw[at + 100] ^= 0xFF
    p.write_bytes(bytes(raw))
    with H.File(p) as f, pytest.raises(H.FormatError, match="fletcher32"):
        f["d"][...]


def test_not_an_hdf5_file(tmp_path):
    p = tmp_path / "x.h5"
    p.write_bytes(b"\0" * 4096)
    with pytest.raises(H.FormatError, match="no HDF5 signature"):
        H.File(p)
    shutil.copy(p, tmp_path / "y.h5")
    with pytest.raises(ValueError, match="mode"):
        H.File(tmp_path / "y.h5", "a")
