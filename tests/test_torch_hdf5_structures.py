"""The HDF5 structures the port's reader (ipp_tpu_torch/io/hdf5.py,
hdf5_v2.py and hdf5_filters.py) reads as h5py reads them, each held to
h5py's read of the same file (h5py is the oracle here; the card's host has
none): arrays bit-equal with equal dtypes, ``dict(obj.attrs)`` equal in
values, dtypes and order, ``keys()``, ``.name`` and ``.file.filename``
equal.

- Soft links (absolute, relative, to a group, chained, dangling) in
  symbol-table, compact and dense groups; external links (relative,
  through ``..``, to the file that holds them, chained through a second
  file, to a missing file or object; HDF5_EXT_PREFIX and ``${ORIGIN}``);
  16 links in a row followed, the 17th refused; a dangling link is a
  KeyError from ``[]``, the default from ``get``, and ``in`` as h5py.
- Huge fractal-heap objects: attributes over the attribute heap's 4 KiB
  managed limit and a link name over the link heap's (B-tree type 1),
  and an ID of the direct form.
- The shared-message table with list and B-tree indexes; committed
  datatypes on datasets and attributes, and opened as objects.
- Enum, h5py's bool, compound (packed, padded, nested) and
  variable-length string datasets (contiguous, compact, chunked).
- External storage, a slice reading only the bytes it needs.
- scaleoffset (integers, floats, fill values, one-value chunks), nbit
  (narrowed integers and floats) and lzf (with shuffle, raw-stored
  chunks); no lzf without its built decoder.
- The committed fixtures of these structures (split BDV, long-attribute
  .ims, shared-message BDV) hold their regenerated arrays, and the JAX
  package's BDVReader and ImarisReader read them as the port's do.
"""

import ctypes
import os

import h5py
import numpy as np
import pytest

from ipp_tpu_torch import native
from ipp_tpu_torch.io import bdv as bdv_t
from ipp_tpu_torch.io import hdf5 as H
from ipp_tpu_torch.io import hdf5_filters as hf
from ipp_tpu_torch.io import hdf5_v2 as V
from ipp_tpu_torch.io import ims as ims_t
from tests.test_torch_hdf5 import _libhdf5
from tests.torch_hdf5_fixtures import make_fixtures as MF

LIBVERS = {"earliest": {}, "latest": {"libver": "latest"}}


def _same(got, want):
    """Bit-equal values of equal type and dtype (structured and object
    arrays by their values: padding bytes are not data)."""
    assert type(got) is type(want), (type(got), type(want))
    if isinstance(want, (bytes, str)):
        assert got == want
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, \
        (got.dtype, want.dtype, got.shape, want.shape)
    if want.dtype == object or want.dtype.names:
        assert got.tolist() == want.tolist()
    else:
        assert got.tobytes() == want.tobytes()


def _same_attrs(got, want):
    assert list(got) == list(want)
    for k in want:
        _same(got[k], want[k])


def _same_tree(g, f):
    """Every object h5py reaches by hard links, and every link's name."""
    _same_attrs(g.attrs, f.attrs)

    def visit(name, obj):
        mine = g[name]
        assert mine.name == obj.name, name
        _same_attrs(mine.attrs, obj.attrs)
        if isinstance(obj, h5py.Dataset):
            _same(mine[...], obj[()])
        elif isinstance(obj, h5py.Datatype):
            assert isinstance(mine, H.Datatype) and mine.dtype == obj.dtype
        else:
            assert list(mine.keys()) == list(obj.keys())

    f.visititems(visit)


# -- links -------------------------------------------------------------------

LINK_PATHS = ["grp/s", "grp/rel", "grp/up", "grp/togroup", "grp/togroup/x",
              "ext", "ext/d", "ext/s", "ext_dotdot", "self", "self/s",
              "chain", "dang", "dang_file", "dang_obj", "/grp/s", "abs"]


def _links(tmp_path, lib, dense):
    sub = tmp_path / "sub"
    sub.mkdir()
    with h5py.File(sub / "other.h5", "w", **LIBVERS[lib]) as f:
        f.create_dataset("g/d", data=np.arange(50, dtype="u2"), chunks=(8,),
                         compression="lzf")
        f["g/s"] = h5py.SoftLink("d")
        f["back"] = h5py.ExternalLink("../main.h5", "/d")
    with h5py.File(tmp_path / "main.h5", "w", **LIBVERS[lib]) as f:
        f.create_dataset("d", data=np.arange(3))
        g = f.create_group("grp")
        g.create_group("sub2").create_dataset("x", data=np.ones(2))
        g["s"] = h5py.SoftLink("/d")
        g["rel"] = h5py.SoftLink("sub2/x")
        g["up"] = h5py.SoftLink("../d")          # '..' is a name to HDF5
        g["togroup"] = h5py.SoftLink("/grp/sub2")
        f["ext"] = h5py.ExternalLink("sub/other.h5", "/g")
        f["ext_dotdot"] = h5py.ExternalLink("sub/../sub/other.h5", "/g/d")
        f["self"] = h5py.ExternalLink("main.h5", "/grp")
        f["chain"] = h5py.ExternalLink("sub/other.h5", "/back")
        f["dang"] = h5py.SoftLink("/nope")
        f["dang_file"] = h5py.ExternalLink("missing.h5", "/x")
        f["dang_obj"] = h5py.ExternalLink("sub/other.h5", "/nope")
        f["abs"] = h5py.ExternalLink(str(sub / "other.h5"), "/g/s")
        for i in range(12 if dense else 0):
            f.create_group(f"pad{i:02d}")


def _open_both(f, g, path):
    """(what h5py gives, what the port gives) for f[path] and g[path]."""
    out = []
    for h in (f, g):
        try:
            o = h[path]
            got = (o.name, o.file.filename, isinstance(o, (h5py.Group,
                                                            H.Group)),
                   list(o.keys()) if hasattr(o, "keys") else o[()].tolist())
        except KeyError:
            got = ("KeyError", h.get(path, "default"))
        out.append(got + (path in h,))
    return out


@pytest.mark.parametrize("dense", [False, True], ids=["compact", "dense"])
@pytest.mark.parametrize("lib", list(LIBVERS))
def test_links_follow_as_h5py_follows_them(tmp_path, monkeypatch, lib,
                                           dense):
    _links(tmp_path, lib, dense)
    monkeypatch.chdir(tmp_path)       # main.h5 opened by a relative name
    with h5py.File("main.h5", "r") as f, H.File("main.h5") as g:
        H.reset_read_counts()
        np.testing.assert_array_equal(g["ext/d"][...], np.arange(50))
        assert H.READ_COUNTS["chunks"] == 7      # the external file's
        assert list(g) == list(f)
        for path in LINK_PATHS:
            want, got = _open_both(f, g, path)
            assert got == want, path
        readers = list(g._readers.values())
        assert len(readers) == 2       # main.h5 (also via "self"), other
        assert len(g._files) == 4      # by built name, as the library
        # the external files inflate on the owner's threads
        assert all(x._pool is None for x in g._files.values())
    assert all(r.fd == -1 for r in readers)


def test_sixteen_links_in_a_row(tmp_path):
    p = tmp_path / "chain.h5"
    with h5py.File(p, "w") as f:
        f.create_dataset("d", data=np.arange(3))
        for i in range(17):
            f[f"c{i:02d}"] = h5py.SoftLink(f"/c{i + 1:02d}" if i < 16
                                           else "/d")
    with h5py.File(p, "r") as f, H.File(p) as g:
        np.testing.assert_array_equal(g["c01"][...], f["c01"][()])
        with pytest.raises(RuntimeError, match="too many links"):
            f["c00"]
        with pytest.raises(RuntimeError, match="too many links"):
            g["c00"]


def test_external_files_are_found_as_the_library_finds_them(tmp_path,
                                                            monkeypatch):
    """HDF5_EXT_PREFIX's directories (``${ORIGIN}`` is no name there)
    before the file's own directory; an absolute name that is missing is
    looked for by its last part."""
    a, b = tmp_path / "a", tmp_path / "b"
    a.mkdir()
    b.mkdir()
    for d, v in ((a, 1), (b, 2)):
        with h5py.File(d / "t.h5", "w") as f:
            f.create_dataset("v", data=np.full(3, v))
    with h5py.File(a / "m.h5", "w") as f:
        f["rel"] = h5py.ExternalLink("t.h5", "/v")
        f["gone"] = h5py.ExternalLink("/no/such/dir/t.h5", "/v")
        f["origin"] = h5py.ExternalLink("b/t.h5", "/v")
    cases = [(None, "rel"), (str(b), "rel"), (str(b), "gone"),
             ("${ORIGIN}/..", "origin"), ("/nowhere:" + str(b), "rel")]
    for prefix, key in cases:
        if prefix is None:
            monkeypatch.delenv("HDF5_EXT_PREFIX", raising=False)
        else:
            monkeypatch.setenv("HDF5_EXT_PREFIX", prefix)
        with h5py.File(a / "m.h5", "r") as f, H.File(a / "m.h5") as g:
            want, got = _open_both(f, g, key)
            assert got == want, (prefix, key)


# -- huge fractal-heap objects -----------------------------------------------

def _huge(p, lib):
    with h5py.File(p, "w", libver=lib) as f:
        g = f.create_group("g", track_order=True)
        for i in range(10):
            g.attrs[f"a{i}"] = np.int32(i)
        g.attrs["Description"] = np.frombuffer(b"x" * 5000, "S1")
        g.attrs["big"] = np.arange(9000, dtype="f8")
        g.attrs["text"] = "y" * 6000
        for i in range(10):
            g.create_group(f"c{i}")
        g.create_group("n" * 5000)
        f.create_dataset("raw", data=np.arange(64, dtype="u1"))


@pytest.mark.parametrize("lib", ["latest", ("v108", "v108")],
                         ids=["latest", "v108"])
def test_huge_heap_objects(tmp_path, lib):
    """Dense attributes (8-byte heap IDs) and dense links (7-byte IDs)
    past the heaps' 4 KiB managed limit, through the heaps' huge-object
    B-trees (type 1)."""
    p = tmp_path / "h.h5"
    _huge(p, lib)
    with h5py.File(p, "r") as f, H.File(p) as g:
        _same_tree(g, f)
        assert list(g["g"]) == list(f["g"])
        msgs = g["g"]._messages()
        for kind, at in ((H.ATTR_INFO, None), (H.LINK_INFO, None)):
            d = next(d for t, _, d in msgs if t == kind)
            heap = V.FractalHeap(g._reader, int.from_bytes(
                d[2 + (2 if kind == H.ATTR_INFO else 8) * (d[1] & 1):][:8],
                "little"))
            assert heap.huge_tree != V.UNDEF and not heap.huge_direct
            assert heap.id_len == (8 if kind == H.ATTR_INFO else 7)


def test_huge_object_ids_of_the_direct_form(tmp_path):
    """An ID wide enough for an address and a length holds them (the
    library's direct form, whose B-tree is of type 3)."""
    p = tmp_path / "h.h5"
    _huge(p, "latest")
    with H.File(p) as g:
        d = next(d for t, _, d in g["g"]._messages() if t == H.ATTR_INFO)
        heap = V.FractalHeap(g._reader, int.from_bytes(d[4:12], "little"))
        raw = g["raw"]
        addr = int.from_bytes(next(x for t, _, x in raw._messages()
                                   if t == H.LAYOUT)[2:10], "little")
    with H.File(p) as g:
        heap.reader, heap.huge_direct = g._reader, True
        hid = bytes([0x10]) + addr.to_bytes(8, "little") + \
            (40).to_bytes(8, "little")
        assert heap.get(hid) == bytes(range(40))


# -- shared messages and committed datatypes ---------------------------------

ALL_SHARED = 1 << 1 | 1 << 3 | 1 << 5 | 1 << 11 | 1 << 12
SOHM_CASES = {
    # (indexes (message flags, minimum size), phase change, datasets)
    "list": (((ALL_SHARED, 1),), (400, 300), 12),
    "btree": (((ALL_SHARED, 1),), None, 12),
    "two": (((1 << 1 | 1 << 3, 1), (1 << 11, 1)), (6, 4), 5)}


def _sohm_file(p, indexes, phase, n):
    fcpl = h5py.h5p.create(h5py.h5p.FILE_CREATE)
    lib, pid = _libhdf5(), ctypes.c_int64(fcpl.id)
    assert lib.H5Pset_shared_mesg_nindexes(pid, ctypes.c_uint(
        len(indexes))) >= 0
    for i, (flags, least) in enumerate(indexes):
        assert lib.H5Pset_shared_mesg_index(pid, ctypes.c_uint(i),
                                            ctypes.c_uint(flags),
                                            ctypes.c_uint(least)) >= 0
    if phase:
        assert lib.H5Pset_shared_mesg_phase_change(
            pid, *map(ctypes.c_uint, phase)) >= 0
    rng = np.random.default_rng(n)
    fid = h5py.h5f.create(str(p).encode(), h5py.h5f.ACC_TRUNC, fcpl=fcpl)
    with h5py.File(fid) as f:
        for i in range(n):
            d = f.create_dataset(f"d{i:03d}", data=rng.integers(
                0, 100, (2, i % 3 + 1, i + 1), dtype="i2"), chunks=(1, 1, 1),
                compression="gzip", fillvalue=i)
            d.attrs["scale"] = np.arange(i % 4 + 1, dtype="f8")
            d.attrs["name"] = f"item {i}"
        g = f.create_group("g")
        for i in range(12):
            g.attrs[f"a{i}"] = np.arange(i + 3)
        f["T"] = np.dtype([("x", "<i4"), ("y", "<f8")])
        f.create_dataset("ct", data=np.ones(3, f["T"].dtype), dtype=f["T"])


@pytest.mark.parametrize("case", list(SOHM_CASES))
def test_shared_message_table(tmp_path, case):
    """Messages shared through the table's fractal heaps, indexed by a
    list up to the phase change's limit (50 by default) and a version 2
    B-tree (type 7) past it; attributes shared in dense storage too, and
    shared dataspaces in attributes."""
    indexes, phase, n = SOHM_CASES[case]
    p = tmp_path / "s.h5"
    _sohm_file(p, indexes, phase, n)
    with h5py.File(p, "r") as f, H.File(p) as g:
        _same_tree(g, f)
        kinds = [x["kind"] for x in g._reader.sohm.indexes]
    assert kinds == {"list": [0], "btree": [1], "two": [1, 0]}[case]


@pytest.mark.parametrize("lib", list(LIBVERS))
def test_committed_datatypes(tmp_path, lib):
    p = tmp_path / "c.h5"
    with h5py.File(p, "w", **LIBVERS[lib]) as f:
        f["types/u2"] = np.dtype("<u2")
        f["types/u2"].attrs["about"] = np.bytes_(b"a committed type")
        f["types/pair"] = np.dtype([("a", "<i4"), ("b", "<f4")])
        f.create_dataset("d", data=np.arange(6, dtype="u2"),
                         dtype=f["types/u2"])
        f.create_dataset("chunked", data=np.arange(60, dtype="u2"),
                         dtype=f["types/u2"], chunks=(7,),
                         compression="gzip")
        f.attrs.create("u2", data=np.arange(3, dtype="u2"),
                       dtype=f["types/u2"])
        f["d"].attrs.create("pair", data=np.ones(2, f["types/pair"].dtype),
                            dtype=f["types/pair"])
    with h5py.File(p, "r") as f, H.File(p) as g:
        _same_tree(g, f)
        t = g["types/pair"]
        assert isinstance(t, H.Datatype) and t.name == "/types/pair"
        assert t.dtype == f["types/pair"].dtype


# -- datatypes ----------------------------------------------------------------

def _typed(p, lib):
    rng = np.random.default_rng(5)
    with h5py.File(p, "w", **LIBVERS[lib]) as f:
        f.create_dataset("bool", data=rng.random(20) > 0.5)
        f.create_dataset("bool_chunked", data=rng.random((6, 7)) > 0.3,
                         chunks=(4, 4), compression="gzip")
        f.create_dataset("enum", data=rng.integers(0, 3, 20).astype("u2"),
                         dtype=h5py.enum_dtype({"RED": 0, "GREEN": 1,
                                                "BLUE": 2}, basetype="u2"))
        f.create_dataset("enum_i1", data=rng.integers(-1, 2, 9).astype("i1"),
                         dtype=h5py.enum_dtype({"neg": -1, "zero": 0,
                                                "one": 1}, basetype="i1"))
        cdt = np.dtype([("a", "<i2"), ("b", "<f8"), ("c", "S5"),
                        ("ok", "?")])
        c = np.zeros(10, cdt)
        c["a"], c["b"] = np.arange(10), np.linspace(0, 1, 10)
        c["c"], c["ok"] = b"hi", np.arange(10) % 2 == 0
        f.create_dataset("compound", data=c)
        pdt = np.dtype({"names": ["x", "y"], "formats": ["<i2", ">f4"],
                        "offsets": [6, 12], "itemsize": 24})
        pc = np.zeros(5, pdt)
        pc["x"], pc["y"] = np.arange(5), np.arange(5) * 1.5
        f.create_dataset("padded", data=pc, chunks=(2,))
        nested = np.zeros(4, [("inner", cdt), ("z", "<u4")])
        nested["inner"] = c[:4]
        nested["z"] = 7
        f.create_dataset("nested", data=nested)
        words = np.array([b"a", b"bcd", b"", "héllo".encode()] * 5,
                         dtype=object)
        f.create_dataset("vlen", data=words, dtype=h5py.string_dtype())
        f.create_dataset("vlen_ascii", data=words[:3],
                         dtype=h5py.string_dtype("ascii"))
        dv = f.create_dataset("vlen_chunked", shape=(30,), chunks=(4,),
                              dtype=h5py.string_dtype(), compression="gzip")
        dv[3:9] = [f"word {i}" * i for i in range(6)]
        f.create_dataset("vlen_scalar", data="just one",
                         dtype=h5py.string_dtype())
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        dcpl.set_layout(h5py.h5d.COMPACT)
        tid = h5py.h5t.py_create(h5py.string_dtype(), logical=True)
        ds = h5py.h5d.create(f.id, b"vlen_compact", tid,
                             h5py.h5s.create_simple((3,)), dcpl=dcpl)
        ds.write(h5py.h5s.ALL, h5py.h5s.ALL,
                 np.array([b"x", b"yy", b"zzz"], dtype=object), mtype=tid)
        f.attrs["bool_attr"] = np.array([True, False])
        f.attrs.create("enum_attr", data=np.array([1, 2], "u1"),
                       dtype=h5py.enum_dtype({"A": 1, "B": 2},
                                             basetype="u1"))
        f.attrs["compound_attr"] = c[:2]


@pytest.mark.parametrize("lib", list(LIBVERS))
def test_datatypes_as_h5py_maps_them(tmp_path, lib):
    """Enum as its base integer, h5py's bool as np.bool_, compound as a
    structured dtype of the stored offsets and size, variable-length
    strings as an object array of bytes (str in attributes)."""
    p = tmp_path / "t.h5"
    _typed(p, lib)
    with h5py.File(p, "r") as f, H.File(p) as g:
        _same_tree(g, f)
        np.testing.assert_array_equal(g["vlen_chunked"][2:5],
                                      f["vlen_chunked"][2:5])
        assert g["enum"].dtype.metadata == f["enum"].dtype.metadata
        assert g["padded"].dtype.itemsize == 24


# -- external storage ---------------------------------------------------------

def test_external_storage_reads_only_what_a_slice_needs(tmp_path,
                                                        monkeypatch):
    """Names relative to the working directory (this test's tmp_path), or
    in HDF5_EXTFILE_PREFIX's directory (which the library reads when it
    starts, so h5py here cannot follow a change: the prefixed reads are
    held to the array)."""
    monkeypatch.chdir(tmp_path)
    vol = np.arange(4 * 50 * 60, dtype="<u2").reshape(4, 50, 60)
    with h5py.File("e.h5", "w") as f:
        f.create_dataset("d", data=vol, external=[
            ("raw0.bin", 100, 4000), ("raw1.bin", 0, 10000),
            ("raw2.bin", 16, h5py.h5f.UNLIMITED)])
    sels = [(), (2,), (slice(1, 3), slice(10, 20), slice(5, 40)), (3, 49),
            (slice(0, 0),)]
    with h5py.File("e.h5", "r") as f, H.File("e.h5") as g:
        for sel in sels:
            _same(g["d"][sel], f["d"][sel])
        for sel, nbytes in (((2,), 50 * 60 * 2),
                            ((slice(1, 3), slice(10, 20), slice(5, 40)),
                             2 * 10 * 35 * 2)):
            H.reset_read_counts()
            g["d"][sel]
            assert H.READ_COUNTS["external_bytes"] == nbytes
    os.mkdir("data")
    for name in ("raw0.bin", "raw1.bin", "raw2.bin"):
        os.replace(name, os.path.join("data", name))
    for prefix in (str(tmp_path / "data"), "${ORIGIN}/data"):
        monkeypatch.setenv("HDF5_EXTFILE_PREFIX", prefix)
        with H.File(tmp_path / "e.h5") as g:
            _same(g["d"][...], vol)


def test_external_storage_names_resolve_once_and_open_once_a_box(
        tmp_path, monkeypatch):
    """HDF5_EXTFILE_PREFIX is read when the dataset opens: a later change
    does not move an open dataset's files (a dataset opened after it
    follows it).  A box read opens each slot's
    file it touches once, however many runs it reads; a scalar reads its
    one element."""
    monkeypatch.chdir(tmp_path)
    vol = np.arange(4 * 50 * 60, dtype="<u2").reshape(4, 50, 60)
    os.mkdir("data")
    with h5py.File("e.h5", "w") as f:
        f.create_dataset("d", data=vol, external=[
            ("data/raw0.bin", 0, 4000), ("data/raw1.bin", 0, 10000),
            ("data/raw2.bin", 0, h5py.h5f.UNLIMITED)])
        f.create_dataset("s", data=np.float64(2.5),
                         external=[("data/s.bin", 8, 8)])
    opened = []

    def counting(path, mode="r", *args, **kwargs):
        opened.append(os.path.basename(path))
        return open(path, mode, *args, **kwargs)

    with h5py.File("e.h5", "r") as f, H.File("e.h5") as g:
        d = g["d"]
        _same(g["s"][()], f["s"][()])
        monkeypatch.setenv("HDF5_EXTFILE_PREFIX", str(tmp_path / "nowhere"))
        monkeypatch.setattr(H, "open", counting, raising=False)
        sel = (slice(1, 3), slice(10, 20), slice(5, 40))
        _same(d[sel], f["d"][sel])
        assert sorted(opened) == ["raw1.bin", "raw2.bin"]
    with H.File("e.h5") as g, pytest.raises(FileNotFoundError):
        g["d"][0]


# -- filters ------------------------------------------------------------------

def _filtered(f, case, rng):
    """Datasets of one filter case; the h5py-made ones by options, the
    others through the low-level API."""
    def lowlevel(name, tid, data, chunks, fill_undefined=False):
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        dcpl.set_chunk(chunks)
        if case == "nbit":
            dcpl.set_filter(5)
        else:
            dcpl.set_scaleoffset(h5py.h5z.SO_INT, 0)
        if fill_undefined:   # H5Pset_fill_value(dcpl, type, NULL)
            assert _libhdf5().H5Pset_fill_value(
                ctypes.c_int64(dcpl.id), ctypes.c_int64(tid.id), None) >= 0
        ds = h5py.h5d.create(f.id, name.encode(), tid,
                             h5py.h5s.create_simple(data.shape), dcpl=dcpl)
        ds.write(h5py.h5s.ALL, h5py.h5s.ALL, data)

    if case == "lzf":
        sm = (np.arange(4000).reshape(40, 100) % 97).astype("u2")
        f.create_dataset("small", data=sm, chunks=(7, 30), compression="lzf")
        f.create_dataset("noise", data=rng.integers(0, 65535, (40, 100),
                                                    dtype="u2"),
                         chunks=(8, 32), compression="lzf")
        f.create_dataset("shuffled", data=rng.standard_normal(
            (40, 100)).astype("f4"), chunks=(8, 32), compression="lzf",
            shuffle=True)
    elif case == "scaleoffset":
        f.create_dataset("i4", data=rng.integers(-1000, 5000, (50, 30),
                                                 dtype="i4"),
                         chunks=(9, 7), scaleoffset=0)
        f.create_dataset("u2_fill", data=rng.integers(100, 300, (50, 30),
                                                      dtype="u2"),
                         chunks=(9, 7), scaleoffset=0, fillvalue=7)
        a = rng.integers(-1000, 5000, (50, 30), dtype="i2")
        a[:9, :7], a[9:18, :7] = 42, -9
        f.create_dataset("i2_fill", data=a, chunks=(9, 7), scaleoffset=0,
                         fillvalue=-9)
        f.create_dataset("u8", data=rng.integers(0, 2 ** 40, (20, 10),
                                                 dtype="u8"),
                         chunks=(9, 7), scaleoffset=0)
        b = (rng.standard_normal((50, 30)) * 10).astype("f4")
        b[3, 3], b[10:20] = 0, 5.5
        f.create_dataset("f4", data=b, chunks=(9, 7), scaleoffset=3)
        f.create_dataset("f4_fill", data=b, chunks=(9, 7), scaleoffset=1,
                         fillvalue=5.5)
        f.create_dataset("f8", data=rng.standard_normal((50, 30)) * 1e3,
                         chunks=(9, 7), scaleoffset=2)
        c = np.full((18, 14), 77, "i4")      # chunks of one value: 0 bits
        c[9:] = rng.integers(0, 9, (9, 14))
        lowlevel("one_value", h5py.h5t.NATIVE_INT32, c, (9, 7), True)
    else:
        t = h5py.h5t.STD_I16LE.copy()
        t.set_precision(12)
        t.set_offset(2)
        lowlevel("i12", t, (np.arange(-600, 600, dtype="i2") * 3).reshape(
            40, 30), (9, 7))
        t = h5py.h5t.STD_U32BE.copy()
        t.set_precision(17)
        t.set_offset(5)
        lowlevel("u17be", t, rng.integers(0, 2 ** 17, (40, 30), dtype="u4"),
                 (9, 7))
        t = h5py.h5t.IEEE_F32LE.copy()     # HDF5's nbit example float
        t.set_fields(26, 20, 6, 7, 13)
        t.set_offset(7)
        t.set_precision(20)
        t.set_size(4)
        t.set_ebias(31)
        lowlevel("f20", t, np.linspace(-3.3, 100.7, 1200).astype(
            "f4").reshape(40, 30), (9, 7))
        lowlevel("full", h5py.h5t.STD_I32LE, rng.integers(-5, 5, (40, 30),
                                                          dtype="i4"),
                 (9, 7))


@pytest.mark.parametrize("case", ["lzf", "scaleoffset", "nbit"])
def test_filters_read_as_h5py_reads_them(tmp_path, case):
    p = tmp_path / "f.h5"
    with h5py.File(p, "w") as f:
        _filtered(f, case, np.random.default_rng(3))
    with h5py.File(p, "r") as f, H.File(p) as g:
        _same_tree(g, f)
        for name in f:
            _same(g[name][5:17, 3:9], f[name][5:17, 3:9])
        if case == "lzf":
            d = g["noise"]
            assert d.compression == f["noise"].compression == "lzf"
            masks = {d._find((z, x))[2] for z in range(0, 40, 8)
                     for x in range(0, 96, 32)}
            assert masks == {1}         # stored raw: lzf could not shrink
            assert {g["small"]._find((0, 0))[2]} == {0}
    with H.File(p) as g:
        if case == "lzf":
            H.reset_read_counts()
            g["small"][...]
            assert H.READ_COUNTS["chunks"] == 6 * 4
    if case == "lzf":
        built = native.library_path(hf._SRC)
        assert built.parent.parts[-2:] == ("build", "ipp_tpu_torch")
        assert built.exists()


def test_no_lzf_without_its_built_decoder(tmp_path, monkeypatch):
    p = tmp_path / "l.h5"
    with h5py.File(p, "w") as f:
        f.create_dataset("d", data=np.arange(100), chunks=(10,),
                         compression="lzf")

    def fail():
        raise OSError("g++: not found")

    monkeypatch.setattr(hf, "_lib", None)
    monkeypatch.setattr(hf, "_error", None)
    monkeypatch.setattr(hf, "_load", fail)
    with H.File(p) as g, pytest.raises(H.FormatError,
                                       match=r"filter 32000 \(lzf\).*g\+\+"):
        g["d"][...]


# -- the committed fixtures ---------------------------------------------------

def test_structure_fixtures_hold_their_regenerated_arrays():
    data = MF.structure_arrays()
    files = [MF.SPLIT, *MF.PARTS, MF.LONG_IMS, MF.SOHM]
    assert sum(p.stat().st_size for p in files) < 1 << 20
    for path, arrays in data.items():
        with h5py.File(path, "r") as f, H.File(path) as g:
            for name, want in arrays.items():
                _same(f[name][()], want)
                H.reset_read_counts()
                _same(g[name][...], want)
                d = g[name]
                assert H.READ_COUNTS["chunks"] == (0 if d.chunks is None
                                                   else int(np.prod([
                                                       -(-n // c) for n, c in
                                                       zip(d.shape,
                                                           d.chunks)])))
            _same_tree(g, f)
    with H.File(MF.LONG_IMS) as g:
        info, want = g["DataSetInfo/Image"].attrs, MF.image_attrs()
        assert sorted(info) == sorted(want)
        for k, v in want.items():
            _same(info[k], v)
        assert len(info["Description"]) == MF.DESCRIPTION_BYTES
        assert isinstance(g["__DATA_TYPES__/UInt16"], H.Datatype)
    with H.File(MF.SOHM) as g:
        assert [x["kind"] for x in g._reader.sohm.indexes] == [1, 0]
        for s in range(MF.SOHM_SETUPS):
            attrs, want = g[f"t00000/s{s:02d}"].attrs, MF.sohm_attrs(s)
            assert sorted(attrs) == sorted(want)
            for k, v in want.items():
                _same(attrs[k], v)
    with H.File(MF.SPLIT) as g:
        d = g["t00000/s01/0/cells"]
        assert d.file.filename == str(MF.PARTS[1])
        assert d._find((0, 0, 0))[2] == 1     # lzf could not shrink it


def test_split_bdv_and_long_ims_read_as_the_jax_package_reads_them():
    from ipp_tpu.io import bdv as bdv_j
    from ipp_tpu.io import ims as ims_j

    for setup, level in ((0, 0), (0, 1), (1, 0)):
        a = bdv_t.BDVReader(MF.SPLIT, setup=setup, level=level)
        b = bdv_j.BDVReader(MF.SPLIT, setup=setup, level=level)
        assert a.shape == b.shape
        for z in range(len(a)):
            np.testing.assert_array_equal(a[z], b[z])
        a.close()
        b.close()
    for level in (0, 1):
        with ims_t.ImarisReader(MF.LONG_IMS, resolution_level=level) as a, \
                ims_j.ImarisReader(MF.LONG_IMS,
                                   resolution_level=level) as b:
            assert a.shape == b.shape
            np.testing.assert_array_equal(a[0:len(a)], b[0:len(b)])
