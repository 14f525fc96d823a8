"""The port's fastio on its own Zstandard codec (CPU).

fastio.cpp, a copy of the JAX package's, includes <zstd.h>; the port
answers it with native/include/zstd.h over native/zstd_api.cpp, whose
ZSTD_compress is native/zstd_enc.cpp and whose ZSTD_decompress is
native/zstd.cpp, so the library builds with g++ and zlib alone.  Here:
frames at levels -5 to 22 decode through the port's decoder, the system
libzstd (through ctypes, where it is installed) and the JAX package's
fastio; bricks cross between the packages both ways; level-3 frames stay
within 1.10x of libzstd's size and every frame within ZSTD_compressBound;
the build resolves zstd.h to the port's header, links no libzstd and
rebuilds on any change; and fastio leaves TIFF bytes and block reads as
the numpy path makes them.  Inputs come from numpy seeds.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import shutil
import struct
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest

from ipp_tpu import native as native_j
from ipp_tpu_torch import native as native_t
from ipp_tpu_torch.geometry.extent import VExtent
from ipp_tpu_torch.geometry.stacks import TileStack
from ipp_tpu_torch.io import tiff as tiff_t
from ipp_tpu_torch.io.zstd import zstd_decode

from tests import torch_zstd_corpus as zc

NATIVE = Path(native_t.__file__).resolve().parent
LEVELS = [-5, 1, 3, 9, 19, 22]
HEADER = 16           # fastio's brick header: magic, raw size
SWEEP_PLANES = 16     # the bricks' planes in the level sweep (64 for sizes)


CORPUS = list(zc.make_corpus(1))


@pytest.fixture(scope="module")
def port():
    """The port's fastio library, its ZSTD_* calls bound."""
    assert native_t.available(), native_t.build_error()
    return zc.bind(ctypes.CDLL(str(native_t._library_path())))


@pytest.fixture(scope="module")
def libzstd():
    name = ctypes.util.find_library("zstd")
    if name is None:
        pytest.skip("no libzstd on this host")
    return zc.bind(ctypes.CDLL(name))


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """Every corpus entry (bricks cut to SWEEP_PLANES planes) saved by the
    port's zstd_save at every level, four at a time (ctypes releases the
    interpreter lock): {(name, level): path}, and the corpus."""
    root = tmp_path_factory.mktemp("bricks")
    corpus = zc.make_corpus(SWEEP_PLANES)

    def save(key):
        name, level = key
        path = root / f"{name}_{level}.zst"
        assert native_t.zstd_save(path, np.frombuffer(corpus[name], np.uint8),
                                  level)
        return key, path

    keys = [(n, lv) for lv in reversed(LEVELS) for n in corpus]
    with ThreadPoolExecutor(4) as pool:
        paths = dict(pool.map(save, keys))
    return paths, corpus


@pytest.mark.parametrize("level", LEVELS)
@pytest.mark.parametrize("name", CORPUS)
def test_frame_decodes_through_three_decoders(saved, libzstd, name, level):
    """The port's frame decodes to its input through the port's decoder,
    the system libzstd and the JAX package's zstd_load, within
    ZSTD_compressBound."""
    paths, corpus = saved
    data = corpus[name]
    blob = paths[name, level].read_bytes()
    magic, raw = struct.unpack("<QQ", blob[:HEADER])
    assert magic == 0x49505059425249 and raw == len(data)
    frame = blob[HEADER:]
    assert len(frame) <= zc.compress_bound(len(data))
    assert zstd_decode(frame, len(data)) == data
    assert zc.decompress(libzstd, frame, len(data)) == data
    if not native_j.available():
        pytest.skip("the JAX package's fastio does not build here")
    got = native_j.zstd_load(paths[name, level], (len(data),), np.uint8)
    assert got is not None and got.tobytes() == data


@pytest.mark.parametrize("name", CORPUS)
def test_level_3_size_within_libzstd(port, libzstd, name):
    """At level 3 (the brick cache's default) each corpus entry, bricks at
    64 planes, compresses to at most 1.10x libzstd's level-3 frame."""
    data = _corpus_64()[name]
    ours = zc.compress(port, data, 3)
    theirs = zc.compress(libzstd, data, 3)
    assert len(ours) <= 1.10 * len(theirs), (len(ours), len(theirs))
    assert zc.decompress(libzstd, ours, len(data)) == data


_FULL = {}


def _corpus_64():
    if not _FULL:
        _FULL.update(zc.make_corpus(64))
    return _FULL


@pytest.mark.parametrize("short", [1, 2, 40, "half", "all"])
def test_short_capacity_is_an_error_with_nothing_written_past_it(port, short):
    """ZSTD_compress into too small a buffer returns an error that
    ZSTD_isError reports (libzstd's dstSize_tooSmall), and the bytes past
    the capacity keep their canary."""
    data = zc.make_corpus(1)["poisson"][:3 * zc.BLOCK + 17]
    need = len(zc.compress(port, data, 3))
    cap = {"half": need // 2, "all": 0}[short] if isinstance(short, str) \
        else need - short
    buf = ctypes.create_string_buffer(b"\xa5" * (need + 64), need + 64)
    got = port.ZSTD_compress(buf, cap, data, len(data), 3)
    assert port.ZSTD_isError(got)
    assert got == ctypes.c_size_t(-70).value
    assert buf.raw[cap:] == b"\xa5" * (need + 64 - cap)


def test_decompress_into_a_short_buffer_is_an_error(port):
    """ZSTD_decompress of a frame larger than the capacity, or of a cut
    frame, returns an error that ZSTD_isError reports, and writes nothing
    past the capacity."""
    data = zc.make_corpus(1)["poisson"][:5000]
    frame = zc.compress(port, data, 3)
    out = ctypes.create_string_buffer(b"\xa5" * len(data), len(data))
    got = port.ZSTD_decompress(out, len(data) - 1, frame, len(frame))
    assert port.ZSTD_isError(got)
    assert out.raw[-1:] == b"\xa5"
    got = port.ZSTD_decompress(out, len(data), frame[:-3], len(frame) - 3)
    assert port.ZSTD_isError(got)


# -- bricks across the packages ----------------------------------------------

def test_port_reads_bricks_the_jax_package_wrote(tmp_path, rng):
    if not native_j.available():
        pytest.skip("the JAX package's fastio does not build here")
    arr = rng.standard_normal((16, 32, 24)).astype(np.float32)
    vol = rng.poisson(100, (6, 40, 60)).astype(np.uint16)
    p = tmp_path / "brick.zst"
    assert native_j.zstd_save(p, arr)
    np.testing.assert_array_equal(native_t.zstd_load(p, arr.shape,
                                                     arr.dtype), arr)
    bricks = []
    for y0, x0 in [(0, 0), (0, 30), (20, 0), (20, 30)]:
        q = tmp_path / f"b_{y0}_{x0}.zst"
        assert native_j.zstd_save(q, vol[:, y0:y0 + 20, x0:x0 + 30], 19)
        bricks.append((str(q), y0, x0, 20, 30))
    out = native_t.load_slab(bricks, 6, 40, 60, np.uint16)
    np.testing.assert_array_equal(out, vol)


def test_zstd_brick_roundtrip(tmp_path, rng):
    arr = rng.standard_normal((16, 32, 24)).astype(np.float32)
    p = tmp_path / "brick.zst"
    assert native_t.zstd_save(p, arr)
    np.testing.assert_array_equal(native_t.zstd_load(p, arr.shape,
                                                     arr.dtype), arr)


def test_load_slab_assembly(tmp_path, rng, monkeypatch):
    """tests/test_native.py's slab test on the port: slab reassembly from
    bricks (reference load_slab_lz4_test.m), threaded, serial and auto."""
    monkeypatch.setitem(native_t._slab_choice, "mode", None)
    slab = rng.standard_normal((4, 40, 60)).astype(np.float32)
    bricks = []
    for (y0, x0, by, bx) in [(0, 0, 20, 30), (0, 30, 20, 30),
                             (20, 0, 20, 30), (20, 30, 20, 30)]:
        p = tmp_path / f"b_{y0}_{x0}.zst"
        assert native_t.zstd_save(p, slab[:, y0:y0 + by, x0:x0 + bx])
        bricks.append((str(p), y0, x0, by, bx))
    out = native_t.load_slab(bricks, 4, 40, 60, np.float32)
    np.testing.assert_array_equal(out, slab)
    ser = native_t.load_slab_serial(bricks, 4, 40, 60, np.float32)
    np.testing.assert_array_equal(ser, slab)
    auto = native_t.load_slab_auto(bricks, 4, 40, 60, np.float32)
    np.testing.assert_array_equal(auto, slab)
    assert native_t.slab_mode() in ("native", "serial")
    auto2 = native_t.load_slab_auto(bricks, 4, 40, 60, np.float32)
    np.testing.assert_array_equal(auto2, slab)


def test_bricks_at_many_threads_decode_alike(tmp_path):
    """zstd_save on 8 threads at once (no shared state in the encoder):
    every brick byte-equal to the same brick saved alone."""
    data = np.frombuffer(zc.make_corpus(2)["poisson"], np.uint8)
    parts = np.array_split(data, 16)

    def save(i):
        p = tmp_path / f"t{i}.zst"
        assert native_t.zstd_save(p, parts[i], 3)
        return p.read_bytes()

    with ThreadPoolExecutor(8) as pool:
        together = list(pool.map(save, range(16)))
    assert [save(i) for i in range(16)] == together


# -- the build -----------------------------------------------------------------

def test_zstd_h_resolves_to_the_ports_header():
    """g++ -M over fastio's build finds zstd.h in native/include, ahead of
    any system header."""
    for src in ("fastio.cpp", "zstd_api.cpp"):
        run = subprocess.run(
            ["g++", "-M", "-std=c++17", *(f"-I{d}" for d in native_t._INCLUDE),
             str(NATIVE / src)], capture_output=True, text=True, check=True)
        deps = run.stdout.replace("\\\n", " ").split()
        found = [Path(d).resolve() for d in deps if Path(d).name == "zstd.h"]
        assert found == [NATIVE / "include" / "zstd.h"], found


def _needed(path):
    """DT_NEEDED names of a 64-bit little-endian ELF shared object."""
    b = Path(path).read_bytes()
    assert b[:4] == b"\x7fELF" and b[4] == 2 and b[5] == 1
    shoff, = struct.unpack_from("<Q", b, 0x28)
    shentsize, shnum = struct.unpack_from("<HH", b, 0x3A)
    sections = [struct.unpack_from("<IIQQQQIIQQ", b, shoff + i * shentsize)
                for i in range(shnum)]
    dynamic = [s for s in sections if s[1] == 6]      # SHT_DYNAMIC
    assert len(dynamic) == 1
    _, _, _, _, off, size, link, _, _, entsize = dynamic[0]
    strtab = sections[link][4]
    names = []
    for at in range(off, off + size, entsize):
        tag, val = struct.unpack_from("<qQ", b, at)
        if tag == 1:                                  # DT_NEEDED
            end = b.index(b"\0", strtab + val)
            names.append(b[strtab + val:end].decode())
    return names


def test_library_links_no_libzstd(port):
    needed = _needed(native_t._library_path())
    assert any(n.startswith("libz.so") for n in needed), needed
    assert not any("zstd" in n for n in needed), needed
    if shutil.which("readelf"):
        out = subprocess.run(["readelf", "-d", str(native_t._library_path())],
                             capture_output=True, text=True).stdout
        assert "zstd" not in out


@pytest.mark.parametrize("changed", ["fastio.cpp", "zstd.cpp", "zstd_enc.cpp",
                                     "zstd_api.cpp", "include/zstd.h",
                                     "flags"])
def test_any_change_gives_a_new_library(tmp_path, changed):
    """The library's name hashes every source, the header and the flags."""
    files = ["fastio.cpp", "zstd.cpp", "zstd_enc.cpp", "zstd_api.cpp",
             "include/zstd.h"]
    for f in files:
        (tmp_path / f).parent.mkdir(exist_ok=True)
        shutil.copy(NATIVE / f, tmp_path / f)

    def path(flags=native_t._FLAGS):
        return native_t.library_path(
            tmp_path / "fastio.cpp", flags, native_t._LIBS,
            [tmp_path / f for f in files[1:4]], [tmp_path / "include"])

    before = path()
    assert before == native_t._library_path()
    if changed == "flags":
        assert path((*native_t._FLAGS, "-g")) != before
        return
    with open(tmp_path / changed, "a") as f:
        f.write("\n// changed\n")
    assert path() != before


# -- fastio leaves results as they were ------------------------------------------

def _plane(rng, dtype, shape=(1100, 700)):
    if np.dtype(dtype).kind == "f":
        return (rng.random(shape) * 1000).astype(dtype)
    hi = np.iinfo(dtype).max
    return rng.integers(0, hi, shape, endpoint=True).astype(dtype)


@pytest.mark.parametrize("dtype", [np.uint16, np.uint8, np.float32])
@pytest.mark.parametrize("compression", [None, "zlib"])
def test_fastio_does_not_change_results(tmp_path, dtype, compression,
                                        monkeypatch):
    """The port's tiff.imwrite bytes, and the arrays of native.read_block
    and TileStack.imread, are the same with fastio and without it (the
    numpy codec), at 1100 x 700, many strips."""
    rng = np.random.default_rng(7)
    planes = [_plane(rng, dtype) for _ in range(3)]
    runs = {}
    for kind in ("fastio", "numpy"):
        if kind == "numpy":
            monkeypatch.setattr(native_t, "_lib", "unavailable")
        d = tmp_path / kind / "tiles"
        d.mkdir(parents=True)
        for z, p in enumerate(planes):
            tiff_t.imwrite(d / f"{z:06d}.tif", p, compression=compression)
        stack = TileStack(row=0, col=0, dir_name="tiles",
                          root_dir=str(tmp_path / kind),
                          bytes_per_chan=np.dtype(dtype).itemsize)
        paths = sorted(d.glob("*.tif"))
        runs[kind] = dict(
            bytes=[p.read_bytes() for p in paths],
            block=native_t.read_block(paths, 100, 1000, 50, 650, dtype=dtype),
            stack=stack.imread(VExtent(50, 650, 100, 1000, 0, 3)))
    want = np.stack(planes)[:, 100:1000, 50:650]
    assert runs["fastio"]["bytes"] == runs["numpy"]["bytes"]
    assert runs["numpy"]["block"] is None
    np.testing.assert_array_equal(runs["fastio"]["block"], want)
    assert runs["fastio"]["block"].dtype == want.dtype
    # a stack reads 4-byte samples as uint32 (reference tsv/volume.py)
    for got in (runs["fastio"]["stack"], runs["numpy"]["stack"]):
        assert got.dtype == stack.dtype
        np.testing.assert_array_equal(got, want.astype(stack.dtype))


@pytest.mark.parametrize("dtype", [np.uint16, np.uint8, np.float32])
@pytest.mark.parametrize("compression", [None, "zlib"])
def test_multi_strip_bytes_equal_the_references_fastio(tmp_path, dtype,
                                                       compression,
                                                       monkeypatch):
    """A plane of many strips (1100 x 700) written by the port, with fastio
    and without it, is byte-equal to the JAX package's tiff.imwrite through
    the JAX package's fastio: the port's numpy writer lays out strip counts
    before offsets as that fastio does."""
    from ipp_tpu.io import tiff as tiff_j

    if not native_j.available():
        pytest.skip("the JAX package's fastio did not build on this host")
    plane = _plane(np.random.default_rng(11), dtype)
    ref = tmp_path / "ref.tif"
    tiff_j.imwrite(ref, plane, compression=compression)
    got = {}
    for kind in ("fastio", "numpy"):
        if kind == "numpy":
            monkeypatch.setattr(native_t, "_lib", "unavailable")
        path = tmp_path / f"{kind}.tif"
        tiff_t.imwrite(path, plane, compression=compression)
        got[kind] = path.read_bytes()
    assert got["fastio"] == ref.read_bytes()
    assert got["numpy"] == ref.read_bytes()
