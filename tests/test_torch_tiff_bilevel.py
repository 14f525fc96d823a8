"""Bilevel, 2- and 4-bit, CCITT fax and separate-plane TIFF read by the
port without PIL, against the JAX package, which reads them through PIL.

The committed fixtures (tests/torch_tiff_fixtures/bilevel, written by
make_fixtures.py with PIL's libtiff writer and the module's own writer):
1-bit planes in every compression (none, PackBits, deflate, LZW, zstd,
LZMA, CCITT RLE, Group 3 1-D and 2-D with and without fill bits, Group 4)
with FillOrder 1 and 2, photometric 0 and 1, one strip and several (the
last cut short), at a width that is no multiple of 8, and fax strips that
use every run-length code; 2- and 4-bit gray and palette planes in strips
and tiles; separate colour planes (gray + alpha, RGB, RGBA, 8 and 16
bits, predictor 2) in LZW, zstd, LZMA and JPEG.  Every file the JAX
package reads comes out of the port's imread, generic2d.read_plane and
tiffcodec.read_tiff_plane equal to its array and to PIL's, dtype and
shape included; every file it does not read raises UnsupportedTiffError
naming the layout, at once.  Then: the fax decoder on malformed and cut
streams, a truncated fax file zero-filled with the warning by read_block
and TileStack.imread as the JAX package's are, and a stack of 4-bit LZW
tiles read by read_block and TileStack.imread as the JAX package reads
it."""

import importlib.util
import json
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import pytest

from ipp_tpu import native as native_j
from ipp_tpu.geometry.stacks import TileStack as TileStackJ
from ipp_tpu.io import tiff as tiff_j
from ipp_tpu_torch import native as native_t
from ipp_tpu_torch.geometry.extent import VExtent
from ipp_tpu_torch.geometry.stacks import TileStack
from ipp_tpu_torch.io import ccitt, generic2d, tiffcodec
from ipp_tpu_torch.io import tiff as tiff_t
from ipp_tpu_torch.io.imgcodec import CodecError, UnsupportedCodecError

ROOT = Path(__file__).resolve().parent.parent
FIXTURES = ROOT / "tests" / "torch_tiff_fixtures"
HERE = FIXTURES / "bilevel"
# under a name of its own: the other fixture folders hold make_fixtures.py
_spec = importlib.util.spec_from_file_location("make_tiff_fixtures",
                                               FIXTURES / "make_fixtures.py")
mk = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(mk)

MANIFEST = json.loads((HERE / "bilevel.json").read_text())
FILES = MANIFEST["files"]
# separate planes that PIL reads but the JAX package's own reader fails on
JAX_FAILS = sorted(n for n, e in FILES.items() if n.startswith("own_planar")
                   and e["compression"] in ("none", "deflate", "packbits"))
READ = sorted(n for n, e in FILES.items()
              if e["pil"] == "reads" and n not in JAX_FAILS)
REFUSED = sorted(set(FILES) - set(READ))
READERS = {"imread": tiff_t.imread, "read_plane": generic2d.read_plane,
           "read_tiff_plane": tiffcodec.read_tiff_plane}


@pytest.fixture(scope="module")
def seeds():
    return mk.bilevel_seeds()


def test_the_fixtures_cover_every_layout():
    """1-bit in every compression and variant, CCITT at every scheme with
    the wide run-length rows, 2- and 4-bit gray and palette in every
    compression, separate planes of every kind in every codec that reads
    them, each read by PIL; and the refused layouts, each refused by
    PIL or the JAX package."""
    names = set(READ)
    for tag, _ in mk.PIL_1BIT.values():
        assert {f"pil_1bit_{tag}_{v}.tif" for v in mk.VARIANTS} <= names
    assert {f"pil_1bit_{t}_runs.tif" for t in mk.FAX_CODECS} <= names
    for bits in (2, 4):
        for c in mk.OWN_CODECS:
            assert {f"own_{bits}bit_{c}_{k}.tif" for k in ("strips", "tiles")
                    } <= names
            assert f"own_{bits}bit_{c}_palette.tif" in (
                names if c != "none" else set(REFUSED))
    for kind in ("la8", "rgb8", "rgba8", "rgb16", "rgba16"):
        for c in ("lzw", "zstd", "lzma"):
            assert {f"own_planar_{c}_{kind}_{k}.tif"
                    for k in ("strips", "tiles")} <= names
    assert len(REFUSED) == 16 and len(READ) == 152


@pytest.mark.parametrize("name", READ)
def test_reads_equal_pil_and_the_jax_package(name):
    from PIL import Image

    path = HERE / name
    with Image.open(path) as im:
        pil = np.asarray(im)
    want = tiff_j.imread(path, retries=1)
    assert want.dtype == pil.dtype and np.array_equal(want, pil)
    assert mk.digest(pil) == FILES[name]["sha256"]
    for reader, read in READERS.items():
        got = read(path)
        assert (got.dtype, got.shape) == (want.dtype, want.shape), reader
        assert np.array_equal(got, want), reader
        assert mk.digest(got) == FILES[name]["sha256"], reader   # bytes too


@pytest.mark.parametrize("name", REFUSED)
def test_refused_layouts_raise_by_name_at_once(name, monkeypatch):
    """What the JAX package does not read (PIL refuses it, or its own
    reader fails on it) raises UnsupportedTiffError naming the layout:
    no retries, no zeros."""
    path = HERE / name
    monkeypatch.setattr(time, "sleep", lambda s: None)
    with pytest.raises(Exception):
        tiff_j.imread(path, retries=1)
    sleeps = []
    monkeypatch.setattr(time, "sleep", sleeps.append)
    for reader, read in READERS.items():
        with pytest.raises(tiff_t.UnsupportedTiffError,
                           match=r"(-bit|planes|alpha).* not read"):
            read(path)
    assert sleeps == []


@pytest.mark.parametrize("name", sorted(
    n for n in READ if n.startswith("own_") and FILES[n]["compression"]
    not in ("jpeg",) and "nophoto" not in n))
def test_readers_return_the_stored_samples(name, seeds):
    """read_tiff, read_tiff_stack and read_tiff_partial give the samples
    as stored (before PIL's view): one uint8 a sub-byte sample."""
    src = seeds[FILES[name]["seed"]]
    if src.dtype == bool:
        src = src.astype(np.uint8)
    path = HERE / name
    for got in (tiff_t.read_tiff(path), tiff_t.read_tiff_stack(path)[0]):
        assert got.dtype == src.dtype and np.array_equal(got, src)
    img, failed = tiff_t.read_tiff_partial(path)
    assert failed == 0 and np.array_equal(img, src)


# -- the fax decoder ----------------------------------------------------------

def _strip(name, i=0):
    return mk.chunks_of(HERE / name)[i]


def test_fax_library_builds_into_the_build_tree():
    ccitt.load()
    path = native_t.library_path(ccitt._SRC, ccitt._FLAGS)
    assert path.parent == ROOT / "build" / "ipp_tpu_torch" and path.exists()


@pytest.mark.parametrize("name,scheme,options", [
    ("pil_1bit_rle_runs.tif", 2, 0), ("pil_1bit_g3_runs.tif", 3, 0),
    ("pil_1bit_g3_2d_runs.tif", 3, 1), ("pil_1bit_g4_runs.tif", 4, 0)])
def test_every_run_length_code_decodes(name, scheme, options, seeds):
    """Rows with every terminating and make-up length in both colours
    (past 2560: two make-up codes), decoded strip by strip."""
    src = seeds["bw_runs"]
    w = src.shape[1]
    for i, chunk in enumerate(mk.chunks_of(HERE / name)):
        want = src[64 * i:64 * (i + 1)]
        raw = ccitt.ccitt_decode(chunk, len(want), w, scheme, options)
        got = np.unpackbits(np.frombuffer(raw, np.uint8).reshape(
            len(want), -1), axis=1, count=w)
        assert np.array_equal(got, want)


@pytest.mark.parametrize("case", ["cut", "zeros", "long row"])
def test_malformed_fax_data_raise(case):
    """Data that end before the last row, a code in no table (twelve
    zeros are no white code) and a row past the width raise CodecError
    naming what is wrong."""
    g4 = _strip("pil_1bit_g4_one.tif")
    h, w = mk.BW_SHAPE
    data, width, match = {"cut": (g4[:len(g4) // 2], w, "end inside row"),
                          "zeros": (bytes(8), w, "bad white code"),
                          "long row": (g4, 9, "longer than the width|off "
                                              "the row|past the row")}[case]
    with pytest.raises(CodecError, match=match):
        ccitt.ccitt_decode(data, h, width, 4 if case != "zeros" else 2)


def test_uncompressed_mode_is_refused_by_name(tmp_path):
    """The extension code that enters uncompressed mode (0000001 111) in a
    Group 4 row raises UnsupportedTiffError naming it, at once."""
    with pytest.raises(UnsupportedCodecError, match="uncompressed mode"):
        ccitt.ccitt_decode(bytes([0b00000011, 0b11000000]), 1, 16, 4)
    h, w = 8, 16
    mk.write_tiff(tmp_path / "u.tif", np.zeros((h, w), bool),
                  lambda d: bytes([0b00000011, 0b11000000]), 4, bits=1)
    with pytest.raises(tiff_t.UnsupportedTiffError, match="uncompressed"):
        tiff_t.imread(tmp_path / "u.tif", retries=1)


CHILD = """
import json, sys
import numpy as np
sys.path.insert(0, sys.argv[1])
from ipp_tpu_torch.io.ccitt import ccitt_decode
from ipp_tpu_torch.io.imgcodec import CodecError
cases = [(bytes.fromhex(h), r, w, s, o) for h, r, w, s, o in
         json.load(open(sys.argv[2]))]
bad, trials = [], 0

def trial(data, rows, w, s, o, tag):
    global trials
    trials += 1
    try:
        out = ccitt_decode(data, rows, w, s, o)
    except CodecError:
        return
    except Exception as e:
        bad.append(f"{tag}: {type(e).__name__}: {e}")
        return
    if len(out) != rows * ((w + 7) // 8):
        bad.append(f"{tag}: {len(out)} bytes")

rng = np.random.default_rng(2028)
for k, (data, rows, w, s, o) in enumerate(cases):
    for cut in range(len(data)):
        trial(data[:cut], rows, w, s, o, f"case {k} cut at {cut}")
    for i in range(100):
        b = bytearray(data)
        at = int(rng.integers(0, len(b)))
        b[at] ^= int(rng.integers(1, 256))
        trial(bytes(b), rows, w, s, o, f"case {k} byte {at} flipped")
print(json.dumps({"trials": trials, "bad": bad}))
"""


def test_cut_and_flipped_fax_data_raise_or_decode(tmp_path):
    """In a child process, so that a crash fails this test and does not
    take the test worker with it: every prefix of an RLE, a Group 3 2-D
    and a Group 4 strip, and 100 byte flips of each, raise CodecError or
    decode to exactly the rows asked for."""
    h, w = mk.BW_SHAPE
    cases = [(_strip(f"pil_1bit_{t}_one.tif").hex(), h, w, s, o)
             for t, s, o in (("rle", 2, 0), ("g3_2d", 3, 1), ("g4", 4, 0))]
    spec = tmp_path / "cases.json"
    spec.write_text(json.dumps(cases))
    run = subprocess.run([sys.executable, "-c", CHILD, str(ROOT), str(spec)],
                         capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stderr[-2000:]
    out = json.loads(run.stdout.strip().splitlines()[-1])
    assert out["trials"] == sum(len(c[0]) // 2 + 100 for c in cases)
    assert not out["bad"], out["bad"][:10]


# -- the stacks ---------------------------------------------------------------

def stack_of(kind: str, root: Path) -> dict:
    """A TileStack's fields for the u8 planes in root/kind."""
    return dict(row=0, col=0, dir_name=kind, root_dir=str(root),
                bytes_per_chan=1)


def _stack(root: Path, kind: str, planes, write) -> list:
    (root / kind).mkdir()
    paths = [root / kind / f"{z:06d}.tif" for z in range(len(planes))]
    for p, plane in zip(paths, planes):
        write(p, plane)
    return paths


@pytest.mark.parametrize("fastio", [True, False], ids=["fastio", "no-fastio"])
def test_truncated_fax_plane_is_zero_filled_with_the_warning(tmp_path,
                                                             fastio,
                                                             monkeypatch):
    """A Group 4 plane whose file ends inside its last strip raises
    TiffError (not UnsupportedTiffError) from imread, as the JAX
    package's imread raises; read_block and TileStack.imread zero-fill it
    with the warning, as the JAX package's do, and read the others."""
    monkeypatch.setattr(time, "sleep", lambda s: None)   # imread's retries
    src = HERE / "pil_1bit_g4_strips.tif"
    data = src.read_bytes()
    last = mk.chunks_of(src)[-1]
    cut = data[:data.rindex(last) + len(last) // 2]

    def write(p, plane):
        p.write_bytes(cut if plane == "cut" else data)

    paths = _stack(tmp_path, "g4", ["ok", "cut", "ok"], write)
    with pytest.raises(tiff_j.TiffError):
        tiff_j.imread(paths[1], retries=1)
    with pytest.raises(tiff_t.TiffError) as e:
        tiff_t.imread(paths[1], retries=1)
    assert not isinstance(e.value, tiff_t.UnsupportedTiffError)
    h, w = mk.BW_SHAPE
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        want = native_j.read_block(paths, 0, h, 0, w, dtype=np.uint8)
        want_stack = TileStackJ(**stack_of("g4", tmp_path)).imread(
            VExtent(0, w, 0, h, 0, 3))
    assert sum("zero-filled" in str(x.message) for x in seen) == 2
    assert not want[1].any() and want[0].any()
    assert want_stack.dtype == want.dtype
    assert np.array_equal(want_stack, want)
    if not fastio:
        monkeypatch.setattr(native_t, "read_block", lambda *a, **k: None)
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        got = [TileStack(**stack_of("g4", tmp_path)).imread(
            VExtent(0, w, 0, h, 0, 3))]
        if fastio:
            got.append(native_t.read_block(paths, 0, h, 0, w,
                                           dtype=np.uint8))
    assert sum("zero-filled" in str(x.message) for x in seen) == len(got)
    for g in got:
        assert g.dtype == want.dtype and np.array_equal(g, want)


@pytest.mark.parametrize("fastio", [True, False], ids=["fastio", "no-fastio"])
def test_4bit_lzw_tile_stack_reads_as_the_jax_package(tmp_path, fastio,
                                                      monkeypatch):
    """8 planes of 40 x 56 4-bit LZW tiles (16 x 16): read_block and
    TileStack.imread, whole and a window, equal the JAX package's (PIL's
    values times 17), none zero-filled."""
    rng = np.random.default_rng(28)
    planes = [rng.integers(0, 16, (40, 56), dtype=np.uint8)
              for _ in range(8)]
    paths = _stack(tmp_path, "s4", planes, lambda p, a: mk.write_tiff(
        p, a, mk.lzw_compress, 5, bits=4, tile=16))
    roi = (3, 37, 5, 50)
    want = native_j.read_block(paths, 0, 40, 0, 56, dtype=np.uint8)
    assert np.array_equal(want, np.stack(planes) * 17)
    stack_j = TileStackJ(**stack_of("s4", tmp_path))
    want_roi = stack_j.imread(VExtent(roi[2], roi[3], roi[0], roi[1], 2, 8))
    if not fastio:
        monkeypatch.setattr(native_t, "read_block", lambda *a, **k: None)
    stack = TileStack(**stack_of("s4", tmp_path))
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        got = [stack.imread(VExtent(0, 56, 0, 40, 0, 8)),
               stack.imread(VExtent(roi[2], roi[3], roi[0], roi[1], 2, 8))]
    assert not [x for x in seen if "zero-filled" in str(x.message)]
    assert got[0].dtype == want.dtype and np.array_equal(got[0], want)
    assert np.array_equal(got[1], want_roi)


def test_fastio_build_error_is_kept(monkeypatch):
    """Where fastio does not build, the callers fall back to numpy as
    before, and native.build_error() keeps g++'s message."""
    def fail(*a, **k):
        raise OSError("g++ exit 1: fastio.cpp:9: fatal error: zstd.h: No "
                      "such file or directory")

    monkeypatch.setattr(native_t, "_lib", None)
    monkeypatch.setattr(native_t, "_build_error", None)
    monkeypatch.setattr(native_t, "build_shared", fail)
    assert native_t.build_error() is None
    assert not native_t.available()
    assert native_t.tiff_read(HERE / "pil_1bit_g4_one.tif") is None
    assert "zstd.h: No such file" in native_t.build_error()
    assert native_t.build_error().startswith("OSError: g++ exit 1")
