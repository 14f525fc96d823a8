"""zstd (compression 50000) and LZMA (34925) TIFFs read by the port
without PIL, against the JAX package, which reads them through PIL.

The committed fixtures (tests/torch_tiff_fixtures, written by its
make_fixtures.py with PIL's libtiff writer and libzstd): every file PIL
reads comes out of the port's imread equal to the JAX package's, dtype
included; read_tiff / read_tiff_stack / read_tiff_partial give the stored
samples; the frames PIL does not read, and the hand-built ones, decode to
what libzstd decodes; together they use every block, literals, Huffman
weight and LL / OF / ML table mode.  Then: native.read_block and
TileStack.imread over zstd and LZMA stacks return the data where they used
to return zeros; a checksum mismatch, a dictionary and a legacy frame are
refused by name; and a child process decodes every prefix of two frames
and 300 byte flips, each raising or returning exactly the expected
bytes."""

import hashlib
import importlib.util
import json
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from ipp_tpu import native as native_j
from ipp_tpu.io import tiff as tiff_j
from ipp_tpu_torch import native as native_t
from ipp_tpu_torch.geometry.extent import VExtent
from ipp_tpu_torch.geometry.stacks import TileStack
from ipp_tpu_torch.io import tiff as tiff_t
from ipp_tpu_torch.io.imgcodec import CodecError, UnsupportedCodecError
from ipp_tpu_torch.io.zstd import zstd_decode

ROOT = Path(__file__).resolve().parent.parent
HERE = ROOT / "tests" / "torch_tiff_fixtures"
# under a name of its own: the other fixture folders hold make_fixtures.py
_spec = importlib.util.spec_from_file_location("make_tiff_fixtures",
                                               HERE / "make_fixtures.py")
mk = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(mk)

MANIFEST = json.loads((HERE / "fixtures.json").read_text())
FILES = MANIFEST["files"]
TWINS = sorted(n for n, e in FILES.items() if e["twin"])


@pytest.fixture(scope="module")
def seeds():
    return mk.seeds()


@pytest.mark.parametrize("name", TWINS)
def test_twin_reads_equal_the_jax_package(name):
    got = tiff_t.imread(HERE / name)
    want = tiff_j.imread(HERE / name)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want)
    assert mk.digest(got) == FILES[name]["sha256"]


@pytest.mark.parametrize("name", sorted(FILES))
def test_readers_return_the_stored_samples(name, seeds):
    src = seeds[FILES[name]["seed"]]
    path = HERE / name
    for got in (tiff_t.read_tiff(path), tiff_t.read_tiff_stack(path)[0]):
        assert got.dtype == src.dtype and np.array_equal(got, src)
    img, failed = tiff_t.read_tiff_partial(path)
    assert failed == 0 and np.array_equal(img, src)


def test_frames_pil_does_not_read_decode_as_libzstd_does(seeds):
    """A strip of two frames with a skippable frame between: PIL (libtiff)
    reads the first frame only and refuses the strip; the port reads them
    all, as libzstd's ZSTD_decompress does."""
    names = [n for n, e in FILES.items() if not e["twin"]]
    assert names == ["own_zstd_two_frames.tif"]
    for name in names:
        chunks = mk.chunks_of(HERE / name)
        src = seeds[FILES[name]["seed"]]
        got = [zstd_decode(c, src.nbytes // len(chunks)) for c in chunks]
        assert [hashlib.sha256(g).hexdigest() for g in got] == \
            FILES[name]["chunks"]
        assert mk.digest(tiff_t.imread(HERE / name)) == FILES[name]["sha256"]


@pytest.mark.parametrize("name", sorted(MANIFEST["frames"]))
def test_hand_built_frames_decode_as_libzstd_does(name):
    entry = MANIFEST["frames"][name]
    got = zstd_decode((HERE / "frames" / name).read_bytes(), entry["size"])
    assert hashlib.sha256(got).hexdigest() == entry["sha256"]


def test_every_mode_is_decoded():
    """The fixtures' frames, each decoded above, use every mode."""
    missing = set(mk.MODES + mk.HEADERS) - mk.coverage(MANIFEST)
    assert not missing, sorted(missing)


# -- the zero-fill fault ----------------------------------------------------

@pytest.fixture(scope="module")
def stacks(tmp_path_factory):
    """8 planes of 48 x 72 u16 as zstd TIFFs with predictor 2 (PIL's) and
    as LZMA TIFFs, with their planes."""
    from PIL import Image, TiffImagePlugin

    rng = np.random.default_rng(27)
    root = tmp_path_factory.mktemp("zstd_stacks")
    yy, xx = np.mgrid[0:48, 0:72]
    planes = [np.clip(3000 + 900 * np.sin(xx / 7.0 + z) * np.cos(yy / 5.0)
                      + rng.normal(0, 30, (48, 72)), 0, 65535)
              .astype(np.uint16) for z in range(8)]
    pred = TiffImagePlugin.ImageFileDirectory_v2()
    pred[317] = 2
    for kind, options in (("zstd", dict(compression="zstd", tiffinfo=pred)),
                          ("lzma", dict(compression="lzma"))):
        (root / kind).mkdir()
        for z, p in enumerate(planes):
            Image.fromarray(p).save(root / kind / f"{z:06d}.tif", **options)
    return root, np.stack(planes)


def _paths(root, kind):
    return sorted((root / kind).glob("*.tif"))


@pytest.mark.parametrize("kind", ["zstd", "lzma"])
@pytest.mark.parametrize("fastio", [True, False], ids=["fastio", "no-fastio"])
def test_zstd_and_lzma_stacks_are_read_not_zero_filled(stacks, kind, fastio,
                                                       monkeypatch):
    """native.read_block (its fallback for what fastio leaves) and
    TileStack.imread (its own per-plane loop where fastio is not built)
    return the planes, equal to the JAX package's read_block, where they
    used to return zeros with a warning."""
    root, vol = stacks
    paths = _paths(root, kind)
    roi = (5, 40, 7, 60)
    want = native_j.read_block(paths, 0, 48, 0, 72)
    want_roi = native_j.read_block(paths, *roi)
    assert np.array_equal(want, vol)
    if not fastio:
        monkeypatch.setattr(native_t, "read_block", lambda *a, **k: None)
    stack = TileStack(row=0, col=0, dir_name=kind, root_dir=str(root))
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        got = [stack.imread(VExtent(0, 72, 0, 48, 0, 8)),
               stack.imread(VExtent(roi[2], roi[3], roi[0], roi[1], 2, 8))]
        if fastio:
            got += [native_t.read_block(paths, 0, 48, 0, 72),
                    native_t.read_block(paths, *roi)]
    assert not [w for w in seen if "zero-filled" in str(w.message)]
    assert np.array_equal(got[0], want)
    assert np.array_equal(got[1], want_roi[2:])
    if fastio:
        assert np.array_equal(got[2], want) and np.array_equal(got[3],
                                                               want_roi)


# -- refusals by name -------------------------------------------------------

def _checksum_frame():
    return mk.chunks_of(HERE / "own_zstd_tiles_checksum.tif")[0]


def test_checksum_mismatch_is_refused():
    frame = _checksum_frame()
    n = mk.TILE * mk.TILE * 2
    assert len(zstd_decode(frame, n)) == n
    bad = frame[:-1] + bytes([frame[-1] ^ 0x5A])
    with pytest.raises(CodecError, match="checksum does not match"):
        zstd_decode(bad, n)


def test_dictionary_is_refused_by_name():
    frame = bytearray((HERE / "frames" / "fcs2_single_did1.zst").read_bytes())
    assert frame[4] & 3 == 1 and frame[5] == 0    # a dictionary ID of 0
    frame[5] = 7
    with pytest.raises(UnsupportedCodecError, match="dictionary 7"):
        zstd_decode(bytes(frame), 300)


@pytest.mark.parametrize("magic", [0xFD2FB51E, 0xFD2FB527])
def test_legacy_frame_is_refused_by_name(magic):
    with pytest.raises(UnsupportedCodecError, match="legacy"):
        zstd_decode(magic.to_bytes(4, "little") + bytes(40), 100)


@pytest.mark.parametrize("case,match", [
    ("reserved", "reserved type 3"), ("big", "past the frame's maximum"),
    ("short", "data end after"), ("magic", "not a Zstandard frame")])
def test_malformed_frames_are_refused(case, match):
    rle = (HERE / "frames" / "fcs0_window_did0.zst").read_bytes()
    head = rle[:6]          # magic, a window descriptor (128 KiB), no FCS
    frames = {"reserved": head + (3 << 1 | 1).to_bytes(3, "little"),
              "big": head + ((200000 << 3) | 1 << 1 | 1).to_bytes(3, "little")
              + b"\x00",
              "short": rle, "magic": b"\x28\xb5\x2f\xfe" + rle[4:]}
    with pytest.raises(CodecError, match=match):
        zstd_decode(frames[case], 400)


def test_lzma_without_its_module_raises_naming_it(monkeypatch):
    """Where Python was built without _lzma, an LZMA TIFF raises naming
    the module, at once, and is never zero-filled."""
    monkeypatch.setitem(sys.modules, "lzma", None)
    sleeps = []
    monkeypatch.setattr(tiff_t.time, "sleep", sleeps.append)
    path = HERE / "pil_lzma_u16.tif"
    with pytest.raises(tiff_t.UnsupportedTiffError, match="_lzma"):
        tiff_t.read_tiff(path)
    with pytest.raises(tiff_t.UnsupportedTiffError, match="_lzma"):
        tiff_t.imread(path)
    assert sleeps == []


@pytest.mark.parametrize("tag,value,match", [
    (284, 2, "separate colour planes"), (262, 6, "YCbCr")])
def test_planar_and_ycbcr_zstd_are_refused_by_name(tmp_path, tag, value,
                                                   match):
    """A zstd RGB fixture with its photometric tag rewritten to YCbCr
    raises UnsupportedTiffError, as LZW does (PIL 12.1 reads it: a
    divergence left loud, ROADMAP item 20).  With its planar configuration
    rewritten to separate planes it holds one strip where its three planes
    need three: that raises a TiffError naming the planes, as PIL
    (libtiff) raises, and is never salvaged into an array."""
    import struct

    path = tmp_path / "rgb.tif"
    b = bytearray((HERE / "own_zstd_rgb16.tif").read_bytes())
    ifd = struct.unpack_from("<I", b, 4)[0]
    for i in range(struct.unpack_from("<H", b, ifd)[0]):
        at = ifd + 2 + 12 * i
        if struct.unpack_from("<H", b, at)[0] == tag:
            struct.pack_into("<H", b, at + 8, value)
    path.write_bytes(bytes(b))
    error = tiff_t.UnsupportedTiffError if tag == 262 else tiff_t.TiffError
    for read in (tiff_t.read_tiff, lambda p: tiff_t.imread(p, retries=1)):
        with pytest.raises(error, match=match):
            read(path)


@pytest.mark.parametrize("bits", [1, 4])
def test_sub_byte_samples_are_refused_by_name(tmp_path, bits):
    """1- and 4-bit TIFF of three samples a pixel (the bits-per-sample and
    samples-per-pixel tags rewritten in a plain file), which PIL does not
    read, raise UnsupportedTiffError naming the sample size (one sample a
    pixel is read: test_torch_tiff_bilevel.py)."""
    import struct

    path = tmp_path / "bits.tif"
    tiff_t.write_tiff(path, np.zeros((8, 8), np.uint8))
    b = bytearray(path.read_bytes())
    ifd = struct.unpack_from("<I", b, 4)[0]
    for i in range(struct.unpack_from("<H", b, ifd)[0]):
        at = ifd + 2 + 12 * i
        tag = struct.unpack_from("<H", b, at)[0]
        if tag in (258, 277):
            struct.pack_into("<H", b, at + 8, bits if tag == 258 else 3)
    path.write_bytes(bytes(b))
    with pytest.raises(tiff_t.UnsupportedTiffError,
                       match=f"{bits}-bit samples"):
        tiff_t.imread(path)


CHILD = """
import json, sys
import numpy as np
sys.path.insert(0, sys.argv[1])
from ipp_tpu_torch.io.imgcodec import CodecError
from ipp_tpu_torch.io.zstd import zstd_decode
frames = [(bytes.fromhex(h), n) for h, n in json.load(open(sys.argv[2]))]
bad, trials = [], 0

def trial(data, n, tag):
    global trials
    trials += 1
    try:
        out = zstd_decode(data, n)
    except CodecError:
        return
    except Exception as e:
        bad.append(f"{tag}: {type(e).__name__}: {e}")
        return
    if len(out) != n:
        bad.append(f"{tag}: {len(out)} bytes of {n}")

for k, (frame, n) in enumerate(frames[:2]):
    for cut in range(len(frame)):
        trial(frame[:cut], n, f"frame {k} cut at {cut}")
rng = np.random.default_rng(2027)
for i in range(300):
    k = int(rng.integers(0, 3))
    frame, n = frames[k]
    b = bytearray(frame)
    at = int(rng.integers(0, len(b)))
    b[at] ^= int(rng.integers(1, 256))
    trial(bytes(b), n, f"frame {k} byte {at} flipped")
print(json.dumps({"trials": trials, "bad": bad}))
"""


def test_prefixes_and_byte_flips_raise_or_decode_exactly(tmp_path):
    """In a child process, so that a crash fails this test and does not
    take the test worker with it."""
    u16 = mk.chunks_of(HERE / "pil_zstd_u16.tif")[0]
    frames = [(HERE / "frames" / "rle_tables_treeless_direct.zst"),
              None, None]
    hand = MANIFEST["frames"]["rle_tables_treeless_direct.zst"]["size"]
    frames = [(frames[0].read_bytes().hex(), hand),
              (u16.hex(), int(np.prod(mk.SHAPE)) * 2),
              (_checksum_frame().hex(), mk.TILE * mk.TILE * 2)]
    spec = tmp_path / "frames.json"
    spec.write_text(json.dumps(frames))
    run = subprocess.run([sys.executable, "-c", CHILD, str(ROOT), str(spec)],
                         capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stderr[-2000:]
    out = json.loads(run.stdout.strip().splitlines()[-1])
    assert out["trials"] == len(bytes.fromhex(frames[0][0])) + \
        len(bytes.fromhex(frames[1][0])) + 300
    assert not out["bad"], out["bad"][:10]


# -- on the card ------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a CUDA card")
def test_destripe_cli_on_zstd_tiles_launches_as_on_tiffs(stacks, tmp_path,
                                                         monkeypatch):
    """The pystripe CLI on the card over the zstd stack and over the same
    planes as plain TIFFs: the same outputs and the same K5 / K5s / K8
    launches."""
    from ipp_tpu_torch.ops import cuda_dwt as cd
    from ipp_tpu_torch.ops import cuda_notch as cn
    from ipp_tpu_torch.pipeline import pystripe_cli as P

    monkeypatch.delenv("IPP_TPU_PLATFORM", raising=False)
    root, vol = stacks
    plain = tmp_path / "plain"
    plain.mkdir()
    for z, p in enumerate(vol):
        tiff_t.imwrite(plain / f"{z:06d}.tif", p)
    flags = ["--sigma1", "40", "--sigma2", "40", "--wavelet", "db9",
             "--bidirectional", "--batch-size", "4", "--workers", "2"]
    runs = {}
    for kind, src in (("zstd", root / "zstd"), ("plain", plain)):
        cd.reset_launch_counts()
        cn.reset_launch_counts()
        assert P.main(["-i", str(src), "-o", str(tmp_path / kind),
                       *flags]) == 0
        torch.cuda.synchronize()
        runs[kind] = (dict(cd.LAUNCHES), dict(cn.LAUNCHES))
    assert runs["zstd"] == runs["plain"]
    assert runs["zstd"][0].get("dwt_analysis", 0) > 0
    for p in sorted((tmp_path / "plain").rglob("*.tif")):
        q = tmp_path / "zstd" / p.relative_to(tmp_path / "plain")
        assert np.array_equal(tiff_t.imread(p), tiff_t.imread(q))
