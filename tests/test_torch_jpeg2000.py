"""The port's JPEG 2000 codec (ipp_tpu_torch/io/jpeg2000.py over
native/j2k.cpp) against PIL over OpenJPEG, which the JAX package reads and
writes .jp2 / .j2k planes through.

- The committed fixtures (tests/torch_jpeg2000_fixtures, written by its
  make_fixtures.py with PIL) decode to the digests of PIL's arrays, and
  the lossless ones to their seeds.
- Planes PIL writes at its options (every mode, tiles, progressions,
  precincts, code-block sizes, resolutions, layers, the 9/7 wavelet with
  and without the ICT) decode bit-equal to PIL's decode.
- What PIL cannot make raises CodecError naming it.
- The port's own files decode to the written array through the port,
  through PIL and through the JAX package's imread, and declare PIL's
  parameters: the same SIZ, COD and QCD segments and JP2 header boxes."""

import importlib.util
import io
import json
import struct
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from ipp_tpu.io import tiff as tj
from ipp_tpu_torch.io import generic2d as gt
from ipp_tpu_torch.io import jpeg2000 as j2
from ipp_tpu_torch.io.imgcodec import CodecError

ROOT = Path(__file__).resolve().parent.parent
FIXTURES = ROOT / "tests" / "torch_jpeg2000_fixtures"
# loaded under a name of its own: other test files import the image and
# HDF5 fixture makers as `make_fixtures` in the same process
_spec = importlib.util.spec_from_file_location("make_jp2_fixtures",
                                               FIXTURES / "make_fixtures.py")
mk = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(mk)
MANIFEST = json.loads((FIXTURES / "fixtures.json").read_text())


@pytest.mark.parametrize("name", sorted(MANIFEST["files"]))
def test_fixture_decodes_bit_equal(name):
    entry = MANIFEST["files"][name]
    got = gt.read_plane(FIXTURES / name)
    assert mk.digest(got) == entry["sha256"]
    with Image.open(FIXTURES / name) as im:
        np.testing.assert_array_equal(got, np.asarray(im))
    if entry["lossless"]:
        want = mk.seeds()[entry["seed"]]
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_fixtures_are_what_the_maker_writes(tmp_path):
    """Regenerated with this host's PIL, the fixtures hold the same
    digests; together they stay under 1 MB."""
    assert sorted(MANIFEST["files"]) == sorted(mk.FILES)
    files = mk.write(tmp_path)["files"]
    assert json.loads(json.dumps(files)) == MANIFEST["files"]
    assert sum(p.stat().st_size for p in FIXTURES.iterdir()) < 1 << 20


def _plane(rng, mode, h, w):
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    field = 0.5 + 0.3 * np.sin(xx / 7.0 + yy / 11.0)
    if mode == "I;16":
        return np.clip(field * 60000 + rng.normal(0, 500, (h, w)), 0,
                       65535).astype(np.uint16)
    n = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4}[mode]
    f = field[..., None] * np.linspace(0.6, 1.0, n)
    a = np.clip(f * 255 + rng.normal(0, 8, (h, w, n)), 0, 255).astype(
        np.uint8)
    return a[..., 0] if n == 1 else a


OPTIONS = [
    ("L", {}), ("I;16", {}), ("LA", {}), ("RGB", {}), ("RGBA", {}),
    ("I;16", dict(no_jp2=True)), ("RGBA", dict(no_jp2=True)),
    ("I;16", dict(irreversible=True)), ("L", dict(irreversible=True)),
    ("RGB", dict(irreversible=True, mct=1)), ("RGB", dict(mct=1)),
    ("RGBA", dict(irreversible=True, mct=1)),
    ("L", dict(tile_size=(32, 32))), ("RGB", dict(tile_size=(40, 24))),
    ("L", dict(progression="RLCP")), ("I;16", dict(progression="RPCL")),
    ("RGB", dict(progression="PCRL", precinct_size=(64, 32))),
    ("RGBA", dict(progression="CPRL", precinct_size=(32, 64))),
    ("L", dict(precinct_size=(32, 32))), ("L", dict(codeblock_size=(16, 64))),
    ("I;16", dict(codeblock_size=(64, 8))), ("L", dict(num_resolutions=1)),
    ("I;16", dict(num_resolutions=3)),
    ("I;16", dict(quality_layers=[40, 10, 1])),
    ("L", dict(quality_mode="dB", quality_layers=[30, 40, 50])),
    ("I;16", dict(quality_layers=[60, 20], irreversible=True)),
    ("RGB", dict(quality_layers=[30, 8], mct=1, irreversible=True,
                 progression="CPRL", precinct_size=(32, 32),
                 tile_size=(40, 40))),
    ("L", dict(plt=True)), ("RGB", dict(comment="a comment")),
]


@pytest.mark.parametrize("mode,options", OPTIONS,
                         ids=[f"{m}-{'-'.join(o) or 'default'}"
                              for m, o in OPTIONS])
def test_pil_files_decode_bit_equal(rng, mode, options):
    """Reversible and irreversible alike: OpenJPEG's arithmetic, so PIL's
    array bit for bit (and never a count apart), at a few sizes."""
    written = 0
    for h, w in ((70, 90), (33, 17), (129, 200), (1, 5)):
        a = _plane(rng, mode, h, w)
        f = io.BytesIO()
        try:          # PIL refuses some options at the smallest sizes
            Image.fromarray(a).save(f, format="JPEG2000", **options)
        except OSError:
            assert (h, w) == (1, 5)
            continue
        written += 1
        data = f.getvalue()
        want = np.asarray(Image.open(io.BytesIO(data)))
        got = j2.decode_jpeg2000(data)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want, err_msg=f"{h} x {w}")
    assert written >= 3


def _segments(cs: bytes) -> dict:
    """Marker -> body of each main-header marker segment."""
    out, i = {}, 2
    while cs[i:i + 2] != b"\xff\x90":
        n = struct.unpack(">H", cs[i + 2:i + 4])[0]
        out[cs[i:i + 2]] = cs[i + 4:i + 2 + n]
        i += 2 + n
    return out


def _codestream(data: bytes) -> bytes:
    return data[data.index(b"\xff\x4f\xff\x51"):]


def _boxes(data: bytes) -> dict:
    """Type -> body of the top-level boxes and of jp2h's."""
    out, i = {}, 0
    while i < len(data):
        n, t = struct.unpack(">I4s", data[i:i + 8])
        out[t] = data[i + 8:i + n]
        if t == b"jp2h":
            out.update(_boxes(data[i + 8:i + n]))
        i += n
    return out


def _pil_bytes(a: np.ndarray, suffix: str, tmp_path: Path) -> bytes:
    p = tmp_path / f"pil{suffix}.tmp"          # the JAX package's name
    Image.fromarray(a).save(p, format="JPEG2000")
    return p.read_bytes()


WRITES = [((70, 90), np.uint8), ((70, 90), np.uint16), ((33, 17, 3), np.uint8),
          ((129, 64, 4), np.uint8), ((64, 65, 2), np.uint8), ((1, 1), np.uint8),
          ((2, 3), np.uint16), ((20, 30), np.uint16), ((5, 300), np.uint16),
          ((300, 7, 3), np.uint8)]


@pytest.mark.parametrize("shape,dtype", WRITES,
                         ids=[f"{'x'.join(map(str, s))}-{np.dtype(d).name}"
                              for s, d in WRITES])
@pytest.mark.parametrize("suffix", [".jp2", ".j2k"])
def test_port_files_read_back_everywhere(tmp_path, rng, shape, dtype, suffix):
    """imwrite_generic's .jp2 / .j2k: the array back through the port,
    PIL and the JAX package's imread; JP2 boxes for both suffixes; SIZ,
    COD, QCD and the JP2 header boxes byte-equal to PIL's."""
    top = np.iinfo(dtype).max
    for kind in ("noise", "smooth", "flat"):
        if kind == "noise":
            a = rng.integers(0, top, shape, endpoint=True).astype(dtype)
        elif kind == "flat":
            a = np.full(shape, top // 3, dtype)
        else:
            a = _plane(rng, "I;16", *shape[:2]).astype(np.float64) / 65535
            if len(shape) == 3:
                a = a[..., None] * np.linspace(0.5, 1, shape[2])
            a = (a * top).astype(dtype)
        p = tmp_path / f"x{suffix}"
        gt.imwrite_generic(p, a)
        for reader in (gt.read_plane, gt.imread_generic, tj.imread,
                       lambda q: np.asarray(Image.open(q))):
            got = reader(p)
            assert got.dtype == a.dtype
            np.testing.assert_array_equal(got, a)
    data = p.read_bytes()
    theirs = _pil_bytes(a, suffix, tmp_path)
    mine_b, their_b = _boxes(data), _boxes(theirs)
    assert data.startswith(b"\0\0\0\x0cjP  \r\n\x87\n")
    for box in (b"ftyp", b"ihdr", b"colr", b"cdef"):
        assert mine_b.get(box) == their_b.get(box), box
    mine, their = _segments(_codestream(data)), _segments(_codestream(theirs))
    for marker in (b"\xff\x51", b"\xff\x52", b"\xff\x5c"):   # SIZ COD QCD
        assert mine[marker] == their[marker], marker


def test_1d_planes_are_columns(tmp_path):
    col = np.arange(7, dtype=np.uint8)            # PIL's fromarray: a column
    gt.imwrite_generic(tmp_path / "c.jp2", col)
    np.testing.assert_array_equal(gt.read_plane(tmp_path / "c.jp2"),
                                  col[:, None])


@pytest.mark.parametrize("a", [np.zeros((4, 4), np.float32),
                               np.zeros((4, 4), np.int16),
                               np.zeros((4, 4, 3), np.uint16),
                               np.zeros((4, 4, 5), np.uint8),
                               np.zeros((0, 4), np.uint8)],
                         ids=["f32", "i16", "rgb16", "5ch", "empty"])
def test_what_pil_cannot_write_raises(tmp_path, a):
    with pytest.raises(Exception):
        Image.fromarray(a).save(tmp_path / "p.jp2", format="JPEG2000")
    with pytest.raises(CodecError, match="JPEG 2000"):
        gt.imwrite_generic(tmp_path / "x.jp2", a)


def _main_header_insert(data: bytes, segment: bytes) -> bytes:
    """`segment` put before the first SOT."""
    i = data.index(b"\xff\x90")
    return data[:i] + segment + data[i:]


def _siz_patch(data: bytes, offset: int, value: int) -> bytes:
    """One byte of SIZ changed: offset counts from the SIZ marker."""
    i = data.index(b"\xff\x51")
    return data[:i + offset] + bytes([value]) + data[i + offset + 1:]


def _box_insert(data: bytes, box: bytes) -> bytes:
    """`box` appended to jp2h (whose length grows by it)."""
    i = data.index(b"jp2h") - 4
    n = struct.unpack(">I", data[i:i + 4])[0]
    return (data[:i] + struct.pack(">I", n + len(box)) + data[i + 4:i + n]
            + box + data[i + n:])


def _cod_scod(data: bytes, flag: int) -> bytes:
    i = data.index(b"\xff\x52")
    return data[:i + 4] + bytes([data[i + 4] | flag]) + data[i + 5:]


def _cod_style(data: bytes, style: int) -> bytes:
    i = data.index(b"\xff\x52")
    return data[:i + 12] + bytes([style]) + data[i + 13:]


# case -> (edit of PIL's file, the name the error gives); the marker
# segments go into a raw codestream, whose length nothing states
def _qcd(cs: bytes):
    """(offset of QCD's marker, its body) in a raw codestream."""
    i = cs.index(b"\xff\x5c")
    n = struct.unpack(">H", cs[i + 2:i + 4])[0]
    return i, cs[i + 4:i + 2 + n]


def test_derived_quantisation_and_qcc_decode_as_pil(rng):
    """Quantisation PIL does not write, made from its files: QCD's
    expounded steps cut to the derived form (one step for every band), a
    QCC giving component 1 steps of its own, and a QCD in the tile-part's
    header; PIL decodes each, and the port must give its bits."""
    a = _plane(rng, "RGB", 70, 90)
    f = io.BytesIO()
    Image.fromarray(a).save(f, format="JPEG2000", irreversible=True,
                            no_jp2=True)
    cs = f.getvalue()
    i, body = _qcd(cs)
    assert body[0] & 0x1F == 2                   # expounded, as PIL writes
    derived = (cs[:i] + b"\xff\x5c\x00\x05" + bytes([body[0] & 0xE0 | 1])
               + body[1:3] + cs[i + 2 + 2 + len(body):])
    steps = bytearray(body[1:])
    for k in range(0, len(steps), 2):            # twice the step's mantissa
        steps[k + 1] = (steps[k + 1] + 37) & 0xFF
    qcc = (b"\xff\x5d" + struct.pack(">H", 4 + len(steps)) + b"\x01"
           + body[:1] + bytes(steps))
    with_qcc = cs[:i + 2 + 2 + len(body)] + qcc + cs[i + 2 + 2 + len(body):]
    # the same steps for every component, from the tile-part's header
    tile_qcd = b"\xff\x5c" + struct.pack(">H", 3 + len(steps)) + body[:1] + \
        bytes(steps)
    j = cs.index(b"\xff\x90")
    psot = struct.unpack(">I", cs[j + 6:j + 10])[0] + len(tile_qcd)
    in_tile = (cs[:j + 6] + struct.pack(">I", psot) + cs[j + 10:j + 12]
               + tile_qcd + cs[j + 12:])
    for data in (derived, with_qcc, in_tile):
        want = np.asarray(Image.open(io.BytesIO(data)))
        np.testing.assert_array_equal(j2.decode_jpeg2000(data), want)
    assert not np.array_equal(j2.decode_jpeg2000(with_qcc),
                              j2.decode_jpeg2000(cs))


REFUSED = {
    "code-block style (bypass)": (lambda d: _cod_style(d, 1), "bypass"),
    "code-block style (termall)": (lambda d: _cod_style(d, 4),
                                   "termination on each coding pass"),
    "code-block style (causal)": (lambda d: _cod_style(d, 8),
                                  "vertically causal"),
    "code-block style (segmentation)": (lambda d: _cod_style(d, 32),
                                        "segmentation symbols"),
    "HTJ2K": (lambda d: _cod_style(d, 64), "HTJ2K"),
    "POC": (lambda d: _main_header_insert(
        d, b"\xff\x5f\x00\x09\x00\x00\x00\x01\x06\x01\x00"), "POC"),
    "PPM": (lambda d: _main_header_insert(d, b"\xff\x60\x00\x03\x00"),
            "PPM"),
    "RGN": (lambda d: _main_header_insert(d, b"\xff\x5e\x00\x05\x00\x00\x02"),
            "RGN"),
    "SOP": (lambda d: _cod_scod(d, 2), "SOP / EPH"),
    "EPH": (lambda d: _cod_scod(d, 4), "SOP / EPH"),
    "subsampling": (lambda d: _siz_patch(d, 41, 2), "subsampling"),
    "12 bits": (lambda d: _siz_patch(d, 40, 11), "12-bit"),
    "signed": (lambda d: _siz_patch(d, 40, 0x87), "signed"),
    "palette": (lambda d: _box_insert(
        d, b"\x00\x00\x00\x0fpclr\x00\x01\x01\x07\x00\x00\x00"), "palette"),
    "cmap": (lambda d: _box_insert(d, b"\x00\x00\x00\x0ccmap\x00\x00\x01\x00"),
             "cmap"),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_refused_cases_raise_codec_error_naming_them(case):
    """What PIL over OpenJPEG 2.5 cannot write is refused by name, never
    misread (the JAX package's reader does not see these files)."""
    a = np.arange(48 * 40, dtype=np.uint32).reshape(48, 40).astype(np.uint8)
    edit, name = REFUSED[case]
    f = io.BytesIO()
    Image.fromarray(a).save(f, format="JPEG2000",
                            no_jp2=case in ("POC", "PPM", "RGN"))
    with pytest.raises(CodecError, match=name):
        j2.decode_jpeg2000(edit(f.getvalue()))


def test_corrupt_files_raise_or_decode_and_never_crash(rng):
    """Bytes flipped past the main header and files cut short: a
    CodecError or some plane, never a crash or a hang."""
    a = _plane(rng, "RGB", 64, 80)
    f = io.BytesIO()
    Image.fromarray(a).save(f, format="JPEG2000", tile_size=(40, 32),
                            quality_layers=[20, 5], precinct_size=(32, 32),
                            num_resolutions=3)
    data = f.getvalue()
    start = data.index(b"\xff\x90")
    outcomes = set()
    for k in range(60):
        b = bytearray(data)
        if k % 3 == 0:
            b = b[:int(rng.integers(start, len(b)))]
        else:
            for i in rng.integers(start, len(b), 1 + k % 5):
                b[i] ^= int(rng.integers(1, 256))
        try:
            out = j2.decode_jpeg2000(bytes(b))
            assert out.shape == a.shape
            outcomes.add("plane")
        except CodecError:
            outcomes.add("error")
    assert "plane" in outcomes
