"""The port's own host image codec against the JAX package's PIL path.

Every fixture is made here from a numpy seed, written by PIL or OpenCV
(both on the CPU host only) or, where neither writes the case (Adam7 PNG,
tiled and predictor-3 LZW TIFF, YCbCr JPEG-in-TIFF strips, uncommon BMP
headers, plain PNM), by a small writer in this file.  Each goes through
`ipp_tpu.io.generic2d.imread_generic` (PIL) and the port's
`ipp_tpu_torch.io.generic2d.imread_generic`: the arrays must be equal, of
the same shape and of a dtype of the same kind and item size.  JPEG
encode: the port's bytes equal PIL's at PIL's defaults (so PIL decodes
them to equal pixels).  Lossless writes of each package read back equal
through the other's reader.  The AVI writer's OpenDML parts are made by
lowering `io/avi.RIFF_LIMIT`.  One subprocess runs with PIL and cv2
refused at import.
"""

import io
import os
import struct
import subprocess
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest

PIL = pytest.importorskip("PIL")
from PIL import Image  # noqa: E402

from ipp_tpu.io import generic2d as gj  # noqa: E402
from ipp_tpu.io import tiff as tj  # noqa: E402
from ipp_tpu_torch.io import avi  # noqa: E402
from ipp_tpu_torch.io import generic2d as gt  # noqa: E402
from ipp_tpu_torch.io import imgcodec  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _same(path, where_pil_refuses=None):
    """The JAX package's and the port's reads of one file agree.  Where
    PIL cannot open the file (`where_pil_refuses` given), the JAX package
    raises and the port returns that array instead."""
    got = gt.imread_generic(path)
    if where_pil_refuses is not None:
        with pytest.raises(tj.TiffError, match="cannot identify"):
            gj.imread_generic(path)
        ref = where_pil_refuses
    else:
        ref = gj.imread_generic(path)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    assert got.dtype.kind == ref.dtype.kind and \
        got.dtype.itemsize == ref.dtype.itemsize, (got.dtype, ref.dtype)
    np.testing.assert_array_equal(got, ref)
    return got


def _smooth(rng, h, w, c=0, lo=0, hi=255):
    """A smooth field with noise: what JPEG and the predictors see in
    light-sheet planes, so every Huffman and upsampling path is taken."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    shape = (h, w, c) if c else (h, w)
    base = 0.5 + 0.3 * np.sin(xx / 5.0 + yy / 11.0)
    if c:
        base = base[..., None] * np.linspace(0.6, 1.0, c)
    img = lo + (hi - lo) * (base + rng.normal(0, 0.08, shape))
    return np.clip(img, lo, hi)


# ---------------------------------------------------------------- PNG

def _png_filter(row, prev, bpp, ft):
    x = row.astype(np.int16)
    up = prev.astype(np.int16)
    left = np.concatenate([np.zeros(bpp, np.int16), x[:-bpp]])
    upleft = np.concatenate([np.zeros(bpp, np.int16), up[:-bpp]])
    if ft == 0:
        out = x
    elif ft == 1:
        out = x - left
    elif ft == 2:
        out = x - up
    elif ft == 3:
        out = x - ((left + up) >> 1)
    else:
        p = left + up - upleft
        pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
        out = x - np.where((pa <= pb) & (pa <= pc), left,
                           np.where(pb <= pc, up, upleft))
    return bytes([ft]) + out.astype(np.uint8).tobytes()


def _png_rows(px, depth):
    """Packed rows of an (h, w, ch) integer array at `depth` bits."""
    h, w, ch = px.shape
    if depth < 8:
        bits = ((px[..., 0, None] >> np.arange(depth - 1, -1, -1)) & 1)
        return np.packbits(bits.reshape(h, w * depth).astype(np.uint8),
                           axis=1)
    dt = ">u2" if depth == 16 else "u1"
    return px.astype(dt).view(np.uint8).reshape(h, -1)


def _png(px, depth, ctype, interlace=False, extra=b"", seed=0):
    """A PNG of px (h, w, ch) with a random filter on every row."""
    rng = np.random.default_rng(seed)
    h, w, ch = px.shape
    bpp = max(1, depth * ch // 8)
    raw = b""
    passes = [(0, 0, 1, 1)] if not interlace else [
        (0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4),
        (1, 0, 2, 2), (0, 1, 1, 2)]
    for x0, y0, dx, dy in passes:
        sub = px[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        rows = _png_rows(sub, depth)
        prev = np.zeros(rows.shape[1], np.uint8)
        for r in rows:
            raw += _png_filter(r, prev, bpp, int(rng.integers(0, 5)))
            prev = r

    def chunk(t, d):
        return struct.pack(">I", len(d)) + t + d + \
            struct.pack(">I", zlib.crc32(t + d) & 0xFFFFFFFF)

    return (b"\x89PNG\r\n\x1a\n" +
            chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0,
                                       int(interlace))) + extra +
            chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


def _plte(n):
    body = bytes(i % 256 for i in range(3 * n))
    return struct.pack(">I", 3 * n) + b"PLTE" + body + \
        struct.pack(">I", zlib.crc32(b"PLTE" + body))


def _trns(data):
    return struct.pack(">I", len(data)) + b"tRNS" + data + \
        struct.pack(">I", zlib.crc32(b"tRNS" + data))


PNG_CASES = [(0, d) for d in (1, 2, 4, 8, 16)] + \
    [(3, d) for d in (1, 2, 4, 8)] + [(2, 8), (2, 16), (4, 8), (4, 16),
                                      (6, 8), (6, 16)]


@pytest.mark.parametrize("interlace", [False, True], ids=["flat", "adam7"])
@pytest.mark.parametrize("ctype,depth", PNG_CASES,
                         ids=[f"type{c}-{d}bit" for c, d in PNG_CASES])
def test_png_equals_pil(tmp_path, ctype, depth, interlace):
    rng = np.random.default_rng(depth * 10 + ctype)
    ch = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    h, w = 13, 19                       # odd: partial bytes and passes
    px = rng.integers(0, 1 << depth, (h, w, ch))
    extra = b""
    if ctype == 3:
        extra = _plte(1 << depth) + _trns(b"\x00\x80")
    elif ctype == 0:
        extra = _trns(struct.pack(">H", 1))
    p = tmp_path / "a.png"
    p.write_bytes(_png(px, depth, ctype, interlace, extra, seed=depth))
    _same(p)


@pytest.mark.parametrize("mode", ["1", "L", "LA", "P", "RGB", "RGBA",
                                  "I;16"])
def test_png_written_by_pil_equals_pil(tmp_path, mode):
    rng = np.random.default_rng(3)
    a = _smooth(rng, 41, 67, 0 if mode in ("1", "L", "P", "I;16") else
                len(mode), 0, 65535 if mode == "I;16" else 255)
    a = a.astype(np.uint16 if mode == "I;16" else np.uint8)
    im = Image.fromarray(a > 128) if mode == "1" else Image.fromarray(a)
    if mode == "P":
        im = im.convert("P")
    im.save(tmp_path / "a.png")
    _same(tmp_path / "a.png")


def test_png_errors(tmp_path):
    good = _png(np.zeros((4, 4, 1), int), 8, 0)
    p = tmp_path / "a.png"
    p.write_bytes(good[:-20])
    with pytest.raises(imgcodec.CodecError, match="cut short|IEND"):
        gt.read_plane(p)
    p.write_bytes(good.replace(b"IDAT", b"IDAX"))
    with pytest.raises(imgcodec.CodecError, match="CRC"):
        gt.read_plane(p)


# ---------------------------------------------------------------- JPEG

def _jpeg_cv2(img, **flags):
    cv2 = pytest.importorskip("cv2")
    params = []
    for k, v in flags.items():
        params += [getattr(cv2, f"IMWRITE_JPEG_{k.upper()}"), v]
    if img.ndim == 3:
        img = img[..., ::-1]
    ok, buf = cv2.imencode(".jpg", np.ascontiguousarray(img), params)
    assert ok
    return buf.tobytes()


JPEG_SIZES = [(1, 1), (8, 8), (13, 21), (17, 33), (31, 7), (64, 96)]


@pytest.mark.parametrize("size", JPEG_SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("kind", ["gray", "444", "422", "420"])
def test_jpeg_decode_equals_pil(tmp_path, kind, size):
    rng = np.random.default_rng(size[0] * 100 + size[1])
    img = _smooth(rng, *size, 0 if kind == "gray" else 3).astype(np.uint8)
    sub = {"gray": {}, "444": {"subsampling": 0}, "422": {"subsampling": 1},
           "420": {"subsampling": 2}}[kind]
    for q in (30, 95):
        p = tmp_path / f"a{q}.jpg"
        Image.fromarray(img).save(p, quality=q, **sub)
        _same(p)


@pytest.mark.parametrize("case", ["rst-gray", "rst-420", "440", "411",
                                  "optimized", "rst-odd"])
def test_jpeg_decode_of_opencv_files_equals_pil(tmp_path, case):
    """Restart intervals, 4:4:0 and 4:1:1 sampling and optimised Huffman
    tables, which PIL does not write: OpenCV's libjpeg does."""
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(len(case))
    shape = (45, 77) if case == "rst-odd" else (48, 80)
    img = _smooth(rng, *shape, 0 if case == "rst-gray" else 3).astype(
        np.uint8)
    flags = {"rst-gray": dict(rst_interval=3),
             "rst-420": dict(rst_interval=2),
             "rst-odd": dict(rst_interval=5, quality=90),
             "440": dict(sampling_factor=cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440),
             "411": dict(sampling_factor=cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411),
             "optimized": dict(optimize=1)}[case]
    p = tmp_path / "a.jpg"
    p.write_bytes(_jpeg_cv2(img, **flags))
    _same(p)


def test_extended_sequential_jpeg_with_16_bit_tables_equals_pil(tmp_path):
    """SOF1 (extended sequential, Huffman) with its quantisation tables
    stored at 16-bit precision: a baseline file rewritten so."""
    rng = np.random.default_rng(8)
    buf = io.BytesIO()
    Image.fromarray(_smooth(rng, 27, 35, 3).astype(np.uint8)).save(
        buf, format="JPEG", quality=60)
    data, out, i = buf.getvalue(), bytearray(b"\xff\xd8"), 2
    while data[i + 1] != 0xDA:
        n = struct.unpack(">H", data[i + 2:i + 4])[0]
        seg = bytearray(data[i:i + 2 + n])
        if seg[1] == 0xC0:
            seg[1] = 0xC1
        elif seg[1] == 0xDB:
            q = seg[5:]
            seg = bytearray(b"\xff\xdb" + struct.pack(">H", 3 + 128) +
                            bytes([0x10 | seg[4]]) +
                            np.array(list(q), ">u2").tobytes())
        out += seg
        i += 2 + n
    (tmp_path / "x.jpg").write_bytes(bytes(out + data[i:]))
    _same(tmp_path / "x.jpg")


def _resegment(data, edit):
    """A JPEG's segments before its first scan, each passed through
    edit(marker, segment bytes) -> bytes, then the rest unchanged."""
    i, out = 2, bytearray(data[:2])
    while data[i + 1] != 0xDA:
        n = struct.unpack(">H", data[i + 2:i + 4])[0]
        out += edit(data[i + 1], bytearray(data[i:i + 2 + n]))
        i += 2 + n
    return bytes(out + data[i:])


def test_jpeg_refuses_what_it_does_not_read_by_name(tmp_path):
    """Arithmetic-coded, lossless, hierarchical and 12-bit JPEGs and a DAC
    segment, made from a PIL baseline file by rewriting its markers, each
    raise an error naming what they are; so does a file cut short."""
    rng = np.random.default_rng(0)
    img = _smooth(rng, 24, 24, 3).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG")
    base = buf.getvalue()

    def sof(marker, bits=8):
        def edit(m, seg):
            if m == 0xC0:
                seg[1], seg[4] = marker, bits
            return seg
        return _resegment(base, edit)

    dac = _resegment(base, lambda m, seg: (b"\xff\xcc\x00\x04\x00\x10" + seg)
                     if m == 0xC4 and b"\xff\xcc" not in base else seg)
    p = tmp_path / "p.jpg"
    for data, name in ((sof(0xC9), r"arithmetic-coded \(SOF9\)"),
                       (sof(0xC3), r"lossless \(SOF3\)"),
                       (sof(0xC5), r"hierarchical \(SOF5\)"),
                       (dac, r"arithmetic coding \(DAC\)"),
                       (sof(0xC1, 12), "12-bit samples")):
        p.write_bytes(data)
        with pytest.raises(imgcodec.CodecError, match=name):
            gt.read_plane(p)
    p.write_bytes(base[:200])
    with pytest.raises(imgcodec.CodecError):
        gt.read_plane(p)


def _fixture_maker():
    """tests/torch_image_fixtures/make_fixtures.py as a module."""
    sys.path.insert(0, str(ROOT / "tests" / "torch_image_fixtures"))
    try:
        import make_fixtures
    finally:
        sys.path.pop(0)
    return make_fixtures


@pytest.mark.parametrize("size", JPEG_SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("kind", ["gray", "444", "422", "420"])
def test_progressive_jpeg_decode_equals_pil(tmp_path, kind, size):
    """PIL's progressive JPEGs (libjpeg's scan script: DC first and
    refine, spectral bands, successive approximation, optimised tables
    before each scan) at qualities 30 and 95, and with a restart marker
    every 1, 3 and 5 blocks (EOB runs cut at each)."""
    rng = np.random.default_rng(size[0] * 100 + size[1] + 7)
    img = _smooth(rng, *size, 0 if kind == "gray" else 3).astype(np.uint8)
    sub = {"gray": {}, "444": {"subsampling": 0}, "422": {"subsampling": 1},
           "420": {"subsampling": 2}}[kind]
    for q, rst in ((30, 0), (95, 0), (75, 1), (75, 3), (75, 5)):
        p = tmp_path / f"a{q}_{rst}.jpg"
        Image.fromarray(img).save(p, quality=q, progressive=True,
                                  restart_marker_blocks=rst, **sub)
        _same(p)


@pytest.mark.parametrize("case", ["prog", "prog-gray", "prog-rst",
                                  "prog-rst-gray", "prog-411", "prog-440",
                                  "prog-rst-odd"])
def test_progressive_jpeg_decode_of_opencv_files_equals_pil(tmp_path, case):
    """OpenCV's progressive files (IMWRITE_JPEG_PROGRESSIVE), with restart
    intervals (RST_INTERVAL, in MCUs) and 4:1:1 and 4:4:0 sampling, which
    PIL does not write."""
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(len(case) + 40)
    shape = (45, 77) if case == "prog-rst-odd" else (48, 80)
    img = _smooth(rng, *shape, 0 if "gray" in case else 3).astype(np.uint8)
    flags = {"prog": {}, "prog-gray": {},
             "prog-rst": dict(rst_interval=2),
             "prog-rst-gray": dict(rst_interval=3),
             "prog-rst-odd": dict(rst_interval=5, quality=90),
             "prog-411": dict(
                 sampling_factor=cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411),
             "prog-440": dict(
                 sampling_factor=cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440)}[case]
    p = tmp_path / "a.jpg"
    p.write_bytes(_jpeg_cv2(img, progressive=1, **flags))
    assert p.read_bytes()[:1000].count(b"\xff\xc2") == 1
    _same(p)


@pytest.mark.parametrize("progressive", [False, True], ids=["seq", "prog"])
@pytest.mark.parametrize("kind", ["cmyk", "ycck", "no-app14", "xform1"])
def test_four_component_jpeg_equals_pil(tmp_path, kind, progressive):
    """PIL's CMYK JPEGs (Adobe APP14, transform 0), the same bytes marked
    YCCK (transform 2; 1 is taken as YCCK too) or without the segment
    (CMYK assumed), at odd sizes, with and without subsampled components:
    (h, w, 4), inverted as PIL's "CMYK;I" hands them out."""
    rng = np.random.default_rng(31 + progressive)
    for size in ((13, 21), (31, 7), (45, 77)):
        cmyk = Image.frombytes("CMYK", size[::-1], _smooth(
            rng, *size, 4).astype(np.uint8).tobytes())
        for sub in ({}, {"subsampling": 2}):
            buf = io.BytesIO()
            cmyk.save(buf, format="JPEG", quality=80,
                      progressive=progressive, **sub)
            data = buf.getvalue()
            if kind != "cmyk":
                data = _fixture_maker().adobe_transform(
                    data, {"ycck": 2, "xform1": 1, "no-app14": None}[kind])
            assert (b"Adobe" in data) == (kind != "no-app14")
            p = tmp_path / "c.jpg"
            p.write_bytes(data)
            assert _same(p).shape == size + (4,)


def test_cmyk_jpeg_round_trips_through_pil_inversion(tmp_path):
    """PIL writes a CMYK plane inverted (Adobe's convention) and reads it
    back inverted: the port hands out what was written."""
    plane = np.zeros((16, 24, 4), np.uint8) + np.array([200, 0, 0, 30],
                                                       np.uint8)
    Image.frombytes("CMYK", (24, 16), plane.tobytes()).save(
        tmp_path / "c.jpg", quality=100)
    np.testing.assert_array_equal(_same(tmp_path / "c.jpg"), plane)


@pytest.mark.parametrize("kind", ["gray", "420", "444", "cmyk", "rst-422",
                                  "420-17x33", "444-40x9"])
def test_cut_progression_equals_pil(tmp_path, kind):
    """A progressive file cut after each of its scans, EOI appended: where
    the scans so far leave some of the first nine AC coefficients unknown
    or not refined, libjpeg-turbo (2.1 and later) smooths the blocks from
    their 5 x 5 neighbourhood's DC values first (after the first scan the
    DC too), so the port does.  17 x 33 at 4:2:0 has a last iMCU row of
    one luma block row (libjpeg counts the rows above it by that row's
    count); 40 x 9 is two blocks wide (both neighbours of a block
    clamped)."""
    rng = np.random.default_rng(len(kind) + 50)
    chans = {"gray": 0, "cmyk": 4}.get(kind, 3)
    h, w = (17, 33) if "17x33" in kind else (40, 9) if "40x9" in kind \
        else (37, 45)
    img = _smooth(rng, h, w, chans).astype(np.uint8)
    im = Image.frombytes("CMYK", (w, h), img.tobytes()) if chans == 4 \
        else Image.fromarray(img)
    sub = {"420": 2, "444": 0, "rst-422": 1}.get(
        kind.split("-")[0] if "x" in kind else kind, -1)
    buf = io.BytesIO()
    im.save(buf, format="JPEG", quality=70, progressive=True,
            subsampling=sub, restart_marker_blocks=3 if "rst" in kind else 0)
    data = buf.getvalue()
    mk = _fixture_maker()
    scans = sum(m == 0xDA for m, _, _ in mk.jpeg_segments(data))
    assert scans >= 6
    p = tmp_path / "c.jpg"
    seen = set()
    for k in range(1, scans + 1):
        p.write_bytes(mk.cut_after_scan(data, k))
        seen.add(_same(p).tobytes())
    assert len(seen) == scans            # every scan changes the pixels


def test_malformed_progression_is_refused_by_name(tmp_path):
    """Scan headers rewritten so the progression breaks its rules (Se
    before Ss, an AC scan over several components, Al past 13, a
    refinement whose Ah does not follow its first scan or whose Al is not
    Ah - 1), and a scan whose data ends before its last block: each raises
    an error naming the fault, none returns pixels."""
    rng = np.random.default_rng(61)
    buf = io.BytesIO()
    Image.fromarray(_smooth(rng, 40, 56, 3).astype(np.uint8)).save(
        buf, format="JPEG", progressive=True, quality=80)
    data = buf.getvalue()
    soss = [i for i in range(len(data) - 1) if data[i:i + 2] == b"\xff\xda"]

    def scan(k, **edit):
        """data with scan k's Ss / Se / Ah-Al bytes (and its component
        count) rewritten."""
        d = bytearray(data)
        i = soss[k]
        ns = d[i + 4]
        at = i + 5 + 2 * ns
        if "Ss" in edit:
            d[at] = edit["Ss"]
        if "Se" in edit:
            d[at + 1] = edit["Se"]
        if "AhAl" in edit:
            d[at + 2] = edit["AhAl"]
        return bytes(d)

    # libjpeg's script: scan 0 the DC of all three components (Al 1), scan 1
    # the luma's AC 1-5 (Al 2), scan 5 refines the luma's AC 1-63 (Ah 2)
    cases = [(scan(1, Ss=5, Se=1), "Se before Ss"),
             (scan(0, Se=5), "a DC scan that carries AC"),
             (scan(1, AhAl=0x0E), "Al past 13"),
             (scan(5, AhAl=0x32), "does not follow"),
             (scan(5, AhAl=0x20), "Al is not Ah - 1")]
    d = bytearray(data)       # scan 0 over three components, made an AC scan
    d[soss[0] + 5 + 2 * 3] = 1
    d[soss[0] + 6 + 2 * 3] = 5
    cases.append((bytes(d), "an AC scan over several components"))
    cut = _fixture_maker().cut_after_scan(data, 5)
    cases.append((cut[:-42] + b"\xff\xd9", "cut short"))
    p = tmp_path / "m.jpg"
    for bad, why in cases:
        p.write_bytes(bad)
        with pytest.raises(imgcodec.CodecError, match=why):
            gt.read_plane(p)


def test_progressive_series_converts_within_one_count(tmp_path,
                                                      monkeypatch):
    """The slice as a whole: `convert --destripe` (test_torch_convert.py's
    flags) on 12 striped 96 x 128 u8 planes written as progressive JPEGs,
    the port's run within 1 count of the JAX package's."""
    from ipp_tpu.pipeline import convert as J
    from ipp_tpu_torch.pipeline import convert as P

    monkeypatch.setenv("IPP_TPU_PLATFORM", "cpu")
    monkeypatch.setenv("IPP_TPU_PROGRESS", "off")
    src = tmp_path / "in"
    src.mkdir()
    rng = np.random.default_rng(66)
    yy, xx = np.mgrid[0:96, 0:128].astype(np.float32)
    for z in range(12):
        img = 90 + 40 * np.sin(xx / 9.0 + z / 3.0) * np.cos(yy / 13.0)
        img *= 1.0 + 0.3 * (rng.random(128) > 0.8)[None, :]
        Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(
            src / f"img_{z:06d}.jpg", quality=95, progressive=True)
    flags = ["--destripe", "--sigma1", "24", "--sigma2", "24", "--wavelet",
             "db3", "--voxel", "2", "1", "1", "-dt", "4", "-zl", "0"]
    outs = {}
    for name, main in (("port", P.main), ("jax", J.main)):
        outs[name] = tmp_path / name
        assert main(["-i", str(src), "-o", str(outs[name]), *flags]) == 0
    names = sorted(p.relative_to(outs["jax"])
                   for p in outs["jax"].rglob("*.tif"))
    assert len(names) >= 12 and names == sorted(
        p.relative_to(outs["port"]) for p in outs["port"].rglob("*.tif"))
    for n in names:
        a, b = tj.imread(outs["port"] / n), tj.imread(outs["jax"] / n)
        assert a.dtype == b.dtype and a.shape == b.shape, n
        assert np.abs(a.astype(np.float64) - b).max() <= 1, n


@pytest.mark.parametrize("kind,quality", [("gray", 75), ("gray", 95),
                                          ("rgb", 75), ("rgb", 95)])
def test_jpeg_encode_equals_pil(tmp_path, kind, quality):
    """The port's JPEG is PIL's byte for byte (PIL's libjpeg-turbo at its
    defaults), so PIL decodes it to equal pixels; odd sizes exercise the
    edge replication and the dummy blocks of a 4:2:0 MCU."""
    from ipp_tpu_torch.io.jpeg import encode_jpeg

    for size in ((37, 53), (16, 16), (9, 33)):
        rng = np.random.default_rng(size[0] + quality)
        img = _smooth(rng, *size, 3 if kind == "rgb" else 0).astype(np.uint8)
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, format="JPEG", quality=quality)
        mine = encode_jpeg(img, quality)
        assert mine == buf.getvalue(), size
        np.testing.assert_array_equal(
            np.asarray(Image.open(io.BytesIO(mine))),
            np.asarray(Image.open(buf)))
    if quality == 75:   # imwrite_generic writes PIL's default quality
        gt.imwrite_generic(tmp_path / "t.jpg", img)
        gj.imwrite_generic(tmp_path / "j.jpg", img)
        assert (tmp_path / "t.jpg").read_bytes() == \
            (tmp_path / "j.jpg").read_bytes()


# ---------------------------------------------------------------- TIFF

def _lzw(data: bytes) -> bytes:
    """TIFF LZW as libtiff writes it (MSB first, early change, Clear at
    4094)."""
    out = bytearray()
    acc = nacc = 0
    nbits = 9

    def put(code):
        nonlocal acc, nacc
        acc = (acc << nbits) | code
        nacc += nbits
        while nacc >= 8:
            out.append((acc >> (nacc - 8)) & 0xFF)
            nacc -= 8
        acc &= (1 << nacc) - 1

    table = {bytes([i]): i for i in range(256)}
    nxt = 258
    put(256)
    w = b""
    for c in data:
        wc = w + bytes([c])
        if wc in table:
            w = wc
            continue
        put(table[w])
        table[wc] = nxt
        nxt += 1
        if nxt == 4094:
            put(256)
            table = {bytes([i]): i for i in range(256)}
            nxt, nbits = 258, 9
        elif nxt > (1 << nbits) - 1:
            nbits += 1
        w = bytes([c])
    if w:
        put(table[w])
        nxt += 1
        if nxt > (1 << nbits) - 1 and nbits < 12:
            nbits += 1
    put(257)
    if nacc:
        out.append((acc << (8 - nacc)) & 0xFF)
    return bytes(out)


def _predict(chunk, predictor, samples):
    """chunk (rows, cols * samples) in its dtype -> the bytes a writer
    stores under `predictor`."""
    if predictor == 2:
        v = chunk.reshape(chunk.shape[0], -1, samples)
        d = v.copy()
        d[:, 1:] = v[:, 1:] - v[:, :-1]
        return d.tobytes()
    if predictor == 3:
        rows, n = chunk.shape
        size = chunk.dtype.itemsize
        b = chunk.astype(chunk.dtype.newbyteorder(">")).view(np.uint8)
        b = b.reshape(rows, n, size).transpose(0, 2, 1).reshape(rows, -1)
        d = b.copy()
        d[:, samples:] = b[:, samples:] - b[:, :-samples]
        return d.tobytes()
    return chunk.tobytes()


def _tiff(path, img, compression=5, predictor=1, tile=None, rps=None,
          bo="<", photometric=None, encode=None, extra=()):
    """A one-page TIFF of img (h, w[, s]) in strips of `rps` rows or tiles
    of `tile` (th, tw), each chunk predicted and LZW-coded (or given to
    `encode(chunk) -> bytes`)."""
    img = np.asarray(img)
    h, w = img.shape[:2]
    s = img.shape[2] if img.ndim == 3 else 1
    dt = img.dtype.newbyteorder(bo)
    flat = img.astype(dt).reshape(h, w * s)
    chunks = []
    if tile:
        th, tw = tile
        for y in range(0, h, th):
            for x in range(0, w, tw):
                c = np.zeros((th, tw * s), dt)
                part = flat[y:y + th, x * s:(x + tw) * s]
                c[:part.shape[0], :part.shape[1]] = part
                chunks.append(c)
    else:
        rps = rps or h
        chunks = [flat[y:y + rps] for y in range(0, h, rps)]
    code = encode or (lambda c: _lzw(_predict(c, predictor, s)))
    datas = [code(c) for c in chunks]
    sfmt = {"u": 1, "i": 2, "f": 3}[img.dtype.kind]
    photometric = photometric if photometric is not None else \
        (2 if s >= 3 else 1)
    tags = [(256, 4, [w]), (257, 4, [h]), (258, 3, [8 * dt.itemsize] * s),
            (259, 3, [compression]), (262, 3, [photometric]),
            (277, 3, [s]), (284, 3, [1]), (317, 3, [predictor]),
            (339, 3, [sfmt] * s)]
    if s == 4:
        tags.append((338, 3, [2]))
    if tile:
        tags += [(322, 4, [tile[1]]), (323, 4, [tile[0]]),
                 (324, 4, [0] * len(datas)), (325, 4, [len(d) for d in datas])]
    else:
        tags += [(273, 4, [0] * len(datas)), (278, 4, [rps]),
                 (279, 4, [len(d) for d in datas])]
    tags += list(extra)
    tags.sort()
    fmt = {3: "H", 4: "I", 7: "B"}
    ifd_size = 2 + 12 * len(tags) + 4
    blob = bytearray()
    entries = []
    base = 8 + ifd_size
    data_at = {}
    for tag, typ, vals in tags:
        raw = struct.pack(bo + fmt[typ] * len(vals), *vals) if typ != 7 \
            else bytes(vals)
        if len(raw) <= 4:
            entries.append((tag, typ, len(vals), raw.ljust(4, b"\0")))
        else:
            data_at[tag] = base + len(blob)
            entries.append((tag, typ, len(vals),
                            struct.pack(bo + "I", base + len(blob))))
            blob += raw + (b"\0" if len(raw) % 2 else b"")
    pos = base + len(blob)
    offsets = []
    for d in datas:
        offsets.append(pos)
        pos += len(d)
    off_tag = 324 if tile else 273
    out = bytearray((b"II" if bo == "<" else b"MM") +
                    struct.pack(bo + "HI", 42, 8))
    out += struct.pack(bo + "H", len(entries))
    for tag, typ, n, val in entries:
        if tag == off_tag:
            raw = struct.pack(bo + "I" * n, *offsets)
            if n == 1:
                val = raw
            else:
                at = data_at[tag] - base
                blob[at:at + len(raw)] = raw
        out += struct.pack(bo + "HHI", tag, typ, n) + val
    out += struct.pack(bo + "I", 0) + blob
    for d in datas:
        out += d
    Path(path).write_bytes(bytes(out))


LZW_CASES = [
    ("u1", 0, 1, None), ("u1", 0, 2, (16, 16)), ("u2", 0, 2, None),
    ("u2", 0, 1, (16, 32)), ("u4", 0, 2, None), ("i2", 0, 2, None),
    ("f4", 0, 3, None), ("f4", 0, 3, (16, 16)), ("f4", 0, 1, None),
    ("u1", 3, 2, None), ("u1", 4, 1, None), ("u2", 3, 2, None),
    ("u2", 4, 1, (16, 16)), ("u1", 3, 1, (32, 16)),
]


@pytest.mark.parametrize("bo", ["<", ">"], ids=["II", "MM"])
@pytest.mark.parametrize("dt,s,pred,tile", LZW_CASES,
                         ids=[f"{d}x{s}-p{p}-{'tiles' if t else 'strips'}"
                              for d, s, p, t in LZW_CASES])
def test_lzw_tiff_equals_pil(tmp_path, dt, s, pred, tile, bo):
    rng = np.random.default_rng(7)
    dt = np.dtype(dt)
    hi = 2.0 ** (8 * dt.itemsize) - 1 if dt.kind == "u" else 3000.0
    img = _smooth(rng, 37, 45, s, 0 if dt.kind == "u" else -hi, hi)
    img = img.astype(dt)
    p = tmp_path / "a.tif"
    _tiff(p, img, predictor=pred, tile=tile, rps=None if tile else 7, bo=bo)
    if dt in (np.float32, np.int16) and bo == ">":
        # libtiff hands PIL native samples and PIL swaps their bytes once
        # more: the JAX package returns them byte-swapped, the port as
        # they are (in PIL's dtype: int32 for i16)
        ref = gj.imread_generic(p)
        np.testing.assert_array_equal(ref, img.byteswap().astype(ref.dtype))
        got = gt.imread_generic(p)
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got, img)
        return
    # PIL has no mode for big-endian 32-bit integers
    got = _same(p, img.view(np.int32) if (dt == np.uint32 and bo == ">")
                else None)
    if dt.kind in "f" or (dt.itemsize < 4 and not (s > 1 and
                                                    dt.itemsize == 2)):
        np.testing.assert_array_equal(got, img)   # PIL's view is the data


def test_lzw_tiff_photometric_min_is_white_and_long_strips(tmp_path):
    """White-is-zero 8-bit gray comes back inverted, as PIL shows it; a
    strip longer than one LZW table (Clear codes mid-strip)."""
    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, (120, 200)).astype(np.uint8)
    _tiff(tmp_path / "w.tif", img, photometric=0, rps=120)
    np.testing.assert_array_equal(_same(tmp_path / "w.tif"), 255 - img)


@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA", "I;16", "F"])
def test_lzw_tiff_written_by_pil_equals_pil(tmp_path, mode):
    rng = np.random.default_rng(11)
    c = {"RGB": 3, "RGBA": 4}.get(mode, 0)
    a = _smooth(rng, 33, 47, c, 0, 65535 if mode == "I;16" else 255)
    a = a.astype({"I;16": np.uint16, "F": np.float32}.get(mode, np.uint8))
    Image.fromarray(a).save(tmp_path / "a.tif", compression="tiff_lzw")
    np.testing.assert_array_equal(_same(tmp_path / "a.tif"), a)


@pytest.mark.parametrize("mode", ["L", "RGB"])
def test_jpeg_tiff_written_by_pil_equals_pil(tmp_path, mode):
    """PIL's JPEG TIFF: one JPEG a strip, tables in JPEGTables (347)."""
    rng = np.random.default_rng(13)
    a = _smooth(rng, 40, 56, 3 if mode == "RGB" else 0).astype(np.uint8)
    for q in (75, 95):
        Image.fromarray(a).save(tmp_path / "a.tif", compression="jpeg",
                                quality=q)
        _same(tmp_path / "a.tif")


@pytest.mark.parametrize("tables", [False, True], ids=["whole", "abbrev"])
def test_ycbcr_jpeg_tiff_equals_pil(tmp_path, tables):
    """Photometric YCbCr, 4:2:0, strips of 16 rows each a JPEG (libtiff
    converts to RGB with libjpeg's fancy upsampling, per strip); with
    `tables` the strips leave their DQT and DHT to JPEGTables."""
    rng = np.random.default_rng(17)
    a = _smooth(rng, 40, 56, 3).astype(np.uint8)

    def whole(chunk):
        b = io.BytesIO()
        Image.fromarray(chunk.reshape(chunk.shape[0], -1, 3)).save(
            b, format="JPEG", quality=85, subsampling=2)
        return b.getvalue()

    def split(data):
        """(tables stream, the stream without DQT / DHT)."""
        i, keep, tabs = 2, bytearray(data[:2]), bytearray(b"\xff\xd8")
        while data[i + 1] != 0xDA:
            n = struct.unpack(">H", data[i + 2:i + 4])[0]
            seg = data[i:i + 2 + n]
            if data[i + 1] in (0xDB, 0xC4):
                tabs += seg
            elif data[i + 1] != 0xE0:
                keep += seg
            i += 2 + n
        return bytes(tabs + b"\xff\xd9"), bytes(keep + data[i:])

    extra = [(530, 3, [2, 2])]
    encode = whole
    if tables:
        tabs = split(whole(a[:16].reshape(16, -1)))[0]
        extra.append((347, 7, list(tabs)))

        def encode(chunk):
            return split(whole(chunk))[1]
    _tiff(tmp_path / "y.tif", a, compression=7, rps=16, photometric=6,
          encode=encode, extra=extra)
    _same(tmp_path / "y.tif")


@pytest.mark.parametrize("sub", [0, 2], ids=["444", "420"])
def test_rgb_photometric_jpeg_tiff_keeps_its_components(tmp_path, sub):
    """Photometric 2 (RGB) JPEG strips, as tiled slide exports write them:
    libtiff turns libjpeg's colour conversion off there, so PIL returns
    the components as stored, and so does the port.  Subsampled
    components under photometric 2 are refused by both."""
    rng = np.random.default_rng(23)
    a = _smooth(rng, 40, 56, 3).astype(np.uint8)

    def encode(chunk):
        b = io.BytesIO()
        Image.fromarray(chunk.reshape(chunk.shape[0], -1, 3)).save(
            b, format="JPEG", quality=85, subsampling=sub)
        return b.getvalue()

    p = tmp_path / "rgb.tif"
    _tiff(p, a, compression=7, rps=16, photometric=2, encode=encode)
    if sub == 2:
        with pytest.raises(tj.TiffError):
            tj.imread(p, retries=1)
        with pytest.raises(Exception, match="subsampled"):
            gt.read_plane(p)
        return
    got = _same(p)
    as_rgb = np.asarray(Image.open(io.BytesIO(encode(a[:16]))))
    assert np.abs(got[:16].astype(int) - as_rgb).max() > 8


def test_every_tiff_reader_undoes_the_float_predictor(tmp_path):
    """LZW f32 with predictor 3 reads alike through every io/tiff reader:
    read_tiff_stack page by page against PIL's pages (the JAX package's
    imread reads the first), read_tiff_partial on strips and tiles, and
    imread's salvage leg on a tiled file whose last tile is cut short."""
    from PIL import ImageSequence, TiffImagePlugin

    from ipp_tpu_torch.io import tiff as tt

    rng = np.random.default_rng(19)
    vol = rng.normal(0, 1000, (3, 37, 45)).astype(np.float32)
    info = TiffImagePlugin.ImageFileDirectory_v2()
    info[317] = 3
    pages = [Image.fromarray(v) for v in vol]
    p = tmp_path / "s.tif"
    pages[0].save(p, compression="tiff_lzw", tiffinfo=info, save_all=True,
                  append_images=pages[1:])
    with Image.open(p) as im:
        assert (im.tag_v2[259], im.tag_v2[317]) == (5, 3)
        ref = np.stack([np.asarray(page)
                        for page in ImageSequence.Iterator(im)])
    np.testing.assert_array_equal(ref, vol)
    np.testing.assert_array_equal(tj.imread(p, retries=1), ref[0])
    got = tt.read_tiff_stack(p)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, ref)
    got, failed = tt.read_tiff_partial(p)
    assert failed == 0
    np.testing.assert_array_equal(got, ref[0])

    t = tmp_path / "t.tif"
    _tiff(t, vol[1], predictor=3, tile=(16, 16))
    np.testing.assert_array_equal(_same(t), vol[1])
    got, failed = tt.read_tiff_partial(t)
    assert failed == 0
    np.testing.assert_array_equal(got, vol[1])
    t.write_bytes(t.read_bytes()[:-12])
    got, failed = tt.read_tiff_partial(t)
    assert failed == 1
    want = vol[1].copy()
    want[32:, 32:] = 0
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tt.imread(t, retries=1), want)


def test_read_tiff_and_partial_read_lzw_through_decompress(tmp_path):
    from ipp_tpu_torch.io import tiff as tt

    rng = np.random.default_rng(2)
    img = rng.integers(0, 65535, (30, 41)).astype(np.uint16)
    _tiff(tmp_path / "a.tif", img, predictor=2, rps=4)
    np.testing.assert_array_equal(tt.read_tiff(tmp_path / "a.tif"), img)
    got, failed = tt.read_tiff_partial(tmp_path / "a.tif")
    assert failed == 0
    np.testing.assert_array_equal(got, img)
    _tiff(tmp_path / "t.tif", img, tile=(16, 16))
    np.testing.assert_array_equal(tt.read_tiff(tmp_path / "t.tif"), img)


# ---------------------------------------------------------------- BMP / PNM

def _bmp(px, bits, palette=None, top_down=False, header=40, masks=None):
    """A BMP of index or BGR(A) bytes px (h, w[, c])."""
    h, w = px.shape[:2]
    if bits < 8:
        bitsr = ((px[..., None] >> np.arange(bits - 1, -1, -1)) & 1)
        rows = np.packbits(bitsr.reshape(h, w * bits).astype(np.uint8), 1)
    else:
        rows = px.reshape(h, -1).astype(np.uint8)
    stride = ((w * bits + 31) >> 3) & ~3
    body = np.zeros((h, stride), np.uint8)
    body[:, :rows.shape[1]] = rows
    if not top_down:
        body = body[::-1]
    pal = b"" if palette is None else bytes(palette)
    if header == 12:
        info = struct.pack("<IhhHH", 12, w, h, 1, bits)
    else:
        comp = 3 if masks else 0
        info = struct.pack("<IiiHHIIiiII", header, w, -h if top_down else h,
                           1, bits, comp, stride * h, 2835, 2835,
                           len(pal) // (4 if header != 12 else 3), 0)
        tail = struct.pack("<4I", *masks) if masks else b""
        info += tail + b"\0" * (header - 40 - len(tail))
    off = 14 + len(info) + len(pal)
    return b"BM" + struct.pack("<IHHI", off + body.size, 0, 0, off) + \
        info + pal + body.tobytes()


BMP_CASES = ["1bw", "1color", "4", "8", "8topdown", "24", "24os2", "32",
             "32bgra", "32rgba"]


@pytest.mark.parametrize("case", BMP_CASES)
def test_bmp_equals_pil(tmp_path, case):
    rng = np.random.default_rng(len(case))
    h, w = 11, 13
    if case.startswith("1"):
        pal = b"\0\0\0\0\xff\xff\xff\0" if case == "1bw" else \
            b"\x10\x20\x30\0\xff\x00\xff\0"
        data = _bmp(rng.integers(0, 2, (h, w)), 1, pal)
    elif case == "4":
        data = _bmp(rng.integers(0, 16, (h, w)), 4,
                    bytes(rng.integers(0, 256, 64, dtype=np.uint8)))
    elif case.startswith("8"):
        data = _bmp(rng.integers(0, 256, (h, w)), 8,
                    bytes(rng.integers(0, 256, 1024, dtype=np.uint8)),
                    top_down=case == "8topdown")
    elif case == "24os2":
        data = _bmp(rng.integers(0, 256, (h, w, 3)), 24, header=12)
    elif case == "24":
        data = _bmp(rng.integers(0, 256, (h, w, 3)), 24, top_down=True)
    elif case == "32":
        data = _bmp(rng.integers(0, 256, (h, w, 4)), 32)
    else:
        masks = (0xFF0000, 0xFF00, 0xFF, 0xFF000000) if case == "32bgra" \
            else (0xFF, 0xFF00, 0xFF0000, 0xFF000000)
        data = _bmp(rng.integers(0, 256, (h, w, 4)), 32, header=56,
                    masks=masks)
    (tmp_path / "a.bmp").write_bytes(data)
    _same(tmp_path / "a.bmp")


PNM_CASES = {
    "P1": b"P1\n# a comment\n5 2\n0 1 0 1 1\n10110\n",
    "P2-100": b"P2\n4 1\n100\n0 33 50 100\n",
    "P2-1000": b"P2\n3 1 1000 0 499 1000\n",
    "P3-255": b"P3\n2 1\n255\n1 2 3 4 5 6\n",
    "P3-1023": b"P3\n1 2\n1023\n0 511 1023 7 8 9\n",
    "P4": b"P4\n9 2\n" + bytes([0b10110011, 0b10000000, 0x0F, 0]),
    "P5-255": b"P5\n3 2\n255\n" + bytes(range(6)),
    "P5-200": b"P5 3 1 200\n" + bytes([0, 100, 255]),
    "P5-4095": b"P5\n2 1\n4095\n" + struct.pack(">HH", 17, 4095),
    "P5-65535": b"P5\n2 2\n65535\n" + struct.pack(">4H", 0, 1, 40000, 65535),
    "P6-255": b"P6\n2 1\n255\n" + bytes(range(6)),
    "P6-1000": b"P6\n1 1\n1000\n" + struct.pack(">HHH", 0, 500, 1000),
}


@pytest.mark.parametrize("case", sorted(PNM_CASES))
def test_netpbm_equals_pil(tmp_path, case):
    (tmp_path / "a.pgm").write_bytes(PNM_CASES[case])
    _same(tmp_path / "a.pgm")


# ---------------------------------------------------------------- writes

WRITES = [(".png", "u1"), (".png", "u2"), (".png", "b"), (".png", "rgb"),
          (".png", "rgba"), (".bmp", "u1"), (".bmp", "b"), (".bmp", "rgb"),
          (".bmp", "rgba"), (".pgm", "u1"), (".pgm", "u2"), (".pbm", "b"),
          (".ppm", "rgb"), (".dib", "rgb")]


@pytest.mark.parametrize("suffix,kind", WRITES,
                         ids=[f"{s[1:]}-{k}" for s, k in WRITES])
def test_lossless_writes_read_back_through_the_other_package(tmp_path,
                                                             suffix, kind):
    rng = np.random.default_rng(len(kind))
    shape = {"rgb": (23, 29, 3), "rgba": (23, 29, 4)}.get(kind, (23, 29))
    img = rng.integers(0, 65536 if kind == "u2" else 256, shape)
    img = (img > 127) if kind == "b" else img.astype(
        np.uint16 if kind == "u2" else np.uint8)
    pt, pj = tmp_path / f"t{suffix}", tmp_path / f"j{suffix}"
    gt.imwrite_generic(pt, img)
    gj.imwrite_generic(pj, img)
    if suffix != ".png":      # PIL's own bytes for BMP and PNM
        assert pt.read_bytes() == pj.read_bytes()
    for p in (pt, pj):
        got = _same(p)
        if not (kind == "rgba" and suffix in (".bmp", ".dib")):
            np.testing.assert_array_equal(got, img)   # PIL drops BMP alpha
    if suffix == ".pgm" and kind == "u2":
        assert _same(pt).dtype == np.int32           # PIL's mode "I"


def test_png_writes_16_bit_rgb_which_pil_reads_as_8(tmp_path):
    rng = np.random.default_rng(9)
    img = rng.integers(0, 65536, (9, 10, 3)).astype(np.uint16)
    gt.imwrite_generic(tmp_path / "a.png", img)
    np.testing.assert_array_equal(_same(tmp_path / "a.png"),
                                  (img >> 8).astype(np.uint8))


# ---------------------------------------------------------------- AVI

def test_avi_crosses_the_riff_limit_into_avix_parts(tmp_path, monkeypatch):
    cv2 = pytest.importorskip("cv2")
    monkeypatch.setattr(avi, "RIFF_LIMIT", 20000)
    rng = np.random.default_rng(1)
    frames = [_smooth(rng, 48, 64).astype(np.uint8) for _ in range(9)]
    with avi.MjpegWriter(tmp_path / "m.avi", 64, 48, 12) as vw:
        for i, f in enumerate(frames):
            vw.write(f, repeat=2 if i == 3 else 1)
    data = (tmp_path / "m.avi").read_bytes()
    assert data.count(b"AVIX") >= 2 and data.count(b"ix00") >= 3
    info = avi.avi_info(tmp_path / "m.avi")
    assert (info["width"], info["height"], info["fps"]) == (64, 48, 12.0)
    mine = list(avi.read_avi(tmp_path / "m.avi"))
    assert len(mine) == 10
    cap = cv2.VideoCapture(str(tmp_path / "m.avi"))
    assert cap.get(cv2.CAP_PROP_FPS) == 12
    theirs = []
    ok, f = cap.read()
    while ok:
        theirs.append(f)
        ok, f = cap.read()
    cap.release()
    assert len(theirs) == 10
    want = frames[:4] + frames[3:]
    for m, t, w in zip(mine, theirs, want):
        assert np.abs(m[..., 0].astype(int) - w).mean() < 2
        # FFmpeg's MJPEG decoder has an IDCT of its own: 1 count apart
        assert np.abs(m[..., ::-1].astype(int) - t).max() <= 1


# ---------------------------------------------------------------- no PIL

CHILD = r"""
import importlib.abc, sys
class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("PIL", "cv2"):
            raise ImportError(f"{name} refused in this test")
sys.meta_path.insert(0, Refuse())

import json
from pathlib import Path
import numpy as np
from ipp_tpu_torch.io import generic2d as gt, tiff as tt
from ipp_tpu_torch.pipeline import convert, pystripe_cli

work = Path(sys.argv[1])
want = np.load(work / "want.npz")
for name in want.files:                  # every fixture reads
    got = gt.imread_generic(work / "fix" / name)
    assert got.dtype == want[name].dtype, name
    np.testing.assert_array_equal(got, want[name], err_msg=name)
rng = np.random.default_rng(0)
for suffix, img in ((".png", rng.integers(0, 65535, (9, 11)).astype(np.uint16)),
                    (".png", rng.integers(0, 255, (9, 11, 3)).astype(np.uint8)),
                    (".bmp", rng.integers(0, 255, (9, 11, 3)).astype(np.uint8)),
                    (".pgm", rng.integers(0, 255, (9, 11)).astype(np.uint8)),
                    (".pbm", rng.integers(0, 2, (9, 11)) > 0)):
    gt.imwrite_generic(work / f"w{suffix}", img)
    np.testing.assert_array_equal(gt.imread_generic(work / f"w{suffix}"), img)
args = ["--sigma1", "40", "--sigma2", "40", "--wavelet", "db9",
        "--bidirectional", "--batch-size", "2", "--workers", "2"]
for tree in ("png", "tif"):
    assert pystripe_cli.main(["-i", str(work / tree), "-o",
                              str(work / f"out_{tree}"), *args]) == 0
outs = sorted(p.relative_to(work / "out_tif") for p in (work / "out_tif").rglob("*.tif"))
assert len(outs) == 4, outs
for rel in outs:
    a = tt.imread(work / "out_png" / rel)
    b = tt.imread(work / "out_tif" / rel)
    assert a.dtype == b.dtype == np.uint16
    assert np.array_equal(a, b), rel
assert convert.main(["-i", str(work / "tif" / "s0"), "-o", str(work / "conv"),
                     "--movie", str(work / "m.avi")]) == 0
assert (work / "m.avi").stat().st_size > 1000
for suffix, img in ((".jp2", rng.integers(0, 65535, (9, 11)).astype(np.uint16)),
                    (".j2k", rng.integers(0, 255, (9, 11, 3)).astype(np.uint8))):
    gt.imwrite_generic(work / f"x{suffix}", img)     # JPEG 2000: no PIL either
    np.testing.assert_array_equal(gt.imread_generic(work / f"x{suffix}"), img)
errors = {}
try:
    convert.tif_series_to_movie(work / "tif" / "s0", work / "x.mp4")
except ImportError as e:
    errors["mp4"] = str(e)
assert "cv2" in errors["mp4"], errors
assert not [m for m in sys.modules if m.split(".")[0] in ("PIL", "cv2")]
print("OK", json.dumps(errors))
"""


def test_reads_writes_destripes_and_movies_with_pil_and_cv2_refused(
        tmp_path):
    """Every fixture kind reads (progressive and CMYK JPEG among them),
    each lossless format writes, the destripe
    CLI runs on 16-bit PNG tiles 0 counts off the same tiles as TIFFs, and
    `convert --movie x.avi` runs, and JPEG 2000 planes write and read
    back, all in a process where importing PIL or cv2 fails; .mp4 raises
    an error naming the missing package."""
    rng = np.random.default_rng(4)
    fix = tmp_path / "fix"
    fix.mkdir()
    img8 = _smooth(rng, 29, 37, 3).astype(np.uint8)
    Image.fromarray(img8).save(fix / "a.jpg")
    Image.fromarray(img8[..., 0]).save(fix / "g.jpg", quality=90)
    Image.fromarray(img8).save(fix / "p.jpg", progressive=True,
                               restart_marker_blocks=4)
    Image.fromarray(img8).convert("CMYK").save(fix / "c.jpg",
                                               progressive=True)
    Image.fromarray(img8).save(fix / "a.png")
    Image.fromarray(img8).save(fix / "a.bmp")
    Image.fromarray(img8[..., 1]).save(fix / "a.pgm")
    Image.fromarray(img8).save(fix / "l.tif", compression="tiff_lzw")
    Image.fromarray(img8).save(fix / "j.tif", compression="jpeg")
    (fix / "i.png").write_bytes(_png(rng.integers(0, 16, (9, 10, 1)), 4, 0,
                                     interlace=True))
    _tiff(fix / "f.tif", _smooth(rng, 20, 24, 0, -5, 5).astype(np.float32),
          predictor=3, tile=(16, 16))
    want = {p.name: gj.imread_generic(p) for p in fix.iterdir()}
    np.savez(tmp_path / "want.npz", **want)
    for s in range(2):
        for z in range(2):
            tile = _smooth(rng, 100, 150, 0, 200, 3000)
            tile *= 1 + 0.2 * rng.standard_normal((1, 150))
            tile = np.clip(tile, 0, 65535).astype(np.uint16)
            for kind in ("png", "tif"):
                d = tmp_path / kind / f"s{s}"
                d.mkdir(parents=True, exist_ok=True)
                if kind == "png":
                    Image.fromarray(tile).save(d / f"{z:06d}.png")
                else:
                    tj.imwrite(d / f"{z:06d}.tif", tile)
    env = dict(os.environ, IPP_TPU_PLATFORM="cpu", IPP_TPU_PROGRESS="off",
               PYTHONPATH=str(ROOT) + os.pathsep +
               os.environ.get("PYTHONPATH", ""))
    out = subprocess.run([sys.executable, "-c", CHILD, str(tmp_path)],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1].startswith("OK")


# ---------------------------------------------------------------- fixtures

def test_fixtures_hold_their_seeds(tmp_path):
    """The committed fixtures (tests/torch_image_fixtures, read on the
    card's host by chip_smoke.py phase 18 (c)) decode to their seeds, or,
    where lossy, to the digest of PIL's decode; regenerated, they hold the
    same."""
    import json

    mk = _fixture_maker()
    manifest = json.loads((mk.HERE / "fixtures.json").read_text())
    assert sorted(manifest) == sorted(mk.FILES)
    seeds = mk.seeds()
    for name, entry in manifest.items():
        got = gt.read_plane(mk.HERE / name)
        assert mk.digest(got) == entry["sha256"], name
        assert mk.digest(gj.imread_generic(mk.HERE / name)) == \
            entry["sha256"], name
        if entry["lossless"]:
            np.testing.assert_array_equal(got, seeds[entry["seed"]])
    assert mk.write(tmp_path) == manifest


def test_corrupt_files_raise_and_never_crash(tmp_path):
    """Bytes flipped, runs zeroed and files cut short in a JPEG (with
    restarts), progressive JPEGs (RGB with restarts, CMYK; cut short with
    and without EOI), a PNG (Adam7), an LZW TIFF and a BMP: each read
    returns an array or raises the codec's error; the library never
    crashes."""
    from ipp_tpu_torch.io import tiff as tt

    rng = np.random.default_rng(99)
    img = _smooth(rng, 40, 56, 3).astype(np.uint8)
    good = {"a.jpg": _jpeg_cv2(img, rst_interval=2),
            "a.png": _png(img.astype(int), 8, 2, interlace=True)}
    _tiff(tmp_path / "a.tif", img[..., 0], predictor=2, rps=8)
    good["a.tif"] = (tmp_path / "a.tif").read_bytes()
    good["a.bmp"] = _bmp(img, 24)
    progressive = {"p.jpg": (Image.fromarray(img),
                             dict(restart_marker_blocks=3)),
                   "c.jpg": (Image.fromarray(img).convert("CMYK"), {})}
    for name, (im, flags) in progressive.items():
        buf = io.BytesIO()
        im.save(buf, format="JPEG", progressive=True, **flags)
        good[name] = buf.getvalue()
    for name, data in good.items():
        for trial in range(60):
            buf = bytearray(data)
            if trial % 3 == 0:
                buf = buf[:int(rng.integers(4, len(buf)))]
                if trial % 2 and name in progressive:
                    buf += b"\xff\xd9"
            else:
                at = rng.integers(2, len(buf), int(rng.integers(1, 8)))
                for i in at:
                    buf[i] = int(rng.integers(0, 256)) if trial % 3 == 1 \
                        else 0
            p = tmp_path / f"x_{name}"
            p.write_bytes(bytes(buf))
            try:
                gt.read_plane(p)
            except (imgcodec.CodecError, tt.TiffError, ValueError,
                    struct.error, zlib.error):
                pass
