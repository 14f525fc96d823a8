"""Write the zstd (compression 50000) and LZMA (34925) TIFF fixtures that
the port reads without PIL: run ``python
tests/torch_tiff_fixtures/make_fixtures.py`` (PIL with libtiff's zstd and
LZMA codecs, and libzstd, needed) and commit the files it writes with
``fixtures.json``.

Every plane is made by ``seeds()`` from numpy seeds (numpy alone).  Three
kinds of file:

- ``pil_*``: saved by PIL's libtiff writer (``compression="zstd"`` or
  ``"lzma"``, ``strip_size`` 65536 or 1 MiB, predictor 2 through
  ``tiffinfo``, also on f32, whose bits libtiff differences as integers)
  where PIL writes the layout as stored: u8, u16 and f32
  gray, u8 RGB, a constant plane (RLE blocks), a noise plane (raw blocks
  and raw literals), a ramp with beads (long matches, repeat offsets) and
  a plane whose last strip is short;
- ``own_*``: the layouts PIL writes otherwise (i16 and u32 gray, which it
  saves as int32, and u16 RGB), and libzstd's own frames, in TIFFs this
  module writes (``write_tiff``), tiled 256 x 256 as tifffile writes them
  (edge tiles padded): libzstd levels -5, 1, 3, 9, 19 and 22 through
  ``ctypes``, the checksum flag, one-shot frames (content size, single
  segment) beside streamed ones (no content size, a window descriptor),
  predictor 2 on u16 and 3 on f32, and a strip of two frames with a
  skippable frame between;
- ``frames/*.zst``: frames built here for what no TIFF above holds (tiny
  and 8-byte content sizes, dictionary ID fields of 0, RLE sequence
  tables, repeat tables, treeless and RLE literals, direct Huffman
  weights, ...), each checked against libzstd's ``ZSTD_decompress``.

``fixtures.json`` records PIL's, libtiff's and libzstd's versions and, for
every TIFF, its seed, its writer and options, whether PIL reads it
(``twin``), the sha256 of ``np.asarray(PIL.Image.open(path))`` (its shape,
dtype string and bytes) or, where PIL does not read it, of the stored
samples, and the modes its frames use (``modes``, from ``walk``); for
every frame, the sha256 and size of what libzstd decodes and its modes.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import json
import os
import struct
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
FRAMES = HERE / "frames"
SHAPE = (64, 96)
TILE = 256
MIB = 1 << 20
ZSTD, LZMA = 50000, 34925

# the modes a decoder meets: each frame's block types, literals types,
# Huffman streams and weights, and the LL / OF / ML table modes
SEQ_MODES = ("predefined", "rle", "fse", "repeat")
MODES = (["block raw", "block rle", "block compressed",
          "literals raw", "literals rle", "literals compressed",
          "literals treeless", "streams 1", "streams 4",
          "weights direct", "weights fse"]
         + [f"{t} {m}" for t in ("LL", "OF", "ML") for m in SEQ_MODES])
# and the frame header's fields
HEADERS = ["fcs 0", "fcs 1", "fcs 2", "fcs 4", "fcs 8", "single segment",
           "window descriptor", "dictionary field", "checksum", "skippable",
           "frames 2"]


# ------------------------------------------------------------- planes --

def seeds() -> dict:
    """name -> the array a fixture is made from."""
    h, w = SHAPE
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    rng = np.random.default_rng(270)
    field = 0.5 + 0.3 * np.sin(xx / 9.0 + yy / 13.0)
    out = {"u16": np.clip(30000 * field + rng.normal(0, 3, (h, w)), 0,
                          65535).astype(np.uint16)}
    out["u8"] = (out["u16"] >> 8).astype(np.uint8)
    out["i16"] = (out["u16"].astype(np.int32) - 30000).astype(np.int16)
    out["u32"] = out["u16"].astype(np.uint32) * 65537  # past 2^31 too
    out["f32"] = (out["u16"].astype(np.float32) / 7.0 - 1000.0)
    rgb = field[..., None] * np.array([0.9, 0.7, 0.5]) * 255
    out["rgb8"] = np.clip(rgb + rng.normal(0, 1, (h, w, 3)), 0,
                          255).astype(np.uint8)
    out["rgb16"] = out["rgb8"].astype(np.uint16) * 257 + 1
    out["const"] = np.full((h, w), 0x0707, np.uint16)
    # 256 KiB of it: libzstd writes an RLE block after the frame's first
    out["const_big"] = np.full((256, 512), 0x0707, np.uint16)
    # random rows, each twice: matches over literals Huffman cannot shrink
    rows = rng.integers(0, 256, (h // 2, w), dtype=np.uint8)
    out["noise"] = np.repeat(rows, 2, axis=0)
    out["noise_raw"] = rng.integers(0, 256, (h, w), dtype=np.uint8)
    # a ramp (each row the last one shifted) with Gaussian beads: 256 KiB,
    # so a 1 MiB strip's frame holds several 128 KiB blocks
    ry, rx = np.mgrid[0:256, 0:512].astype(np.float64)
    ramp = 40 * rx + 90 * ry
    for cy, cx in rng.uniform(0, [256, 512], (12, 2)):
        ramp += 6000 * np.exp(-((ry - cy) ** 2 + (rx - cx) ** 2) / 18.0)
    out["ramp"] = np.clip(ramp, 0, 65535).astype(np.uint16)
    # 150 rows of 512 bytes: strips of 128 rows, the last of 22
    sy, sx = np.mgrid[0:150, 0:256].astype(np.float64)
    out["short_last"] = (np.round(
        (20000 + 8000 * np.sin(sx / 23.0) * np.cos(sy / 17.0)) / 64)
        * 64).astype(np.uint16)
    # libzstd's tiles: 256 x 300, one full tile and one padded edge tile,
    # and the full tile alone
    ty, tx = np.mgrid[0:TILE, 0:300].astype(np.float64)
    tile = 12000 + 3000 * np.sin(tx / 31.0) * np.cos(ty / 27.0)
    for cy, cx in rng.uniform(0, [TILE, 300], (20, 2)):
        tile += 5000 * np.exp(-((ty - cy) ** 2 + (tx - cx) ** 2) / 8.0)
    out["tiles_u16"] = (np.round(tile / 128) * 128).astype(np.uint16)
    out["tile_u16"] = out["tiles_u16"][:, :TILE].copy()
    out["tiles_f32"] = (np.round(tile / 64.0) / 4.0).astype(np.float32)
    return out


def digest(a: np.ndarray) -> str:
    a = np.ascontiguousarray(a)
    return hashlib.sha256(f"{a.shape} {a.dtype.str}".encode() +
                          a.tobytes()).hexdigest()


def pil_view(a: np.ndarray) -> np.ndarray:
    """What PIL returns for stored samples `a` (the port's
    io/tiffcodec._pil_view, for the layouts here)."""
    if a.dtype == np.uint32:
        return a.view(np.int32)
    if a.dtype == np.int16:
        return a.astype(np.int32)
    if a.ndim == 3 and a.dtype == np.uint16:
        return (a >> 8).astype(np.uint8)
    return a


# ------------------------------------------------------------ libzstd --

def libzstd() -> ctypes.CDLL:
    """The host's libzstd (the system's, else the one beside PIL)."""
    import PIL

    cands = ["/usr/lib/x86_64-linux-gnu/libzstd.so.1"] + sorted(glob.glob(
        str(Path(PIL.__file__).parent.parent / "pillow.libs" / "libzstd*")))
    for c in cands:
        if os.path.exists(c):
            lib = ctypes.CDLL(c)
            break
    else:
        raise OSError("no libzstd")
    sz, vp, cp = ctypes.c_size_t, ctypes.c_void_p, ctypes.c_char_p
    for name, res, args in (
            ("ZSTD_compress", sz, [vp, sz, cp, sz, ctypes.c_int]),
            ("ZSTD_decompress", sz, [vp, sz, cp, sz]),
            ("ZSTD_compressBound", sz, [sz]),
            ("ZSTD_isError", ctypes.c_uint, [sz]),
            ("ZSTD_versionString", cp, []),
            ("ZSTD_createCCtx", vp, []),
            ("ZSTD_freeCCtx", sz, [vp]),
            ("ZSTD_CCtx_setParameter", sz, [vp, ctypes.c_int, ctypes.c_int]),
            ("ZSTD_compressStream2", sz, [vp, vp, vp, ctypes.c_int])):
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = res, args
    return lib


class _Buf(ctypes.Structure):
    _fields_ = [("ptr", ctypes.c_void_p), ("size", ctypes.c_size_t),
                ("pos", ctypes.c_size_t)]


def zstd_compress(data: bytes, level: int = 3, checksum: bool = False,
                  streamed: bool = False, piece: int = 20000) -> bytes:
    """One frame of `data`: one-shot (content size in the header, single
    segment where it fits) or, `streamed`, fed in pieces so the header
    holds a window descriptor and no content size."""
    z = libzstd()
    cctx = z.ZSTD_createCCtx()
    try:
        for param, value in ((100, level), (201, int(checksum))):
            r = z.ZSTD_CCtx_setParameter(cctx, param, value)
            if z.ZSTD_isError(r):
                raise RuntimeError(f"ZSTD_CCtx_setParameter({param})")
        cap = z.ZSTD_compressBound(len(data)) + 64
        out = ctypes.create_string_buffer(cap)
        src = ctypes.create_string_buffer(data, len(data) or 1)
        ob = _Buf(ctypes.cast(out, ctypes.c_void_p), cap, 0)
        pos = 0
        while True:
            n = min(piece if streamed else len(data), len(data) - pos)
            last = pos + n >= len(data)
            ib = _Buf(ctypes.c_void_p(ctypes.addressof(src) + pos), n, 0)
            while True:
                r = z.ZSTD_compressStream2(cctx, ctypes.byref(ob),
                                           ctypes.byref(ib), 2 if last else 0)
                if z.ZSTD_isError(r):
                    raise RuntimeError("ZSTD_compressStream2")
                if (last and r == 0) or (not last and ib.pos == ib.size):
                    break
            pos += n
            if last:
                return out.raw[:ob.pos]
    finally:
        z.ZSTD_freeCCtx(cctx)


def zstd_decompress(frame: bytes, size: int) -> bytes:
    z = libzstd()
    out = ctypes.create_string_buffer(size or 1)
    n = z.ZSTD_decompress(out, size, frame, len(frame))
    if z.ZSTD_isError(n):
        raise ValueError("libzstd refuses the frame")
    return out.raw[:n]


# ---------------------------------------------------------------- walk --

def walk(data: bytes) -> set:
    """The modes and header fields that the frames in `data` use (read
    from their headers alone, never decoded)."""
    seen, ip, frames = set(), 0, 0
    while ip < len(data):
        magic = struct.unpack_from("<I", data, ip)[0]
        ip += 4
        if magic & 0xFFFFFFF0 == 0x184D2A50:
            seen.add("skippable")
            ip += 4 + struct.unpack_from("<I", data, ip)[0]
            continue
        assert magic == 0xFD2FB528, hex(magic)
        frames += 1
        fhd = data[ip]
        ip += 1
        single = fhd >> 5 & 1
        if single:
            seen.add("single segment")
        else:
            seen.add("window descriptor")
            ip += 1
        did = (0, 1, 2, 4)[fhd & 3]
        if did:
            seen.add("dictionary field")
        ip += did
        fcs = (single, 2, 4, 8)[fhd >> 6]
        seen.add(f"fcs {fcs}")
        ip += fcs
        while True:
            bh = int.from_bytes(data[ip:ip + 3], "little")
            ip += 3
            last, btype, size = bh & 1, bh >> 1 & 3, bh >> 3
            seen.add("block " + ("raw", "rle", "compressed")[btype])
            if btype == 2:
                _walk_block(data[ip:ip + size], seen)
            ip += 1 if btype == 1 else size
            if last:
                break
        if fhd >> 2 & 1:
            seen.add("checksum")
            ip += 4
    if frames > 1:
        seen.add("frames 2")
    return seen


def _walk_block(b: bytes, seen: set) -> None:
    ltype, sf = b[0] & 3, b[0] >> 2 & 3
    seen.add("literals " + ("raw", "rle", "compressed", "treeless")[ltype])
    if ltype < 2:
        head = (1, 2, 1, 3)[sf]
        regen = b[0] >> 3 if head == 1 else int.from_bytes(
            b[:head], "little") >> 4
        ip = head + (regen if ltype == 0 else 1)
    else:
        head, bits = (3, 3, 4, 5)[sf], (10, 10, 14, 18)[sf]
        h = int.from_bytes(b[:head], "little")
        comp = h >> (4 + bits) & ((1 << bits) - 1)
        seen.add(f"streams {1 if sf == 0 else 4}")
        if ltype == 2:
            seen.add("weights " + ("fse" if b[head] < 128 else "direct"))
        ip = head + comp
    n = b[ip]
    if n == 0:
        return
    ip += 1 if n < 128 else 2 if n < 255 else 3
    modes = b[ip]
    for name, shift in (("LL", 6), ("OF", 4), ("ML", 2)):
        seen.add(f"{name} {SEQ_MODES[modes >> shift & 3]}")


# ---------------------------------------------------------- TIFF write --

def write_tiff(path: Path, a: np.ndarray, compress, compression: int, *,
               tile: int = 0, rows: int = 0, predictor: int = 1,
               bits: int = 0, planar: int = 1, photometric: int = -1,
               tags: dict = None) -> None:
    """A classic little-endian TIFF of the (h, w) or (h, w, s) plane `a`:
    strips of `rows` rows (all rows by default) or `tile` x `tile` tiles
    (edge tiles padded with zeros, as tifffile writes them), each chunk
    through `predictor` then `compress(bytes) -> bytes`.  `bits` (1, 2 or
    4) packs each row of one-sample values, most significant bits first,
    to a byte (stored as given: no predictor); `planar` 2 writes each
    sample's chunks in turn; `photometric` (2 for 3 samples or more, else
    1, by default) and `tags` ({tag: (type, values)}, added last) go into
    the IFD; FillOrder 2 among them reverses each compressed chunk's bits,
    as libtiff writes it."""
    a = np.ascontiguousarray(a)
    h, w = a.shape[:2]
    s = a.shape[2] if a.ndim == 3 else 1
    a = a.reshape(h, w, s)
    planes = [a[..., k:k + 1] for k in range(s)] if planar == 2 else [a]
    tags = dict(tags or {})
    flip = tags.get(266, (3, [1]))[1][0] == 2

    def put(t: np.ndarray) -> bytes:
        data = pack_bits(t[..., 0], bits) if bits else _predict(t, predictor)
        out = compress(data)
        return out.translate(BIT_REVERSED) if flip else out

    chunks = []
    for plane in planes:
        cs = plane.shape[2]
        if tile:
            for y in range(0, h, tile):
                for x in range(0, w, tile):
                    t = np.zeros((tile, tile, cs), a.dtype)
                    part = plane[y:y + tile, x:x + tile]
                    t[:part.shape[0], :part.shape[1]] = part
                    chunks.append(put(t))
        else:
            rows = rows or h
            for y in range(0, h, rows):
                chunks.append(put(plane[y:y + rows]))
    sf = {"u": 1, "i": 2, "f": 3, "b": 1}[a.dtype.kind]
    if photometric < 0:
        photometric = 2 if s >= 3 else 1
    tags = {256: (4, [w]), 257: (4, [h]),
            258: (3, [bits or a.dtype.itemsize * 8] * s),
            259: (3, [compression]), 262: (3, [photometric]), 277: (3, [s]),
            284: (3, [planar]), 317: (3, [predictor]), 339: (3, [sf] * s),
            **tags}
    if tile:
        tags.update({322: (3, [tile]), 323: (3, [tile]),
                     325: (4, [len(c) for c in chunks])})
        offsets_tag = 324
    else:
        tags.update({278: (4, [rows]), 279: (4, [len(c) for c in chunks])})
        offsets_tag = 273
    tags = {t: v for t, v in tags.items() if v is not None}
    tags[offsets_tag] = (4, [0] * len(chunks))
    fmt = {3: "H", 4: "I"}

    def layout():
        head = bytearray(struct.pack("<2sHI", b"II", 42, 8))
        head += struct.pack("<H", len(tags))
        extra = bytearray()
        at = 8 + 2 + 12 * len(tags) + 4
        for t in sorted(tags):
            typ, v = tags[t]
            d = struct.pack("<" + fmt[typ] * len(v), *v)
            if len(d) > 4:
                head += struct.pack("<HHII", t, typ, len(v), at + len(extra))
                extra += d + b"\0" * (len(d) % 2)
            else:
                head += struct.pack("<HHI", t, typ, len(v)) + d.ljust(4, b"\0")
        return head + struct.pack("<I", 0) + extra

    start = len(layout())
    offs, pos = [], start
    for c in chunks:
        offs.append(pos)
        pos += len(c)
    tags[offsets_tag] = (4, offs)
    out = layout()
    assert len(out) == start
    path.write_bytes(bytes(out) + b"".join(chunks))


BIT_REVERSED = bytes(int(f"{i:08b}"[::-1], 2) for i in range(256))


def pack_bits(a: np.ndarray, bits: int) -> bytes:
    """(rows, cols) values below 2**bits, each row packed most significant
    bits first and padded to a byte."""
    rows, cols = a.shape
    b = (a.astype(np.uint8)[..., None] >> np.arange(bits - 1, -1, -1)) & 1
    return np.packbits(b.reshape(rows, cols * bits), axis=1).tobytes()


def _predict(t: np.ndarray, predictor: int) -> bytes:
    """A (rows, w, s) chunk's bytes under TIFF predictor 1, 2 or 3."""
    if predictor == 1:
        return t.tobytes()
    if predictor == 2:
        d = t.copy()
        d[:, 1:] = t[:, 1:] - t[:, :-1]
        return d.tobytes()
    rows, w, s = t.shape   # 3: byte planes, most significant first, then
    be = t.astype(t.dtype.newbyteorder(">")).view(np.uint8)   # differences
    planes = be.reshape(rows, w * s, t.dtype.itemsize).transpose(0, 2, 1)
    b = planes.reshape(rows, -1, s).copy()
    b[:, 1:] = b[:, 1:] - b[:, :-1]
    return b.tobytes()


def lzma_compress(data: bytes) -> bytes:
    import lzma

    return lzma.compress(data, format=lzma.FORMAT_XZ)


# --------------------------------------------------------------- files --

# PIL's libtiff writer: file -> (seed, compression, strip size, predictor)
PIL_FILES = {}
for _c, _tag in (("zstd", ZSTD), ("lzma", LZMA)):
    for _seed in ("u8", "u16", "f32", "rgb8", "const", "noise", "noise_raw",
                  "short_last"):
        PIL_FILES[f"pil_{_c}_{_seed}.tif"] = (_seed, _tag, 65536, 1)
    PIL_FILES[f"pil_{_c}_ramp.tif"] = ("ramp", _tag, 65536, 1)
    PIL_FILES[f"pil_{_c}_const_1m.tif"] = ("const_big", _tag, MIB, 1)
    PIL_FILES[f"pil_{_c}_ramp_1m.tif"] = ("ramp", _tag, MIB, 1)
    PIL_FILES[f"pil_{_c}_ramp_1m_p2.tif"] = ("ramp", _tag, MIB, 2)
    PIL_FILES[f"pil_{_c}_u16_p2.tif"] = ("u16", _tag, 65536, 2)
    PIL_FILES[f"pil_{_c}_f32_p2.tif"] = ("f32", _tag, 65536, 2)

# this module's writer: file -> (seed, compression, options)
OWN_FILES = {}
for _c, _tag in (("zstd", ZSTD), ("lzma", LZMA)):
    for _seed in ("i16", "u32", "rgb16"):
        OWN_FILES[f"own_{_c}_{_seed}.tif"] = (_seed, _tag, {})
for _lvl in (-5, 1, 3, 9, 19, 22):
    OWN_FILES[f"own_zstd_tiles_l{_lvl}.tif".replace("-", "m")] = (
        "tile_u16", ZSTD, dict(tile=TILE, level=_lvl))
OWN_FILES.update({
    "own_zstd_tiles_checksum.tif": ("tile_u16", ZSTD,
                                    dict(tile=TILE, level=3, checksum=True)),
    "own_zstd_tiles_streamed.tif": ("tile_u16", ZSTD,
                                    dict(tile=TILE, level=3, streamed=True)),
    "own_zstd_tiles_p2.tif": ("tiles_u16", ZSTD,
                              dict(tile=TILE, level=3, predictor=2)),
    "own_zstd_tiles_f32_p3.tif": ("tiles_f32", ZSTD,
                                  dict(tile=TILE, level=3, predictor=3)),
    "own_lzma_tiles_p2.tif": ("tiles_u16", LZMA, dict(tile=TILE, predictor=2)),
    # one strip: a frame, a skippable frame, a frame (PIL reads the first)
    "own_zstd_two_frames.tif": ("u16", ZSTD, dict(split=True)),
})


def own_compress(compression: int, options: dict):
    if compression == LZMA:
        return lzma_compress
    level = options.get("level", 3)
    checksum = options.get("checksum", False)
    streamed = options.get("streamed", False)
    if options.get("split"):
        def two(data: bytes) -> bytes:
            half = len(data) // 2
            return (zstd_compress(data[:half], level) +
                    struct.pack("<II", 0x184D2A5A, 5) + b"skip!" +
                    zstd_compress(data[half:], level, checksum=True))
        return two
    return lambda data: zstd_compress(data, level, checksum, streamed)


def chunks_of(path: Path) -> list:
    """The strips' or tiles' bytes of a one-page TIFF that this module or
    PIL wrote (classic, little-endian)."""
    b = path.read_bytes()
    ifd = struct.unpack_from("<I", b, 4)[0]
    n = struct.unpack_from("<H", b, ifd)[0]
    tags = {}
    for i in range(n):
        t, typ, cnt = struct.unpack_from("<HHI", b, ifd + 2 + 12 * i)
        f = {3: "H", 4: "I"}.get(typ)
        if f is None:
            continue
        size = struct.calcsize(f) * cnt
        at = ifd + 2 + 12 * i + 8
        if size > 4:
            at = struct.unpack_from("<I", b, at)[0]
        tags[t] = struct.unpack_from("<" + f * cnt, b, at)
    offs = tags.get(273) or tags[324]
    counts = tags.get(279) or tags[325]
    return [b[o:o + c] for o, c in zip(offs, counts)]


# --------------------------------------------------------- hand frames --

class _Bits:
    """A backward bitstream writer: fields are read back in the reverse
    order of their writing."""

    def __init__(self):
        self.v, self.n = 0, 0

    def put(self, value: int, bits: int) -> None:
        self.v |= (value & ((1 << bits) - 1)) << self.n
        self.n += bits

    def done(self) -> bytes:
        self.put(1, 1)
        return self.v.to_bytes((self.n + 7) // 8, "little")


def _frame(blocks: list, content: bytes, fcs_bytes: int = -1,
           single: bool = True, did_bytes: int = 0) -> bytes:
    """A frame of `blocks` [(type, body, block size)] holding `content`,
    with the header asked for (no checksum)."""
    size = len(content)
    if fcs_bytes < 0:
        fcs_bytes = 1 if size < 256 else 2 if size < 65792 else 4
    flag = {0: 0, 1: 0, 2: 1, 4: 2, 8: 3}[fcs_bytes]
    assert not (single and fcs_bytes == 0) and not (fcs_bytes == 1
                                                    and not single)
    fhd = flag << 6 | single << 5 | {0: 0, 1: 1, 2: 2, 4: 3}[did_bytes]
    out = struct.pack("<IB", 0xFD2FB528, fhd)
    if not single:
        out += bytes([(17 - 10) << 3])     # a 128 KiB window
    out += bytes(did_bytes)
    v = size - 256 if fcs_bytes == 2 else size
    out += v.to_bytes(fcs_bytes, "little") if fcs_bytes else b""
    for i, (btype, body, bsize) in enumerate(blocks):
        last = i == len(blocks) - 1
        out += (bsize << 3 | btype << 1 | last).to_bytes(3, "little") + body
    return out


def _lits_header(ltype: int, n: int) -> bytes:
    """A raw (0) or RLE (1) literals header for n literals."""
    if n < 32:
        return bytes([n << 3 | ltype])
    if n < 4096:
        return (n << 4 | 1 << 2 | ltype).to_bytes(2, "little")
    return (n << 4 | 3 << 2 | ltype).to_bytes(3, "little")


def _huffman(literals: bytes, streams: int, alphabet: list):
    """Literals as a Huffman-coded section with 4-bit direct weights over
    `alphabet` (3 or 4 sorted symbols, the last at most 128): weights 1, 1
    (the two longest codes, paired as libzstd requires) and 2, the last
    symbol's implied by the remainder.  Returns (tree, streams bytes)."""
    top = alphabet[-1]
    assert set(literals) <= set(alphabet) and top <= 128
    assert len(alphabet) in (3, 4)
    weights = [0] * (top + 1)
    for s, w in zip(alphabet[:-1], (1, 1, 2)):
        weights[s] = w
    total = sum(1 << (w - 1) for w in weights if w)
    maxbits = total.bit_length()
    left = (1 << maxbits) - total
    assert left & (left - 1) == 0
    weights[top] = left.bit_length()
    nbits = {s: maxbits + 1 - weights[s] for s in alphabet}
    # the decoder's table: longest codes first, symbols in order
    start = {}
    at = 0
    for b in range(maxbits, 0, -1):
        start[b] = at
        at += sum(1 for s in alphabet if nbits[s] == b) << (maxbits - b)
    code = {}
    for s in alphabet:
        b = nbits[s]
        code[s] = start[b] >> (maxbits - b)
        start[b] += 1 << (maxbits - b)
    n = top   # explicit weights: symbols 0 .. top - 1
    tree = bytes([127 + n]) + bytes(
        (weights[i] << 4) | (weights[i + 1] if i + 1 < n else 0)
        for i in range(0, n, 2))

    def stream(part: bytes) -> bytes:
        bits = _Bits()
        for s in reversed(part):
            bits.put(code[s], nbits[s])
        return bits.done()

    if streams == 1:
        body = stream(literals)
    else:
        seg = (len(literals) + 3) // 4
        parts = [stream(literals[i * seg:(i + 1) * seg]) for i in range(3)]
        parts.append(stream(literals[3 * seg:]))
        body = struct.pack("<HHH", *(len(p) for p in parts[:3])) + \
            b"".join(parts)
    return tree, body


def _comp_lits_header(ltype: int, streams: int, regen: int,
                      comp: int) -> bytes:
    """A Huffman-coded (2) or treeless (3) literals header of size format
    0 (1 stream) or 1 (4 streams): 10-bit sizes."""
    assert regen < 1024 and comp < 1024
    return (ltype | (streams == 4) << 2 | regen << 4 | comp << 14).to_bytes(
        3, "little")


# LL / ML codes of small values (code = value for LL < 16, value - 3 for
# ML < 35): no extra bits
def _sequences_rle(seqs: list, modes=(1, 1, 1), codes=None) -> bytes:
    """A sequences section of (ll, offset_value, ml) with every table RLE
    (mode 1, the codes' symbols given) or repeat (mode 3)."""
    llc, ofc, mlc = codes
    n = len(seqs)
    head = bytes([n]) if n < 128 else bytes([128 + (n >> 8), n & 255])
    head += bytes([modes[0] << 6 | modes[1] << 4 | modes[2] << 2])
    for m, c in zip(modes, (llc, ofc, mlc)):
        if m == 1:
            head += bytes([c])
    bits = _Bits()
    for ll, ofv, ml in reversed(seqs):   # read: OF, ML, LL extra bits
        assert ll == llc and ml - 3 == mlc and ofv >> ofc == 1
        bits.put(ofv - (1 << ofc), ofc)
    return head + bits.done()


def hand_frames() -> dict:
    """name -> (frame, its content): frames for the header fields and
    modes no TIFF's frames hold."""
    rng = np.random.default_rng(271)
    out = {}
    tiny = bytes(rng.integers(0, 256, 40, dtype=np.uint8))
    out["fcs1_raw.zst"] = (_frame([(0, tiny, len(tiny))], tiny), tiny)
    # one RLE block of 300 bytes under each content-size field and
    # dictionary ID field of 0, with and without a single segment
    rle = b"\x2a" * 300
    for fcs, single, did in ((2, True, 1), (4, True, 2), (8, True, 4),
                             (0, False, 0), (8, False, 1)):
        out[f"fcs{fcs}_{'single' if single else 'window'}_did{did}.zst"] = (
            _frame([(1, b"\x2a", 300)], rle, fcs, single, did), rle)
    # RLE literals, then sequences with RLE tables, then a block repeating
    # them with treeless literals after a block of direct-weight Huffman
    # literals in 1 and 4 streams
    lit = b"\x05" * 12
    seqs = [(4, 1 << 5 | 3, 9)] * 3       # LL 4, offset value 35 (32), ML 9
    body = _lits_header(1, 12)[:1] + b"\x05" + _sequences_rle(
        seqs, codes=(4, 5, 6))
    # 3 sequences: 4 literals, then a match of 9 at offset 32 (needs 32
    # bytes before it: the first block is 40 raw bytes)
    first = bytes(rng.integers(0, 256, 40, dtype=np.uint8))
    content = bytearray(first)
    lits = iter(lit)
    for ll, ofv, ml in seqs:
        content += bytes(next(lits) for _ in range(ll))
        for _ in range(ml):
            content.append(content[-(ofv - 3)])
    # block 3: direct-weight Huffman literals, 4 streams, no sequences
    abc = [1, 2, 3, 7]
    hl = bytes(rng.choice(abc, 64).astype(np.uint8))
    tree, streams = _huffman(hl, 4, abc)
    b3 = _comp_lits_header(2, 4, len(hl), len(tree) + len(streams)) + tree + \
        streams + b"\x00"
    content += hl
    # block 4: treeless literals (1 stream) and the three tables repeated
    tl = bytes(rng.choice(abc, 20).astype(np.uint8))
    _, s1 = _huffman(tl, 1, abc)
    seqs4 = [(4, 1 << 5 | 3, 9)] * 2
    b4 = _comp_lits_header(3, 1, len(tl), len(s1)) + s1 + _sequences_rle(
        seqs4, modes=(3, 3, 3), codes=(4, 5, 6))
    lits4 = iter(tl)
    for ll, ofv, ml in seqs4:
        content += bytes(next(lits4) for _ in range(ll))
        for _ in range(ml):
            content.append(content[-(ofv - 3)])
    content += tl[8:]
    # block 5: Huffman literals in 1 stream
    h1 = bytes(rng.choice([0, 9, 100], 30).astype(np.uint8))
    tree, s = _huffman(h1, 1, [0, 9, 100])
    b5 = _comp_lits_header(2, 1, len(h1), len(tree) + len(s)) + tree + s + \
        b"\x00"
    content += h1
    blocks = [(0, first, len(first)), (2, body, len(body)),
              (2, b3, len(b3)), (2, b4, len(b4)), (2, b5, len(b5))]
    content = bytes(content)
    out["rle_tables_treeless_direct.zst"] = (_frame(blocks, content),
                                             content)
    return out


# --------------------------------------------------------------- write --

def write(out: Path = HERE) -> dict:
    """Write every fixture into `out` and return the manifest."""
    import PIL
    from PIL import Image, TiffImagePlugin, features

    s = seeds()
    out.mkdir(parents=True, exist_ok=True)
    files = {}
    for name, (seed, tag, strip, predictor) in PIL_FILES.items():
        info = TiffImagePlugin.ImageFileDirectory_v2()
        if predictor != 1:
            info[317] = predictor
        Image.fromarray(s[seed]).save(
            out / name, compression="zstd" if tag == ZSTD else "lzma",
            strip_size=strip, tiffinfo=info)
        files[name] = dict(seed=seed, writer="pil", compression=tag,
                           options=dict(strip_size=strip,
                                        predictor=predictor))
    for name, (seed, tag, options) in OWN_FILES.items():
        write_tiff(out / name, s[seed], own_compress(tag, options), tag,
                   tile=options.get("tile", 0),
                   predictor=options.get("predictor", 1))
        files[name] = dict(seed=seed, writer="own", compression=tag,
                           options=options)
    for name, entry in files.items():
        src = s[entry["seed"]]
        try:
            with Image.open(out / name) as im:
                got = np.asarray(im)
            twin = got.dtype == pil_view(src).dtype and np.array_equal(
                got, pil_view(src))
        except Exception:   # noqa: BLE001 — PIL refuses the layout
            got, twin = None, False
        entry["twin"] = bool(twin)
        entry["sha256"] = digest(got if twin else src)
        if entry["compression"] == ZSTD:
            chunks = chunks_of(out / name)
            modes = set()
            for c in chunks:
                modes |= walk(c)
            entry["modes"] = sorted(modes)
            if not twin:   # its frames, held against libzstd's decode
                entry["chunks"] = [hashlib.sha256(_libzstd_all(c)).hexdigest()
                                   for c in chunks]
    FRAMES.mkdir(exist_ok=True)
    frames = {}
    for name, (frame, content) in hand_frames().items():
        if zstd_decompress(frame, len(content)) != content:
            raise AssertionError(f"libzstd decodes {name} otherwise")
        (FRAMES / name).write_bytes(frame)
        frames[name] = dict(size=len(content),
                            sha256=hashlib.sha256(content).hexdigest(),
                            modes=sorted(walk(frame)))
    manifest = dict(pil=PIL.__version__, libtiff=features.version("libtiff"),
                    libzstd=libzstd().ZSTD_versionString().decode(),
                    files=files, frames=frames)
    (out / "fixtures.json").write_text(json.dumps(manifest, indent=1) + "\n")
    return manifest


def _libzstd_all(chunk: bytes) -> bytes:
    """What libzstd decodes from every frame of a chunk, in a row."""
    z = libzstd()
    cap = 1 << 22
    buf = ctypes.create_string_buffer(cap)
    n = z.ZSTD_decompress(buf, cap, chunk, len(chunk))
    if z.ZSTD_isError(n):
        raise ValueError("libzstd refuses the chunk")
    return buf.raw[:n]


def coverage(manifest: dict) -> set:
    """The union of the modes every fixture's frames use."""
    seen = set()
    for e in list(manifest["files"].values()) + list(
            manifest["frames"].values()):
        seen |= set(e.get("modes", ()))
    return seen


# ---------------------------------------- bilevel, sub-byte and planar --

BILEVEL = HERE / "bilevel"
BW_SHAPE = (21, 37)      # a width that is no multiple of 8
RUNS_WIDTH = 2700
PIL_1BIT = {             # PIL's compression -> (file tag, tiffinfo)
    "raw": ("none", {}), "packbits": ("packbits", {}),
    "tiff_adobe_deflate": ("deflate", {}), "tiff_lzw": ("lzw", {}),
    "zstd": ("zstd", {}), "lzma": ("lzma", {}), "tiff_ccitt": ("rle", {}),
    "group3": ("g3", {}), "group3/2d": ("g3_2d", {292: 1}),
    "group3/2d fill": ("g3_2d_fill", {292: 5}),
    "group3/fill": ("g3_fill", {292: 4}), "group4": ("g4", {})}
VARIANTS = {"one": {}, "strips": {278: 4}, "fill2": {266: 2},
            "photo0": {262: 0}, "all": {262: 0, 266: 2, 278: 4}}
# this module's writer: compression name -> TIFF compression
OWN_CODECS = {"none": 1, "packbits": 32773, "deflate": 8, "lzw": 5,
              "zstd": ZSTD, "lzma": LZMA}
FAX_CODECS = {"rle": (2, 0), "g3": (3, 0), "g3_2d": (3, 1), "g4": (4, 0)}


def every_run(width: int = RUNS_WIDTH) -> np.ndarray:
    """Rows in which every run length T.4 codes occurs in both colours: a
    white run of each length followed by 5 black, and 3 white then a
    black run of each length: the terminating lengths 0 to 63, make-up
    lengths from 64 to past 2560 (two make-up codes) with terminating
    remainders, and a whole row."""
    lengths = (list(range(64)) + [64 * m + (7 * m) % 64 for m in range(1, 41)]
               + [2600, width - 5])
    rows = []
    for n in lengths:
        white = np.zeros(width, bool)
        white[n:n + 5] = True
        black = np.zeros(width, bool)
        black[3:3 + n] = True
        rows += [white, black]
    rows += [np.zeros(width, bool), np.ones(width, bool)]
    return np.stack(rows)


def bilevel_seeds() -> dict:
    """name -> the array a bilevel, sub-byte or planar fixture is made
    from."""
    h, w = BW_SHAPE
    rng = np.random.default_rng(280)
    yy, xx = np.mgrid[0:h, 0:w]
    bw = ((yy - 10) ** 2 + (xx - 17) ** 2 < 60) ^ (rng.random((h, w)) < 0.1)
    bw[3:6, 2:35] = True
    field = yy * 3 + xx * 2 + rng.integers(0, 3, (h, w))
    smooth = 0.5 + 0.4 * np.sin(xx / 6.0 + yy / 9.0)
    rgb = np.clip(smooth[..., None] * [220, 160, 90]
                  + rng.normal(0, 4, (h, w, 3)), 0, 255).astype(np.uint8)
    alpha = (40 + 5 * xx + yy).astype(np.uint8)[..., None]
    out = {"bw": bw, "bw_runs": every_run(),
           "g2": (field % 4).astype(np.uint8),
           "g4": (field % 16).astype(np.uint8),
           "u8": rgb[..., 0].copy(),
           "rgb8": rgb, "rgba8": np.concatenate([rgb, alpha], 2),
           "la8": np.concatenate([rgb[..., :1], alpha], 2)}
    for k in ("rgb8", "rgba8", "la8"):
        out[k.replace("8", "16")] = out[k].astype(np.uint16) * 257 + \
            rng.integers(0, 200, out[k].shape).astype(np.uint16)
    return out


def packbits_compress(data: bytes) -> bytes:
    """PackBits: runs of 3 to 128 equal bytes, literals between."""
    out, i, n = bytearray(), 0, len(data)
    while i < n:
        j = i
        while j < n and j - i < 128 and data[j] == data[i]:
            j += 1
        if j - i >= 3:
            out += bytes([257 - (j - i), data[i]])
            i = j
            continue
        j = i + 1
        while j < n and j - i < 128 and not (
                j + 2 < n and data[j] == data[j + 1] == data[j + 2]):
            j += 1
        out += bytes([j - i - 1]) + data[i:j]
        i = j
    return bytes(out)


def lzw_compress(data: bytes) -> bytes:
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


def pil_chunks(data: bytes) -> list:
    """The strips' or tiles' bytes of a one-page TIFF in memory."""
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        p = Path(d) / "t.tif"
        p.write_bytes(data)
        return chunks_of(p)


def fax_compress(name: str, cols: int):
    """A chunk of 1-bit rows `cols` wide as PIL's libtiff fax encoder
    writes it (`name` in FAX_CODECS)."""
    import io

    from PIL import Image, TiffImagePlugin

    scheme, options = FAX_CODECS[name]
    pil = {2: "tiff_ccitt", 3: "group3", 4: "group4"}[scheme]

    def enc(data: bytes) -> bytes:
        stride = (cols + 7) // 8
        rows = np.frombuffer(data, np.uint8).reshape(-1, stride)
        img = np.unpackbits(rows, axis=1, count=cols).astype(bool)
        info = TiffImagePlugin.ImageFileDirectory_v2()
        if options:
            info[292] = options
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, "TIFF", compression=pil,
                                  tiffinfo=info)
        (chunk,) = pil_chunks(buf.getvalue())
        return chunk
    return enc


def jpeg_compress(cols: int):
    """A chunk of 8-bit gray rows `cols` wide as a whole JPEG stream
    (PIL's encoder, quality 95)."""
    import io

    from PIL import Image

    def enc(data: bytes) -> bytes:
        buf = io.BytesIO()
        Image.fromarray(np.frombuffer(data, np.uint8).reshape(-1, cols)).save(
            buf, "JPEG", quality=95)
        return buf.getvalue()
    return enc


def codec(name: str, cols: int = 0):
    """(compress, TIFF compression) of a compression name."""
    if name in FAX_CODECS:
        return fax_compress(name, cols), FAX_CODECS[name][0]
    if name == "jpeg":
        return jpeg_compress(cols), 7
    return {"none": lambda d: d, "packbits": packbits_compress,
            "deflate": zlib_compress, "lzw": lzw_compress,
            "zstd": zstd_compress, "lzma": lzma_compress}[name], \
        OWN_CODECS[name]


def fax_tags(name: str) -> dict:
    """Group3Options of a two-dimensional T.4 chunk from fax_compress."""
    options = FAX_CODECS.get(name, (0, 0))[1]
    return {292: (4, [options])} if options else {}


def zlib_compress(data: bytes) -> bytes:
    import zlib

    return zlib.compress(data)


def palette(bits: int) -> tuple:
    """A ColorMap of 2**bits entries (SHORT, red then green then blue)."""
    n = 1 << bits
    ramp = [int(65535 * i / (n - 1)) for i in range(n)]
    return (3, ramp + ramp[::-1] + [ramp[i // 2] for i in range(n)])


def own_bilevel_files() -> dict:
    """This module's bilevel, sub-byte and planar files: name -> (seed,
    compression name, write_tiff options)."""
    files = {}
    for bits, seed in ((2, "g2"), (4, "g4")):
        for c in OWN_CODECS:
            files[f"own_{bits}bit_{c}_strips.tif"] = (
                seed, c, dict(bits=bits, rows=4))
            files[f"own_{bits}bit_{c}_tiles.tif"] = (
                seed, c, dict(bits=bits, tile=16, photometric=0))
            files[f"own_{bits}bit_{c}_palette.tif"] = (
                seed, c, dict(bits=bits, rows=8, photometric=3,
                              tags={320: palette(bits), 266: (3, [2])}))
    for c in list(OWN_CODECS) + list(FAX_CODECS):
        files[f"own_1bit_{c}_tiles.tif"] = ("bw", c, dict(bits=1, tile=16))
    files.update({
        "own_1bit_lzw_palette.tif": ("bw", "lzw", dict(
            bits=1, rows=8, photometric=3, tags={320: palette(1)})),
        # no PhotometricInterpretation: PIL takes 0, white is zero
        "own_1bit_none_nophoto.tif": ("bw", "none", dict(
            bits=1, tags={262: None})),
        "own_8bit_lzw_nophoto.tif": ("u8", "lzw", dict(tags={262: None})),
        # a predictor on sub-byte samples: libtiff refuses it where it
        # applies one (LZW, deflate, zstd, LZMA), ignores it elsewhere
        "own_4bit_lzw_p2.tif": ("g4", "lzw", dict(bits=4, predictor=2)),
        "own_1bit_deflate_p2.tif": ("bw", "deflate", dict(bits=1,
                                                           predictor=2)),
        "own_4bit_packbits_p2.tif": ("g4", "packbits", dict(bits=4,
                                                             predictor=2)),
        "own_1bit_g4_p2.tif": ("bw", "g4", dict(bits=1, predictor=2)),
        # gray + alpha in one plane without ExtraSamples: PIL has no mode
        "own_lzw_la8_noextra.tif": ("la8", "lzw", dict(rows=8)),
        # PIL reads no 4-bit RGB, nor 2-bit samples as RGB
        "own_4bit_none_rgb.tif": ("g4", "none", dict(
            bits=4, tags={258: (3, [4, 4, 4]), 277: (3, [3]),
                          262: (3, [2])})),
        "own_2bit_none_photo2.tif": ("g2", "none", dict(
            bits=2, photometric=2)),
    })
    for kind in ("la8", "rgb8", "rgba8", "la16", "rgb16", "rgba16"):
        extra = {338: (3, [2])} if "a" in kind else {}   # unassociated
        for c in ("lzw", "zstd", "lzma"):
            files[f"own_planar_{c}_{kind}_strips.tif"] = (
                kind, c, dict(planar=2, rows=4, tags=extra))
            files[f"own_planar_{c}_{kind}_tiles.tif"] = (
                kind, c, dict(planar=2, tile=16, tags=extra))
    for c in ("lzw", "zstd", "lzma"):
        files[f"own_planar_{c}_rgb16_p2_strips.tif"] = (
            "rgb16", c, dict(planar=2, rows=4, predictor=2))
        files[f"own_planar_{c}_rgba8_p2_tiles.tif"] = (
            "rgba8", c, dict(planar=2, tile=16, predictor=2,
                             tags={338: (3, [2])}))
    # separate planes as whole gray JPEG streams, which libtiff reads
    files["own_planar_jpeg_rgb8_strips.tif"] = ("rgb8", "jpeg", dict(
        planar=2, rows=8))
    files["own_planar_jpeg_rgb8_tiles.tif"] = ("rgb8", "jpeg", dict(
        planar=2, tile=16))
    # where the JAX package's own reader fails on separate planes
    for c in ("none", "deflate", "packbits"):
        files[f"own_planar_{c}_rgb8_strips.tif"] = (
            "rgb8", c, dict(planar=2, rows=8))
    return files


def write_bilevel(out: Path = BILEVEL) -> dict:
    """Write every bilevel, sub-byte and planar fixture into `out`, with
    PIL's reading of each, and return the manifest."""
    import PIL
    from PIL import Image, TiffImagePlugin, features

    s = bilevel_seeds()
    out.mkdir(parents=True, exist_ok=True)
    files = {}
    for comp, (tag, base) in PIL_1BIT.items():
        for variant, extra in VARIANTS.items():
            info = TiffImagePlugin.ImageFileDirectory_v2()
            for k, v in {**base, **extra}.items():
                info[k] = v
            name = f"pil_1bit_{tag}_{variant}.tif"
            Image.fromarray(s["bw"]).save(out / name,
                                          compression=comp.split("/")[0],
                                          tiffinfo=info)
            files[name] = dict(seed="bw", writer="pil", compression=tag,
                               options={str(k): v for k, v in
                                        {**base, **extra}.items()})
    for tag in FAX_CODECS:
        name = f"pil_1bit_{tag}_runs.tif"
        compress, comp = codec(tag, RUNS_WIDTH)
        write_tiff(out / name, s["bw_runs"], compress, comp, bits=1,
                   rows=64, tags=fax_tags(tag))
        files[name] = dict(seed="bw_runs", writer="pil fax", compression=tag,
                           options=dict(rows=64))
    info = TiffImagePlugin.ImageFileDirectory_v2()
    info[266] = 2
    Image.fromarray(s["u8"]).save(out / "pil_8bit_lzw_fill2.tif",
                                  compression="tiff_lzw", tiffinfo=info)
    files["pil_8bit_lzw_fill2.tif"] = dict(seed="u8", writer="pil",
                                           compression="lzw",
                                           options={"266": 2})
    for name, (seed, c, options) in own_bilevel_files().items():
        a = s[seed]
        compress, comp = codec(c, options.get("tile") or a.shape[1])
        options = dict(options, tags={**fax_tags(c),
                                      **options.get("tags", {})})
        write_tiff(out / name, a, compress, comp, **options)
        files[name] = dict(seed=seed, writer="own", compression=c,
                           options={k: v for k, v in options.items()
                                    if k != "tags"})
    for name, entry in files.items():
        try:
            with Image.open(out / name) as im:
                got = np.asarray(im)
            entry["pil"] = "reads"
            entry["sha256"] = digest(got)
        except Exception as e:   # noqa: BLE001 — PIL refuses the layout
            entry["pil"] = f"raises {type(e).__name__}"
    manifest = dict(pil=PIL.__version__, libtiff=features.version("libtiff"),
                    files=files)
    (out / "bilevel.json").write_text(json.dumps(manifest, indent=1) + "\n")
    return manifest


if __name__ == "__main__":
    import sys

    which = sys.argv[1:] or ["zstd", "bilevel"]
    if "zstd" in which:
        m = write()
        size = sum(p.stat().st_size for p in HERE.glob("*") if p.is_file())
        size += sum(p.stat().st_size for p in FRAMES.glob("*"))
        missing = sorted(set(MODES + HEADERS) - coverage(m))
        print(f"{len(m['files'])} TIFFs "
              f"({sum(e['twin'] for e in m['files'].values())}"
              f" read by PIL), {len(m['frames'])} frames, {size / 1e3:.0f} "
              f"kB; PIL {m['pil']}, libtiff {m['libtiff']}, libzstd "
              f"{m['libzstd']}; modes missing: {missing}")
    if "bilevel" in which:
        m = write_bilevel()
        size = sum(p.stat().st_size for p in BILEVEL.glob("*"))
        reads = sum(e["pil"] == "reads" for e in m["files"].values())
        print(f"bilevel: {len(m['files'])} TIFFs ({reads} read by PIL), "
              f"{size / 1e3:.0f} kB; PIL {m['pil']}, libtiff {m['libtiff']}")
