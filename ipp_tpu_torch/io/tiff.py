"""TIFF codec — numpy-native reader/writer with atomic commits and retries.

Replaces the reference's tifffile/PIL/bfconvert fallback chain
(reference imread_tif_raw_png / imsave_tif, pystripe/core.py:200-334) with:

- a from-scratch numpy TIFF parser (classic + BigTIFF, strips + tiles,
  uncompressed / deflate / PackBits / LZW / JPEG / zstd / LZMA / CCITT
  fax, grayscale u8/u16/u32/f32, 1-, 2- and 4-bit samples),
- the port's own codecs where the reference falls back to PIL: planes the
  numpy codec leaves (LZW and JPEG with their predictors and tables, zstd
  through io/zstd.py, LZMA through Python's lzma module, CCITT RLE, Group
  3 and Group 4 fax through io/ccitt.py, 1- to 4-bit samples, FillOrder 2,
  separate colour planes in LZW, JPEG, zstd and LZMA, PIL's view of their
  samples: io/tiffcodec.py) and every other format, by the file's
  signature (io/generic2d.read_plane),
- loud refusals: an encoding the port does not read (old-style JPEG,
  PixarLog, SGILog, WebP, ..., a predictor on sub-byte samples, separate
  colour planes outside LZW, JPEG, zstd and LZMA) raises
  UnsupportedTiffError at once, without retries, and the readers that
  zero-fill a damaged plane (native.read_block, TileStack.imread) let it
  pass,
- atomic tmp->rename writes so readers never observe partial files
  (reference: pystripe/core.py:304-314),
- bounded retry loops for flaky network filesystems
  (reference NUM_RETRIES, pystripe/core.py:83,204-264).

The writer emits single-strip-per-chunk grayscale TIFFs (optionally
zlib-compressed) that round-trip through this reader, PIL, and ImageJ.
"""

from __future__ import annotations

import os
import struct
import time
import zlib
from pathlib import Path
from typing import Optional, Tuple, Union

import numpy as np

from .imgcodec import UnsupportedCodecError

__all__ = ["imread", "imwrite", "read_tiff", "read_tiff_partial",
           "read_tiff_stack", "write_tiff_stack", "write_tiff", "TiffError",
           "UnsupportedTiffError"]

NUM_RETRIES = 10
RETRY_SLEEP = 0.2

# TIFF tag ids
_T_WIDTH = 256
_T_LENGTH = 257
_T_BITS = 258
_T_COMPRESSION = 259
_T_PHOTOMETRIC = 262
_T_FILL_ORDER = 266
_T_STRIP_OFFSETS = 273
_T_SAMPLES_PER_PIXEL = 277
_T_ROWS_PER_STRIP = 278
_T_STRIP_BYTE_COUNTS = 279
_T_PLANAR_CONFIG = 284
_T_GROUP3_OPTIONS = 292
_T_PREDICTOR = 317
_T_TILE_WIDTH = 322
_T_TILE_LENGTH = 323
_T_TILE_OFFSETS = 324
_T_TILE_BYTE_COUNTS = 325
_T_SAMPLE_FORMAT = 339
_T_JPEG_TABLES = 347

_TYPE_SIZES = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8,
               11: 4, 12: 8, 16: 8, 17: 8, 18: 8}
_TYPE_FMT = {1: "B", 3: "H", 4: "I", 6: "b", 8: "h", 9: "i", 11: "f",
             12: "d", 16: "Q", 17: "q"}


class TiffError(RuntimeError):
    pass


class UnsupportedTiffError(TiffError):
    """A well-formed TIFF in an encoding the port does not read (its
    compression, sample size or layout is named): never retried, never
    zero-filled."""


# libtiff's registered compressions that the port does not read, by name
_REFUSED = {6: "old-style JPEG", 9: "JBIG (T.85)", 10: "JBIG2 (T.43)",
            32766: "NeXT 2-bit RLE", 32771: "CCITT RLEW",
            32809: "ThunderScan", 32895: "IT8 CT padding",
            32896: "IT8 linework RLE", 32897: "IT8 monochrome picture",
            32898: "IT8 binary line art", 32908: "PixarFilm",
            32909: "PixarLog", 32947: "Kodak DCS", 34661: "JBIG",
            34676: "SGILog", 34677: "SGILog24", 34712: "JPEG 2000",
            34887: "LERC", 34892: "lossy JPEG (DNG)", 50001: "WebP",
            50002: "JPEG XL"}
_XZ_MAGIC = b"\xfd7zXZ\0"
_FAX = (2, 3, 4)                 # CCITT RLE, Group 3, Group 4
# the compressions the JAX package gives PIL (libtiff): LZW, JPEG, LZMA,
# zstd and fax; it gives PIL every page of 1- to 4-bit samples too
_LIBTIFF = _FAX + (5, 7, 34925, 50000)
# compressions under which libtiff applies a predictor (and refuses one on
# sub-byte samples)
_PREDICTED = (5, 8, 32946, 34925, 50000)
# separate colour planes are read in LZW, JPEG, LZMA and zstd, which the
# JAX package gives PIL; its own reader fails on them in these
_PLANAR_REFUSED = {1: "uncompressed", 8: "deflate", 32946: "deflate",
                   32773: "PackBits"}
# each byte with its bits in reverse order (FillOrder 2)
_BIT_REVERSED = bytes(int(f"{i:08b}"[::-1], 2) for i in range(256))


def _unpackbits_decode(data: bytes, expected: int) -> bytes:
    """PackBits (RLE) decode."""
    out = bytearray()
    i = 0
    n = len(data)
    while i < n and len(out) < expected:
        h = data[i]
        i += 1
        if h < 128:
            out += data[i:i + h + 1]
            i += h + 1
        elif h > 128:
            out += data[i:i + 1] * (257 - h)
            i += 1
    return bytes(out)


class _TiffPage:
    def __init__(self, width, length, bits, compression, sample_format,
                 samples, rows_per_strip, strip_offsets, strip_counts,
                 tile_w, tile_l, tile_offsets, tile_counts, predictor,
                 photometric=1, planar=1, jpeg_tables=b"",
                 fill_order=1, fax_options=0):
        self.width = width
        self.length = length
        self.bits = bits
        self.compression = compression
        self.sample_format = sample_format
        self.samples = samples
        self.rows_per_strip = rows_per_strip
        self.strip_offsets = strip_offsets
        self.strip_counts = strip_counts
        self.tile_w = tile_w
        self.tile_l = tile_l
        self.tile_offsets = tile_offsets
        self.tile_counts = tile_counts
        self.predictor = predictor
        self.photometric = photometric
        self.planar = planar
        self.jpeg_tables = jpeg_tables
        self.fill_order = fill_order
        self.fax_options = fax_options     # Group3Options under compression 3

    @property
    def dtype(self) -> np.dtype:
        """The stored samples' type (uint8 for 1- to 4-bit samples)."""
        kind = {1: "u", 2: "i", 3: "f"}.get(self.sample_format, "u")
        return np.dtype(f"{kind}{max(1, self.bits // 8)}")

    @property
    def libtiff(self) -> bool:
        """Whether the JAX package reads this page through PIL (libtiff)
        rather than its own numpy reader."""
        return self.bits < 8 or self.compression in _LIBTIFF

    @property
    def reverse_bits(self) -> bool:
        """FillOrder 2 as libtiff reads it: the raw bytes of every chunk
        reversed, for every codec but JPEG (the fax codecs read them
        reversed, which is the same)."""
        return (self.fill_order == 2 and self.compression != 7
                and self.libtiff)


def _parse_ifds(f, byteorder: str, big: bool):
    """Yield dicts of tag -> values for each IFD."""
    bo = byteorder
    if big:
        off_fmt, cnt_fmt, entry_sz, inline = "Q", "Q", 20, 8
        f.seek(8)
        ifd_off = struct.unpack(bo + "Q", f.read(8))[0]
    else:
        off_fmt, cnt_fmt, entry_sz, inline = "I", "H", 12, 4
        f.seek(4)
        ifd_off = struct.unpack(bo + "I", f.read(4))[0]
    while ifd_off:
        f.seek(ifd_off)
        n_entries = struct.unpack(bo + cnt_fmt, f.read(struct.calcsize(cnt_fmt)))[0]
        raw = f.read(n_entries * entry_sz)
        tags = {}
        for i in range(n_entries):
            e = raw[i * entry_sz:(i + 1) * entry_sz]
            if big:
                tag, typ, count = struct.unpack(bo + "HHQ", e[:12])
                val_bytes = e[12:20]
            else:
                tag, typ, count = struct.unpack(bo + "HHI", e[:8])
                val_bytes = e[8:12]
            size = _TYPE_SIZES.get(typ, 1) * count
            if size > 1 << 27:
                # corrupt count: a 128 MB tag value is far beyond any
                # legitimate strip table; building the struct format
                # string alone would stall for minutes
                raise TiffError(f"implausible tag {tag} size {size}")
            if size <= inline:
                data = val_bytes[:size]
            else:
                off = struct.unpack(bo + off_fmt, val_bytes)[0]
                pos = f.tell()
                f.seek(off)
                data = f.read(size)
                f.seek(pos)
            fmt = _TYPE_FMT.get(typ)
            if fmt:
                vals = struct.unpack(bo + fmt * count, data)
            else:
                vals = (data,)
            tags[tag] = vals
        nxt = f.read(struct.calcsize(off_fmt))
        ifd_off = struct.unpack(bo + off_fmt, nxt)[0]
        yield tags


def _page_from_tags(tags) -> _TiffPage:
    def one(tag, default=None):
        v = tags.get(tag)
        return v[0] if v else default

    width = one(_T_WIDTH)
    length = one(_T_LENGTH)
    if width is None or length is None:
        raise TiffError("missing dimensions")
    # sanity cap so corrupt headers can't trigger absurd allocations
    # (stitched whole-brain planes are ~60k x 60k; 2^22 per axis and
    # 64 GB total are far above any legitimate plane)
    if not (0 < width <= 1 << 22 and 0 < length <= 1 << 22):
        raise TiffError(f"implausible dimensions {width}x{length}")
    bits = one(_T_BITS, 1)
    comp = one(_T_COMPRESSION, 1)
    sfmt = one(_T_SAMPLE_FORMAT, 1)
    samples = one(_T_SAMPLES_PER_PIXEL, 1)
    if not (0 < samples <= 16 and (bits in (1, 2, 4) or
                                   (0 < bits <= 64 and bits % 8 == 0))):
        raise TiffError(f"implausible bits/samples {bits}/{samples}")
    if int(width) * int(length) * samples * bits > 1 << 39:
        raise TiffError("implausible plane size")
    rps = one(_T_ROWS_PER_STRIP, length)
    predictor = one(_T_PREDICTOR, 1)
    planar = one(_T_PLANAR_CONFIG, 1)
    fill = one(_T_FILL_ORDER, 1)
    page = _TiffPage(
        width, length, bits, comp, sfmt, samples, rps,
        tags.get(_T_STRIP_OFFSETS), tags.get(_T_STRIP_BYTE_COUNTS),
        one(_T_TILE_WIDTH), one(_T_TILE_LENGTH),
        tags.get(_T_TILE_OFFSETS), tags.get(_T_TILE_BYTE_COUNTS), predictor,
        one(_T_PHOTOMETRIC, 1), planar, one(_T_JPEG_TABLES, b""), fill,
        one(_T_GROUP3_OPTIONS, 0) if comp == 3 else 0)
    if bits < 8:
        if samples != 1:
            raise UnsupportedTiffError(
                f"{bits}-bit samples, {samples} a pixel, are not read (one "
                f"a pixel is)")
        if sfmt != 1:
            raise UnsupportedTiffError(f"{bits}-bit samples of SampleFormat "
                                       f"{sfmt} are not read")
        if predictor != 1 and comp in _PREDICTED:
            raise UnsupportedTiffError(
                f"predictor {predictor} on {bits}-bit samples is not read "
                f"(libtiff refuses it)")
    if comp in _FAX and bits != 1:
        raise UnsupportedTiffError(f"CCITT fax of {bits}-bit samples is not "
                                   f"read (libtiff reads 1-bit fax only)")
    if page.libtiff and fill not in (1, 2):   # PIL knows no other
        raise UnsupportedTiffError(f"FillOrder {fill} is not read")
    if planar == 2 and samples > 1 and comp in _PLANAR_REFUSED:
        raise UnsupportedTiffError(
            f"TIFF with separate colour planes is not read "
            f"{_PLANAR_REFUSED[comp]} (LZW, JPEG, LZMA and zstd are)")
    if planar == 2 and samples > 1 and page.photometric == 6:
        raise UnsupportedTiffError("YCbCr TIFF with separate colour planes "
                                   "is not read")
    return page


def _decompress(data: bytes, page: _TiffPage, expected: int, rows: int,
                cols: int) -> bytes:
    """The bytes of a strip or tile of `rows` x `cols` pixels.  LZW and
    JPEG decode in the codec library (io/imgcodec.py), zstd in its own
    (io/zstd.py), CCITT fax in its own (io/ccitt.py, with the page's
    Group3Options), LZMA (an .xz stream, as libtiff writes it) through
    Python's lzma module; a JPEG strip that leaves its tables to the
    page's JPEGTables (tag 347) takes them from there.  JPEG components
    turn from YCbCr to RGB only under photometric 6, as libtiff turns them
    for PIL; under any other photometric they come as stored.  Predictors
    are _decode_chunk's.  A compression the port does not read raises
    UnsupportedTiffError naming it."""
    compression = page.compression
    if compression == 1:
        return data
    if compression in (8, 32946):  # deflate / old-style deflate
        return zlib.decompress(data)
    if compression == 32773:  # PackBits
        return _unpackbits_decode(data, expected)
    if compression == 34925:
        return _lzma_decode(data, expected)
    if compression in _FAX + (5, 7, 50000):  # fax / LZW / JPEG / zstd
        from . import ccitt, imgcodec, zstd

        try:
            if compression == 5:
                return imgcodec.lzw_decode(data, expected)
            if compression == 50000:
                return zstd.zstd_decode(data, expected)
            if compression in _FAX:
                return ccitt.ccitt_decode(data, rows, cols, compression,
                                          page.fax_options)
            return imgcodec.jpeg_decode(data, page.jpeg_tables,
                                        page.photometric == 6).tobytes()
        except imgcodec.UnsupportedCodecError as e:
            raise UnsupportedTiffError(str(e)) from None
        except imgcodec.CodecError as e:
            raise TiffError(str(e)) from None
    raise _refused(compression)


def _refused(compression: int) -> TiffError:
    """The error for a compression the port does not read: an
    UnsupportedTiffError naming it where libtiff registers it, else a
    TiffError (a damaged tag, most likely)."""
    name = _REFUSED.get(compression)
    if name is None:
        return TiffError(f"unsupported compression {compression}")
    return UnsupportedTiffError(
        f"TIFF compression {compression} ({name}) is not read (none, "
        f"deflate, PackBits, LZW, JPEG, LZMA, zstd and CCITT fax are)")


def _lzma_decode(data: bytes, expected: int) -> bytes:
    """Up to `expected` bytes of the one .xz stream that libtiff's LZMA
    codec writes a strip as."""
    if not data.startswith(_XZ_MAGIC):
        raise TiffError("LZMA: the strip is not an .xz stream")
    try:
        import lzma
    except ImportError as e:
        raise UnsupportedTiffError(
            f"LZMA TIFF needs Python's _lzma module, which this Python lacks "
            f"({e})") from None
    try:
        return lzma.LZMADecompressor(lzma.FORMAT_XZ).decompress(
            data, max_length=expected)
    except lzma.LZMAError as e:
        raise TiffError(f"LZMA: {e}") from None


def _undo_float_predictor(rows: np.ndarray, dtype: np.dtype,
                          samples: int) -> np.ndarray:
    """TIFF predictor 3 on (n, w * samples * itemsize) bytes: each row's
    bytes summed along the row with a stride of `samples`, then the byte
    planes (most significant first) interleaved into values."""
    n, nbytes = rows.shape
    size = dtype.itemsize
    w = nbytes // (samples * size)
    acc = rows.reshape(n, nbytes // samples, samples)
    acc = np.cumsum(acc, axis=1, dtype=np.uint8).reshape(n, size, w * samples)
    # byte plane k holds the k-th most significant byte of every value
    be = np.ascontiguousarray(acc.transpose(0, 2, 1))
    return be.view(dtype.newbyteorder(">")).reshape(n, w * samples)


def _decode_chunk(raw: bytes, page: _TiffPage, dtype: np.dtype, rows: int,
                  cols: int, samples: int) -> np.ndarray:
    """One strip or tile of `rows` x `cols` pixels of `samples` samples
    as (rows, cols * samples) values of `dtype`: its bits reversed under
    FillOrder 2, decompressed, its predictor undone (2: horizontal
    differencing; 3: floating point, bytes re-interleaved), or, for 1- to
    4-bit samples, each row (padded to a byte) unpacked, most significant
    bits first, into one uint8 a sample (no predictor: libtiff ignores it
    in none, PackBits and fax)."""
    s = samples
    if page.bits < 8:
        stride = (cols * page.bits + 7) // 8
        expected = rows * stride
    else:
        expected = rows * cols * s * dtype.itemsize
    if page.compression in (5, 7, 34925, 50000):    # PIL's (libtiff's)
        if page.photometric == 6 and page.compression != 7:
            raise UnsupportedTiffError("YCbCr TIFF outside JPEG is not read")
        if page.compression == 7 and page.bits != 8:
            raise UnsupportedTiffError(f"JPEG TIFF of {page.bits}-bit "
                                       f"samples is not read (8-bit is)")
    if page.reverse_bits:
        raw = raw.translate(_BIT_REVERSED)
    raw = _decompress(raw, page, expected, rows, cols)
    if len(raw) < expected:
        raise TiffError(f"a chunk of {len(raw)} bytes, {expected} expected")
    if page.bits < 8:
        return _unpack_bits(np.frombuffer(raw, np.uint8, expected).reshape(
            rows, stride), page.bits, cols)
    if page.predictor == 3:
        if dtype.kind != "f":
            raise TiffError("predictor 3 on integer samples")
        return _undo_float_predictor(
            np.frombuffer(raw, np.uint8, expected).reshape(rows, -1),
            dtype, s)
    arr = np.frombuffer(raw, dtype, rows * cols * s).reshape(rows, cols * s)
    if page.predictor == 2:
        if dtype.kind == "f":   # libtiff differences a float's bits
            bits = np.dtype(f"u{dtype.itemsize}").newbyteorder(dtype.byteorder)
            return _undo_predictor(arr.view(bits).copy(), 2, s).view(dtype)
        arr = _undo_predictor(arr.copy(), 2, s)
    return arr


def _unpack_bits(rows: np.ndarray, bits: int, cols: int) -> np.ndarray:
    """(n, stride) bytes of packed `bits`-bit samples, most significant
    first, as (n, cols) uint8 values."""
    if bits == 1:
        return np.unpackbits(rows, axis=1, count=cols)
    # each byte's 2 or 4 samples in one 16- or 32-bit table entry
    return _UNPACKED[bits].take(rows).view(np.uint8).reshape(
        len(rows), -1)[:, :cols]


# byte -> its samples at 2 and 4 bits, most significant first, as one
# uint32 / uint16 (its bytes in order)
_UNPACKED = {b: ((np.arange(256, dtype=np.uint8)[:, None]
                  >> np.arange(8 - b, -1, -b, dtype=np.uint8))
                 & np.uint8((1 << b) - 1)).view(f"u{8 // b}").ravel()
             for b in (2, 4)}


def _undo_predictor(arr: np.ndarray, predictor: int,
                    samples: int = 1) -> np.ndarray:
    """Undo horizontal differencing.  TIFF predictor=2 differences per
    sample channel, so interleaved RGB rows must cumsum along the width
    axis with the channel axis kept separate."""
    if predictor == 2:
        if samples > 1:
            rows = arr.shape[0]
            v = arr.reshape(rows, -1, samples)
            np.cumsum(v, axis=1, dtype=v.dtype, out=v)
        else:
            np.cumsum(arr, axis=-1, dtype=arr.dtype, out=arr)
    return arr


def _read_tiff_header(f):
    """Parse the II/MM + 42/43 prologue; returns (byteorder, is_bigtiff)
    with the stream positioned at the first-IFD offset field."""
    head = f.read(4)
    if head[:2] == b"II":
        bo = "<"
    elif head[:2] == b"MM":
        bo = ">"
    else:
        raise TiffError("not a TIFF")
    magic = struct.unpack(bo + "H", head[2:4])[0]
    if magic == 42:
        return bo, False
    if magic == 43:
        f.read(4)  # offset size + pad
        return bo, True
    raise TiffError("bad magic")


def read_tiff(path: Union[str, Path], page_index: int = 0) -> np.ndarray:
    """Read one page of a TIFF into a numpy array (native codec path)."""
    with open(path, "rb") as f:
        bo, big = _read_tiff_header(f)
        for idx, tags in enumerate(_parse_ifds(f, bo, big)):
            if idx != page_index:
                continue
            return _read_page(f, _page_from_tags(tags), bo)[0]
    raise TiffError(f"page {page_index} not found")


def _read_page(f, page: _TiffPage, bo: str,
               salvage: bool = False) -> Tuple[np.ndarray, int]:
    """(the page's samples, the chunks that did not decode): (h, w) or
    (h, w, samples).  Without `salvage` a chunk that does not decode
    raises; with it, it stays zero and is counted."""
    dtype = page.dtype.newbyteorder(bo)
    h, w, s = page.length, page.width, page.samples
    out = np.zeros((h, w, s), dtype.newbyteorder("="))
    if page.tile_offsets:
        failed = _read_tiled(f, page, dtype, out, salvage)
    else:
        failed = _read_striped(f, page, dtype, out, salvage)
    return (out if s > 1 else out.reshape(h, w)), failed


def _planes(page: _TiffPage) -> int:
    """Chunks that hold one sample each, one plane after another
    (PlanarConfiguration 2), or all samples together."""
    return page.samples if page.planar == 2 else 1


def _read_chunk(f, page: _TiffPage, dtype, out: np.ndarray, off: int,
                count: Optional[int], y0: int, x0: int, rows: int, cols: int,
                plane: int) -> None:
    """Decode one strip or tile of `rows` x `cols` pixels at `off` and put
    it at (y0, x0) of `out`, in sample `plane` of separate planes."""
    h, w, s = out.shape
    cs = s // _planes(page)
    if count is None:   # no byte counts: as many as the samples fill
        count = rows * ((cols * cs * page.bits + 7) // 8)
    f.seek(off)
    raw = f.read(count)
    if page.libtiff and len(raw) < count:   # libtiff's read error
        raise TiffError(f"the file ends inside a chunk ({len(raw)} of its "
                        f"{count} bytes)")
    chunk = _decode_chunk(raw, page, dtype, rows, cols, cs)
    ny, nx = min(rows, h - y0), min(cols, w - x0)
    out[y0:y0 + ny, x0:x0 + nx, plane * cs:(plane + 1) * cs] = \
        chunk.reshape(rows, cols, cs)[:ny, :nx]


def _read_striped(f, page: _TiffPage, dtype, out: np.ndarray,
                  salvage: bool) -> int:
    """Fill `out` from the page's strips: each plane's strips in turn
    under separate planes.  Returns the strips that did not decode (with
    `salvage`; otherwise the first raises, as a missing strip does)."""
    h, w = page.length, page.width
    rps = min(page.rows_per_strip, h)
    per_plane = -(-h // rps)
    offsets = page.strip_offsets
    counts = page.strip_counts or [None] * len(offsets)
    if len(offsets) < per_plane * _planes(page) and not salvage:
        planes = (f" ({_planes(page)} separate colour planes of {per_plane})"
                  if _planes(page) > 1 else "")
        raise TiffError(f"{len(offsets)} strips, {per_plane * _planes(page)} "
                        f"expected{planes}")
    failed = 0
    for i, off in enumerate(offsets[:per_plane * _planes(page)]):
        plane, k = divmod(i, per_plane)
        try:
            _read_chunk(f, page, dtype, out, off, counts[i], k * rps, 0,
                        min(rps, h - k * rps), w, plane)
        except Exception:
            if not salvage:
                raise
            failed += 1
    return failed


def _read_tiled(f, page: _TiffPage, dtype, out: np.ndarray,
                salvage: bool) -> int:
    """Fill `out` from the page's tiles (edge tiles cut to the page): each
    plane's tiles in turn under separate planes; missing tiles stay zero.
    Returns the tiles that did not decode (with `salvage`; otherwise the
    first raises)."""
    tw, tl = page.tile_w, page.tile_l
    ntx = -(-page.width // tw)
    per_plane = ntx * -(-page.length // tl)
    failed = 0
    for i, off in enumerate(page.tile_offsets[:per_plane * _planes(page)]):
        plane, k = divmod(i, per_plane)
        ty, tx = divmod(k, ntx)
        try:
            _read_chunk(f, page, dtype, out, off, page.tile_counts[i],
                        ty * tl, tx * tw, tl, tw, plane)
        except Exception:
            if not salvage:
                raise
            failed += 1
    return failed


def read_tiff_stack(path: Union[str, Path]) -> np.ndarray:
    """Read ALL pages of a multi-page TIFF into a (Z, H, W[, S]) array —
    the 3D-TIFF role of TeraStitcher's tiff3D iomanager plugin
    (src/iomanager/plugins/tiff3D)."""
    with open(path, "rb") as f:
        bo, big = _read_tiff_header(f)
        planes = []
        for tags in _parse_ifds(f, bo, big):
            planes.append(_read_page(f, _page_from_tags(tags), bo)[0])
            if len(planes) > 65535:
                raise TiffError("implausible page count (IFD cycle?)")
    if not planes:
        raise TiffError("no pages")
    return np.stack(planes)


def write_tiff_stack(path: Union[str, Path], vol: np.ndarray,
                     compression: Optional[str] = None) -> None:
    """Write a (Z, H, W) volume as one multi-page TIFF (tiff3D plugin
    role).  Pages are written as independent IFDs chained in order."""
    vol = np.ascontiguousarray(vol)
    if vol.ndim != 3:
        raise TiffError(f"expected (Z, H, W), got {vol.shape}")
    # write each page to bytes via the single-page writer, then splice the
    # IFD chains: simplest correct approach at our page counts
    parts = []
    for z in range(vol.shape[0]):
        import tempfile

        with tempfile.NamedTemporaryFile(suffix=".tif", delete=False) as tf:
            tmp_name = tf.name
        write_tiff(tmp_name, vol[z], compression=compression)
        parts.append(Path(tmp_name).read_bytes())
        os.unlink(tmp_name)
    # relocate: page k's offsets shift by the cumulative size of pages
    # before it (header of later pages dropped, IFD offsets patched)
    out = bytearray()
    bo = "<"
    next_ifd_patch_pos = None
    for k, data in enumerate(parts):
        base = len(out)
        if k == 0:
            out += data
            # first IFD offset lives at byte 4 (classic) — pages we write
            # are always classic little-endian from write_tiff unless big
        else:
            # shift every offset in this page's IFD by base - 0 minus the
            # 8-byte header we drop... simpler: keep the full page bytes
            # (header too) and point the previous IFD chain at
            # base + first_ifd_offset; readers follow offsets absolutely,
            # so intra-page offsets must ALSO shift — rewrite them.
            shifted = _shift_tiff_offsets(data, base)
            out += shifted
        # find this page's first IFD offset and the position of its
        # next-IFD pointer so the following page can be chained
        magic = struct.unpack_from(bo + "H", data, 2)[0]
        big = magic == 43
        if big:
            first_ifd = struct.unpack_from(bo + "Q", data, 8)[0]
            n = struct.unpack_from(bo + "Q", data, first_ifd)[0]
            next_ptr = first_ifd + 8 + n * 20
            ptr_fmt = "Q"
        else:
            first_ifd = struct.unpack_from(bo + "I", data, 4)[0]
            n = struct.unpack_from(bo + "H", data, first_ifd)[0]
            next_ptr = first_ifd + 2 + n * 12
            ptr_fmt = "I"
        if next_ifd_patch_pos is not None:
            struct.pack_into(bo + ptr_fmt, out, next_ifd_patch_pos,
                             base + first_ifd)
        next_ifd_patch_pos = base + next_ptr
    path = Path(path)
    tmp = path.with_suffix(path.suffix + ".tmp")
    tmp.write_bytes(bytes(out))
    os.replace(tmp, path)


def _shift_tiff_offsets(data: bytes, delta: int) -> bytes:
    """Shift all absolute file offsets in a single-page classic/BigTIFF
    produced by write_tiff by `delta` (IFD offset, out-of-line tag values,
    strip offsets)."""
    buf = bytearray(data)
    bo = "<"
    magic = struct.unpack_from(bo + "H", buf, 2)[0]
    big = magic == 43
    if big:
        first_ifd = struct.unpack_from(bo + "Q", buf, 8)[0]
        struct.pack_into(bo + "Q", buf, 8, first_ifd + delta)
        n = struct.unpack_from(bo + "Q", buf, first_ifd)[0]
        entry0, esz, inline, off_fmt = first_ifd + 8, 20, 8, "Q"
    else:
        first_ifd = struct.unpack_from(bo + "I", buf, 4)[0]
        struct.pack_into(bo + "I", buf, 4, first_ifd + delta)
        n = struct.unpack_from(bo + "H", buf, first_ifd)[0]
        entry0, esz, inline, off_fmt = first_ifd + 2, 12, 4, "I"
    for i in range(n):
        e = entry0 + i * esz
        tag, typ = struct.unpack_from(bo + "HH", buf, e)
        count = struct.unpack_from(
            bo + ("Q" if big else "I"), buf, e + 4)[0]
        size = _TYPE_SIZES.get(typ, 1) * count
        val_pos = e + (12 if big else 8)
        if size > inline:
            off = struct.unpack_from(bo + off_fmt, buf, val_pos)[0]
            struct.pack_into(bo + off_fmt, buf, val_pos, off + delta)
            if tag in (_T_STRIP_OFFSETS, _T_TILE_OFFSETS):
                fmt = _TYPE_FMT[typ]
                isz = struct.calcsize(fmt)
                for kk in range(count):
                    v = struct.unpack_from(bo + fmt, buf, off + kk * isz)[0]
                    struct.pack_into(bo + fmt, buf, off + kk * isz,
                                     v + delta)
        elif tag in (_T_STRIP_OFFSETS, _T_TILE_OFFSETS):
            fmt = _TYPE_FMT[typ]
            isz = struct.calcsize(fmt)
            for kk in range(count):
                v = struct.unpack_from(bo + fmt, buf, val_pos + kk * isz)[0]
                struct.pack_into(bo + fmt, buf, val_pos + kk * isz,
                                 v + delta)
    return bytes(buf)


def read_tiff_partial(path: Union[str, Path]) -> Tuple[np.ndarray, int]:
    """Salvage read of a damaged TIFF: every strip/tile that still decodes
    is kept, unreadable ones zero-fill.  Returns (img, n_failed_chunks).

    The repair role of the reference's tifffile->PIL->bfconvert chain
    (pystripe/core.py:212-250) without a bioformats dependency: truncated
    files and single corrupt strips yield a mostly-intact plane instead of
    a hard failure."""
    with open(path, "rb") as f:
        bo, big = _read_tiff_header(f)
        tags = next(iter(_parse_ifds(f, bo, big)))
        return _read_page(f, _page_from_tags(tags), bo, salvage=True)


def write_tiff(path: Union[str, Path], img: np.ndarray,
               compression: Optional[str] = None,
               rows_per_strip: Optional[int] = None,
               bigtiff: Optional[bool] = None) -> None:
    """Write a 2D grayscale (or (H,W,3) RGB) numpy array as TIFF.

    compression: None | 'zlib' | 'zlib:N' (N = zlib level 1-9, default 6).
    Writes BigTIFF automatically for data > 3.5 GB or when bigtiff=True.
    """
    img = np.ascontiguousarray(img)
    if img.ndim == 2:
        h, w = img.shape
        samples = 1
    elif img.ndim == 3 and img.shape[2] in (3, 4):
        h, w, samples = img.shape
    else:
        raise TiffError(f"unsupported shape {img.shape}")
    if img.dtype == np.bool_:
        img = img.astype(np.uint8)
    dt = img.dtype
    if dt.kind == "u":
        sfmt = 1
    elif dt.kind == "i":
        sfmt = 2
    elif dt.kind == "f":
        sfmt = 3
        if dt.itemsize == 8:
            img = img.astype(np.float32)
            dt = img.dtype
    else:
        raise TiffError(f"unsupported dtype {dt}")
    bits = dt.itemsize * 8
    nbytes = img.nbytes
    if bigtiff is None:
        bigtiff = nbytes > int(3.5 * 2 ** 30)

    if rows_per_strip is None:
        # target ~1 MB strips
        rows_per_strip = max(1, min(h, (1 << 20) // max(1, w * samples * dt.itemsize)))
    zlib_level = None
    if isinstance(compression, str) and compression.startswith("zlib"):
        zlib_level = 6
        if ":" in compression:
            zlib_level = max(1, min(9, int(compression.split(":", 1)[1])))
    elif compression not in (None, "none", "raw"):
        raise TiffError(f"unsupported compression {compression!r}")
    strips = []
    for y0 in range(0, h, rows_per_strip):
        chunk = img[y0:y0 + rows_per_strip].tobytes()
        if zlib_level is not None:
            chunk = zlib.compress(chunk, zlib_level)
        strips.append(chunk)
    comp_tag = 8 if zlib_level is not None else 1

    bo = "<"
    entries = []  # (tag, type, count, values)

    def add(tag, typ, values):
        if not isinstance(values, (list, tuple)):
            values = [values]
        entries.append((tag, typ, len(values), values))

    long_t = 16 if bigtiff else 4  # LONG8 vs LONG
    add(_T_WIDTH, 4, w)
    add(_T_LENGTH, 4, h)
    add(_T_BITS, 3, [bits] * samples)
    add(_T_COMPRESSION, 3, comp_tag)
    add(_T_PHOTOMETRIC, 3, 2 if samples >= 3 else 1)
    add(_T_STRIP_OFFSETS, long_t, [0] * len(strips))  # patched later
    add(_T_SAMPLES_PER_PIXEL, 3, samples)
    add(_T_ROWS_PER_STRIP, 4, rows_per_strip)
    add(_T_STRIP_BYTE_COUNTS, long_t, [len(s) for s in strips])
    add(_T_PLANAR_CONFIG, 3, 1)
    add(_T_SAMPLE_FORMAT, 3, [sfmt] * samples)
    entries.sort(key=lambda e: e[0])

    if bigtiff:
        header_sz = 16
        entry_sz = 20
        inline = 8
        cnt_fmt, off_fmt = "Q", "Q"
    else:
        header_sz = 8
        entry_sz = 12
        inline = 4
        cnt_fmt, off_fmt = "H", "I"

    ifd_off = header_sz
    ifd_size = (struct.calcsize(cnt_fmt) + entry_sz * len(entries)
                + struct.calcsize(off_fmt))
    # out-of-line values area follows the IFD
    extra = bytearray()
    extra_base = ifd_off + ifd_size
    packed_entries = []
    strip_off_patch = None
    # out-of-line values in tag order, but the strip byte counts before the
    # strip offsets, as native/fastio.cpp lays them out: a plane of many
    # strips is byte-equal whichever writer runs
    rank = {_T_STRIP_BYTE_COUNTS: _T_STRIP_OFFSETS - 0.5}
    for tag, typ, count, values in sorted(entries,
                                          key=lambda e: rank.get(e[0], e[0])):
        fmt = _TYPE_FMT[typ]
        size = struct.calcsize(fmt) * count
        data = struct.pack(bo + fmt * count, *values)
        if size <= inline:
            val_field = data + b"\0" * (inline - size)
            val_is_offset = False
            voff = None
        else:
            voff = extra_base + len(extra)
            extra += data
            if len(extra) % 2:
                extra += b"\0"
            val_field = struct.pack(bo + off_fmt, voff)
            val_is_offset = True
        packed_entries.append((tag, typ, count, val_field, voff, size))
        if tag == _T_STRIP_OFFSETS:
            strip_off_patch = (val_is_offset, voff, typ, count)

    packed_entries.sort(key=lambda e: e[0])

    data_base = extra_base + len(extra)
    if data_base % 2:
        extra += b"\0"
        data_base += 1
    offsets = []
    pos = data_base
    for s_ in strips:
        offsets.append(pos)
        pos += len(s_)
        if pos % 2:
            pos += 1

    # rebuild strip offsets value
    fmt = _TYPE_FMT[16 if bigtiff else 4]
    so_data = struct.pack(bo + fmt * len(offsets), *offsets)
    if strip_off_patch[0]:
        voff = strip_off_patch[1]
        extra[voff - extra_base:voff - extra_base + len(so_data)] = so_data
    else:
        packed_entries = [
            (tag, typ, count,
             (so_data + b"\0" * (inline - len(so_data))) if tag == _T_STRIP_OFFSETS else vf,
             vo, sz)
            for (tag, typ, count, vf, vo, sz) in packed_entries]

    out = bytearray()
    if bigtiff:
        out += struct.pack(bo + "2sHHHQ", b"II", 43, 8, 0, ifd_off)
    else:
        out += struct.pack(bo + "2sHI", b"II", 42, ifd_off)
    if bigtiff:
        out += struct.pack(bo + "Q", len(packed_entries))
    else:
        out += struct.pack(bo + "H", len(packed_entries))
    for tag, typ, count, val_field, _, _ in packed_entries:
        if bigtiff:
            out += struct.pack(bo + "HHQ", tag, typ, count) + val_field
        else:
            out += struct.pack(bo + "HHI", tag, typ, count) + val_field
    out += struct.pack(bo + ("Q" if bigtiff else "I"), 0)  # next IFD
    out += extra
    for i, s_ in enumerate(strips):
        assert len(out) == offsets[i], (len(out), offsets[i])
        out += s_
        if len(out) % 2:
            out += b"\0"

    path = Path(path)
    tmp = path.with_suffix(path.suffix + ".tmp")
    with open(tmp, "wb") as f:
        f.write(out)
    os.replace(tmp, path)  # atomic commit (reference: pystripe/core.py:304-314)


def imread(path: Union[str, Path], retries: int = NUM_RETRIES) -> np.ndarray:
    """Robust image read: native C++ codec, then the codec the file's
    signature names (io/generic2d.read_plane), with retries (reference
    imread_tif_raw_png, pystripe/core.py:200-264).  An encoding the port
    refuses by name raises UnsupportedTiffError naming the file, at once."""
    from ..utils import iostat

    if iostat.ACTIVE:
        t0 = time.perf_counter()
        out = _imread_impl(path, retries)
        iostat.add("host_decode", time.perf_counter() - t0, out.nbytes)
        return out
    return _imread_impl(path, retries)


def _imread_impl(path: Union[str, Path], retries: int) -> np.ndarray:
    path = Path(path)
    last_exc: Optional[Exception] = None
    for attempt in range(max(1, retries)):
        try:
            if path.suffix.lower() in (".tif", ".tiff"):
                try:
                    from .. import native

                    out = native.tiff_read(path)
                    if out is not None:
                        return out
                except Exception:
                    pass
            # the file's signature picks the codec, as PIL's does
            from .generic2d import read_plane

            return read_plane(path)
        except FileNotFoundError:
            raise
        except (UnsupportedTiffError, UnsupportedCodecError) as exc:
            # not a flaky read: the file holds what the port does not read
            raise UnsupportedTiffError(f"{path}: {exc}") from None
        except Exception as exc:  # noqa: BLE001 — retry any decode/IO error
            last_exc = exc
            time.sleep(RETRY_SLEEP)
    # repair chain of last resort: salvage whatever strips/tiles still
    # decode (the reference's bfconvert repair role, pystripe/core.py:228);
    # not sub-byte samples or separate colour planes, which the JAX
    # package's salvage does not read
    if path.suffix.lower() in (".tif", ".tiff"):
        try:
            with open(path, "rb") as f:
                bo, big = _read_tiff_header(f)
                page = _page_from_tags(next(iter(_parse_ifds(f, bo, big))))
            if page.bits >= 8 and _planes(page) == 1:
                img, failed = read_tiff_partial(path)
                if failed == 0 or img.any():
                    print(f"salvaged {path} with {failed} unreadable chunks")
                    return img
        except Exception:  # noqa: BLE001
            pass
    raise TiffError(f"failed to read {path}: {last_exc}")


def _native_compress_level(compression: Optional[str]) -> Optional[int]:
    """Map the 'zlib[:N]' compression spec onto the native writer's zlib
    level (0 = store).  None means the spec is not representable natively
    and the caller must use the Python codec."""
    if compression in (None, "none", "raw"):
        return 0
    if isinstance(compression, str) and compression.startswith("zlib"):
        if ":" in compression:
            try:
                return max(1, min(9, int(compression.split(":", 1)[1])))
            except ValueError:
                return None
        return 6
    return None


def imwrite(path: Union[str, Path], img: np.ndarray,
            compression: Optional[str] = None,
            retries: int = NUM_RETRIES) -> None:
    """Robust atomic image write with retries
    (reference imsave_tif, pystripe/core.py:276-334).

    Fast path: the native C++ encoder (fastio_tiff_write — the reference's
    save_bl_tif.cpp role) handles 2D planes of standard dtypes; it writes
    tmp->rename atomically and releases the GIL, so the pipeline writer
    thread pools (stitch/merge.py, pipeline/deconvolve.py reassembly,
    parallel/executor.py) encode in parallel C++.  Anything the native
    layer cannot represent (RGB, float64, >3.5 GB classic-TIFF overflow)
    falls back to the pure-Python codec below.
    """
    from ..utils import iostat

    if iostat.ACTIVE:
        nbytes = img.nbytes if isinstance(img, np.ndarray) else 0
        t0 = time.perf_counter()
        _imwrite_impl(path, img, compression, retries)
        iostat.add("host_encode", time.perf_counter() - t0, nbytes)
        return
    _imwrite_impl(path, img, compression, retries)


def _imwrite_impl(path: Union[str, Path], img: np.ndarray,
                  compression: Optional[str], retries: int) -> None:
    level = _native_compress_level(compression)
    if (level is not None and isinstance(img, np.ndarray) and img.ndim == 2
            and not (img.dtype.kind == "f" and img.dtype.itemsize == 8)
            and img.dtype.kind != "b"
            and img.nbytes < int(3.5 * 2 ** 30)):
        try:
            from .. import native

            if native.tiff_write(path, img, compress_level=level):
                return
        except Exception:  # noqa: BLE001 — any native hiccup: Python path
            pass
    last_exc: Optional[Exception] = None
    for attempt in range(max(1, retries)):
        try:
            write_tiff(path, img, compression=compression)
            return
        except OSError as exc:
            last_exc = exc
            time.sleep(RETRY_SLEEP)
    raise TiffError(f"failed to write {path}: {last_exc}")
