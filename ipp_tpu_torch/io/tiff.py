"""TIFF codec — numpy-native reader/writer with atomic commits and retries.

Replaces the reference's tifffile/PIL/bfconvert fallback chain
(reference imread_tif_raw_png / imsave_tif, pystripe/core.py:200-334) with:

- a from-scratch numpy TIFF parser (classic + BigTIFF, strips + tiles,
  uncompressed / deflate / PackBits, grayscale u8/u16/u32/f32),
- PIL as the compatibility fallback for exotic encodings (LZW, JPEG, ...),
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

__all__ = ["imread", "imwrite", "read_tiff", "read_tiff_partial",
           "read_tiff_stack", "write_tiff_stack", "write_tiff", "TiffError"]

NUM_RETRIES = 10
RETRY_SLEEP = 0.2

# TIFF tag ids
_T_WIDTH = 256
_T_LENGTH = 257
_T_BITS = 258
_T_COMPRESSION = 259
_T_PHOTOMETRIC = 262
_T_STRIP_OFFSETS = 273
_T_SAMPLES_PER_PIXEL = 277
_T_ROWS_PER_STRIP = 278
_T_STRIP_BYTE_COUNTS = 279
_T_PLANAR_CONFIG = 284
_T_PREDICTOR = 317
_T_TILE_WIDTH = 322
_T_TILE_LENGTH = 323
_T_TILE_OFFSETS = 324
_T_TILE_BYTE_COUNTS = 325
_T_SAMPLE_FORMAT = 339

_TYPE_SIZES = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8,
               11: 4, 12: 8, 16: 8, 17: 8, 18: 8}
_TYPE_FMT = {1: "B", 3: "H", 4: "I", 6: "b", 8: "h", 9: "i", 11: "f",
             12: "d", 16: "Q", 17: "q"}


class TiffError(RuntimeError):
    pass


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
                 tile_w, tile_l, tile_offsets, tile_counts, predictor):
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

    @property
    def dtype(self) -> np.dtype:
        kind = {1: "u", 2: "i", 3: "f"}.get(self.sample_format, "u")
        return np.dtype(f"{kind}{self.bits // 8}")


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
    if not (0 < bits <= 64 and bits % 8 == 0 and 0 < samples <= 16):
        raise TiffError(f"implausible bits/samples {bits}/{samples}")
    if int(width) * int(length) * samples * (bits // 8) > 1 << 36:
        raise TiffError("implausible plane size")
    rps = one(_T_ROWS_PER_STRIP, length)
    predictor = one(_T_PREDICTOR, 1)
    return _TiffPage(
        width, length, bits, comp, sfmt, samples, rps,
        tags.get(_T_STRIP_OFFSETS), tags.get(_T_STRIP_BYTE_COUNTS),
        one(_T_TILE_WIDTH), one(_T_TILE_LENGTH),
        tags.get(_T_TILE_OFFSETS), tags.get(_T_TILE_BYTE_COUNTS), predictor)


def _decompress(data: bytes, compression: int, expected: int) -> bytes:
    if compression == 1:
        return data
    if compression in (8, 32946):  # deflate / old-style deflate
        return zlib.decompress(data)
    if compression == 32773:  # PackBits
        return _unpackbits_decode(data, expected)
    raise TiffError(f"unsupported compression {compression}")


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
            page = _page_from_tags(tags)
            dtype = page.dtype.newbyteorder(bo)
            if page.tile_offsets:
                return _read_tiled(f, page, dtype)
            return _read_striped(f, page, dtype)
    raise TiffError(f"page {page_index} not found")


def _read_striped(f, page: _TiffPage, dtype) -> np.ndarray:
    h, w, s = page.length, page.width, page.samples
    rps = min(page.rows_per_strip, h)
    rows_out = []
    offsets = page.strip_offsets
    counts = page.strip_counts or [None] * len(offsets)
    itemsize = dtype.itemsize
    for i, off in enumerate(offsets):
        nrows = min(rps, h - i * rps)
        if nrows <= 0:
            break
        expected = nrows * w * s * itemsize
        f.seek(off)
        raw = f.read(counts[i] if counts[i] is not None else expected)
        raw = _decompress(raw, page.compression, expected)
        arr = np.frombuffer(raw[:expected], dtype=dtype).reshape(nrows, w * s)
        if page.predictor == 2:
            arr = _undo_predictor(arr.copy(), 2, s)
        rows_out.append(arr)
    img = np.concatenate(rows_out, axis=0)
    if s > 1:
        img = img.reshape(h, w, s)
    else:
        img = img.reshape(h, w)
    if img.dtype.byteorder not in ("=", "|") and img.dtype != np.dtype(img.dtype.str[1:]):
        img = img.astype(img.dtype.newbyteorder("="))
    return img


def _read_tiled(f, page: _TiffPage, dtype) -> np.ndarray:
    h, w, s = page.length, page.width, page.samples
    tw, tl = page.tile_w, page.tile_l
    ntx = -(-w // tw)
    nty = -(-h // tl)
    img = np.zeros((h, w * s), dtype=dtype.newbyteorder("="))
    itemsize = dtype.itemsize
    for i, off in enumerate(page.tile_offsets):
        ty, tx = divmod(i, ntx)
        if ty >= nty:
            break
        expected = tl * tw * s * itemsize
        f.seek(off)
        raw = f.read(page.tile_counts[i])
        raw = _decompress(raw, page.compression, expected)
        tile = np.frombuffer(raw[:expected], dtype=dtype).reshape(tl, tw * s)
        if page.predictor == 2:
            tile = _undo_predictor(tile.copy(), 2, s)
        y0, x0 = ty * tl, tx * tw * s
        ny = min(tl, h - y0)
        nx = min(tw * s, w * s - x0)
        img[y0:y0 + ny, x0:x0 + nx] = tile[:ny, :nx]
    return img.reshape(h, w, s) if s > 1 else img


def read_tiff_stack(path: Union[str, Path]) -> np.ndarray:
    """Read ALL pages of a multi-page TIFF into a (Z, H, W[, S]) array —
    the 3D-TIFF role of TeraStitcher's tiff3D iomanager plugin
    (src/iomanager/plugins/tiff3D)."""
    with open(path, "rb") as f:
        bo, big = _read_tiff_header(f)
        planes = []
        for tags in _parse_ifds(f, bo, big):
            page = _page_from_tags(tags)
            dtype = page.dtype.newbyteorder(bo)
            if page.tile_offsets:
                planes.append(_read_tiled(f, page, dtype))
            else:
                planes.append(_read_striped(f, page, dtype))
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
        page = _page_from_tags(tags)
        dtype = page.dtype.newbyteorder(bo)
        h, w, s = page.length, page.width, page.samples
        img = np.zeros((h, w * s), dtype.newbyteorder("="))
        failed = 0
        if page.tile_offsets:
            tw, tl = page.tile_w, page.tile_l
            ntx = -(-w // tw)
            for i, off in enumerate(page.tile_offsets):
                ty, tx = divmod(i, ntx)
                expected = tl * tw * s * dtype.itemsize
                try:
                    f.seek(off)
                    raw = _decompress(f.read(page.tile_counts[i]),
                                      page.compression, expected)
                    if len(raw) < expected:
                        raise TiffError("short tile")
                    tile = np.frombuffer(raw[:expected], dtype=dtype
                                         ).reshape(tl, tw * s)
                    if page.predictor == 2:
                        tile = _undo_predictor(tile.copy(), 2, s)
                    y0, x0 = ty * tl, tx * tw * s
                    ny = min(tl, h - y0)
                    nx = min(tw * s, w * s - x0)
                    img[y0:y0 + ny, x0:x0 + nx] = tile[:ny, :nx]
                except Exception:
                    failed += 1
        else:
            rps = min(page.rows_per_strip, h)
            counts = page.strip_counts or [None] * len(page.strip_offsets)
            for i, off in enumerate(page.strip_offsets):
                nrows = min(rps, h - i * rps)
                if nrows <= 0:
                    break
                expected = nrows * w * s * dtype.itemsize
                try:
                    f.seek(off)
                    raw = f.read(counts[i] if counts[i] is not None
                                 else expected)
                    raw = _decompress(raw, page.compression, expected)
                    if len(raw) < expected:
                        raise TiffError("short strip")
                    arr = np.frombuffer(raw[:expected], dtype=dtype
                                        ).reshape(nrows, w * s)
                    if page.predictor == 2:
                        arr = _undo_predictor(arr.copy(), 2, s)
                    img[i * rps:i * rps + nrows] = arr
                except Exception:
                    failed += 1
        img = np.ascontiguousarray(img)
        if img.dtype.byteorder not in ("=", "|"):
            img = img.astype(img.dtype.newbyteorder("="))
        return (img.reshape(h, w, s) if s > 1 else img.reshape(h, w)), failed


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
    for tag, typ, count, values in entries:
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
    """Robust image read: native C++ codec, numpy codec, then PIL fallback,
    with retries (reference imread_tif_raw_png, pystripe/core.py:200-264)."""
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
                try:
                    return read_tiff(path)
                except TiffError:
                    pass
            from PIL import Image

            with Image.open(path) as im:
                return np.asarray(im)
        except FileNotFoundError:
            raise
        except Exception as exc:  # noqa: BLE001 — retry any decode/IO error
            last_exc = exc
            time.sleep(RETRY_SLEEP)
    # repair chain of last resort: salvage whatever strips/tiles still
    # decode (the reference's bfconvert repair role, pystripe/core.py:228)
    if path.suffix.lower() in (".tif", ".tiff"):
        try:
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
