"""PNG planes without PIL: every colour type and bit depth, Adam7, read as
``np.asarray(PIL.Image.open(path))`` shows them; gray, gray + alpha, RGB
and RGBA written at 8 and 16 bits.

The chunks, zlib and the mapping to PIL's view are numpy; the row filters
and Adam7's passes run in the codec library (``io/imgcodec.py``).  PIL's
view, which the JAX package's readers return:

- gray at 1 bit: bool; at 2 and 4 bits: scaled to 8 (x 85, x 17); at 16:
  u16;
- palette (1-8 bits): the indices, u8 (the palette is not applied);
- RGB and RGBA at 16 bits: their high bytes, u8;
- gray + alpha at 8 bits: (h, w, 2) u8; at 16 bits: RGBA of the high
  bytes (gray repeated), u8;
- tRNS leaves the array as it is.
"""

from __future__ import annotations

import struct
import zlib
from typing import Tuple

import numpy as np

from .imgcodec import CodecError, png_unfilter

__all__ = ["SIGNATURE", "read_png", "png_shape", "encode_png"]

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
           6: (8, 16)}


def _chunks(data: bytes):
    if data[:8] != SIGNATURE:
        raise CodecError("PNG: not a PNG file")
    pos = 8
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if len(body) < n or pos + 12 + n > len(data):
            raise CodecError(f"PNG: chunk {kind!r} cut short")
        crc = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])[0]
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise CodecError(f"PNG: broken chunk {kind!r} (CRC)")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + n
    raise CodecError("PNG: no IEND chunk (truncated)")


def _header(body: bytes) -> Tuple[int, int, int, int, int]:
    w, h, depth, ctype, comp, filt, interlace = struct.unpack(">IIBBBBB",
                                                              body[:13])
    if ctype not in _DEPTHS or depth not in _DEPTHS[ctype]:
        raise CodecError(f"PNG: colour type {ctype} at {depth} bits")
    if comp or filt or interlace > 1 or not (w and h):
        raise CodecError("PNG: unknown compression, filter or interlace "
                         "method, or an empty image")
    return w, h, depth, ctype, interlace


def png_shape(path) -> Tuple[int, int]:
    """(height, width) from the IHDR chunk alone."""
    with open(path, "rb") as f:
        head = f.read(33)
    if head[:8] != SIGNATURE or head[12:16] != b"IHDR":
        raise CodecError(f"PNG: {path} has no IHDR")
    w, h = struct.unpack(">II", head[16:24])
    return h, w


def read_png(path) -> np.ndarray:
    with open(path, "rb") as f:
        data = f.read()
    head = None
    idat = []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            head = _header(body)
        elif kind == b"IDAT":
            idat.append(body)
    if head is None or not idat:
        raise CodecError("PNG: no IHDR or no IDAT")
    w, h, depth, ctype, interlace = head
    ch = _CHANNELS[ctype]
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise CodecError(f"PNG: {e}") from None
    rows = png_unfilter(raw, w, h, depth * ch, bool(interlace))
    if depth < 8:
        bits = np.unpackbits(rows, axis=1)[:, :w * depth]
        if depth == 1:
            v = bits
        else:
            v = bits.reshape(h, w, depth) @ (1 << np.arange(depth - 1, -1, -1)
                                             ).astype(np.uint8)
            v = v.astype(np.uint8)
        if ctype == 3:
            return np.ascontiguousarray(v, np.uint8)
        if depth == 1:
            return v.astype(bool)
        return v * np.uint8(255 // ((1 << depth) - 1))
    if depth == 8:
        out = rows.reshape(h, w, ch)
        return out[..., 0] if ch == 1 else out
    px = rows.view(">u2").reshape(h, w, ch)
    if ctype == 0:
        return px[..., 0].astype(np.uint16)
    hi = (px >> 8).astype(np.uint8)
    if ctype == 4:       # PIL reads 16-bit gray + alpha as RGBA
        return np.ascontiguousarray(hi[..., [0, 0, 0, 1]])
    return hi


def _filtered(rows: np.ndarray, bpp: int, block: int = 256) -> np.ndarray:
    """PNG rows with the filter of least sum of |signed byte| each (the
    adaptive heuristic of libpng and PIL), filter byte first; `block`
    rows at a time, which bounds the temporaries."""
    out = np.empty((rows.shape[0], rows.shape[1] + 1), np.uint8)
    for r0 in range(0, rows.shape[0], block):
        x = rows[max(r0 - 1, 0):r0 + block].astype(np.int16)
        up = np.zeros_like(x)
        up[1:] = x[:-1]
        if r0:
            x, up = x[1:], up[1:]
        left = np.zeros_like(x)
        left[:, bpp:] = x[:, :-bpp]
        upleft = np.zeros_like(x)
        upleft[:, bpp:] = up[:, :-bpp]
        p = left + up - upleft
        pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
        pred = np.where((pa <= pb) & (pa <= pc), left,
                        np.where(pb <= pc, up, upleft))
        cands = np.stack([x, x - left, x - up, x - ((left + up) >> 1),
                          x - pred]).astype(np.uint8)
        score = np.abs(cands.view(np.int8), dtype=np.int16).sum(
            axis=2, dtype=np.int64)
        best = score.argmin(axis=0)
        o = out[r0:r0 + len(x)]
        o[:, 0] = best
        o[:, 1:] = cands[best, np.arange(len(x))]
    return out


def encode_png(img: np.ndarray, level: int = 6) -> bytes:
    """A PNG of a bool, u8 or u16 plane: (h, w) gray (bool: 1 bit),
    (h, w, 2) gray + alpha, (h, w, 3) RGB, (h, w, 4) RGBA."""
    img = np.asarray(img)
    if img.ndim == 2:
        img = img[..., None]
    if img.ndim != 3 or img.shape[2] not in (1, 2, 3, 4) or img.dtype.kind \
            not in "bu" or img.dtype.itemsize > 2 or \
            (img.dtype.kind == "b" and img.shape[2] != 1):
        raise CodecError(f"PNG: cannot write {img.dtype} {img.shape}")
    h, w, ch = img.shape
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[ch]
    if img.dtype.kind == "b":
        depth = 1
        rows = np.packbits(img[..., 0], axis=1)
    else:
        depth = 8 * img.dtype.itemsize
        rows = np.ascontiguousarray(img.astype(f">u{img.dtype.itemsize}")
                                    ).view(np.uint8).reshape(h, -1)
    bpp = max(1, depth * ch // 8)
    body = zlib.compress(_filtered(rows, bpp).tobytes(), level)

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data +
                struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    return (SIGNATURE +
            chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0,
                                       0)) +
            chunk(b"IDAT", body) + chunk(b"IEND", b""))
