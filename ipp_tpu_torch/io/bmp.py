"""BMP / DIB planes without PIL: uncompressed at 1, 4 and 8 bits with a
palette and at 24 and 32 bits, bottom-up and top-down, read as
``np.asarray(PIL.Image.open(path))`` shows them, and written as PIL
writes them.

PIL's view, which the JAX package's readers return:

- 1-8 bits: the palette indices, u8; bool when a 1-bit file's two
  colours are black and white, in that order;
- 24 bits: RGB u8; 32 bits: RGB u8 (the fourth byte dropped) unless
  BITFIELDS masks name an alpha channel (then RGBA);
- RLE, 16-bit and other BITFIELDS layouts raise ``CodecError``.
"""

from __future__ import annotations

import struct

import numpy as np

from .imgcodec import CodecError

__all__ = ["read_bmp", "encode_bmp"]

# 32-bit BITFIELDS masks (R, G, B, A) PIL reads, as the channel each
# byte of a pixel holds (X: dropped)
_MASKS32 = {
    (0xFF0000, 0xFF00, 0xFF, 0x0): "BGRX",
    (0xFF000000, 0xFF0000, 0xFF00, 0x0): "XBGR",
    (0xFF000000, 0xFF00, 0xFF, 0x0): "BGXR",
    (0xFF000000, 0xFF0000, 0xFF00, 0xFF): "ABGR",
    (0xFF, 0xFF00, 0xFF0000, 0xFF000000): "RGBA",
    (0xFF0000, 0xFF00, 0xFF, 0xFF000000): "BGRA",
    (0xFF000000, 0xFF00, 0xFF, 0xFF0000): "BGAR",
    (0x0, 0x0, 0x0, 0x0): "BGRA",
}


def read_bmp(path) -> np.ndarray:
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] != b"BM" or len(data) < 26:
        raise CodecError("BMP: not a BMP file")
    offset = struct.unpack_from("<I", data, 10)[0]
    hsize = struct.unpack_from("<I", data, 14)[0]
    hd = data[18:14 + hsize]
    layout = None
    if hsize == 12:
        w, h, _, bits = struct.unpack_from("<hhHH", hd)
        comp, colors, pad, down = 0, 0, 3, False
    elif hsize in (40, 52, 56, 64, 108, 124) and len(hd) >= hsize - 4:
        w, h, _, bits, comp = struct.unpack_from("<iIHHI", hd)
        down = hd[7] == 0xFF
        h = 2 ** 32 - h if down else h
        colors = struct.unpack_from("<I", hd, 28)[0]
        pad = 4
        if comp == 3:
            if len(hd) >= 48:
                masks = list(struct.unpack_from("<III", hd, 36)) + [
                    struct.unpack_from("<I", hd, 48)[0] if len(hd) >= 52
                    else 0]
            else:
                masks = list(struct.unpack_from("<III", data,
                                                14 + hsize)) + [0]
            if bits == 32 and tuple(masks) in _MASKS32:
                layout = _MASKS32[tuple(masks)]
            elif bits == 24 and tuple(masks[:3]) == (0xFF0000, 0xFF00, 0xFF):
                layout = "BGR"
            else:
                raise CodecError(f"BMP: BITFIELDS layout {bits} bits "
                                 f"{[hex(m) for m in masks]} is not read")
        elif comp != 0:
            raise CodecError(f"BMP: compression {comp} (RLE or other) is "
                             f"not read; uncompressed BMPs are")
    else:
        raise CodecError(f"BMP: header of {hsize} bytes")
    if bits not in (1, 4, 8, 24, 32):
        raise CodecError(f"BMP: {bits}-bit pixels are not read")
    if w <= 0 or h <= 0:
        raise CodecError(f"BMP: size {w} x {h}")
    colors = colors or (1 << bits)
    if offset == 14 + hsize and bits <= 8:      # as PIL corrects it
        offset += 4 * colors
    stride = ((w * bits + 31) >> 3) & ~3
    if len(data) < offset + stride * h:
        raise CodecError("BMP: pixel data cut short")
    rows = np.frombuffer(data, np.uint8, stride * h, offset).reshape(h,
                                                                     stride)
    if not down:
        rows = rows[::-1]
    if bits <= 8:
        if not 0 < colors <= 65536:
            raise CodecError(f"BMP: palette of {colors} colours")
        pal = data[14 + hsize:14 + hsize + pad * colors]
        if bits == 8:
            idx = rows[:, :w]
        else:
            idx = np.unpackbits(rows, axis=1)[:, :w * bits]
            if bits == 4:
                idx = idx.reshape(h, w, 4) @ np.array([8, 4, 2, 1], np.uint8)
        idx = np.ascontiguousarray(idx, np.uint8)
        if bits == 1 and colors == 2 and pal[:3] == b"\0\0\0" and \
                pal[pad:pad + 3] == b"\xff\xff\xff":
            return idx.astype(bool)
        return idx
    px = rows[:, :w * bits // 8].reshape(h, w, bits // 8)
    layout = layout or ("BGR" if bits == 24 else "BGRX")
    order = [layout.index(c) for c in "RGBA" if c in layout]
    return np.ascontiguousarray(px[..., order])


def encode_bmp(img: np.ndarray) -> bytes:
    """PIL's BMP: bool -> 1 bit (black, white), u8 -> 8 bits with a gray
    ramp, RGB u8 -> 24 bits, RGBA u8 -> 32 bits (BGRA, no masks), each
    bottom-up at 96 dpi."""
    img = np.asarray(img)
    h, w = img.shape[:2]
    if img.ndim == 2 and img.dtype == bool:
        bits, pal = 1, b"\0\0\0\0\xff\xff\xff\0"
        rows = np.packbits(img, axis=1)
    elif img.ndim == 2 and img.dtype == np.uint8:
        bits = 8
        pal = np.repeat(np.arange(256, dtype=np.uint8), 4).reshape(256, 4)
        pal[:, 3] = 0
        pal = pal.tobytes()
        rows = img
    elif img.ndim == 3 and img.shape[2] in (3, 4) and img.dtype == np.uint8:
        bits, pal = 8 * img.shape[2], b""
        order = [2, 1, 0, 3][:img.shape[2]]
        rows = img[..., order].reshape(h, -1)
    else:
        raise CodecError(f"BMP: cannot write {img.dtype} {img.shape}")
    stride = ((w * bits + 7) // 8 + 3) & ~3
    body = np.zeros((h, stride), np.uint8)
    body[:, :rows.shape[1]] = rows
    colors = len(pal) // 4
    offset = 14 + 40 + len(pal)
    ppm = int(96 * 39.3701 + 0.5)
    head = (b"BM" + struct.pack("<III", offset + stride * h, 0, offset) +
            struct.pack("<IiiHHIIiiII", 40, w, h, 1, bits, 0, stride * h,
                        ppm, ppm, colors, colors))
    return head + pal + body[::-1].tobytes()
