"""Bindings of the host image codec's byte loops (``native/imgcodec.cpp``).

LZW decode, PNG unfiltering with Adam7, and JPEG decode (sequential and
progressive) and encode are
sequential by nature, so they live in C++: built with g++ at first use into
``build/ipp_tpu_torch/`` (``native.build_shared``) and loaded through
ctypes, which releases the GIL, so reader threads decode side by side.
There is no Python fallback: when the build fails, a read or write that
needs the library raises ``CodecError`` naming the codec.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from ..native import build_shared

__all__ = ["CodecError", "UnsupportedCodecError", "load", "lzw_decode",
           "png_unfilter", "jpeg_decode", "jpeg_encode"]

_SRC = Path(__file__).resolve().parent.parent / "native" / "imgcodec.cpp"
_ABI_VERSION = 2      # imgcodec_abi_version() in imgcodec.cpp
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_error: Optional[str] = None


class CodecError(ValueError):
    """A plane the codec cannot read or write (also raised when its
    library did not build)."""


class UnsupportedCodecError(CodecError):
    """An encoding the codec refuses by name (old-style LZW, a JPEG
    process it does not read, a zstd dictionary): well-formed data that
    the port does not read, never a damaged file."""


def load() -> None:
    """Build (unless built) and load the library now; raises CodecError
    when it cannot."""
    _library("the image codec")


def _library(codec: str) -> ctypes.CDLL:
    global _lib, _error
    with _lock:
        if _lib is None and _error is None:
            try:
                _lib = _load()
            except OSError as e:        # reported on every call
                _error = f"{type(e).__name__}: {e}"
    if _lib is None:
        raise CodecError(f"{codec}: the image codec {_SRC.name} did not "
                         f"build or load ({_error})")
    return _lib


def _load() -> ctypes.CDLL:
    lib = build_shared(_SRC, "imgcodec_abi_version", _ABI_VERSION,
                       ("-O3", "-fwrapv"))
    c = ctypes
    lib.imgcodec_lzw_decode.argtypes = [c.c_char_p, c.c_int64, c.c_void_p,
                                        c.c_int64]
    lib.imgcodec_lzw_decode.restype = c.c_int64
    lib.imgcodec_png_unfilter.argtypes = [c.c_char_p, c.c_int64, c.c_void_p,
                                          c.c_int64, c.c_int64, c.c_int32,
                                          c.c_int32]
    lib.imgcodec_png_unfilter.restype = c.c_int64
    lib.imgcodec_jpeg_decode.argtypes = [
        c.c_char_p, c.c_int64, c.c_char_p, c.c_int64, c.c_void_p, c.c_int64,
        c.POINTER(c.c_int32), c.c_char_p, c.c_int32, c.c_int32]
    lib.imgcodec_jpeg_decode.restype = c.c_int32
    lib.imgcodec_jpeg_encode.argtypes = [c.c_void_p, c.c_int32, c.c_int32,
                                         c.c_int32, c.c_int32, c.c_int32,
                                         c.c_void_p, c.c_int64]
    lib.imgcodec_jpeg_encode.restype = c.c_int64
    return lib


def lzw_decode(data: bytes, expected: int) -> bytes:
    """TIFF LZW (compression 5): up to `expected` bytes of the strip."""
    fn = _library("LZW").imgcodec_lzw_decode
    out = np.empty(expected, np.uint8)
    got = fn(bytes(data), len(data), out.ctypes.data, expected)
    if got == -3:
        raise UnsupportedCodecError("LZW: old-style (LSB-first) LZW is not "
                                    "read")
    if got < 0:
        raise CodecError("LZW: invalid data")
    return out[:got].tobytes()


def png_unfilter(raw: bytes, width: int, height: int, bits: int,
                 interlace: bool) -> np.ndarray:
    """The packed rows (height, ceil(width * bits / 8)) of an inflated
    IDAT stream; bits: bits a pixel."""
    fn = _library("PNG").imgcodec_png_unfilter
    stride = (width * bits + 7) // 8
    out = np.empty((height, stride), np.uint8)
    rc = fn(raw, len(raw), out.ctypes.data, width, height, bits,
            int(interlace))
    if rc == -1:
        raise CodecError("PNG: image data cut short")
    if rc < 0:
        raise CodecError("PNG: a row with an unknown filter type")
    return out


def jpeg_decode(data: bytes, tables: bytes = b"",
                colour: Optional[bool] = None) -> np.ndarray:
    """A JPEG stream's pixels: (h, w) u8 for one component, (h, w, 3) RGB
    for three, (h, w, 4) CMYK for four (YCCK turned to CMYK; inverted, as
    PIL's "CMYK;I" hands every four-component JPEG out).  Sequential or
    progressive.  `tables`: an abbreviated tables-only stream (TIFF's
    JPEGTables) read before the stream.  `colour`: three components turn
    from YCbCr to RGB as the stream's markers say (None, as libjpeg), or
    always (True), or never (False, and then none may be subsampled):
    libtiff's choice under photometric 6 and under any other; with True or
    False four components are refused."""
    fn = _library("JPEG").imgcodec_jpeg_decode
    flag = -1 if colour is None else int(bool(colour))
    info = (ctypes.c_int32 * 3)()
    err = ctypes.create_string_buffer(256)
    data = bytes(data)
    if fn(data, len(data), tables or None, len(tables), None, 0, info, err,
          256, flag) != 0:
        _jpeg_error(err.value.decode())
    w, h, nc = info[0], info[1], info[2]
    out = np.empty((h, w, nc) if nc > 1 else (h, w), np.uint8)
    if fn(data, len(data), tables or None, len(tables), out.ctypes.data,
          out.nbytes, info, err, 256, flag) != 0:
        _jpeg_error(err.value.decode())
    return out


def _jpeg_error(msg: str):
    """The decoder's message as the error it is: a JPEG process or layout
    the codec does not read (its messages say "unsupported" or "not read")
    or damaged data."""
    if msg.startswith("unsupported") or msg.endswith("is not read"):
        raise UnsupportedCodecError(f"JPEG: {msg}")
    raise CodecError(f"JPEG: {msg}")


def jpeg_encode(img: np.ndarray, quality: int = 75,
                color: Optional[bool] = None) -> bytes:
    """A JFIF file of a (h, w) gray or (h, w, 3) RGB u8 plane, as
    libjpeg writes it at PIL's defaults: one component for gray, YCbCr
    4:2:0 for RGB, the standard tables scaled to `quality`.  color=True
    writes a gray plane as YCbCr (Cb = Cr = 128), as a movie's frames."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or not (img.ndim == 2 or (
            img.ndim == 3 and img.shape[2] == 3)):
        raise CodecError(f"JPEG: cannot write {img.dtype} {img.shape}; "
                         f"gray or RGB u8 planes are written")
    h, w = img.shape[:2]
    if not (0 < w <= 65535 and 0 < h <= 65535):
        raise CodecError(f"JPEG: a {w} x {h} plane is past JPEG's 65535")
    comp = 1 if img.ndim == 2 else 3
    color = comp == 3 if color is None else bool(color) or comp == 3
    fn = _library("JPEG").imgcodec_jpeg_encode
    cap = w * h * comp // 2 + 4096
    while True:
        out = np.empty(cap, np.uint8)
        n = fn(img.ctypes.data, w, h, comp, int(quality), int(color),
               out.ctypes.data, cap)
        if n > 0:
            return out[:n].tobytes()
        if n == 0:
            raise CodecError(f"JPEG: encoding a {w} x {h} plane failed")
        cap = -n

