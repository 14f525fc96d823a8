"""CCITT fax decode for TIFF strips and tiles of compression 2 (Modified
Huffman run lengths), 3 (T.4, one- or two-dimensional) and 4 (T.6),
without libtiff.

The rows are decoded by ``native/ccitt.cpp``, built with g++ at first use
into ``build/ipp_tpu_torch/`` (``native.build_shared``) and loaded through
ctypes, which releases the GIL, so reader threads decode side by side.
There is no Python fallback: when the build fails, a decode raises
``CodecError`` naming the fax codec.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from ..native import build_shared
from .imgcodec import CodecError, UnsupportedCodecError

__all__ = ["ccitt_decode", "load"]

_SRC = Path(__file__).resolve().parent.parent / "native" / "ccitt.cpp"
_FLAGS = ("-O3",)
_ABI_VERSION = 1      # ccitt_abi_version() in ccitt.cpp
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_error: Optional[str] = None


def load() -> None:
    """Build (unless built) and load the library now; raises CodecError
    when it cannot."""
    _library()


def _library() -> ctypes.CDLL:
    global _lib, _error
    with _lock:
        if _lib is None and _error is None:
            try:
                lib = build_shared(_SRC, "ccitt_abi_version", _ABI_VERSION,
                                   _FLAGS)
                c = ctypes
                lib.ccitt_decode.argtypes = [
                    c.c_char_p, c.c_int64, c.c_void_p, c.c_int64, c.c_int64,
                    c.c_int32, c.c_int32, c.c_char_p, c.c_int32]
                lib.ccitt_decode.restype = c.c_int64
                _lib = lib
            except OSError as e:        # reported on every call
                _error = f"{type(e).__name__}: {e}"
    if _lib is None:
        raise CodecError(f"CCITT fax: the codec {_SRC.name} did not build "
                         f"or load ({_error})")
    return _lib


def ccitt_decode(data: bytes, rows: int, width: int, compression: int,
                 options: int = 0) -> bytes:
    """`rows` rows of `width` pixels, one bit a pixel (1 where the code
    says black), each row padded to a byte, from the fax data of TIFF
    compression 2, 3 (with its Group3Options) or 4.  Raises CodecError for
    malformed data or data that end before the last row,
    UnsupportedCodecError for uncompressed mode."""
    fn = _library().ccitt_decode
    out = np.empty(rows * ((width + 7) // 8), np.uint8)
    err = ctypes.create_string_buffer(256)
    data = bytes(data)
    got = fn(data, len(data), out.ctypes.data, rows, width, compression,
             options, err, 256)
    if got == -2:
        raise UnsupportedCodecError(err.value.decode())
    if got < 0:
        raise CodecError(err.value.decode())
    return out.tobytes()
