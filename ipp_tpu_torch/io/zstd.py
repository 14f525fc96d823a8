"""Zstandard decode (RFC 8878) for TIFF strips and tiles of compression
50000, without libzstd.

The frames are decoded by ``native/zstd.cpp``, built with g++ at first use
into ``build/ipp_tpu_torch/`` (``native.build_shared``) and loaded through
ctypes, which releases the GIL, so reader threads decode side by side.
There is no Python fallback: when the build fails, a decode raises
``CodecError`` naming zstd.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from ..native import build_shared
from .imgcodec import CodecError, UnsupportedCodecError

__all__ = ["zstd_decode", "load"]

_SRC = Path(__file__).resolve().parent.parent / "native" / "zstd.cpp"
_ABI_VERSION = 1      # zstd_abi_version() in zstd.cpp
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
                lib = build_shared(_SRC, "zstd_abi_version", _ABI_VERSION,
                                   ("-O3",))
                c = ctypes
                lib.zstd_decode.argtypes = [c.c_char_p, c.c_int64, c.c_void_p,
                                            c.c_int64, c.c_char_p, c.c_int32]
                lib.zstd_decode.restype = c.c_int64
                _lib = lib
            except OSError as e:        # reported on every call
                _error = f"{type(e).__name__}: {e}"
    if _lib is None:
        raise CodecError(f"zstd: the codec {_SRC.name} did not build or load "
                         f"({_error})")
    return _lib


def zstd_decode(data: bytes, expected: int) -> bytes:
    """The `expected` bytes that the Zstandard frames in `data` hold (every
    frame in a row, skippable frames skipped).  Raises CodecError when the
    data are malformed or end before `expected` bytes (frames past them are
    not read), UnsupportedCodecError for a dictionary or a legacy frame."""
    fn = _library().zstd_decode
    out = np.empty(expected, np.uint8)
    err = ctypes.create_string_buffer(256)
    data = bytes(data)
    got = fn(data, len(data), out.ctypes.data, expected, err, 256)
    if got == -2:
        raise UnsupportedCodecError(f"zstd: {err.value.decode()}")
    if got < 0:
        raise CodecError(f"zstd: {err.value.decode()}")
    if got < expected:
        raise CodecError(f"zstd: the data end after {got} of {expected} "
                         f"bytes")
    return out.tobytes()
