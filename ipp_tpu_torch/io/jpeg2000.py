"""JPEG 2000 planes (.jp2 / .j2k) without PIL.

Decoding returns what ``np.asarray(PIL.Image.open(path))`` returns with
PIL over OpenJPEG 2.5 (the JAX package's ``io/tiff._imread_impl``): the
same dtype, shape and bits.  The codestream is decoded by
``native/j2k.cpp`` (OpenJPEG's arithmetic, code-blocks on the host's
threads), built with g++ at first use into ``build/ipp_tpu_torch/``; then
PIL's choices are applied here:

- the mode: from the JP2 header box (``ihdr``: one component with a bit
  depth byte past 8 is ``I;16``, else ``L``; two ``LA``, three ``RGB``,
  four ``RGBA``), or for a raw codestream from SIZ (one component of more
  than 8 bits is ``I;16``);
- PIL's unpackers (``Jpeg2KDecode.c``'s ``j2ku_*``): each sample shifted
  from its component's precision to the mode's 8 or 16 bits.

What PIL over OpenJPEG cannot make raises ``CodecError`` naming it, and
nothing is misread: code-block styles other than 0, POC, PPM / PPT, RGN,
SOP / EPH, component subsampling, precisions other than 8 and 16, signed components,
palettes (``pclr`` / ``cmap``), colour spaces other than sRGB and
greyscale, more than four components.

Encoding writes what the JAX package's PIL call writes, by its declared
parameters (see ``native/j2k.cpp``): lossless 5/3, one tile and one layer,
in JP2 boxes for either suffix.  There is no Python fallback: without the
library a read or write raises ``CodecError`` naming the codec.
"""

from __future__ import annotations

import ctypes
import os
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from ..native import build_shared
from .imgcodec import CodecError

__all__ = ["SIGNATURES", "decode_jpeg2000", "read_jpeg2000",
           "encode_jpeg2000", "load"]

SIGNATURES = (b"\0\0\0\x0cjP  \r\n\x87\n", b"\xff\x4f\xff\x51")
_SRC = Path(__file__).resolve().parent.parent / "native" / "j2k.cpp"
_ABI_VERSION = 2        # j2k_abi_version() in j2k.cpp
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_error: Optional[str] = None
_ENUMCS = {16: "sRGB", 17: "greyscale"}


def _threads() -> int:
    try:
        return max(1, min(16, len(os.sched_getaffinity(0))))
    except AttributeError:      # pragma: no cover - non-Linux
        return max(1, min(16, os.cpu_count() or 1))


def load() -> None:
    """Build (unless built) and load the library now; raises CodecError
    when it cannot."""
    _library()


def _library() -> ctypes.CDLL:
    global _lib, _error
    with _lock:
        if _lib is None and _error is None:
            try:
                lib = build_shared(_SRC, "j2k_abi_version", _ABI_VERSION,
                                   ("-O3", "-ffp-contract=off", "-pthread"),
                                   ("-pthread",))
                c = ctypes
                lib.j2k_decode.argtypes = [c.c_char_p, c.c_int64, c.c_void_p,
                                           c.c_int64, c.POINTER(c.c_int32),
                                           c.c_char_p, c.c_int32, c.c_int32]
                lib.j2k_decode.restype = c.c_int32
                lib.j2k_encode.argtypes = [c.c_void_p, c.c_int32, c.c_int32,
                                           c.c_int32, c.c_int32, c.c_void_p,
                                           c.c_int64, c.c_char_p, c.c_int32,
                                           c.c_int32]
                lib.j2k_encode.restype = c.c_int64
                _lib = lib
            except OSError as e:        # reported on every call
                _error = f"{type(e).__name__}: {e}"
    if _lib is None:
        raise CodecError(f"JPEG 2000: the codec {_SRC.name} did not build "
                         f"or load ({_error})")
    return _lib


def _mode(info) -> str:
    """PIL's mode for the file (Jpeg2KImagePlugin), refusing what PIL's
    unpackers do not cover."""
    nc, jp2, ihdr_nc, ihdr_bpc, enumcs = (info[2], info[3], info[4],
                                          info[5], info[6])
    prec = list(info[7:7 + min(nc, 4)])
    if nc > 4:
        raise CodecError(f"JPEG 2000: {nc} components (PIL reads 1-4)")
    if any(info[11:11 + min(nc, 4)]):
        raise CodecError("JPEG 2000: signed components are not read")
    bad = sorted({p for p in prec if p not in (8, 16)})
    if bad:
        raise CodecError(f"JPEG 2000: {bad[0]}-bit components are not read "
                         f"(8 and 16 bits are)")
    if jp2:
        if ihdr_nc != nc:
            raise CodecError(f"JPEG 2000: the ihdr box says {ihdr_nc} "
                             f"components, the codestream {nc}")
        want = 17 if nc <= 2 else 16
        if enumcs not in (0, want):
            raise CodecError(f"JPEG 2000: colour space {enumcs} with {nc} "
                             f"components (the {_ENUMCS[want]} one is read)")
        if nc == 1:
            return "I;16" if (ihdr_bpc & 0x7F) > 8 else "L"
    elif nc == 1:
        return "I;16" if prec[0] > 8 else "L"
    return {2: "LA", 3: "RGB", 4: "RGBA"}[nc]


def decode_jpeg2000(data: bytes) -> np.ndarray:
    """The plane in a JP2 file or a raw codestream, as PIL gives it:
    (h, w) uint8 (L) or uint16 (I;16), or (h, w, 2 / 3 / 4) uint8."""
    lib = _library()
    data = bytes(data)
    info = (ctypes.c_int32 * 16)()
    err = ctypes.create_string_buffer(256)
    if lib.j2k_decode(data, len(data), None, 0, info, err, 256,
                      _threads()) != 0:
        raise CodecError(f"JPEG 2000: {err.value.decode()}")
    mode = _mode(info)
    w, h, nc = info[0], info[1], info[2]
    if w * h * nc > 1 << 32:
        raise CodecError(f"JPEG 2000: a {w} x {h} x {nc} plane is past "
                         f"2^32 samples")
    raw = np.empty((h, w, nc), np.int32)
    if lib.j2k_decode(data, len(data), raw.ctypes.data, raw.nbytes, info,
                      err, 256, _threads()) != 0:
        raise CodecError(f"JPEG 2000: {err.value.decode()}")
    bits = 16 if mode == "I;16" else 8
    out = np.empty((h, w, nc), np.uint16 if bits == 16 else np.uint8)
    for c in range(nc):
        shift = bits - info[7 + c]
        v = raw[..., c] << shift if shift >= 0 else raw[..., c] >> -shift
        out[..., c] = v
    return out[..., 0] if nc == 1 else out


def read_jpeg2000(path) -> np.ndarray:
    """Decode a .jp2 / .j2k file (see decode_jpeg2000)."""
    return decode_jpeg2000(Path(path).read_bytes())


def encode_jpeg2000(img: np.ndarray) -> bytes:
    """A lossless JP2 file of a plane PIL writes as JPEG 2000: (h, w)
    uint8 or uint16, or (h, w, 2 / 3 / 4) uint8; a 1-D array is a column,
    as PIL's fromarray takes it."""
    img = np.asarray(img)
    if img.ndim == 1:
        img = img[:, None]
    if img.dtype.kind == "u" and img.dtype.itemsize == 2:
        img = img.astype(np.uint16, copy=False)
    ok = (img.ndim == 2 and img.dtype in (np.uint8, np.uint16)) or (
        img.ndim == 3 and img.dtype == np.uint8 and img.shape[2] in (2, 3, 4))
    if not ok:
        raise CodecError(f"JPEG 2000: cannot write {img.dtype} {img.shape}; "
                         f"(h, w) uint8 / uint16 or (h, w, 2-4) uint8 planes "
                         f"are written")
    h, w = img.shape[:2]
    if h < 1 or w < 1:
        raise CodecError(f"JPEG 2000: cannot write an empty {img.shape} plane")
    nc = 1 if img.ndim == 2 else img.shape[2]
    prec = 8 * img.dtype.itemsize
    img = np.ascontiguousarray(img)
    lib = _library()
    err = ctypes.create_string_buffer(256)
    cap = img.nbytes + 4096
    while True:
        out = np.empty(cap, np.uint8)
        n = lib.j2k_encode(img.ctypes.data, w, h, nc, prec, out.ctypes.data,
                           cap, err, 256, _threads())
        if n > 0:
            return out[:n].tobytes()
        if n == 0:
            raise CodecError(f"JPEG 2000: {err.value.decode()}")
        cap = -n
