"""The HDF5 chunk filters io/hdf5.py decodes besides deflate, shuffle and
fletcher32: lzf (h5py's filter 32000), scaleoffset (6) and nbit (5).

- lzf is sequential by nature: ``native/h5filters.cpp``, built with g++
  at first use into ``build/ipp_tpu_torch/`` (``native.build_shared``)
  and loaded through ctypes, which releases the GIL, so the reader's
  inflate threads run side by side.  There is no Python fallback: when
  the build fails, a read of an lzf chunk raises ``FormatError`` naming
  the filter.
- scaleoffset (H5Zscaleoffset.c) and nbit (H5Znbit.c) pack each value's
  significant bits, most significant first, into one bit stream a chunk;
  both unpack here in numpy.  scaleoffset leads the stream with 21 bytes:
  the bits a value (4 bytes), the width of the minimum (1) and the
  minimum (up to 8).  Integers add the minimum back; floats (D-scaling)
  are integers over 10^D plus the minimum, in the float's own precision;
  where the dataset defines a fill value, the all-ones value stands for
  it.  0 bits a value: a chunk of one value.  nbit reads atomic integers
  and floats; the dataset's datatype says how its bits convert
  (io/hdf5.py).
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from ..native import build_shared
from .hdf5_v2 import FormatError

__all__ = ["lzf_decompress", "scaleoffset_decode", "nbit_check",
           "nbit_decode", "unpack_bits"]

FILTER_NBIT, FILTER_SCALEOFFSET, FILTER_LZF = 5, 6, 32000
_SRC = Path(__file__).resolve().parent.parent / "native" / "h5filters.cpp"
_ABI_VERSION = 1      # h5filters_abi_version() in h5filters.cpp
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_error: Optional[str] = None


def _library() -> ctypes.CDLL:
    """The built decoder, built on first use; raises FormatError naming
    lzf when it cannot be built or loaded."""
    global _lib, _error
    with _lock:
        if _lib is None and _error is None:
            try:
                _lib = _load()
            except OSError as e:        # reported on every read
                _error = f"{type(e).__name__}: {e}"
    if _lib is None:
        raise FormatError(f"filter {FILTER_LZF} (lzf): its decoder "
                          f"{_SRC.name} did not build or load ({_error})")
    return _lib


def _load() -> ctypes.CDLL:
    lib = build_shared(_SRC, "h5filters_abi_version", _ABI_VERSION)
    fn = lib.h5filters_lzf_decompress
    fn.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p,
                   ctypes.c_int64]
    fn.restype = ctypes.c_int64
    return lib


def lzf_decompress(buf: bytes, cd: Sequence[int]) -> bytearray:
    """A chunk h5py's lzf filter compressed.  Its client data are the
    filter's version, LZF's version and the chunk's bytes, the first
    guess at the output's size (h5py's, which grows it by the input's size
    until the stream fits)."""
    fn = _library().h5filters_lzf_decompress
    buf = bytes(buf)
    cap = cd[2] if len(cd) >= 3 and cd[2] else len(buf)
    while True:
        out = bytearray(cap)
        got = fn(buf, len(buf), (ctypes.c_char * cap).from_buffer(out), cap)
        if got >= 0:
            del out[got:]
            return out
        if got == -1:
            raise FormatError(f"filter {FILTER_LZF} (lzf): invalid data")
        cap += max(len(buf), 1)


def unpack_bits(buf, n: int, bits: int, width: int) -> np.ndarray:
    """n values of `bits` bits each, most significant bit first, from a
    bit stream whose first bit is the top bit of buf[0], as unsigned
    integers of `width` bits (8, 16, 32 or 64)."""
    if bits == 0 or n == 0:
        return np.zeros(n, f"u{width // 8}")
    nbytes = -(-n * bits // 8)
    if len(buf) < nbytes:
        raise FormatError(f"a packed chunk of {len(buf)} bytes holds fewer "
                          f"than {n} values of {bits} bits")
    stream = np.unpackbits(np.frombuffer(buf, np.uint8, nbytes))
    full = np.zeros((n, width), np.uint8)
    full[:, width - bits:] = stream[:n * bits].reshape(n, bits)
    return np.packbits(full, axis=1).view(f">u{width // 8}").ravel() \
        .astype(f"u{width // 8}")


def _fill_bytes(cd: Sequence[int], size: int) -> bytes:
    """The fill value scaleoffset keeps in its client data from cd[8] on:
    its bytes, least significant first, packed into the 4-byte values."""
    return np.array(cd[8:], "<u4").tobytes()[:size]


def scaleoffset_decode(buf, cd: Sequence[int]) -> bytes:
    """A scaleoffset chunk's values, in the dataset's byte order.  Client
    data: scale type (0 float D-scaling, 1 float E-scaling, 2 integer),
    scale factor, values a chunk, class (0 integer, 1 float), size, sign,
    byte order, fill value defined, then the fill value."""
    if len(cd) < 8:
        raise FormatError(f"filter {FILTER_SCALEOFFSET} (scaleoffset) with "
                          f"{len(cd)} client data values")
    stype, factor, n, cls, size, signed, order, filled = cd[:8]
    if stype == 1:
        raise FormatError(f"filter {FILTER_SCALEOFFSET} (scaleoffset) with "
                          f"E-scaling, which the library does not decode")
    if cls not in (0, 1) or size not in (1, 2, 4, 8) or \
            (cls == 1 and size not in (4, 8)):
        raise FormatError(f"filter {FILTER_SCALEOFFSET} (scaleoffset) on a "
                          f"{size}-byte type of class {cls}")
    buf = bytes(buf)
    minbits = int.from_bytes(buf[:4], "little")
    mbytes = min(8, buf[4])
    minval = int.from_bytes(buf[5:5 + mbytes], "little")
    body = buf[21:]
    end = ">" if order else "<"
    kind = "f" if cls == 1 else "i" if signed else "u"
    out_dt = np.dtype(f"{end}{kind}{size}")
    if minbits > 8 * size:
        raise FormatError(f"scaleoffset chunk of {minbits} bits a "
                          f"{size}-byte value")
    if minbits == 8 * size:       # stored whole, in the host's order
        if len(body) < n * size:
            raise FormatError("a scaleoffset chunk cut short")
        return np.frombuffer(body, f"<{kind}{size}", n).astype(out_dt) \
            .tobytes()
    v = unpack_bits(body, n, minbits, 8 * size)
    marker = (1 << minbits) - 1
    fill = mask = None
    if filled:
        fill = np.frombuffer(_fill_bytes(cd, size), f"<{kind}{size}")[0]
        mask = v == marker
    if cls == 0:
        top = np.uint64((1 << 8 * size) - 1)
        vals = ((v.astype(np.uint64) + np.uint64(minval)) & top).astype(
            f"<u{size}").view(f"<{kind}{size}")
    else:
        ints = v.view(f"<i{size}")
        ft = np.dtype(f"<f{size}")
        factor -= (1 << 32) if factor >= 1 << 31 else 0   # a signed int
        low = np.frombuffer(minval.to_bytes(8, "little")[:size], ft)[0]
        vals = ints.astype(ft) / ft.type(10.0 ** factor) + low
    if mask is not None:
        vals = vals.copy()
        vals[mask] = fill
    return vals.astype(out_dt).tobytes()


def nbit_check(cd: Sequence[int]) -> None:
    """Raise unless nbit's client data describe an atomic type."""
    if len(cd) < 8 or cd[3] != 1:
        what = {2: "an array", 3: "a compound"}.get(
            cd[3] if len(cd) > 3 else None, "an unknown")
        raise FormatError(f"filter {FILTER_NBIT} (nbit) on {what} type; "
                          f"nbit on atomic integers and floats is read")


def nbit_decode(buf, cd: Sequence[int]) -> bytes:
    """An nbit chunk: each value's `precision` bits from bit `offset`,
    the others 0.  Client data: parameters, no compression needed,
    values a chunk, class (1 atomic), then size, byte order, precision,
    offset."""
    nbit_check(cd)
    if cd[1]:                     # full precision: stored as it is
        return bytes(buf)
    n, (size, order, precision, offset) = cd[2], cd[4:8]
    if size not in (1, 2, 4, 8) or offset + precision > 8 * size:
        raise FormatError(f"filter {FILTER_NBIT} (nbit): precision "
                          f"{precision} at offset {offset} of {size} bytes")
    v = unpack_bits(buf, n, precision, 8 * size)
    v = v << v.dtype.type(offset)
    return v.astype(f"{'>' if order else '<'}u{size}").tobytes()
