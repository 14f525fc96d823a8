"""Vaa3D raw (.v3draw / TeraFly "Vaa3DRaw" block) codec.

Layout (reference RawFmtMngr.cpp loadMetadata/loadRaw2Metadata,
TeraStitcher/src/imagemanager/RawFmtMngr.cpp:210-331):

    24 bytes  magic "raw_image_stack_by_hpeng"
     1 byte   endian code 'B' (big) | 'L' (little)
     2 bytes  datatype = bytes per pixel (1 | 2 | 4), int16
    16 bytes  sz[4] uint32 = (x, y, z, c)
     data     c-major, then z, y, x fastest

This is the block format of the reference's `mergeTilesVaa3DRaw` output
(TeraStitcher/src/stitcher/StackStitcher.h:338) and Vaa3D's native stack
format; `export_terafly(block_format="vaa3draw")` writes TeraFly
hierarchies whose blocks are these files instead of 2D TIFF series.
"""

from __future__ import annotations

import os
import struct
from pathlib import Path
from typing import Tuple, Union

import numpy as np

__all__ = ["VAA3D_MAGIC", "vaa3d_raw_read", "vaa3d_raw_write",
           "vaa3d_raw_info", "vaa3d_raw_read_plane"]

VAA3D_MAGIC = b"raw_image_stack_by_hpeng"
_HEADER_LEN = len(VAA3D_MAGIC) + 1 + 2 + 16  # 43 bytes


def _parse_header(head: bytes, path) -> Tuple[np.dtype, Tuple[int, ...]]:
    if head[:24] != VAA3D_MAGIC:
        raise ValueError(f"{path}: not a Vaa3D raw stack (bad magic)")
    endian = {ord("L"): "<", ord("B"): ">"}.get(head[24])
    if endian is None:
        raise ValueError(f"{path}: bad endian code {head[24]!r}")
    (dcode,) = struct.unpack(endian + "h", head[25:27])
    if dcode not in (1, 2, 4):
        raise ValueError(f"{path}: unsupported datatype code {dcode}")
    sx, sy, sz, sc = struct.unpack(endian + "4I", head[27:43])
    dt = np.dtype({1: "u1", 2: "u2", 4: "f4"}[dcode]).newbyteorder(endian)
    return dt, (sc, sz, sy, sx)


def vaa3d_raw_info(path) -> Tuple[np.dtype, Tuple[int, int, int, int]]:
    """(dtype, (c, z, y, x)) from the 43-byte header."""
    with open(path, "rb") as f:
        head = f.read(_HEADER_LEN)
    if len(head) < _HEADER_LEN:
        raise ValueError(f"{path}: truncated Vaa3D raw header")
    return _parse_header(head, path)


def vaa3d_raw_read(path) -> np.ndarray:
    """Read a full stack; single-channel stacks come back 3D (z, y, x),
    multi-channel 4D (c, z, y, x)."""
    dt, (sc, sz, sy, sx) = vaa3d_raw_info(path)
    arr = np.fromfile(path, dtype=dt, offset=_HEADER_LEN,
                      count=sc * sz * sy * sx).reshape(sc, sz, sy, sx)
    if arr.dtype.byteorder not in ("=", "|"):
        arr = arr.astype(arr.dtype.newbyteorder("="))
    return arr[0] if sc == 1 else arr


def vaa3d_raw_read_plane(path, z: int, channel: int = 0) -> np.ndarray:
    """Read ONE z plane without touching the rest of the file (the
    streamRaw partial-read role, RawFmtMngr.cpp:597-660)."""
    dt, (sc, sz, sy, sx) = vaa3d_raw_info(path)
    if not (0 <= z < sz and 0 <= channel < sc):
        raise IndexError((z, channel))
    plane_bytes = sy * sx
    off = _HEADER_LEN + ((channel * sz + z) * plane_bytes) * dt.itemsize
    arr = np.fromfile(path, dtype=dt, offset=off,
                      count=plane_bytes).reshape(sy, sx)
    if arr.dtype.byteorder not in ("=", "|"):
        arr = arr.astype(arr.dtype.newbyteorder("="))
    return arr


def vaa3d_raw_write(path: Union[str, Path], vol: np.ndarray) -> None:
    """Write a (z, y, x) or (c, z, y, x) stack atomically (tmp -> rename),
    little-endian.  dtype maps u1->1, u2->2, f4->4 (the saveImage2Raw
    codes, RawFmtMngr.cpp:352-)."""
    vol = np.asarray(vol)
    if vol.ndim == 2:
        vol = vol[None]
    if vol.ndim == 3:
        vol = vol[None]
    if vol.ndim != 4:
        raise ValueError(f"need 2D/3D/4D stack, got shape {vol.shape}")
    kind_code = {("u", 1): 1, ("u", 2): 2, ("f", 4): 4}.get(
        (vol.dtype.kind, vol.dtype.itemsize))
    if kind_code is None:
        # normalize the odd cases the reference would reject
        vol = vol.astype(np.float32)
        kind_code = 4
    vol = np.ascontiguousarray(vol.astype(vol.dtype.newbyteorder("<"),
                                          copy=False))
    sc, sz, sy, sx = vol.shape
    path = Path(path)
    tmp = path.with_suffix(path.suffix + ".tmp")
    with open(tmp, "wb") as f:
        f.write(VAA3D_MAGIC)
        f.write(b"L")
        f.write(struct.pack("<h", kind_code))
        f.write(struct.pack("<4I", sx, sy, sz, sc))
        vol.tofile(f)
    os.replace(tmp, path)
