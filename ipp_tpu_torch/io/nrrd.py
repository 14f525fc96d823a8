"""Minimal NRRD codec (raw / gzip encodings) for FNT cube processing
(reference fnt_cube_processor.py reads/writes .nrrd via pynrrd)."""

from __future__ import annotations

import gzip
from pathlib import Path
from typing import Dict, Tuple

import numpy as np

__all__ = ["read_nrrd", "write_nrrd"]

_TYPES = {
    "uint8": np.uint8, "uchar": np.uint8,
    "uint16": np.uint16, "unsigned short": np.uint16, "ushort": np.uint16,
    "int16": np.int16, "short": np.int16,
    "uint32": np.uint32, "int32": np.int32, "int": np.int32,
    "float": np.float32, "double": np.float64,
}


def read_nrrd(path) -> Tuple[np.ndarray, Dict[str, str]]:
    with open(path, "rb") as f:
        magic = f.readline()
        if not magic.startswith(b"NRRD"):
            raise ValueError(f"not a NRRD file: {path}")
        header: Dict[str, str] = {}
        while True:
            line = f.readline()
            if line in (b"\n", b"\r\n", b""):
                break
            text = line.decode("ascii", "replace").strip()
            if text.startswith("#"):
                continue
            if ":" in text:
                k, v = text.split(":", 1)
                header[k.strip().lower()] = v.strip()
        data = f.read()
    dtype = _TYPES[header["type"]]
    sizes = tuple(int(s) for s in header["sizes"].split())
    encoding = header.get("encoding", "raw").lower()
    if encoding in ("gzip", "gz"):
        data = gzip.decompress(data)
    elif encoding in ("raw",):
        pass
    else:
        raise ValueError(f"unsupported NRRD encoding {encoding!r}")
    endian = header.get("endian", "little")
    dt = np.dtype(dtype).newbyteorder("<" if endian == "little" else ">")
    arr = np.frombuffer(data, dtype=dt, count=int(np.prod(sizes)))
    # NRRD sizes are fastest-first; numpy shape is slowest-first
    arr = arr.reshape(sizes[::-1])
    return np.ascontiguousarray(arr.astype(dtype)), header


def write_nrrd(path, arr: np.ndarray, encoding: str = "gzip",
               extra_header: Dict[str, str] = None) -> Path:
    path = Path(path)
    arr = np.ascontiguousarray(arr)
    typename = {np.dtype(np.uint8): "uint8", np.dtype(np.uint16): "uint16",
                np.dtype(np.int16): "int16", np.dtype(np.uint32): "uint32",
                np.dtype(np.int32): "int32", np.dtype(np.float32): "float",
                np.dtype(np.float64): "double"}[arr.dtype]
    lines = [
        "NRRD0004",
        f"type: {typename}",
        f"dimension: {arr.ndim}",
        "sizes: " + " ".join(str(s) for s in arr.shape[::-1]),
        f"encoding: {'gzip' if encoding == 'gzip' else 'raw'}",
        "endian: little",
    ]
    for k, v in (extra_header or {}).items():
        lines.append(f"{k}: {v}")
    payload = arr.tobytes()
    if encoding == "gzip":
        payload = gzip.compress(payload, 6)
    tmp = path.with_suffix(path.suffix + ".tmp")
    with open(tmp, "wb") as f:
        f.write(("\n".join(lines) + "\n\n").encode("ascii"))
        f.write(payload)
    tmp.replace(path)
    return path
