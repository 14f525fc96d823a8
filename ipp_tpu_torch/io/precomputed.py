"""Neuroglancer `precomputed` volume writer/reader.

Reference role: the optional neuroglancer-precomputed output leg of the
TSV merge step (`/root/reference/tsv/convert.py:41-115` drives blockfs /
precomputed-tif targets for `convert_to_2D_tif`).  This is a
self-contained implementation of the public precomputed format
(info JSON + raw little-endian chunk files named
``x0-x1_y0-y1_z0-z1``), written streaming: planes arrive one z at a
time and chunks flush whenever a chunk-depth slab completes, so memory
stays at chunk_z * plane_size regardless of volume depth.

Format: https://github.com/google/neuroglancer/tree/master/src/datasource/precomputed
(raw unsharded encoding, one scale per mip level).  Chunks are written
uncompressed by default — the precomputed format signals gzip via HTTP
Content-Encoding, which a plain file store cannot; `gzipped=True` is for
servers that set the header.
"""

from __future__ import annotations

import gzip
import json
from pathlib import Path
from typing import Iterable, Tuple

import numpy as np

__all__ = ["PrecomputedWriter", "write_precomputed", "read_precomputed_chunk",
           "read_precomputed"]


class PrecomputedWriter:
    """Streamed single-channel precomputed writer with on-the-fly 2x
    mip downsampling (mean-of-blocks, matching the alternating max/mean
    isotropic plan's mean arm for display purposes)."""

    def __init__(self, out_dir, shape_zyx: Tuple[int, int, int], dtype,
                 voxel_nm: Tuple[float, float, float] = (1000., 1000., 1000.),
                 chunk: Tuple[int, int, int] = (64, 64, 64),
                 n_levels: int = 1, gzipped: bool = False,
                 halve: str = "mean"):
        self.dir = Path(out_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.shape = tuple(int(s) for s in shape_zyx)
        self.dtype = np.dtype(dtype)
        self.chunk = tuple(int(c) for c in chunk)
        self.gz = gzipped
        if halve not in ("mean", "max"):
            raise ValueError(f"halve must be mean|max, got {halve}")
        self.halve = halve
        self.n_levels = max(1, int(n_levels))
        nz, ny, nx = self.shape
        self.scales = []
        for lv in range(self.n_levels):
            f = 2 ** lv
            if lv and (nx // f < 1 or ny // f < 1):
                break  # a deeper level would have no full pooling block
            size = [max(1, nx // f), max(1, ny // f), max(1, nz // f)]
            key = f"{int(voxel_nm[2] * f)}_{int(voxel_nm[1] * f)}_" \
                  f"{int(voxel_nm[0] * f)}"
            self.scales.append({
                "key": key,
                "size": size,  # x, y, z
                "resolution": [voxel_nm[2] * f, voxel_nm[1] * f,
                               voxel_nm[0] * f],
                "chunk_sizes": [list(self.chunk[::-1])],  # x, y, z
                "encoding": "raw",
                "voxel_offset": [0, 0, 0],
            })
            (self.dir / key).mkdir(exist_ok=True)
        info = {
            "type": "image",
            "data_type": self.dtype.name,
            "num_channels": 1,
            "scales": self.scales,
        }
        (self.dir / "info").write_text(json.dumps(info, indent=1))
        # per level: a slab buffer of chunk_z planes at that level's size
        self._slabs = []
        self._slab_z0 = []
        for sc in self.scales:
            sx, sy, _ = sc["size"]
            self._slabs.append(np.zeros((self.chunk[0], sy, sx), self.dtype))
            self._slab_z0.append(0)
        self._z = 0

    def add_plane(self, plane: np.ndarray) -> None:
        """Append one full-resolution (H, W) z plane."""
        nz, ny, nx = self.shape
        assert plane.shape == (ny, nx), (plane.shape, self.shape)
        plane = np.ascontiguousarray(plane, self.dtype)
        for lv, sc in enumerate(self.scales):
            f = 2 ** lv
            if self._z % f:  # this z is subsampled away at this level
                continue
            zl = self._z // f
            if zl >= sc["size"][2]:
                continue
            if lv:
                sy, sx = sc["size"][1], sc["size"][0]
                p = plane[:sy * f, :sx * f].reshape(sy, f, sx, f)
                pool = p.max(axis=(1, 3)) if self.halve == "max" \
                    else p.mean(axis=(1, 3))
                p = pool.astype(self.dtype)
            else:
                p = plane
            slab = self._slabs[lv]
            rel = zl - self._slab_z0[lv]
            if rel >= slab.shape[0]:
                self._flush_level(lv)
                self._slab_z0[lv] = zl
                rel = 0
            slab[rel] = p
        self._z += 1
        if self._z == nz:
            for lv in range(len(self.scales)):
                self._flush_level(lv, final=True)

    def _flush_level(self, lv: int, final: bool = False) -> None:
        sc = self.scales[lv]
        sx, sy, sz = sc["size"]
        z0 = self._slab_z0[lv]
        depth = (min(self.chunk[0], sz - z0) if final
                 else self._slabs[lv].shape[0])
        if depth <= 0 or z0 >= sz:
            return
        slab = self._slabs[lv][:depth]
        cz, cy, cx = self.chunk
        root = self.dir / sc["key"]
        for y0 in range(0, sy, cy):
            y1 = min(y0 + cy, sy)
            for x0 in range(0, sx, cx):
                x1 = min(x0 + cx, sx)
                # raw encoding: x fastest, then y, then z == C order of
                # the (z, y, x) block
                block = slab[:, y0:y1, x0:x1]
                data = np.ascontiguousarray(block).tobytes()
                name = f"{x0}-{x1}_{y0}-{y1}_{z0}-{z0 + depth}"
                payload = gzip.compress(data) if self.gz else data
                (root / name).write_bytes(payload)
        self._slab_z0[lv] = z0 + depth


def write_precomputed(out_dir, planes: Iterable[np.ndarray],
                      shape_zyx, dtype,
                      voxel_nm=(1000., 1000., 1000.),
                      chunk=(64, 64, 64), n_levels: int = 1,
                      gzipped: bool = False, halve: str = "mean") -> Path:
    """Write a z-plane iterable as a precomputed volume; returns the dir."""
    w = PrecomputedWriter(out_dir, shape_zyx, dtype, voxel_nm, chunk,
                          n_levels, gzipped, halve)
    for p in planes:
        w.add_plane(p)
    return w.dir


def _load_info(root: Path):
    return json.loads((Path(root) / "info").read_text())


def read_precomputed_chunk(root, level: int, x0, x1, y0, y1, z0, z1
                           ) -> np.ndarray:
    """Read one stored chunk as (z, y, x)."""
    root = Path(root)
    info = _load_info(root)
    sc = info["scales"][level]
    dt = np.dtype(info["data_type"])
    p = root / sc["key"] / f"{x0}-{x1}_{y0}-{y1}_{z0}-{z1}"
    raw = p.read_bytes()
    expected = (z1 - z0) * (y1 - y0) * (x1 - x0) * dt.itemsize
    # size check FIRST: raw u16 data can start with the gzip magic bytes
    # (a first voxel of 0x8b1f); a gzipped chunk essentially never equals
    # the exact raw byte count
    if len(raw) != expected and raw[:2] == b"\x1f\x8b":
        raw = gzip.decompress(raw)
    if len(raw) != expected:
        raise ValueError(f"chunk {p.name}: {len(raw)} bytes, "
                         f"expected {expected}")
    return np.frombuffer(raw, dt).reshape(z1 - z0, y1 - y0, x1 - x0)


def read_precomputed(root, level: int = 0) -> np.ndarray:
    """Assemble a whole level as (z, y, x) (test/QC helper)."""
    root = Path(root)
    info = _load_info(root)
    sc = info["scales"][level]
    sx, sy, sz = sc["size"]
    cx, cy, cz = sc["chunk_sizes"][0]
    dt = np.dtype(info["data_type"])
    out = np.zeros((sz, sy, sx), dt)
    for z0 in range(0, sz, cz):
        z1 = min(z0 + cz, sz)
        for y0 in range(0, sy, cy):
            y1 = min(y0 + cy, sy)
            for x0 in range(0, sx, cx):
                x1 = min(x0 + cx, sx)
                out[z0:z1, y0:y1, x0:x1] = read_precomputed_chunk(
                    root, level, x0, x1, y0, y1, z0, z1)
    return out
