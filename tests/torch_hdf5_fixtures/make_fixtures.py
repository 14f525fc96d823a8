"""Write the HDF5 fixtures of newer format that the port reads on hosts
without h5py: run ``python tests/torch_hdf5_fixtures/make_fixtures.py``
(h5py needed) and commit ``striped.ims`` and ``striped_bdv.h5``.

Both are written with ``libver='latest'`` (superblock 3, version 2 object
headers) from arrays made by ``arrays()`` from numpy seeds, which needs
only numpy, so readers can regenerate what the files must hold:

- ``striped.ims``, an Imaris file as io/ims.write_imaris lays it out: 8
  striped 256 x 256 u16 planes, level 0 under a fixed maximum shape (a
  fixed-array chunk index), level 1 (their 2 x 2 x 2 mean) under an
  unlimited z (an extensible array), both gzip 2, a thumbnail, the
  DataSetInfo attributes as 1-byte string arrays;
- ``striped_bdv.h5``, a BigDataViewer file of ten setups: setup 0 the
  same planes and their 2 x 2 mean in xy, the others one small volume
  each, all under unlimited maximum shapes (version 2 B-tree chunk
  indexes), gzip 1; the root and ``t00000`` hold more than 8 links (dense
  storage in fractal heaps), ``t00000`` in creation order
  (``track_order``, setups made last to first); the root holds 12
  attributes (dense), one a ``str``.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
IMS, BDV = HERE / "striped.ims", HERE / "striped_bdv.h5"
SEED, SHAPE = 1717, (8, 256, 256)
CHUNKS = (4, 64, 64)
SETUPS = 10
ROOT_ATTRS = 12


def striped_planes(seed: int = SEED, shape=SHAPE) -> np.ndarray:
    """u16 planes: a smooth field, beads, stripes along x and y on ~15% of
    the lines, noise."""
    nz, h, w = shape
    rng = np.random.default_rng(seed)
    yy = np.linspace(0, 1, h)[:, None]
    xx = np.linspace(0, 1, w)[None, :]
    field = 600 + 1400 * np.exp(-((yy - 0.4) ** 2 + (xx - 0.5) ** 2) / 0.08)
    out = np.empty(shape, np.uint16)
    for z in range(nz):
        img = field.copy()
        ys, xs = rng.integers(2, h - 2, 60), rng.integers(2, w - 2, 60)
        img[ys, xs] += 2000 + 6000 * rng.random(60)
        rows = 1 + 0.6 * (rng.random((h, 1)) - 0.5) * (rng.random((h, 1))
                                                       < 0.15)
        cols = 1 + 0.6 * (rng.random((1, w)) - 0.5) * (rng.random((1, w))
                                                       < 0.15)
        img = img * rows * cols + 12 * rng.random((h, w))
        out[z] = np.clip(np.rint(img), 0, 65535).astype(np.uint16)
    return out


def mean_pool(vol: np.ndarray, fz: int) -> np.ndarray:
    """The mean of fz x 2 x 2 blocks, rounded, in the input's dtype."""
    nz, h, w = vol.shape
    blocks = vol.astype(np.float64).reshape(nz // fz, fz, h // 2, 2, w // 2,
                                            2)
    return np.rint(blocks.mean(axis=(1, 3, 5))).astype(vol.dtype)


def thumbnail(vol: np.ndarray) -> np.ndarray:
    """The (h / 2, 2 w) u8 RGBA rows of the maximum projection taken at
    every other pixel, as Imaris stores a thumbnail."""
    mip = vol[:, ::2, ::2].max(axis=0).astype(np.float64)
    gray = np.rint(255 * (mip - mip.min()) / (mip.max() - mip.min()))
    gray = gray.astype(np.uint8)
    return np.dstack([gray, gray, gray, np.full_like(gray, 255)]).reshape(
        gray.shape[0], -1)


def small_volume(setup: int) -> np.ndarray:
    rng = np.random.default_rng(SEED + setup)
    return rng.integers(0, 65535, (2, 32, 32), dtype=np.uint16,
                        endpoint=True)


def arrays():
    """{"ims": {dataset path: array}, "bdv": {...}}: what each fixture
    holds.  BDV cells hold u16 bits as int16 (the BDV convention)."""
    planes = striped_planes()
    ims = {"DataSet/ResolutionLevel 0/TimePoint 0/Channel 0/Data": planes,
           "DataSet/ResolutionLevel 1/TimePoint 0/Channel 0/Data":
               mean_pool(planes, 2),
           "Thumbnail/Data": thumbnail(planes)}
    bdv = {"t00000/s00/0/cells": planes.view(np.int16),
           "t00000/s00/1/cells": mean_pool(planes, 1).view(np.int16)}
    for s in range(SETUPS):
        levels = 2 if s == 0 else 1
        bdv[f"s{s:02d}/resolutions"] = np.array(
            [[float(1 << i)] * 2 + [1.0] for i in range(levels)])
        bdv[f"s{s:02d}/subdivisions"] = np.array(
            [[CHUNKS[2], CHUNKS[1], CHUNKS[0]]] * levels, np.int32)
        if s:
            bdv[f"t00000/s{s:02d}/0/cells"] = small_volume(s).view(np.int16)
    return {"ims": ims, "bdv": bdv}


def root_attrs():
    """The BDV fixture's root attributes (a str among them)."""
    out = {f"meta{i:02d}": np.arange(i + 1, dtype=np.int32)
           for i in range(ROOT_ATTRS - 2)}
    out["name"] = "striped fixture"
    out["voxel_um"] = np.array([2.0, 1.8, 1.8])
    return out


def _s1(obj, name, value):
    obj.attrs[name] = np.frombuffer(value.encode("ascii"), dtype="S1")


def write_ims(path: Path, data) -> None:
    import h5py

    level0 = data["DataSet/ResolutionLevel 0/TimePoint 0/Channel 0/Data"]
    nz, ny, nx = level0.shape
    with h5py.File(path, "w", libver="latest") as f:
        for k, v in (("ImarisDataSet", "ImarisDataSet"),
                     ("ImarisVersion", "5.5.0"),
                     ("DataSetDirectoryName", "DataSet"),
                     ("DataSetInfoDirectoryName", "DataSetInfo"),
                     ("ThumbnailDirectoryName", "Thumbnail")):
            _s1(f, k, v)
        f.attrs["NumberOfDataSets"] = np.uint32(1)
        for name, vol in data.items():
            if not name.startswith("DataSet/"):
                continue
            level = int(name.split("/")[1].split()[-1])
            d = f.create_dataset(
                name, data=vol, compression="gzip", compression_opts=2,
                chunks=tuple(min(c, s) for c, s in zip(CHUNKS, vol.shape)),
                maxshape=vol.shape if level == 0 else (None,) + vol.shape[1:])
            for axis, n in zip("ZYX", vol.shape):
                _s1(d.parent, f"ImageSize{axis}", str(n))
        img = f.create_group("DataSetInfo/Image")
        for k, v in (("X", nx), ("Y", ny), ("Z", nz), ("Unit", "um"),
                     ("ExtMax0", f"{nx * 1.8:.3f}"),
                     ("ExtMax1", f"{ny * 1.8:.3f}"),
                     ("ExtMax2", f"{nz * 2.0:.3f}")):
            _s1(img, k, str(v))
        _s1(f.create_group("DataSetInfo/Channel 0"), "Name", "Channel 1")
        f.create_dataset("Thumbnail/Data", data=data["Thumbnail/Data"])


def write_bdv(path: Path, data) -> None:
    import h5py

    with h5py.File(path, "w", libver="latest") as f:
        for k, v in root_attrs().items():
            f.attrs[k] = v
        f.create_group("t00000", track_order=True)
        for s in reversed(range(SETUPS)):
            f.create_group(f"t00000/s{s:02d}")
        for name, vol in data.items():
            kw = {}
            if name.endswith("/cells"):
                kw = dict(chunks=tuple(min(c, n) for c, n in
                                       zip(CHUNKS, vol.shape)),
                          maxshape=(None,) * vol.ndim, compression="gzip",
                          compression_opts=1)
            f.create_dataset(name, data=vol, **kw)


def main() -> int:
    data = arrays()
    write_ims(IMS, data["ims"])
    write_bdv(BDV, data["bdv"])
    for p in (IMS, BDV):
        print(f"{p.name}: {p.stat().st_size} bytes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
