"""Write the HDF5 fixtures that the port reads on hosts without h5py: run
``python tests/torch_hdf5_fixtures/make_fixtures.py`` (h5py needed) and
commit the files it writes.

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

The structures the port reads since (same seeds, numpy alone to
regenerate; under 1 MB together):

- ``split_bdv.h5``, a BigDataViewer "split hdf5" master as BigDataViewer
  writes one: the setups' ``resolutions`` and ``subdivisions``, and
  ``t00000/sSS`` external links into two partition files,
  ``split_bdv-00-00.h5`` (setup 0: 8 striped 128 x 160 u16 planes and
  their 2 x 2 mean in xy) and ``split_bdv-00-01.h5`` (setup 1: uniform
  random u16, which lzf cannot shrink, so every chunk is stored raw with
  the filter's mask bit set); the cells lzf-compressed (h5py's filter
  32000), as npy2bdv and pybdv offer;
- ``long_attr.ims``, an Imaris file (libver 'latest') of the same planes:
  ``DataSetInfo/Image`` holds 14 attributes (dense storage), its
  ``Description`` 5000 bytes (a huge fractal-heap object); the level-0
  data and three attributes use committed datatypes in
  ``/__DATA_TYPES__`` (where jhdf5 commits its types);
- ``sohm_bdv.h5``, a BigDataViewer file of six setups of different
  shapes written with a shared-message table: through ctypes on h5py's
  bundled libhdf5, ``H5Pset_shared_mesg_nindexes(fcpl, 2)``,
  ``H5Pset_shared_mesg_index(fcpl, 0, H5O_SHMESG_SDSPACE_FLAG |
  H5O_SHMESG_DTYPE_FLAG | H5O_SHMESG_FILL_FLAG | H5O_SHMESG_PLINE_FLAG,
  1)``, ``H5Pset_shared_mesg_index(fcpl, 1, H5O_SHMESG_ATTR_FLAG, 1)`` and
  ``H5Pset_shared_mesg_phase_change(fcpl, 8, 6)``: index 0 (more than 8
  messages) a version 2 B-tree, index 1 (7 attributes) a list.
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
SPLIT = HERE / "split_bdv.h5"
PARTS = (HERE / "split_bdv-00-00.h5", HERE / "split_bdv-00-01.h5")
LONG_IMS, SOHM = HERE / "long_attr.ims", HERE / "sohm_bdv.h5"
SMALL_SHAPE, SMALL_CHUNKS = (8, 128, 160), (4, 64, 64)
DESCRIPTION_BYTES = 5000
SOHM_SETUPS = 6
# H5O_SHMESG_*_FLAG (H5Opublic.h): dataspace, datatype, fill value,
# filter pipeline; attribute
SOHM_INDEXES = ((1 << 1 | 1 << 3 | 1 << 5 | 1 << 11, 1), (1 << 12, 1))
SOHM_PHASE = (8, 6)          # list above 8 messages, back below 6


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


def small_planes() -> np.ndarray:
    """The planes of the split BDV and the long-attribute .ims."""
    return striped_planes(SEED + 100, SMALL_SHAPE)


def noise_volume() -> np.ndarray:
    """Setup 1 of the split BDV: uniform u16, which lzf cannot shrink."""
    rng = np.random.default_rng(SEED + 101)
    return rng.integers(0, 65535, (4, 48, 40), dtype=np.uint16,
                        endpoint=True)


def sohm_volume(setup: int) -> np.ndarray:
    rng = np.random.default_rng(SEED + 200 + setup)
    return rng.integers(0, 4000, (2, 16 + 4 * setup, 24 + 2 * setup),
                        dtype=np.uint16)


def _bdv_setup(s: int, levels: int, chunks):
    return {f"s{s:02d}/resolutions": np.array(
        [[float(1 << i)] * 2 + [1.0] for i in range(levels)]),
        f"s{s:02d}/subdivisions": np.array(
            [[chunks[2], chunks[1], chunks[0]]] * levels, np.int32)}


def structure_arrays():
    """{fixture path: {dataset path: array}} of the fixtures of the
    structures read since (the split BDV's through its master)."""
    planes = small_planes()
    split = {"t00000/s00/0/cells": planes.view(np.int16),
             "t00000/s00/1/cells": mean_pool(planes, 1).view(np.int16),
             "t00000/s01/0/cells": noise_volume().view(np.int16),
             **_bdv_setup(0, 2, SMALL_CHUNKS), **_bdv_setup(1, 1, (4, 48, 40))}
    ims = {"DataSet/ResolutionLevel 0/TimePoint 0/Channel 0/Data": planes,
           "DataSet/ResolutionLevel 1/TimePoint 0/Channel 0/Data":
               mean_pool(planes, 2)}
    sohm = {}
    for s in range(SOHM_SETUPS):
        vol = sohm_volume(s)
        sohm[f"t00000/s{s:02d}/0/cells"] = vol.view(np.int16)
        sohm.update(_bdv_setup(s, 1, vol.shape))
    return {SPLIT: split, LONG_IMS: ims, SOHM: sohm}


def image_attrs():
    """``DataSetInfo/Image`` of the long-attribute .ims: name -> value (1-
    byte string arrays, as Imaris stores them), in creation order."""
    nz, ny, nx = SMALL_SHAPE
    words = np.random.default_rng(SEED + 102).choice(
        ["light", "sheet", "cleared", "brain", "objective", "stripe",
         "tile", "channel"], 1000)
    text = " ".join(words)[:DESCRIPTION_BYTES - 1] + "."
    vals = {"Description": text, "Name": "long attribute fixture",
            "X": nx, "Y": ny, "Z": nz, "Unit": "um",
            "ExtMin0": 0, "ExtMin1": 0, "ExtMin2": 0,
            "ExtMax0": f"{nx * 1.8:.3f}", "ExtMax1": f"{ny * 1.8:.3f}",
            "ExtMax2": f"{nz * 2.0:.3f}", "Noc": 1,
            "RecordingDate": "2026-01-01 00:00:00.000"}
    return {k: np.frombuffer(str(v).encode("ascii"), dtype="S1")
            for k, v in vals.items()}


# the attributes of the long-attribute .ims stored with the committed
# 1-byte string type
COMMITTED_ATTRS = ("Description", "Name", "Unit")


def sohm_attrs(setup: int):
    """The attributes of a setup group of the SOHM file: one value shared
    by all six, one each."""
    return {"unit": np.frombuffer(b"micrometer", "S1"),
            "id": np.int32(setup)}


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


def write_split(data) -> None:
    """The master first names its partitions, which the links reach from
    the master's directory (relative names, as BigDataViewer writes)."""
    import h5py

    for s, part in enumerate(PARTS):
        with h5py.File(part, "w") as f:
            for name, vol in data.items():
                if name.startswith(f"s{s:02d}/"):
                    f.create_dataset(name, data=vol)
                elif name.startswith(f"t00000/s{s:02d}/"):
                    f.create_dataset(name, data=vol, compression="lzf",
                                     chunks=tuple(min(c, n) for c, n in zip(
                                         SMALL_CHUNKS, vol.shape)))
    with h5py.File(SPLIT, "w") as f:
        for name, vol in data.items():
            if name.startswith("s"):
                f.create_dataset(name, data=vol)
        for s, part in enumerate(PARTS):
            f[f"t00000/s{s:02d}"] = h5py.ExternalLink(part.name,
                                                      f"t00000/s{s:02d}")


def write_long_ims(data) -> None:
    import h5py

    planes = data["DataSet/ResolutionLevel 0/TimePoint 0/Channel 0/Data"]
    with h5py.File(LONG_IMS, "w", libver="latest") as f:
        f["__DATA_TYPES__/UInt16"] = np.dtype("<u2")
        f["__DATA_TYPES__/String1"] = np.dtype("S1")
        s1 = f["__DATA_TYPES__/String1"]
        for k, v in (("ImarisDataSet", "ImarisDataSet"),
                     ("ImarisVersion", "5.5.0"),
                     ("DataSetDirectoryName", "DataSet"),
                     ("DataSetInfoDirectoryName", "DataSetInfo"),
                     ("ThumbnailDirectoryName", "Thumbnail")):
            _s1(f, k, v)
        f.attrs["NumberOfDataSets"] = np.uint32(1)
        for name, vol in data.items():
            level = int(name.split("/")[1].split()[-1])
            kw = dict(dtype=f["__DATA_TYPES__/UInt16"]) if level == 0 else {}
            d = f.create_dataset(
                name, data=vol, compression="gzip", compression_opts=2,
                chunks=tuple(min(c, n) for c, n in zip(SMALL_CHUNKS,
                                                       vol.shape)), **kw)
            for axis, n in zip("ZYX", vol.shape):
                _s1(d.parent, f"ImageSize{axis}", str(n))
        img = f.create_group("DataSetInfo/Image")
        for k, v in image_attrs().items():
            if k in COMMITTED_ATTRS:
                img.attrs.create(k, v, dtype=s1)
            else:
                img.attrs[k] = v
        _s1(f.create_group("DataSetInfo/Channel 0"), "Name", "Channel 1")
    assert len(planes) == SMALL_SHAPE[0]


def write_sohm(data) -> None:
    import ctypes

    import h5py

    libs = Path(h5py.__file__).parent.parent / "h5py.libs"
    found = sorted(libs.glob("libhdf5-*.so*"))
    lib = ctypes.CDLL(str(found[0]) if found else "libhdf5.so")
    fcpl = h5py.h5p.create(h5py.h5p.FILE_CREATE)
    pid = ctypes.c_int64(fcpl.id)
    assert lib.H5Pset_shared_mesg_nindexes(pid, ctypes.c_uint(
        len(SOHM_INDEXES))) >= 0
    for i, (flags, least) in enumerate(SOHM_INDEXES):
        assert lib.H5Pset_shared_mesg_index(pid, ctypes.c_uint(i),
                                            ctypes.c_uint(flags),
                                            ctypes.c_uint(least)) >= 0
    assert lib.H5Pset_shared_mesg_phase_change(
        pid, *map(ctypes.c_uint, SOHM_PHASE)) >= 0
    fid = h5py.h5f.create(str(SOHM).encode(), h5py.h5f.ACC_TRUNC, fcpl=fcpl)
    with h5py.File(fid) as f:
        for name, vol in data.items():
            kw = {}
            if name.endswith("/cells"):
                kw = dict(chunks=(1,) + vol.shape[1:], compression="gzip",
                          compression_opts=1)
            f.create_dataset(name, data=vol, **kw)
        for s in range(SOHM_SETUPS):
            for k, v in sohm_attrs(s).items():
                f[f"t00000/s{s:02d}"].attrs[k] = v


def main() -> int:
    data = arrays()
    write_ims(IMS, data["ims"])
    write_bdv(BDV, data["bdv"])
    more = structure_arrays()
    write_split(more[SPLIT])
    write_long_ims(more[LONG_IMS])
    write_sohm(more[SOHM])
    for p in (IMS, BDV, SPLIT, *PARTS, LONG_IMS, SOHM):
        print(f"{p.name}: {p.stat().st_size} bytes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
