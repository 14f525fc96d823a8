"""Imaris .ims (HDF5) reader and writer.

Replaces two reference dependencies:
- imaris_ims_file_reader / ImarisZWrapper (parallel_image_processor.py:38-80)
  for reading z planes out of .ims files,
- the vendored Windows ImarisConvertiv.exe run under wine
  (process_images.py:1000-1059) for producing .ims from stitched TIFF
  series — here written natively with h5py, including the multi-resolution
  pyramid and the DataSetInfo attributes Imaris needs (layout per the
  open Imaris5 HDF format, cf. TeraStitcher IMS_HDF5Mngr.cpp:200-280).
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

__all__ = ["ImarisReader", "write_imaris", "write_imaris_timeseries",
           "tif_series_to_imaris"]


def _attr_str(group, name: str, value: str) -> None:
    import h5py

    group.attrs[name] = np.frombuffer(value.encode("ascii"),
                                      dtype="S1")


class ImarisReader:
    """z-indexed access to an .ims volume
    (reference ImarisZWrapper, parallel_image_processor.py:38-80)."""

    def __init__(self, path, timepoint: int = 0, channel: int = 0,
                 resolution_level: int = 0):
        import h5py

        self._f = h5py.File(path, "r")
        self._ds = self._f[f"DataSet/ResolutionLevel {resolution_level}/"
                           f"TimePoint {timepoint}/Channel {channel}/Data"]
        # trailing pad (chunk alignment) may exceed the logical size
        info = self._f.get("DataSetInfo/Image")
        self.shape = self._logical_shape(info)

    def _logical_shape(self, info) -> Tuple[int, int, int]:
        if info is not None and "Z" in info.attrs:
            def geti(k):
                raw = info.attrs[k]
                return int(b"".join(bytes(raw)).decode()
                           if raw.dtype.kind == "S" else raw)

            try:
                return (geti("Z"), geti("Y"), geti("X"))
            except Exception:
                pass
        return tuple(self._ds.shape)

    def __len__(self) -> int:
        return self.shape[0]

    def __getitem__(self, z):
        if isinstance(z, slice):
            return np.stack([self[zi] for zi in range(*z.indices(len(self)))])
        return np.asarray(self._ds[z, :self.shape[1], :self.shape[2]])

    def read_roi(self, z0: int, z1: int, y0: int, y1: int,
                 x0: int, x1: int) -> np.ndarray:
        """Read a sub-box directly from the HDF5 dataset — only the ROI's
        chunks are touched (the reference's read_direct source_sel,
        supplements/croping.py:89-90), never whole planes."""
        nz, ny, nx = self.shape
        if not (0 <= z0 <= z1 <= nz and 0 <= y0 <= y1 <= ny
                and 0 <= x0 <= x1 <= nx):
            raise ValueError(
                f"ROI {(z0, z1, y0, y1, x0, x1)} outside volume "
                f"{self.shape}")
        return np.asarray(self._ds[z0:z1, y0:y1, x0:x1])

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def write_imaris(
    path,
    volume_reader,
    shape: Tuple[int, int, int],
    dtype,
    voxel_um: Tuple[float, float, float] = (1.0, 1.0, 1.0),
    n_levels: Optional[int] = None,
    channel_color: str = "Blue",
    compression: int = 2,
    chunk: Tuple[int, int, int] = (16, 256, 256),
) -> Path:
    """Write an Imaris5 HDF5 file with a resolution pyramid.

    volume_reader(z) -> (H, W) plane; planes are streamed so terabyte
    volumes never materialize.  Pyramid levels are xy (and z, when deep
    enough) halvings with mean pooling.
    """
    import h5py

    path = Path(path)
    nz, ny, nx = shape
    if n_levels is None:
        n_levels = 1
        sz = [nz, ny, nx]
        while max(sz[1], sz[2]) > 1024:
            sz = [max(1, s // 2) for s in sz]
            n_levels += 1

    f = h5py.File(path, "w")
    # root attributes (reference build_std_rootattributes,
    # IMS_HDF5Mngr.cpp:190-207: DataSetDirectoryName/DataSetInfoDirectory
    # Name/ThumbnailDirectoryName/ImarisDataSet/ImarisVersion)
    _attr_str(f, "ImarisDataSet", "ImarisDataSet")
    _attr_str(f, "ImarisVersion", "5.5.0")
    _attr_str(f, "DataSetDirectoryName", "DataSet")
    _attr_str(f, "DataSetInfoDirectoryName", "DataSetInfo")
    _attr_str(f, "ThumbnailDirectoryName", "Thumbnail")
    f.attrs["NumberOfDataSets"] = np.uint32(1)

    ds_group = f.create_group("DataSet")
    level_shapes: List[Tuple[int, int, int]] = []
    sz, sy, sx = nz, ny, nx
    for lv in range(n_levels):
        level_shapes.append((sz, sy, sx))
        sz = max(1, sz // 2) if sz > 4 else sz
        sy = max(1, sy // 2)
        sx = max(1, sx // 2)
    datasets = []
    for lv, (lz, ly, lx) in enumerate(level_shapes):
        g = ds_group.create_group(
            f"ResolutionLevel {lv}/TimePoint 0/Channel 0")
        ch = tuple(min(c, s) for c, s in zip(chunk, (lz, ly, lx)))
        d = g.create_dataset("Data", shape=(lz, ly, lx), dtype=dtype,
                             chunks=ch, compression="gzip",
                             compression_opts=compression)
        _attr_str(g, "ImageSizeX", str(lx))
        _attr_str(g, "ImageSizeY", str(ly))
        _attr_str(g, "ImageSizeZ", str(lz))
        datasets.append(d)

    # stream planes; build pyramid via running mean-pool buffers
    buffers: List[List[np.ndarray]] = [[] for _ in level_shapes]
    hist_min, hist_max = np.inf, -np.inf

    def downsample_plane(img, target_hw):
        h, w = img.shape
        th, tw = target_hw
        fy, fx = h // th, w // tw
        if fy > 1 or fx > 1:
            img = img[: th * fy, : tw * fx].reshape(th, fy, tw, fx)
            img = img.mean(axis=(1, 3))
        return img

    # thumbnail MIP accumulates from the streamed planes (decimated to
    # <=256 per axis first) — reading a pyramid level back post-hoc
    # would materialize the whole coarsest level (the FULL volume when
    # n_levels == 1) and break the streaming contract
    t_fy = max(1, ny // 256)
    t_fx = max(1, nx // 256)
    thumb_mip: Optional[np.ndarray] = None

    z_written = [0] * len(level_shapes)
    for z in range(nz):
        plane = np.asarray(volume_reader(z))
        hist_min = min(hist_min, float(plane.min()))
        hist_max = max(hist_max, float(plane.max()))
        datasets[0][z] = plane.astype(dtype)
        small = plane[: (ny // t_fy) * t_fy, : (nx // t_fx) * t_fx]
        small = small.reshape(ny // t_fy, t_fy, nx // t_fx, t_fx)
        small = small.max(axis=(1, 3)).astype(np.float32)
        thumb_mip = small if thumb_mip is None else np.maximum(thumb_mip,
                                                               small)
        # coarser levels
        carry = plane.astype(np.float32)
        for lv in range(1, len(level_shapes)):
            lz, ly, lx = level_shapes[lv]
            carry = downsample_plane(carry, (ly, lx))
            z_factor = level_shapes[0][0] // lz if lz else 1
            buffers[lv].append(carry)
            if len(buffers[lv]) == max(1, z_factor) or z == nz - 1:
                zi = z_written[lv]
                if zi < lz:
                    datasets[lv][zi] = np.mean(buffers[lv], axis=0).astype(dtype)
                    z_written[lv] += 1
                buffers[lv].clear()

    # DataSetInfo layout per the reference's build_std_filestruct
    # (IMS_HDF5Mngr.cpp:211-283): CustomData, ImarisDataSet, Image,
    # Channel N, Log, TimeInfo groups with string-encoded attributes
    timestamp = "2024-01-01 00:00:00.000"
    info = f.create_group("DataSetInfo")
    custom = info.create_group("CustomData")
    _attr_str(custom, "DateAndTime", timestamp)
    _attr_str(custom, "Height", str(ny))
    _attr_str(custom, "Width", str(nx))
    _attr_str(custom, "NumberOfZPoints", str(nz))
    _attr_str(custom, "NumberOfChannels", "1")
    _attr_str(custom, "NumberOfTimePoints", "1")
    _attr_str(custom, "XPosition", "0.00")
    _attr_str(custom, "YPosition", "0.00")
    ids_info = info.create_group("ImarisDataSet")
    _attr_str(ids_info, "Creator", "ipp_tpu")
    _attr_str(ids_info, "NumberOfImages", "1")
    _attr_str(ids_info, "Version", "5.5")
    log_info = info.create_group("Log")
    _attr_str(log_info, "Entries", "0")
    img_info = info.create_group("Image")
    _attr_str(img_info, "Name", path.name)
    _attr_str(img_info, "Description", "(description not specified)")
    _attr_str(img_info, "RecordingDate", timestamp)
    _attr_str(img_info, "X", str(nx))
    _attr_str(img_info, "Y", str(ny))
    _attr_str(img_info, "Z", str(nz))
    _attr_str(img_info, "Unit", "um")
    _attr_str(img_info, "ExtMin0", "0")
    _attr_str(img_info, "ExtMin1", "0")
    _attr_str(img_info, "ExtMin2", "0")
    _attr_str(img_info, "ExtMax0", f"{nx * voxel_um[2]:.3f}")
    _attr_str(img_info, "ExtMax1", f"{ny * voxel_um[1]:.3f}")
    _attr_str(img_info, "ExtMax2", f"{nz * voxel_um[0]:.3f}")
    ch_info = info.create_group("Channel 0")
    _attr_str(ch_info, "Name", "Channel 1")
    _attr_str(ch_info, "Description", "")
    _attr_str(ch_info, "Color", {"Blue": "0 0 1", "Green": "0 1 0",
                                 "Red": "1 0 0"}.get(channel_color, "1 1 1"))
    _attr_str(ch_info, "ColorMode", "BaseColor")
    _attr_str(ch_info, "HistogramMin", f"{hist_min:.3f}")
    _attr_str(ch_info, "HistogramMax", f"{hist_max:.3f}")
    time_info = info.create_group("TimeInfo")
    _attr_str(time_info, "DataSetTimePoints", "1")
    _attr_str(time_info, "FileTimePoints", "1")
    _attr_str(time_info, "TimePoint1", timestamp)

    # Thumbnail: RGBA MIP accumulated during the plane stream, the group
    # Imaris shows in its file browser (IMS_HDF5Mngr.cpp:283 Thumbnail
    # group; real files carry a Thumbnail/Data uint8 RGBA dataset)
    thumb = f.create_group("Thumbnail")
    if thumb_mip is None:
        thumb_mip = np.zeros((1, 1), np.float32)
    rng_ = max(hist_max - hist_min, 1e-6)
    gray = np.clip((thumb_mip - hist_min) / rng_ * 255.0,
                   0, 255).astype(np.uint8)
    rgba = np.dstack([gray, gray, gray,
                      np.full_like(gray, 255)])
    # Imaris stores the thumbnail as (H, 4*W) uint8 rows of RGBA samples
    thumb.create_dataset("Data", data=rgba.reshape(gray.shape[0], -1))
    f.close()
    return path


def write_imaris_timeseries(
    path,
    volume_reader,
    shape_tzyx: Tuple[int, int, int, int],
    dtype,
    voxel_um: Tuple[float, float, float] = (1.0, 1.0, 1.0),
    channel_color: str = "Blue",
) -> Path:
    """4D time-series .ims: one DataSet TimePoint group per t
    (the TeraStitcher imagemanager TimeSeries role,
    src/imagemanager/TimeSeries.h — multi-TimePoint volumes the 3D
    pipelines never produce but the Imaris5 format supports).

    volume_reader(t, z) -> (H, W) plane.  Written single-resolution (time
    series are small QC/alignment artifacts here; the pyramid writer is
    write_imaris).
    """
    import h5py

    path = Path(path)
    nt, nz, ny, nx = shape_tzyx
    f = h5py.File(path, "w")
    _attr_str(f, "ImarisDataSet", "ImarisDataSet")
    _attr_str(f, "ImarisVersion", "5.5.0")
    _attr_str(f, "DataSetDirectoryName", "DataSet")
    _attr_str(f, "DataSetInfoDirectoryName", "DataSetInfo")
    _attr_str(f, "ThumbnailDirectoryName", "Thumbnail")
    f.attrs["NumberOfDataSets"] = np.uint32(1)
    ds = f.create_group("DataSet")
    hist_min, hist_max = np.inf, -np.inf
    for t in range(nt):
        g = ds.create_group(f"ResolutionLevel 0/TimePoint {t}/Channel 0")
        d = g.create_dataset("Data", shape=(nz, ny, nx), dtype=dtype,
                             chunks=(min(16, nz), min(256, ny),
                                     min(256, nx)),
                             compression="gzip", compression_opts=2)
        _attr_str(g, "ImageSizeX", str(nx))
        _attr_str(g, "ImageSizeY", str(ny))
        _attr_str(g, "ImageSizeZ", str(nz))
        for z in range(nz):
            plane = np.asarray(volume_reader(t, z))
            hist_min = min(hist_min, float(plane.min()))
            hist_max = max(hist_max, float(plane.max()))
            d[z] = plane.astype(dtype)

    timestamp = "2024-01-01 00:00:00.000"
    info = f.create_group("DataSetInfo")
    custom = info.create_group("CustomData")
    _attr_str(custom, "DateAndTime", timestamp)
    _attr_str(custom, "Height", str(ny))
    _attr_str(custom, "Width", str(nx))
    _attr_str(custom, "NumberOfZPoints", str(nz))
    _attr_str(custom, "NumberOfChannels", "1")
    _attr_str(custom, "NumberOfTimePoints", str(nt))
    img_info = info.create_group("Image")
    _attr_str(img_info, "Name", path.name)
    _attr_str(img_info, "Unit", "um")
    _attr_str(img_info, "X", str(nx))
    _attr_str(img_info, "Y", str(ny))
    _attr_str(img_info, "Z", str(nz))
    for i, (ext, vox, npix) in enumerate(
            zip("012", voxel_um[::-1], (nx, ny, nz))):
        _attr_str(img_info, f"ExtMin{ext}", "0")
        _attr_str(img_info, f"ExtMax{ext}", f"{npix * vox:.3f}")
    ch_info = info.create_group("Channel 0")
    _attr_str(ch_info, "Name", "Channel 1")
    _attr_str(ch_info, "Color", {"Blue": "0 0 1", "Green": "0 1 0",
                                 "Red": "1 0 0"}.get(channel_color, "1 1 1"))
    _attr_str(ch_info, "HistogramMin", f"{hist_min:.3f}")
    _attr_str(ch_info, "HistogramMax", f"{hist_max:.3f}")
    ti = info.create_group("TimeInfo")
    _attr_str(ti, "DataSetTimePoints", str(nt))
    _attr_str(ti, "FileTimePoints", str(nt))
    for t in range(1, nt + 1):
        _attr_str(ti, f"TimePoint{t}", timestamp)
    f.create_group("Thumbnail")
    f.close()
    return path


def tif_series_to_imaris(tif_dir, ims_path,
                         voxel_um: Tuple[float, float, float] = (1, 1, 1),
                         channel_color: str = "Blue") -> Path:
    """Convert an img_ZZZZZZ.tif series to .ims
    (the get_imaris_command role, process_images.py:1000-1045)."""
    from . import tiff as tio

    tif_dir = Path(tif_dir)
    paths = sorted(tif_dir.glob("*.tif"))
    if not paths:
        raise FileNotFoundError(f"no TIFFs in {tif_dir}")
    first = tio.imread(paths[0])

    def reader(z):
        return tio.imread(paths[z])

    return write_imaris(ims_path, reader,
                        (len(paths),) + tuple(first.shape), first.dtype,
                        voxel_um=voxel_um, channel_color=channel_color)
