"""TeraFly multi-resolution pyramid export.

Native replacement for the reference's `teraconverter` + `paraconverter`
MPI wrapper (reference: process_images.py:751-783 launches
`mpiexec paraconverter --sfmt="TIFF (series, 2D)" --dfmt="TIFF (tiled, 2D)"`;
layout produced per TeraStitcher VolumeConverter::generateTiles,
src/utils/volumeconverter/VolumeConverter.cpp:928-1010):

    out/RES(HxWxD)/VVVVVV/VVVVVV_HHHHHH/VVVVVV_HHHHHH_ZZZZZZ.tif

where VVVVVV/HHHHHH/ZZZZZZ are the block's absolute position in tenths of
micrometers at that resolution.  Each level halves x/y (and z, tracking the
reference's halve_pow2 scheme) with mean pooling.  TeraFly/Vaa3D imports
this hierarchy directly (mdata.bin is regenerated by the importer).
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, Optional, Tuple

import numpy as np

from . import tiff as tio
from ..utils.progress import ProgressReporter

__all__ = ["export_terafly", "tif_series_to_terafly", "TeraFlyVolume",
           "write_mdata_bin", "read_mdata_bin", "regenerate_mdata"]


def regenerate_mdata(res_dir, voxel_um_vhd=(1.0, 1.0, 1.0)) -> Path:
    """Rebuild mdata.bin for an existing RES(...) level by scanning the
    V/V_H directory hierarchy (the TeraStitcher `mdatagenerator` utility
    role, utils/mdatagenerator) — for pyramids produced by other tools or
    with lost metadata."""
    res_dir = Path(res_dir)
    vdirs = sorted((d for d in res_dir.iterdir()
                    if d.is_dir() and d.name.isdigit()),
                   key=lambda d: int(d.name))
    if not vdirs:
        raise FileNotFoundError(f"no V dirs under {res_dir}")
    stacks = []
    dim_v = dim_h = dim_d = 0
    vv, vh, vd = voxel_um_vhd
    for vdir in vdirs:
        row = []
        for hdir in sorted(d for d in vdir.iterdir() if d.is_dir()):
            files = sorted(hdir.glob("*.tif"))
            v_t, h_t = hdir.name.split("_")
            abs_v = int(round(int(v_t) / 10.0 / vv))
            abs_h = int(round(int(h_t) / 10.0 / vh))
            if files:
                first = tio.imread(files[0])
                height, width = first.shape[:2]
            else:
                height = width = 0  # placeholder: keeps the grid DENSE —
                # write/read_mdata_bin serialize exactly n_rows x n_cols
                # records, so a skipped empty block dir would desync the
                # binary stream
            row.append(dict(height=height, width=width,
                            depth=len(files), abs_v=abs_v, abs_h=abs_h,
                            dir_name=f"{vdir.name}/{hdir.name}",
                            filenames=[f.name for f in files]))
            if files:
                dim_v = max(dim_v, abs_v + height)
                dim_h = max(dim_h, abs_h + width)
                dim_d = max(dim_d, len(files))
        if row:
            stacks.append(row)
    if not stacks:
        raise ValueError(f"no block rows under {res_dir}: nothing to "
                         f"serialize into mdata.bin")
    n_cols = max(len(r) for r in stacks)
    if any(len(r) != n_cols for r in stacks):
        raise ValueError(
            f"jagged block grid under {res_dir}: rows have "
            f"{sorted({len(r) for r in stacks})} column counts — the "
            f"mdata.bin format needs a dense n_rows x n_cols grid")
    return write_mdata_bin(res_dir, voxel_um_vhd, (dim_v, dim_h, dim_d),
                           stacks)


def write_mdata_bin(res_dir: Path, voxel_um_vhd: Tuple[float, float, float],
                    dim_vhd: Tuple[int, int, int],
                    stacks) -> Path:
    """Emit the binary metadata file TeraFly/Vaa3D loads to skip re-import
    (StackedVolume::saveBinaryMetadata, imagemanager/StackedVolume.cpp:
    190-222 + Stack::binarizeInto, Stack.cpp:139-162; version 2, axis enum
    IM_config.h:212 vertical=1 horizontal=2 depth=3).

    stacks: row-major list of lists of dicts with keys
    height/width/depth/abs_v/abs_h/dir_name/filenames."""
    import struct

    p = Path(res_dir) / "mdata.bin"
    vv, vh, vd = voxel_um_vhd
    dv, dh, dd = dim_vhd
    n_rows = len(stacks)
    n_cols = len(stacks[0]) if n_rows else 0
    out = bytearray()
    out += struct.pack("<f", 2.0)  # MDATA_BIN_FILE_VERSION
    out += struct.pack("<iii", 1, 2, 3)  # ref system V, H, D
    out += struct.pack("<fff", vv, vh, vd)  # VXL_1..3 (import order)
    out += struct.pack("<fff", vv, vh, vd)  # VXL_V/H/D
    out += struct.pack("<fff", 0.0, 0.0, 0.0)  # ORG_V/H/D (mm)
    out += struct.pack("<III", dv, dh, dd)
    out += struct.pack("<HH", n_rows, n_cols)
    for row in stacks:
        for s in row:
            out += struct.pack("<iiiii", s["height"], s["width"],
                               s["depth"], s["abs_v"], s["abs_h"])
            d = s["dir_name"].encode() + b"\0"
            out += struct.pack("<H", len(d)) + d
            for fn in s["filenames"]:
                f = fn.encode() + b"\0"
                out += struct.pack("<H", len(f)) + f
    tmp = p.with_suffix(".bin.tmp")
    tmp.write_bytes(bytes(out))
    tmp.replace(p)
    return p


def read_mdata_bin(path) -> dict:
    """Parse mdata.bin (inverse of write_mdata_bin; format of
    StackedVolume::load, imagemanager/StackedVolume.cpp:225-330)."""
    import struct

    data = Path(path).read_bytes()
    off = 0

    def take(fmt):
        nonlocal off
        vals = struct.unpack_from("<" + fmt, data, off)
        off += struct.calcsize("<" + fmt)
        return vals

    (version,) = take("f")
    ax = take("iii")
    vxl123 = take("fff")
    vxl_vhd = take("fff")
    org_vhd = take("fff")
    dim_vhd = take("III")
    n_rows, n_cols = take("HH")
    stacks = []
    for _r in range(n_rows):
        row = []
        for _c in range(n_cols):
            h, w, d, abs_v, abs_h = take("iiiii")
            (sl,) = take("H")
            dir_name = data[off:off + sl - 1].decode()
            off += sl
            files = []
            for _z in range(d):
                (fl,) = take("H")
                files.append(data[off:off + fl - 1].decode())
                off += fl
            row.append(dict(height=h, width=w, depth=d, abs_v=abs_v,
                            abs_h=abs_h, dir_name=dir_name,
                            filenames=files))
        stacks.append(row)
    return dict(version=version, axes=ax, voxel=vxl_vhd, origin=org_vhd,
                dim=dim_vhd, vxl123=vxl123, stacks=stacks)


def _halvings_for(shape_yx: Tuple[int, int], min_dim: int = 400) -> int:
    n = 1
    h, w = shape_yx
    while min(h, w) // 2 >= min_dim:
        h //= 2
        w //= 2
        n += 1
    return n


def export_terafly(
    plane_reader: Callable[[int], np.ndarray],
    shape_zyx: Tuple[int, int, int],
    out_dir,
    voxel_um: Tuple[float, float, float] = (1.0, 1.0, 1.0),
    block_yx: Tuple[int, int] = (256, 256),
    n_resolutions: Optional[int] = None,
    halve_z: bool = True,
    dtype=None,
    progress: bool = False,
    halve: str = "mean",
    block_format: str = "tiff2d",
    block_z: int = 256,
) -> Path:
    """Stream z planes into a TeraFly pyramid.

    voxel_um is (z, y, x).  Each resolution level i scales x/y by 2^-i and
    z by 2^-i when halve_z (the reference's halve_pow2[i]=i scheme for
    near-isotropic volumes) else keeps z full.  `halve` is the pyramid
    pooling method — 'mean' or 'max' (the reference teraconverter's
    --halve=mean/max option, utils/volumeconverter).

    block_format: 'tiff2d' (one 2D TIFF per block per z — the
    TiledXY|2Dseries layout) or 'vaa3draw' — each block dir holds Vaa3D
    raw stacks of up to `block_z` planes (the reference's
    mergeTilesVaa3DRaw output, StackStitcher.h:338 + RawFmtMngr.cpp),
    readable by Vaa3D itself and by TeraFlyVolume.
    """
    if halve not in ("mean", "max"):
        raise ValueError(f"halve must be mean|max, got {halve}")
    if block_format not in ("tiff2d", "vaa3draw"):
        raise ValueError(f"block_format must be tiff2d|vaa3draw, "
                         f"got {block_format}")
    pool2d = (lambda a: a.max(axis=(1, 3))) if halve == "max" else \
        (lambda a: a.mean(axis=(1, 3)))
    poolz = np.max if halve == "max" else np.mean
    out_dir = Path(out_dir)
    nz, ny, nx = shape_zyx
    vz, vy, vx = voxel_um
    if n_resolutions is None:
        n_resolutions = _halvings_for((ny, nx))
    levels = []
    for i in range(n_resolutions):
        zdiv = (1 << i) if halve_z else 1
        lh, lw, ld = ny >> i, nx >> i, max(1, nz // zdiv)
        res_dir = out_dir / f"RES({lh}x{lw}x{ld})"
        # block grid at this level
        bh = min(block_yx[0], lh)
        bw = min(block_yx[1], lw)
        rows = [(r, min(bh, lh - r)) for r in range(0, lh, bh)]
        cols = [(c, min(bw, lw - c)) for c in range(0, lw, bw)]
        meta = []
        for r0, rh in rows:
            v_name = f"{int(round(r0 * vy * (1 << i) * 10)):06d}"
            mrow = []
            for c0, cw in cols:
                h_name = f"{int(round(c0 * vx * (1 << i) * 10)):06d}"
                (res_dir / v_name / f"{v_name}_{h_name}").mkdir(
                    parents=True, exist_ok=True)
                mrow.append(dict(height=rh, width=cw, depth=ld,
                                 abs_v=r0, abs_h=c0,
                                 dir_name=f"{v_name}/{v_name}_{h_name}",
                                 filenames=[]))
            meta.append(mrow)
        levels.append(dict(i=i, zdiv=zdiv, lh=lh, lw=lw, ld=ld,
                           res_dir=res_dir, rows=rows, cols=cols,
                           z_accum=[], z_written=0, meta=meta,
                           blk_buf=[], blk_z0=0))

    prog = ProgressReporter(nz, desc="terafly") if progress else None
    out_dtype = dtype

    def write_level_plane(lv, plane2d, z_index):
        i = lv["i"]
        if block_format == "vaa3draw":
            # buffer up to block_z planes, flush as one Vaa3D raw stack
            # per block (mergeTilesVaa3DRaw's z-chunked block files)
            lv["blk_buf"].append(plane2d)
            if len(lv["blk_buf"]) == block_z or z_index == lv["ld"] - 1:
                _flush_vaa3d_chunk(lv)
            return
        for ri, (r0, rh) in enumerate(lv["rows"]):
            v_name = f"{int(round(r0 * vy * (1 << i) * 10)):06d}"
            for ci, (c0, cw) in enumerate(lv["cols"]):
                h_name = f"{int(round(c0 * vx * (1 << i) * 10)):06d}"
                z_name = f"{int(round(z_index * vz * lv['zdiv'] * 10)):06d}"
                fname = f"{v_name}_{h_name}_{z_name}.tif"
                p = (lv["res_dir"] / v_name / f"{v_name}_{h_name}" / fname)
                tio.imwrite(p, plane2d[r0:r0 + rh, c0:c0 + cw])
                lv["meta"][ri][ci]["filenames"].append(fname)

    def _flush_vaa3d_chunk(lv):
        from .vaa3draw import vaa3d_raw_write

        if not lv["blk_buf"]:
            return
        i = lv["i"]
        chunk = np.stack(lv["blk_buf"])
        lv["blk_buf"].clear()
        z_name = f"{int(round(lv['blk_z0'] * vz * lv['zdiv'] * 10)):06d}"
        lv["blk_z0"] += chunk.shape[0]
        for ri, (r0, rh) in enumerate(lv["rows"]):
            v_name = f"{int(round(r0 * vy * (1 << i) * 10)):06d}"
            for ci, (c0, cw) in enumerate(lv["cols"]):
                h_name = f"{int(round(c0 * vx * (1 << i) * 10)):06d}"
                fname = f"{v_name}_{h_name}_{z_name}.raw"
                p = (lv["res_dir"] / v_name / f"{v_name}_{h_name}" / fname)
                vaa3d_raw_write(p, chunk[:, r0:r0 + rh, c0:c0 + cw])
                lv["meta"][ri][ci]["filenames"].append(fname)

    for z in range(nz):
        plane = np.asarray(plane_reader(z))
        nonlocal_dtype = out_dtype or plane.dtype
        carry = plane
        for lv in levels:
            i = lv["i"]
            if i > 0:
                h, w = carry.shape
                th, tw = lv["lh"], lv["lw"]
                carry = carry[: th * 2, : tw * 2].astype(np.float32)
                carry = pool2d(carry.reshape(th, 2, tw, 2))
            if lv["zdiv"] == 1:
                write_level_plane(lv, carry.astype(nonlocal_dtype), z)
            else:
                lv["z_accum"].append(carry.astype(np.float32))
                if len(lv["z_accum"]) == lv["zdiv"] or z == nz - 1:
                    if lv["z_written"] < lv["ld"]:
                        merged = poolz(lv["z_accum"], axis=0)
                        write_level_plane(lv, merged.astype(nonlocal_dtype),
                                          lv["z_written"])
                        lv["z_written"] += 1
                    lv["z_accum"].clear()
        if prog:
            prog.step()
    # binary metadata per level so TeraFly/Vaa3D skips re-import
    # (the reference regenerates it via `mdatagenerator`)
    for lv in levels:
        if block_format == "vaa3draw":
            _flush_vaa3d_chunk(lv)  # partial tail chunk
        i = lv["i"]
        scale = 1 << i
        for row in lv["meta"]:
            for s in row:
                # mdata.bin's depth field doubles as the per-block file
                # count in the stream layout (== z depth for 2D series;
                # == number of Vaa3D raw chunks for vaa3draw blocks —
                # the level z depth lives in dim_vhd)
                s["depth"] = len(s["filenames"])
        write_mdata_bin(
            lv["res_dir"],
            (vy * scale, vx * scale, vz * lv["zdiv"]),
            (lv["lh"], lv["lw"], lv["ld"]), lv["meta"])
    return out_dir


def tif_series_to_terafly(tif_dir, out_dir,
                          voxel_um: Tuple[float, float, float] = (1, 1, 1),
                          **kwargs) -> Path:
    """Convert an img_ZZZZZZ.tif series into a TeraFly pyramid
    (the `teraconverter --sfmt='TIFF (series, 2D)'` role)."""
    tif_dir = Path(tif_dir)
    paths = sorted(tif_dir.glob("*.tif"))
    if not paths:
        raise FileNotFoundError(f"no TIFFs in {tif_dir}")
    first = tio.imread(paths[0])
    return export_terafly(lambda z: tio.imread(paths[z]),
                          (len(paths),) + tuple(first.shape), out_dir,
                          voxel_um=voxel_um, **kwargs)


class TeraFlyVolume:
    """Read a TeraFly hierarchy back as a z-indexed volume (the TeraStitcher
    imagemanager TiledVolume role, for one resolution level).

    Block dirs are VVVVVV/VVVVVV_HHHHHH with files VVVVVV_HHHHHH_ZZZZZZ.tif;
    names are tenths of micrometers at this level's voxel size."""

    def __init__(self, root, resolution: int = 0,
                 voxel_um: Tuple[float, float, float] = (1.0, 1.0, 1.0)):
        root = Path(root)
        res_dirs = sorted(root.glob("RES(*)"),
                          key=lambda d: -np.prod(self._parse_res(d.name)))
        if not res_dirs:
            raise FileNotFoundError(f"no RES(...) level under {root}")
        self.res_dir = res_dirs[min(resolution, len(res_dirs) - 1)]
        self.shape = tuple(self._parse_res(self.res_dir.name))  # (H, W, D)
        scale = 1 << min(resolution, len(res_dirs) - 1)
        self.voxel_um = (voxel_um[0] * scale, voxel_um[1] * scale,
                         voxel_um[2] * scale)
        # block index: (v0_px, h0_px) -> z files, from mdata.bin when
        # present (no directory walk — the TiledVolume fast-load path),
        # else by scanning the tenths-of-um dir names
        self.blocks = []
        mdata = self.res_dir / "mdata.bin"
        if mdata.exists():
            info = read_mdata_bin(mdata)
            for row in info["stacks"]:
                for s in row:
                    zfiles = [self.res_dir / s["dir_name"] / fn
                              for fn in s["filenames"]]
                    self.blocks.append((s["abs_v"], s["abs_h"], zfiles))
            return
        vz, vy, vx = self.voxel_um
        for vdir in sorted(d for d in self.res_dir.iterdir() if d.is_dir()):
            for hdir in sorted(d for d in vdir.iterdir() if d.is_dir()):
                v_t, h_t = hdir.name.split("_")
                v0 = int(round(int(v_t) / 10.0 / vy))
                h0 = int(round(int(h_t) / 10.0 / vx))
                zfiles = sorted(hdir.glob("*.tif")) or \
                    sorted(hdir.glob("*.raw")) or sorted(hdir.glob("*.v3draw"))
                self.blocks.append((v0, h0, zfiles))

    @staticmethod
    def _parse_res(name: str):
        h, w, d = name[4:-1].split("x")
        return int(h), int(w), int(d)

    def _read_block_plane(self, zfiles, z):
        """One block's plane z: per-plane 2D TIFFs, or z-chunked Vaa3D
        raw stacks (block_format='vaa3draw'; chunk depths come from the
        43-byte headers, cached)."""
        if zfiles and zfiles[0].suffix.lower() in (".raw", ".v3draw"):
            from .vaa3draw import vaa3d_raw_info, vaa3d_raw_read_plane

            if not hasattr(self, "_raw_depths"):
                self._raw_depths = {}
            zz = z
            for p in zfiles:
                dz = self._raw_depths.get(p)
                if dz is None:
                    dz = self._raw_depths[p] = vaa3d_raw_info(p)[1][1]
                if zz < dz:
                    return vaa3d_raw_read_plane(p, zz)
                zz -= dz
            return None
        if z >= len(zfiles):  # empty/short placeholder block
            return None
        return tio.imread(zfiles[z])

    def read_plane(self, z: int) -> np.ndarray:
        h, w, d = self.shape
        if not 0 <= z < d:
            raise IndexError(z)
        out = None
        for v0, h0, zfiles in self.blocks:
            blk = self._read_block_plane(zfiles, z)
            if blk is None:
                continue
            if out is None:
                out = np.zeros((h, w), blk.dtype)
            out[v0:v0 + blk.shape[0], h0:h0 + blk.shape[1]] = blk
        if out is None:
            out = np.zeros((h, w), np.uint16)
        return out

    def __len__(self):
        return self.shape[2]

    def __getitem__(self, z):
        if isinstance(z, slice):
            return np.stack([self.read_plane(i)
                             for i in range(*z.indices(len(self)))])
        return self.read_plane(z)
