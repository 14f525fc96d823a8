"""Small volume utilities — the tsv/ mini-CLI family (port of
ipp_tpu/pipeline/tsv_tools.py; same subcommands, flags and defaults).
Device work runs on one device: the block reductions of `downsample`,
the blends of `justified_stitch`, `convert` and `simple` (through
stitch/merge.merge_to_tif_series and stitch/blend.PlaneBlender), the 3D
resize of `resize3d` and the z resize of `npz`; the merges of `convert`
and `simple` blend over the device mesh of `parallel.mesh.default_mesh`
when more than one card is visible.

Equivalents of the reference's small tools:
- downsample_series: 2x downsample of a TIFF dir (tsv/downsample.py:11-55)
- fill_blanks_tree: zero-fill every missing (x, y, z) tile plane of a
  microscope tree into the destriped dest tree (tsv/fill_blanks.py:32-101)
- fill_blanks: synthesize missing z planes in a flat series by copying
  the nearest neighbor (supplements/replace_missing_files.py's role)
- justified_stitch: overlap-blend two planes with a known offset
  (tsv/stitch.py:16-193)
- simple_stitch: nominal-position stitch of a SmartSPIM tree
  (tsv/simple.py:66-101, TSVSimpleVolume + convert)
- simple_grid_stitch: fixed-offset grid stitch without NCC
- renumber_series: renumber plane files to a contiguous 0..N-1 range
  (tsv/renumber*.py)
- generate_downsampled_npz: standalone npz generator
  (downsampled_npz_generator.py:51-132)
"""

from __future__ import annotations

import argparse
import re
import shutil
import sys
from pathlib import Path
from typing import List, Tuple

import numpy as np
import torch

from ..geometry.extent import VExtent
from ..io import tiff as tio
from ..ops.resample import block_reduce
from ..stitch.blend import PlaneBlender
from ..utils.device import resolve_device
from ..utils.log import Logger
from ..utils.transfer import upload

__all__ = ["downsample_series", "fill_blanks", "fill_blanks_tree",
           "justified_stitch", "simple_grid_stitch", "simple_stitch",
           "renumber_series", "generate_downsampled_npz", "pfc_to_ls",
           "main"]


def fill_blanks_tree(src, dest=None, silent: bool = True) -> int:
    """Zero-fill missing tile planes of a two-level microscope tree
    (reference tsv/fill_blanks.py:32-101): discover every X (top dirs),
    Y ("X_Y" dirs) and Z (plane file names) coordinate under `src`, then
    write an all-zeros TIFF into `dest` (default src + "_destriped") for
    every (x, y, z) of the FULL product whose dest plane is missing —
    the acquisition gaps the stitcher would otherwise trip over.

    Returns the number of blanks written.  Deviation: dest x/y dirs are
    created only for numeric coordinates (the reference mkdirs a dest
    dir for any src dir before checking the name parses)."""
    src = Path(src)
    dest = Path(dest) if dest is not None else src.parent / (
        src.name + "_destriped")
    xs, ys, zs = set(), set(), set()
    n_digits = z_digits = None
    blank = None
    for dx in sorted(src.iterdir()):
        if not dx.is_dir():
            continue
        try:
            xs.add(int(dx.name))
        except ValueError:
            continue
        n_digits = len(dx.name)
        for dy in sorted(dx.iterdir()):
            if not dy.is_dir():
                continue
            try:
                _, y = (int(p) for p in dy.name.split("_"))
            except ValueError:
                continue
            ys.add(y)
            for f in sorted(dy.iterdir()):
                try:
                    zs.add(int(f.stem))
                except ValueError:
                    continue
                if blank is None:
                    z_digits = len(f.stem)
                    from ..io.raw import raw_imread

                    img = (raw_imread(f) if f.suffix.lower() == ".raw"
                           else tio.imread(f))
                    blank = np.zeros(img.shape, img.dtype)
    if blank is None:
        return 0
    n_filled = 0
    for x in sorted(xs):
        for y in sorted(ys):
            d = dest / f"{x:0{n_digits}d}" / \
                f"{x:0{n_digits}d}_{y:0{n_digits}d}"
            d.mkdir(parents=True, exist_ok=True)
            for z in sorted(zs):
                p = d / f"{z:0{z_digits}d}.tif"
                if not p.exists():
                    tio.imwrite(p, blank, compression="zlib:9")
                    n_filled += 1
                    if not silent:
                        print(f"blank {p}")
    return n_filled


def downsample_series(src, output_dir, factor: int = 2,
                      method: str = "sum", z_factor: int = 1,
                      compression: int = 4) -> int:
    """2D-downsample EVERY plane of a series, preserving file names
    (reference tsv/downsample.py:11-55: block_reduce at skimage's default
    reducer — SUM — then cast back to the input dtype, wrap-around and
    all; pass method='mean' for a non-saturating variant).

    `src` is a directory or a glob (the reference's --src form).
    z_factor > 1 additionally keeps every z_factor-th plane (our
    extension; the reference tool is 2D-only)."""
    src = Path(src)
    if src.is_dir():
        paths = sorted(p for p in src.iterdir()
                       if p.suffix.lower() in (".tif", ".tiff"))
    else:
        import glob as _glob

        paths = [Path(p) for p in sorted(_glob.glob(str(src)))]
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    kept = paths[::max(1, z_factor)]
    level = max(0, min(9, compression))
    dev = resolve_device()
    for p in kept:
        img = tio.imread(p)
        small = block_reduce(upload(img, dev), (factor, factor),
                             method).cpu().numpy()
        small = small.astype(img.dtype)
        tio.imwrite(output_dir / p.name, small,
                    compression=f"zlib:{level}" if level else None)
    return len(kept)


def fill_blanks(directory, pattern: str = r"img_(\d+)\.tif") -> int:
    """Insert copies of the nearest plane for missing indices
    (reference tsv/fill_blanks.py)."""
    directory = Path(directory)
    rx = re.compile(pattern)
    found = {}
    for p in directory.iterdir():
        m = rx.fullmatch(p.name)
        if m:
            found[int(m.group(1))] = p
    if not found:
        return 0
    n_filled = 0
    lo, hi = min(found), max(found)
    for i in range(lo, hi + 1):
        if i not in found:
            nearest = min(found, key=lambda k: abs(k - i))
            target = directory / f"img_{i:06d}.tif"
            shutil.copy(found[nearest], target)
            n_filled += 1
    return n_filled


def justified_stitch(plane_a: np.ndarray, plane_b: np.ndarray,
                     offset_yx: Tuple[int, int],
                     cosine: bool = True) -> np.ndarray:
    """Blend two planes with plane_b placed at offset (y, x) relative to
    plane_a (reference tsv/stitch.py two-plane justified stitch)."""
    dy, dx = offset_yx
    ha, wa = plane_a.shape
    hb, wb = plane_b.shape
    exts = [VExtent(0, wa, 0, ha, 0, 1),
            VExtent(dx, dx + wb, dy, dy + hb, 0, 1)]
    x0 = min(e.x0 for e in exts)
    y0 = min(e.y0 for e in exts)
    exts = [e.shifted(dx=-x0, dy=-y0) for e in exts]
    blender = PlaneBlender(exts, cosine=cosine)
    bbox = VExtent(0, max(e.x1 for e in exts), 0, max(e.y1 for e in exts),
                   0, 1)
    planes = [plane_a, plane_b]

    def reader(i, inter):
        e = exts[i]
        return planes[i][None, inter.y0 - e.y0:inter.y1 - e.y0,
                         inter.x0 - e.x0:inter.x1 - e.x0]

    return blender.blend_plane(bbox, reader, dtype=plane_a.dtype)


def simple_grid_stitch(tile_dirs: List[List[Path]], out_dir,
                       overlap: int, cosine: bool = True) -> Path:
    """Fixed-offset grid stitch without alignment (reference tsv/simple.py):
    tiles placed at nominal stage positions only."""
    from ..geometry.stacks import TileGrid, TileStack

    rows = len(tile_dirs)
    cols = len(tile_dirs[0])
    stacks = []
    for r in range(rows):
        row = []
        for c in range(cols):
            d = Path(tile_dirs[r][c])
            s = TileStack(row=r, col=c, dir_name=d.name,
                          root_dir=str(d.parent))
            th, tw = s.plane_shape
            s.abs_v = r * (th - overlap)
            s.abs_h = c * (tw - overlap)
            row.append(s)
        stacks.append(row)
    grid = TileGrid(stacks)
    from ..parallel.mesh import default_mesh
    from ..stitch.merge import merge_to_tif_series

    mesh, plane_batch = default_mesh()
    out, _ = merge_to_tif_series(grid, out_dir, cosine_blending=cosine,
                                 mesh=mesh, plane_batch=plane_batch)
    return out


def pfc_to_ls(root, target, xy_step: int, z_step: int,
              frame_shape: Tuple[int, int] = (2048, 2048)) -> int:
    """Restructure a PFC plane tree into the SmartSPIM/TeraStitcher
    two-level column/row layout (reference supplements/PFC_to_LS.m:27-80).

    Source layout: root/Z*/Y*/{Z}_{Y}_{X}.tif — one 2D plane per file,
    X encoded as the trailing token of the stem (the reference slices
    fixed character positions 17:23 of its site's names; the trailing
    '_'-separated token is the same field, position-independent).

    Target layout: target/sY/sY_sX/sZ.tif with the reference's exact
    index mapping — Y folders REVERSE-sorted become columns at
    kY*xy_step, X tokens numerically sorted (AdvanceSort, 'X' stripped)
    become rows at kX*xy_step (both 1-based), z planes at (kZ-1)*z_step
    (0-based), all rendered %06d.  Missing source planes are replaced by
    an all-zeros uint16 frame (the reference's blank.tif); existing
    target planes are never rewritten ('cp -u').

    Returns the number of planes written.  The dead overview-stitch code
    after the script's `return` (naive fixed-overlap abutting) is served
    by simple_grid_stitch."""
    root, target = Path(root), Path(target)
    z_folders = sorted(d.name for d in root.iterdir() if d.is_dir())
    y_folders: set = set()
    x_tokens: set = set()
    for z in z_folders:
        for dy in (root / z).iterdir():
            if not dy.is_dir():
                continue
            y_folders.add(dy.name)
            for f in dy.glob("*.tif"):
                x_tokens.add(f.stem.split("_")[-1])
    ys = sorted(y_folders, reverse=True)       # reverse sort -> columns
    xs = sorted(x_tokens,                       # AdvanceSort: numeric
                key=lambda t: int(t.lstrip("X") or 0))
    blank = np.zeros(frame_shape, np.uint16)
    written = 0
    for ky, y in enumerate(ys, start=1):
        s_x = f"{ky * xy_step:06d}"
        for kx, x in enumerate(xs, start=1):
            s_y = f"{kx * xy_step:06d}"
            out_dir = target / s_y / f"{s_y}_{s_x}"
            out_dir.mkdir(parents=True, exist_ok=True)
            for kz, z in enumerate(z_folders):
                dst = out_dir / f"{kz * z_step:06d}.tif"
                if dst.exists():
                    continue
                src_f = root / z / y / f"{z}_{y}_{x}.tif"
                if src_f.is_file():
                    shutil.copy2(src_f, dst)
                else:
                    tio.imwrite(dst, blank)
                written += 1
    return written


def renumber_tree(root, n_digits: int = 6) -> int:
    """Zero-pad the numeric plane names of a two-level stack hierarchy so
    alphabetical order == numeric order (reference tsv/renumber.py:23-37:
    root/*/*/*.tiff, index preserved — NOT renumbered contiguous)."""
    root = Path(root)
    n = 0
    for p in sorted(root.glob("*/*/*.tiff")):
        try:
            idx = int(p.name.split(".")[0])
        except ValueError:
            continue
        dest = p.parent / f"{idx:0{n_digits}d}.tiff"
        if dest != p:
            p.rename(dest)
            n += 1
    return n


def renumber_directories(path) -> int:
    """Shift negative SmartSPIM stage coordinates positive by renaming
    <X>/<X>_<Y> dirs with a +(-min) offset (reference
    tsv/renumber_directories.py:20-60; TeraStitcher can't take negative
    names).  Returns the number of renamed directories."""
    path = Path(path)
    coords = []
    min_x = min_y = 0
    xdirs = {}
    for dx in path.iterdir():
        if not dx.is_dir():
            continue
        try:
            x_of_dir = int(dx.name)
        except ValueError:
            continue
        xdirs[x_of_dir] = dx
        for dy in dx.iterdir():
            if dy.is_dir() and "_" in dy.name:
                try:
                    x, y = (int(v) for v in dy.name.split("_"))
                except ValueError:
                    continue
                coords.append((dy, x, y))
                min_x = min(min_x, x)
                min_y = min(min_y, y)
    if min_x == 0 and min_y == 0:
        return 0
    n = 0
    # descending y so an upward shift never renames onto a sibling that
    # has not moved yet (same collision class as the x loop below)
    for dy, x, y in sorted(coords, key=lambda t: -t[2]):
        dest = dy.parent / f"{x - min_x:06d}_{y - min_y:06d}"
        if dy != dest:
            dy.rename(dest)
            n += 1
    if min_x < 0:
        # descending target order so an upward shift never collides
        # (the reference renames in set order and can, tsv/
        # renumber_directories.py:53-58 — documented fix)
        for x in sorted(xdirs, reverse=True):
            src = xdirs[x]
            dest = path / f"{x - min_x:06d}"
            if src != dest:
                src.rename(dest)
                n += 1
    return n


def renumber_series(directory, prefix: str = "img_") -> int:
    """Renumber plane files to contiguous img_000000..N-1 order."""
    directory = Path(directory)
    paths = sorted(p for p in directory.iterdir()
                   if p.suffix.lower() in (".tif", ".tiff"))
    for i, p in enumerate(paths):
        target = directory / f"{prefix}{i:06d}.tif"
        if p != target:
            p.rename(target)
    return len(paths)


def generate_downsampled_npz(input_dir, npz_path,
                             source_voxel_zyx: Tuple[float, float, float],
                             target_voxel_um: float) -> Path:
    """Standalone downsampled-npz generator
    (reference downsampled_npz_generator.py:51-132)."""
    from ..stitch.merge import downsampled_npz

    input_dir = Path(input_dir)
    paths = sorted(p for p in input_dir.iterdir()
                   if p.suffix.lower() in (".tif", ".tiff"))
    if not paths:
        raise FileNotFoundError(f"no TIFFs in {input_dir}")
    vol = np.stack([tio.imread(p) for p in paths]).astype(np.float32)
    return downsampled_npz(vol, npz_path, source_voxel_zyx, vol.shape,
                           target_voxel_um)


def series_to_precomputed(input_dir, output_dir,
                          voxel_nm=(1000.0, 1000.0, 1000.0),
                          n_levels: int = 3,
                          chunk=(64, 64, 64), halve: str = "mean") -> Path:
    """TIFF z series -> neuroglancer precomputed volume, streamed one
    plane at a time (reference: the precomputed/blockfs output leg of
    tsv/convert.py:41-115)."""
    from ..io.precomputed import PrecomputedWriter

    input_dir = Path(input_dir)
    paths = sorted(p for p in input_dir.iterdir()
                   if p.suffix.lower() in (".tif", ".tiff"))
    if not paths:
        raise FileNotFoundError(f"no TIFFs in {input_dir}")
    first = tio.imread(paths[0])
    w = PrecomputedWriter(output_dir, (len(paths),) + first.shape,
                          first.dtype, voxel_nm, chunk, n_levels,
                          halve=halve)
    w.add_plane(first)
    for p in paths[1:]:
        w.add_plane(tio.imread(p))
    return w.dir


def convert_xml_to_2d_tif(xml_path, output_pattern: str,
                          mipmap_level: int = 0, volume_str: str = "",
                          compression: int = 4, rotation: int = 0,
                          ignore_z_offsets: bool = False,
                          alt_input=None, resume: bool = True,
                          cosine: bool = False) -> Path:
    """The tsv/convert.py CLI role: TeraStitcher step-5 XML -> 2D TIFF
    series (reference convert_to_2D_tif + parse_args,
    tsv/convert.py:41-115,283-409).

    Deviation: when the XML carries ABS positions (our own step-5 output)
    they are used directly; otherwise — and always with
    ignore_z_offsets — positions are chain-propagated from the
    NORTH/WEST displacements exactly as the reference's make_stacks does
    (tsv/volume.py:730-797)."""
    from ..geometry.stacks import TileGrid

    grid = TileGrid.from_xml(xml_path, alt_stack_dir=alt_input)
    has_abs = any(s.abs_h or s.abs_v or s.abs_d for s in grid.flattened())
    if ignore_z_offsets or not has_abs:
        grid.place_from_neighbor_chain(ignore_z_offsets=ignore_z_offsets)
    return _merge_grid_to_pattern(grid, output_pattern, mipmap_level,
                                  volume_str, compression, rotation,
                                  resume, cosine)


def _merge_grid_to_pattern(grid, output_pattern: str, mipmap_level: int,
                           volume_str: str, compression: int, rotation: int,
                           resume: bool, cosine: bool) -> Path:
    from ..parallel.mesh import default_mesh
    from ..stitch.merge import merge_to_tif_series

    vol = None
    if volume_str:
        x0, x1, y0, y1, z0, z1 = map(int, volume_str.split(","))
        vol = VExtent(x0, x1, y0, y1, z0, z1)
    level = max(0, min(9, compression))
    mesh, plane_batch = default_mesh()
    out, _ = merge_to_tif_series(
        grid, Path(output_pattern.format(z=0)).parent,
        cosine_blending=cosine,
        compression=f"zlib:{level}" if level else None,
        rotation=rotation,
        mipmap_level=mipmap_level or None,
        volume=vol, output_pattern=output_pattern,
        resume=resume, mesh=mesh, plane_batch=plane_batch)
    return out


def simple_stitch(path, output_pattern: str, voxel_size_x: float,
                  voxel_size_y: float, voxel_size_z: float = 1.0,
                  mipmap_level: int = 0, volume_str: str = "",
                  compression: int = 4, resume: bool = True,
                  cosine: bool = False) -> Path:
    """Simple mode: stitch a SmartSPIM tree at its NOMINAL stage positions
    (dir names in tenths of micron), no alignment — the reference's
    tsv/simple.py:66-101 (TSVSimpleVolume + convert_to_2D_tif with
    ignore_z_offsets)."""
    from ..geometry.stacks import TileGrid

    grid = TileGrid.from_directory(
        path, voxel_um=(voxel_size_y, voxel_size_x, voxel_size_z))
    return _merge_grid_to_pattern(grid, output_pattern, mipmap_level,
                                  volume_str, compression, rotation=0,
                                  resume=resume, cosine=cosine)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="tsv mini tools")
    sub = p.add_subparsers(dest="cmd", required=True)
    c = sub.add_parser(
        "convert", help="TeraStitcher XML -> 2D TIFF series "
                        "(the tsv/convert.py role)")
    c.add_argument("--xml-path", required=True, type=Path)
    c.add_argument("--output-pattern", required=True,
                   help='e.g. "out/img_{z:04d}.tif"')
    c.add_argument("--mipmap-level", type=int, default=0,
                   help="decimation level: 2 = every 4th plane at 1/4 "
                        "resolution")
    c.add_argument("--volume", default="",
                   help='"x0,x1,y0,y1,z0,z1" sub-extent')
    c.add_argument("--compression", type=int, default=4,
                   help="zlib level 0-9 (reference default 4)")
    c.add_argument("--rotation", type=int, default=0,
                   choices=[0, 90, 180, 270])
    c.add_argument("--ignore-z-offsets", action="store_true")
    c.add_argument("--input", default=None,
                   help="alternative stacks dir (another channel)")
    c.add_argument("--cosine-blending", action="store_true")
    c.add_argument("--cpus", type=int, default=None,
                   help="accepted for reference-CLI compatibility; "
                        "blending is device-batched")
    c.add_argument("--silent", action="store_true",
                   help="accepted for reference-CLI compatibility")
    d = sub.add_parser("downsample")
    d.add_argument("--input", "--src", dest="input", required=True,
                   help="input directory or glob (reference --src)")
    d.add_argument("--output", "--dest", dest="output", required=True,
                   type=Path)
    d.add_argument("--factor", "--downsample-factor", dest="factor",
                   type=int, default=2)
    d.add_argument("--method", default="sum",
                   help="sum (reference wrap-cast default) | mean | "
                        "max | min")
    d.add_argument("--z-factor", type=int, default=1,
                   help="keep every Nth plane (extension; reference is "
                        "2D-only)")
    d.add_argument("--compression", type=int, default=4)
    d.add_argument("--n-cores", type=int, default=None,
                   help="accepted for reference-CLI compatibility")
    d.add_argument("--silent", action="store_true",
                   help="accepted for reference-CLI compatibility")
    sm = sub.add_parser("simple",
                        help="nominal-position stitch of a SmartSPIM "
                             "tree (tsv/simple.py flags)")
    sm.add_argument("--path", required=True, type=Path)
    sm.add_argument("--voxel-size-xy", type=float, default=None)
    sm.add_argument("--voxel-size-x", type=float, default=None)
    sm.add_argument("--voxel-size-y", type=float, default=None)
    sm.add_argument("--voxel-size-z", type=float, default=1.0)
    sm.add_argument("--output-pattern", required=True)
    sm.add_argument("--mipmap-level", type=int, default=0)
    sm.add_argument("--volume", default="")
    sm.add_argument("--compression", type=int, default=4)
    sm.add_argument("--cosine-blending", action="store_true")
    sm.add_argument("--silent", action="store_true",
                    help="accepted for reference-CLI compatibility")
    sm.add_argument("--cpus", type=int, default=None,
                    help="accepted for reference-CLI compatibility")
    f = sub.add_parser("fill-blanks")
    f.add_argument("--dir", required=True, type=Path)
    fb = sub.add_parser("fill-blanks-tree",
                        help="zero-fill missing tile planes of a "
                             "microscope tree (tsv/fill_blanks.py flags)")
    fb.add_argument("--src", required=True, type=Path)
    fb.add_argument("--dest", type=Path, default=None)
    fb.add_argument("--silent", action="store_true")
    r = sub.add_parser("renumber")
    r.add_argument("--dir", required=True, type=Path)
    rt = sub.add_parser("renumber-tree",
                        help="zero-pad plane names in a stack hierarchy "
                             "(tsv/renumber.py)")
    rt.add_argument("root", type=Path)
    rt.add_argument("--n-digits", type=int, default=6)
    rd = sub.add_parser("renumber-directories",
                        help="shift negative stage coordinates positive "
                             "(tsv/renumber_directories.py)")
    rd.add_argument("--path", required=True, type=Path)
    n = sub.add_parser("npz")
    n.add_argument("--input", "-i", required=True, type=Path)
    n.add_argument("--output", "-o", required=True, type=Path)
    n.add_argument("--voxel", type=float, nargs=3, default=None,
                   metavar=("Z", "Y", "X"))
    # reference spellings (downsampled_npz_generator.py CLI)
    n.add_argument("--voxel_x", "-dx", type=float, default=None)
    n.add_argument("--voxel_y", "-dy", type=float, default=None)
    n.add_argument("--voxel_z", "-dz", type=float, default=None)
    n.add_argument("--target-voxel", "--downsampled_voxel", "-dt",
                   dest="target_voxel", type=float, required=True)
    cs = sub.add_parser("crop-series",
                        help="crop a TIFF series to a sub-box "
                             "(supplements/croping.py role)")
    cs.add_argument("--input", required=True, type=Path)
    cs.add_argument("--output", required=True, type=Path)
    cs.add_argument("--roi", type=int, nargs=4, required=True,
                    metavar=("Y0", "Y1", "X0", "X1"))
    cs.add_argument("--z", type=int, nargs=2, default=(0, None),
                    metavar=("Z0", "Z1"))
    rz = sub.add_parser("resize3d",
                        help="resize a series volume to a target shape "
                             "(supplements/resize3D.py)")
    rz.add_argument("--input", required=True, type=Path)
    rz.add_argument("--output", required=True, type=Path)
    rz.add_argument("--shape", type=int, nargs=3, required=True,
                    metavar=("Z", "Y", "X"))
    ci = sub.add_parser("crop-ims",
                        help="crop an .ims ROI to 16-bit + 8-bit "
                             "multi-page TIFFs (supplements/croping.py)")
    ci.add_argument("--ims", required=True, type=Path)
    ci.add_argument("--output", required=True, type=Path)
    ci.add_argument("--roi", type=int, nargs=6, required=True,
                    metavar=("Z0", "Z1", "Y0", "Y1", "X0", "X1"),
                    help="half-open bounds")
    ci.add_argument("--channel", type=int, default=0)
    ci.add_argument("--resolution-level", type=int, default=0)
    ci.add_argument("--right-shift", type=int, default=3)
    ci.add_argument("--no-8bit", action="store_true")
    pf = sub.add_parser("pfc-to-ls",
                        help="restructure a PFC Z/Y/X plane tree into "
                             "the TeraStitcher col/row layout "
                             "(supplements/PFC_to_LS.m)")
    pf.add_argument("--root", required=True, type=Path)
    pf.add_argument("--target", required=True, type=Path)
    pf.add_argument("--xy-step", type=int, required=True,
                    help="stage step in tenths of um (XYStep)")
    pf.add_argument("--z-step", type=int, required=True,
                    help="z step in tenths of um (ZStep)")
    pf.add_argument("--frame-shape", type=int, nargs=2,
                    default=(2048, 2048), metavar=("H", "W"),
                    help="blank-tile shape for missing planes")
    pc = sub.add_parser("precomputed",
                        help="TIFF series -> neuroglancer precomputed")
    pc.add_argument("--input", required=True, type=Path)
    pc.add_argument("--output", required=True, type=Path)
    pc.add_argument("--voxel-nm", type=float, nargs=3,
                    default=(1000.0, 1000.0, 1000.0), metavar=("Z", "Y", "X"))
    pc.add_argument("--levels", type=int, default=3)
    return p


def main(argv=None) -> int:
    p = build_parser()
    args = p.parse_args(argv)
    log = Logger()
    if args.cmd == "convert":
        out = convert_xml_to_2d_tif(
            args.xml_path, args.output_pattern,
            mipmap_level=args.mipmap_level, volume_str=args.volume,
            compression=args.compression, rotation=args.rotation,
            ignore_z_offsets=args.ignore_z_offsets, alt_input=args.input,
            cosine=args.cosine_blending)
        log.info(f"converted to {out}")
    elif args.cmd == "downsample":
        n_out = downsample_series(args.input, args.output, args.factor,
                                  args.method, z_factor=args.z_factor,
                                  compression=args.compression)
        log.info(f"{n_out} planes downsampled")
    elif args.cmd == "simple":
        if args.voxel_size_xy is not None:
            if (args.voxel_size_x is not None
                    or args.voxel_size_y is not None):
                p.error("--voxel-size-xy conflicts with --voxel-size-x/-y")
            vx = vy = args.voxel_size_xy
        elif args.voxel_size_x is not None and args.voxel_size_y is not None:
            vx, vy = args.voxel_size_x, args.voxel_size_y
        else:
            p.error("specify --voxel-size-xy, or both --voxel-size-x "
                    "and --voxel-size-y (tsv/simple.py:62-79)")
        out = simple_stitch(
            args.path, args.output_pattern, vx, vy, args.voxel_size_z,
            mipmap_level=args.mipmap_level, volume_str=args.volume,
            compression=args.compression, cosine=args.cosine_blending)
        log.info(f"stitched to {out}")
    elif args.cmd == "fill-blanks":
        log.info(f"{fill_blanks(args.dir)} planes filled")
    elif args.cmd == "fill-blanks-tree":
        n = fill_blanks_tree(args.src, args.dest, silent=args.silent)
        log.info(f"{n} blank tile planes written")
    elif args.cmd == "renumber":
        log.info(f"{renumber_series(args.dir)} planes renumbered")
    elif args.cmd == "renumber-tree":
        log.info(f"{renumber_tree(args.root, args.n_digits)} planes "
                 "zero-padded")
    elif args.cmd == "renumber-directories":
        log.info(f"{renumber_directories(args.path)} directories shifted")
    elif args.cmd == "crop-series":
        y0, y1, x0, x1 = args.roi
        n = crop_series(args.input, args.output, y0, y1, x0, x1,
                        z0=args.z[0], z1=args.z[1])
        log.info(f"{n} planes cropped")
    elif args.cmd == "resize3d":
        out = resize3d_series(args.input, args.output, tuple(args.shape))
        log.info(f"resized to {out}")
    elif args.cmd == "crop-ims":
        z0, z1, y0, y1, x0, x1 = args.roi
        out = crop_ims(args.ims, args.output, z0, z1, y0, y1, x0, x1,
                       channel=args.channel,
                       resolution_level=args.resolution_level,
                       right_shift=args.right_shift,
                       write_8bit=not args.no_8bit)
        log.info(f"cropped to {out}")
    elif args.cmd == "pfc-to-ls":
        n = pfc_to_ls(args.root, args.target, args.xy_step, args.z_step,
                      frame_shape=tuple(args.frame_shape))
        log.info(f"{n} planes placed")
    elif args.cmd == "npz":
        voxel = args.voxel
        if voxel is None:
            if None in (args.voxel_z, args.voxel_y, args.voxel_x):
                raise SystemExit(
                    "npz: pass --voxel Z Y X or all of -dz/-dy/-dx")
            voxel = (args.voxel_z, args.voxel_y, args.voxel_x)
        log.info(str(generate_downsampled_npz(
            args.input, args.output, tuple(voxel), args.target_voxel)))
    elif args.cmd == "precomputed":
        log.info(str(series_to_precomputed(
            args.input, args.output, tuple(args.voxel_nm), args.levels)))
    return 0


def crop_series(input_dir, output_dir, y0: int, y1: int, x0: int, x1: int,
                z0: int = 0, z1: int = None) -> int:
    """Crop a TIFF series to a sub-box (reference supplements/croping.py)."""
    input_dir, output_dir = Path(input_dir), Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    paths = sorted(p for p in input_dir.iterdir()
                   if p.suffix.lower() in (".tif", ".tiff"))
    paths = paths[z0:z1]
    for i, p in enumerate(paths):
        img = tio.imread(p)
        tio.imwrite(output_dir / f"img_{i:06d}.tif", img[y0:y1, x0:x1])
    return len(paths)


def crop_ims(ims_path, output_dir, z0: int, z1: int, y0: int, y1: int,
             x0: int, x1: int, channel: int = 0,
             resolution_level: int = 0, right_shift: int = 3,
             write_8bit: bool = True) -> Path:
    """Crop an .ims ROI to multi-page TIFFs: a 16-bit crop plus an 8-bit
    right-shifted companion (reference supplements/croping.py crop_imaris
    :125-188; the ROI naming zmin_zmax_..._16bit.tif is preserved).

    The 8-bit conversion here matches croping.py's own
    convert_16bit_to_8bit_fun (:23-39): plain ``img >> right_shift`` with
    a 255 clip — deliberately WITHOUT pystripe's nonzero->1 mapping,
    because the reference's crop tool doesn't apply it either."""
    from ..io.ims import ImarisReader

    ims_path, output_dir = Path(ims_path), Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    with ImarisReader(ims_path, channel=channel,
                      resolution_level=resolution_level) as r:
        vol = r.read_roi(z0, z1, y0, y1, x0, x1)
    roi = f"{z0}_{z1 - 1}_{y0}_{y1 - 1}_{x0}_{x1 - 1}"
    base = ims_path.stem
    path16 = output_dir / f"{base}_{roi}_16bit.tif"
    tio.write_tiff_stack(path16, vol)
    if write_8bit:
        if not 0 <= right_shift <= 8:
            raise ValueError("right shift should be between 0 and 8")
        v8 = np.minimum(vol >> right_shift, 255).astype(np.uint8)
        tio.write_tiff_stack(output_dir / f"{base}_{roi}_8bit.tif", v8)
    return path16


def resize3d_series(input_dir, output_dir,
                    target_shape_zyx: Tuple[int, int, int]) -> Path:
    """Resize a whole TIFF series volume to a target 3D shape
    (reference supplements/resize3D.py)."""
    from ..ops.resample import resize

    input_dir, output_dir = Path(input_dir), Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    paths = sorted(p for p in input_dir.iterdir()
                   if p.suffix.lower() in (".tif", ".tiff"))
    vol = np.stack([tio.imread(p) for p in paths])
    dtype = vol.dtype
    out = resize(torch.from_numpy(vol.astype(np.float32)).to(
        resolve_device()), target_shape_zyx).cpu().numpy()
    if np.issubdtype(dtype, np.integer):
        info = np.iinfo(dtype)
        out = np.clip(np.rint(out), info.min, info.max)
    out = out.astype(dtype)
    for z in range(out.shape[0]):
        tio.imwrite(output_dir / f"img_{z:06d}.tif", out[z])
    return output_dir


if __name__ == "__main__":
    sys.exit(main())
