"""Vaa3D marker / soma coordinate utilities.

Equivalents of the reference's marker shuttles
(supplements/merge_marker_files.py, supplements/convert_recut_terafly_imaris/
soma-coordinate converters, supplements/find_swc_location.py): read/write
Vaa3D .marker CSVs, merge with de-duplication, and convert coordinates
between pixel spaces (recut/terafly voxels <-> physical um <-> flipped axes).

The JAX package's functions take and return pandas DataFrames; these take
and return numpy structured arrays, one field a column with the dtype
pandas infers, read and written by utils/csvtable.py (pandas' parser and
writer rebuilt, so values and files equal the JAX package's bit for bit).
"""

from __future__ import annotations

from pathlib import Path
from typing import Sequence, Tuple

import numpy as np

from . import csvtable as ct

__all__ = ["read_marker", "write_marker", "merge_marker_files",
           "convert_coordinates", "recut_seeds_to_terafly_ano",
           "terafly_apo_to_recut_seeds", "swc_to_recut_seeds"]

MARKER_COLUMNS = ["x", "y", "z", "radius", "shape", "name", "comment",
                  "color_r", "color_g", "color_b"]


def read_marker(path) -> np.ndarray:
    """Read a Vaa3D .marker file (comma-separated, # comments) into a
    structured array with the fields MARKER_COLUMNS."""
    raw = ct.read_csv(path, comment="#", header=False)
    found = ct.columns(raw)[: len(MARKER_COLUMNS)]
    df = ct.table(MARKER_COLUMNS[: len(found)], [raw[k] for k in found])
    for col in MARKER_COLUMNS:
        if col not in ct.columns(df):
            df = ct.assign(df, col, {
                "radius": 0, "shape": 1, "name": "", "comment": "",
                "color_r": 255, "color_g": 0, "color_b": 0}.get(col, 0))
    return ct.select(df, MARKER_COLUMNS)


def write_marker(df, path) -> Path:
    """Write the MARKER_COLUMNS of `df` (a structured array, or any
    mapping of columns) as a Vaa3D .marker file."""
    path = Path(path)
    with open(path, "w") as f:
        f.write("#x, y, z, radius, shape, name, comment, color_r, color_g, "
                "color_b\n")
        ct.write_csv(f, df, MARKER_COLUMNS)
    return path


def merge_marker_files(paths: Sequence, out_path,
                       dedup_radius: float = 0.0) -> Path:
    """Concatenate marker files; optionally drop points within dedup_radius
    of an earlier point (reference merge_marker_files.py)."""
    frames = [read_marker(p) for p in paths]
    merged = ct.concat(frames)
    if dedup_radius > 0 and len(merged) > 1:
        pts = np.stack([np.asarray(merged[k], float) for k in "xyz"], 1)
        keep = np.ones(len(pts), bool)
        for i in range(1, len(pts)):
            if not keep[: i].any():
                continue
            d = np.linalg.norm(pts[:i][keep[:i]] - pts[i], axis=1)
            if (d < dedup_radius).any():
                keep[i] = False
        merged = merged[keep]
    return write_marker(merged, out_path)


def convert_coordinates(
    df: np.ndarray,
    voxel_source: Tuple[float, float, float] = (1.0, 1.0, 1.0),
    voxel_target: Tuple[float, float, float] = (1.0, 1.0, 1.0),
    flip_lengths: Tuple[float, float, float] = (0.0, 0.0, 0.0),
    offset: Tuple[float, float, float] = (0.0, 0.0, 0.0),
) -> np.ndarray:
    """Coordinate shuttle between pixel spaces: scale by voxel ratio, flip
    axes of known length, add an offset (covers the recut/terafly/imaris
    soma conversions of supplements/convert_recut_terafly_imaris).  A new
    structured array; `df` is left as it is."""
    out = df
    for ax, s, t, L, off in zip("xyz", voxel_source, voxel_target,
                                flip_lengths, offset):
        v = ct.column(out, ax) * (s / t)
        if L and L > 0:
            v = L - v
        out = ct.assign(out, ax, v + off)
    return out


def recut_seeds_to_terafly_ano(seeds_dir, color=(0, 0, 255),
                               voxel=(1.0, 1.0, 1.0)):
    """Convert a recut seeds directory (marker_* files, um coordinates)
    to a TeraFly .ano/.ano.apo/.ano.eswc triple (reference
    soma_recut_seed_to_terafly_ano.py:7-44).  Coordinates divide by the
    voxel size; the radius divides by min(voxel); volsize = 4/3 pi r^3.

    Deviation (documented): the reference writes its apo header WITHOUT
    a trailing newline, gluing the first record onto the header line
    (soma_recut_seed_to_terafly_ano.py:26-28) — here the header ends
    with a newline so the .apo parses."""
    from math import pi

    seeds_dir = Path(seeds_dir)
    ano_file = seeds_dir / (seeds_dir.name + ".ano")
    apo_file = ano_file.parent / (ano_file.name + ".apo")
    eswc_file = ano_file.parent / (ano_file.name + ".eswc")
    frames = [ct.read_csv(f, sep=",", comment="#",
                          names=("x", "y", "z", "radius"), index_col=0)
              for f in sorted(seeds_dir.glob("marker_*"))]
    df = ct.concat(frames)
    vx, vy, vz = voxel
    df = ct.assign(df, "x", ct.column(df, "x") / vx)
    df = ct.assign(df, "y", ct.column(df, "y") / vy)
    df = ct.assign(df, "z", ct.column(df, "z") / vz)
    df = ct.assign(df, "radius", ct.column(df, "radius") / min(voxel))
    r, g, b = color
    with open(apo_file, "w") as apo:
        apo.write("##n,orderinfo,name,comment,z,x,y,pixmax,intensity,"
                  "sdev,volsize,mass,,,,color_r,color_g,color_b\n")
        for index, (x, y, z, radius) in enumerate(
                ct.rows(df, ("x", "y", "z", "radius"))):
            apo.write(
                f"{index},,,,{z},{x},{y},0.000,0.000,"
                f"0.000,{4 / 3 * pi * radius ** 3},0.000,,,,"
                f"{r},{g},{b}\n")
    ano_file.write_text(f"APOFILE={apo_file.name}\n"
                        f"SWCFILE={eswc_file.name}\n")
    eswc_file.write_text("#")
    return ano_file


def terafly_apo_to_recut_seeds(apo_file, default_radius: float = 0.0,
                               voxel=(0.4, 0.4, 0.4)):
    """Convert a TeraFly .apo to recut seed marker files plus a
    consolidated SWC for Imaris proofreading (reference
    soma_terafly_ano_to_recut_seed.py:18-71): marker file CONTENT is in
    um, file NAMES carry voxel coordinates + integer volume, the SWC is
    in voxels with radius from the voxel-space volsize."""
    from math import pi
    from shutil import rmtree

    apo_file = Path(apo_file)
    vx, vy, vz = (float(v) for v in voxel)
    df = ct.drop_duplicates(ct.read_csv(apo_file))
    recut = apo_file.parent / "recut_seeds_from_marker"
    if recut.exists():
        rmtree(recut)
    recut.mkdir()
    swc_path = recut / "seeds_for_Imaris_proofread.swc"
    df = ct.assign(df, "x_in_voxel", ct.column(df, "x"))
    df = ct.assign(df, "y_in_voxel", ct.column(df, "y"))
    df = ct.assign(df, "z_in_voxel", ct.column(df, "z"))
    df = ct.assign(df, "x", ct.column(df, "x") * vx)
    df = ct.assign(df, "y", ct.column(df, "y") * vy)
    df = ct.assign(df, "z", ct.column(df, "z") * vz)
    df = ct.assign(df, "volsize_um", ct.column(df, "volsize") * vx * vy * vz)
    for c in ("x", "y", "z", "volsize", "x_in_voxel", "y_in_voxel",
              "z_in_voxel"):
        v = ct.column(df, c)
        df = ct.assign(df, c, ct.to_int(np.round(v, 0) if v.dtype.kind == "f"
                                        else v))
    names = ("x", "y", "z", "volsize", "volsize_um", "x_in_voxel",
             "y_in_voxel", "z_in_voxel")
    with swc_path.open("w") as swc:
        for index, (x, y, z, volsize, volsize_um, x_vox, y_vox,
                    z_vox) in enumerate(ct.rows(df, names)):
            r_um = (volsize_um * 3 / 4 / pi) ** (1 / 3)
            if default_radius and default_radius > 0:
                r_um = default_radius
            volume = round(4 / 3 * pi * r_um ** 3, 3)
            with open(recut / f"marker_{x_vox}_{y_vox}"
                              f"_{z_vox}_{int(volume)}",
                      "w") as mf:
                mf.write("# x,y,z,radius_um\n")
                mf.write(f"{x},{y},{z},{r_um}")
            r_vox = (volsize * 3 / 4 / pi) ** (1 / 3)
            swc.write(f"{index} 0 {x_vox} {y_vox} "
                      f"{z_vox} {r_vox} {-1}\n")
    return recut


def swc_to_recut_seeds(swc_path, radii: float = 12.0,
                       voxel=(0.4, 0.4, 0.4)):
    """Convert an Imaris-proofread consolidated SWC back to recut seed
    marker files (reference convert_imaris_soma_to_markers.py:15-40):
    space-separated SWC, coordinates scaled by the voxel size and
    truncated to int, a forced uniform radius."""
    from math import pi

    swc_path = Path(swc_path)
    out_dir = swc_path.parent / (
        "IMS_proofread_recut_seeds_" + swc_path.name.replace(".swc", ""))
    out_dir.mkdir(exist_ok=True)
    vx, vy, vz = voxel
    volume = int(4 / 3 * pi * radii ** 3)
    for line in swc_path.read_text().splitlines():
        parts = line.split(" ")
        if len(parts) < 5 or line.startswith("#"):
            continue
        x = int(float(parts[2]) * vx)
        y = int(float(parts[3]) * vy)
        z = int(float(parts[4]) * vz)
        (out_dir / f"marker_{x}_{y}_{z}_{volume}").write_text(
            f"# x,y,z,radius_um\n{x},{y},{z},{radii}")
    return out_dir
