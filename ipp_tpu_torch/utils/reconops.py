"""Neuron-reconstruction file operations: SWC / ESWC / APO conversions.

Re-design of the reference's supplements/reconops.py (431 LoC): pandas
dataframes in, with axis flips, voxel rescaling, topological sorting, and
format conversions.  The reference's Vaa3D plugin shell-outs (resample,
N3DFix, inter-node pruning) are external binaries and are represented by
`sort_swc` (implemented natively) plus documented extension points.
"""

from __future__ import annotations

from pathlib import Path
from typing import Tuple

import numpy as np
import pandas as pd

__all__ = ["SWC_COLUMNS", "ESWC_COLUMNS", "read_swc", "read_eswc",
           "read_apo", "write_swc", "write_eswc", "sort_swc",
           "flip_and_scale", "swc_to_seeds"]

SWC_COLUMNS = ["id", "type", "x", "y", "z", "radius", "parent_id"]
ESWC_COLUMNS = ["seg_id", "level", "mode", "timestamp", "TFresindex"]


def read_swc(path) -> pd.DataFrame:
    return pd.read_csv(path, sep=r"\s+", comment="#", names=SWC_COLUMNS,
                       index_col=False)


def read_eswc(path) -> pd.DataFrame:
    return pd.read_csv(path, sep=r"\s+", comment="#",
                       names=SWC_COLUMNS + ESWC_COLUMNS, index_col=False)


def read_apo(path, radius: float = 12.0) -> pd.DataFrame:
    """APO (cell annotation) -> SWC-like points (reference reconops
    main(): type=1, parent=-1, sequential ids)."""
    df = pd.read_csv(path).drop_duplicates().reset_index(drop=True)
    df.columns = [c.strip() for c in df.columns]
    out = pd.DataFrame({
        "id": np.arange(1, len(df) + 1),
        "type": 1,
        "x": df["x"], "y": df["y"], "z": df["z"],
        "radius": radius,
        "parent_id": -1,
    })
    return out


def write_swc(df: pd.DataFrame, path, comment: str = "") -> Path:
    path = Path(path)
    with open(path, "w") as f:
        f.write(f"#{comment}\n#" + " ".join(SWC_COLUMNS) + "\n")
        df[SWC_COLUMNS].to_csv(f, sep=" ", index=False, header=False)
    return path


def write_eswc(df: pd.DataFrame, path, comment: str = "") -> Path:
    path = Path(path)
    out = df.copy()
    for col in ESWC_COLUMNS:
        if col not in out.columns:
            out[col] = 0
    with open(path, "w") as f:
        f.write(f"#{comment}\n#" + " ".join(SWC_COLUMNS + ESWC_COLUMNS) + "\n")
        out[SWC_COLUMNS + ESWC_COLUMNS].to_csv(f, sep=" ", index=False,
                                               header=False)
    return path


def flip_and_scale(df: pd.DataFrame,
                   flip_lengths: Tuple[float, float, float] = (0, 0, 0),
                   voxel_source: Tuple[float, float, float] = (1, 1, 1),
                   voxel_target: Tuple[float, float, float] = (1, 1, 1),
                   ) -> pd.DataFrame:
    """Axis flips (x -> L - x when L > 0) and voxel-size rescale
    (reference reconops main(), x/y/z_axis_length + voxel args)."""
    out = df.copy()
    for ax, L in zip("xyz", flip_lengths):
        if L and L > 0:
            out[ax] = L - out[ax]
    for ax, s, t in zip("xyz", voxel_source, voxel_target):
        out[ax] = out[ax] * (s / t)
    return out


def sort_swc(df: pd.DataFrame) -> pd.DataFrame:
    """Topological re-id so every parent precedes its children and ids are
    contiguous from 1, matching the reference's traversal EXACTLY
    (reference sort_swc, supplements/reconops.py:59-102): rows sorted by
    id and de-duplicated first; roots are parent==-1, falling back to
    parent==0, falling back to forcing the id==1 row; each tree walks its
    FIRST child chain depth-first and pushes the remaining children onto
    the FRONT of the pending-roots list; parents are re-pointed at the
    first output row carrying the old id.

    Documented deviation: orphan nodes (parent id absent and not a root
    sentinel) are appended at the tail with parent -1 — the reference
    silently drops them."""
    arr = (df[SWC_COLUMNS].sort_values(by=["id"], ascending=True)
           .drop_duplicates().to_numpy(dtype=float))
    n = arr.shape[0]
    ids, parents = arr[:, 0], arr[:, 6]
    roots = list(np.where(parents == -1)[0])
    if not roots:
        roots = list(np.where(parents == 0)[0])
    if not roots:
        roots = list(np.where(ids == 1)[0])
        if roots:
            arr[roots[0], 6] = -1
    # first-child DFS with branch children PREPENDED to the pending roots
    order: list = []
    visited = np.zeros(n, bool)
    pending = [int(r) for r in roots]
    while pending:
        parent = pending.pop(0)
        while True:
            if visited[parent]:
                break
            visited[parent] = True
            order.append(parent)
            child = list(np.where(parents == ids[parent])[0])
            child = [int(c) for c in child if not visited[c]]
            if not child:
                break
            pending = child[1:] + pending
            parent = child[0]
    order += [i for i in range(n) if not visited[i]]  # orphans (deviation)
    out = arr[order].copy()
    # re-point parents at the first output row with the old parent id,
    # then renumber ids 1..n (reference :86-97)
    old_ids = out[:, 0].copy()
    # the reference's loop starts at row 1, so row 0 keeps its sentinel
    # verbatim (0 stays 0); rows whose parent id no longer exists get -1
    # (deviation: the reference raises IndexError there)
    for i in range(1, len(out)):
        pid = out[i, 6]
        if pid != -1:
            hits = np.where(old_ids == pid)[0]
            out[i, 6] = hits[0] + 1 if hits.size else -1
    out[:, 0] = np.arange(1, len(out) + 1)
    res = pd.DataFrame(out, columns=SWC_COLUMNS)
    for column in ("id", "type", "parent_id"):
        res[column] = res[column].astype(int)
    return res


def swc_to_seeds(df: pd.DataFrame) -> pd.DataFrame:
    """Root nodes only (soma seeds) — the 'seed' output format of the
    reference converter."""
    return df[df["parent_id"] == -1][["x", "y", "z", "radius"]].copy()


# ---------------------------------------------------------------------------
# Soma-in-region lookup (the supplements/find_swc_location.py role)
# ---------------------------------------------------------------------------


def soma_of_swc(path) -> "np.ndarray":
    """(x, y, z) of the soma: the type-1 node, else the root (parent -1),
    else the first node (reference get_soma_locations reads the same)."""
    df = read_swc(path)
    soma = df[df["type"] == 1]
    if soma.empty:
        soma = df[df["parent"] == -1]
    if soma.empty:
        soma = df.iloc[:1]
    r = soma.iloc[0]
    return np.array([r["x"], r["y"], r["z"]], dtype=np.float64)


def load_obj_mesh(path):
    """Vertices/triangles from a Wavefront .obj (the reference converts
    region meshes wrl->obj via pyvista, find_swc_location.py:23-30; this
    consumes the .obj directly — no VTK dependency)."""
    verts = []
    faces = []
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                verts.append([float(t) for t in line.split()[1:4]])
            elif line.startswith("f "):
                idx = [int(t.split("/")[0]) - 1 for t in line.split()[1:]]
                for k in range(1, len(idx) - 1):  # fan-triangulate
                    faces.append([idx[0], idx[k], idx[k + 1]])
    v = np.asarray(verts, np.float64)
    t = np.asarray(faces, np.int64)
    return v[t]  # (n_tris, 3, 3)


def points_inside_mesh(tris: "np.ndarray", points: "np.ndarray") -> "np.ndarray":
    """Ray-casting containment test: count +x ray/triangle crossings per
    point (odd = inside).  Vectorized Möller-Trumbore over all triangles
    (reference uses pyvista select_enclosed_points,
    find_swc_location.py:17-21)."""
    pts = np.atleast_2d(points).astype(np.float64)
    v0, v1, v2 = tris[:, 0], tris[:, 1], tris[:, 2]
    e1 = v1 - v0
    e2 = v2 - v0
    # slightly irrational ray direction: an axis-aligned ray hits shared
    # triangle edges/diagonals of axis-aligned meshes and double-counts
    d = np.array([1.0, 7.1234567e-5, 3.9876543e-5])
    d /= np.linalg.norm(d)
    h = np.cross(d, e2)  # (T, 3)
    a = np.einsum("tj,tj->t", e1, h)
    ok = np.abs(a) > 1e-12
    inside = np.zeros(len(pts), bool)
    f = np.where(ok, 1.0 / np.where(ok, a, 1.0), 0.0)
    for i, p in enumerate(pts):
        s = p - v0
        u = f * np.einsum("tj,tj->t", s, h)
        q = np.cross(s, e1)
        v = f * np.einsum("tj,j->t", q, d)
        t = f * np.einsum("tj,tj->t", q, e2)
        hit = (ok & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1)
               & (t > 1e-12))
        inside[i] = (np.count_nonzero(hit) % 2) == 1
    return inside


def find_swc_location(recon_dir, mesh_obj, out_dir=None,
                      scale=(1.0, 1.0, 1.0)) -> list:
    """SWC files whose soma lies inside the region mesh; optionally copy
    them to out_dir (reference find_swc_location.py get_soma_locations +
    copy flow).  `scale` converts SWC coordinates to mesh units."""
    from pathlib import Path
    from shutil import copy as _copy

    recon_dir = Path(recon_dir)
    tris = load_obj_mesh(mesh_obj)
    hits = []
    files = sorted(recon_dir.rglob("*.swc"))
    if not files:
        return hits
    pts = np.stack([soma_of_swc(p) * np.asarray(scale) for p in files])
    inside = points_inside_mesh(tris, pts)
    for p, isin in zip(files, inside):
        if isin:
            hits.append(p)
            if out_dir is not None:
                Path(out_dir).mkdir(parents=True, exist_ok=True)
                _copy(p, Path(out_dir) / p.name)
    return hits
