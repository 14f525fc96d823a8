"""Step 2 — pairwise tile displacement computation over the grid, on one
device (port of ipp_tpu/stitch/align.py: compute_displacements and its
helpers, merge_displacement_candidates).

Re-design of StackStitcher::computeDisplacements
(reference: src/stitcher/StackStitcher.cpp:119-360) + the MPI z-subvolume
partitioning of Parastitcher (pyscripts/Parastitcher.py:410-470):

- the z axis is split into subvolumes (subvol_dim) and each chunk produces a
  candidate displacement per adjacent pair (projection in step 3 keeps the
  most reliable one per axis),
- instead of MPI ranks running one pair each, pairs are processed as batched
  device chains (the NCC maps of every same-shape pair in one
  `ncc_maps_batched` call per map kind), with IO on host threads.

With a device mesh the pair batches split over its "data" devices.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..geometry.stacks import Displacement, TileGrid, TileStack
from ..ops.ncc import NCCParams, NCCResult, align_pairs_batched

__all__ = ["compute_displacements", "PairResult"]

S_DISPL_SEARCH_RADIUS_DEF = 25  # reference S_config.h default search radius


@dataclass
class PairResult:
    row_a: int
    col_a: int
    row_b: int
    col_b: int
    side: str  # 'ns' | 'we'
    result: NCCResult


def _read_substack(stack: TileStack, z0: int, z1: int) -> np.ndarray:
    """Full-frame z-range read through TileStack.imread (which routes
    TIFFs to the native threaded ROI loader).

    Stays in the stack's NATIVE dtype: the only downstream consumer is
    the host MIP reduction (align_pairs_batched), and max-reducing u16
    moves half the bytes of a premature f32 cast — the cast happens on
    the tiny MIPs instead (measured: the f32 substack casts+copies were
    most of the align stage's host-other time in the e2e split)."""
    e = stack.extent
    from ..geometry.extent import VExtent

    sub = VExtent(e.x0, e.x1, e.y0, e.y1, e.z0 + z0, e.z0 + z1)
    return stack.imread(sub)


def _reliability(peak: float, width: int, inf_w: int) -> float:
    """evalReliability (reference DisplacementMIPNCC.cpp:130-147):
    sqrt(0.5 * nw^2 + 0.5 * peak^2), nw = 1 - width/inf_w."""
    nw = (100.0 - (width * 100.0 / inf_w)) / 100.0
    return float(np.sqrt(0.5 * nw * nw + 0.5 * peak * peak))


def _to_displacement(res: NCCResult, delays: Tuple[int, int, int],
                     default: Tuple[int, int, int],
                     params: NCCParams) -> Displacement:
    inf_w = params.inf_w(delays)
    rel = tuple(_reliability(res.ncc_peak[i], res.ncc_width[i], inf_w)
                for i in range(3))
    wr = tuple(params.w_range(d) for d in delays)
    return Displacement(
        displ=tuple(int(c) for c in res.coord),
        default_displ=tuple(int(d) for d in default),
        reliability=rel,
        ncc_peak=tuple(float(p) for p in res.ncc_peak),
        ncc_width=tuple(int(w) for w in res.ncc_width),
        ncc_w_range_thr=wr,
        ncc_inv_width=(inf_w, inf_w, inf_w),
        delay=delays,
    )


def _mirror(d: Displacement) -> Displacement:
    """getMirrored(dir_all) (reference DisplacementMIPNCC.cpp:240-305):
    negate all coordinate components, keep quality metrics."""
    return Displacement(
        displ=tuple(-c for c in d.displ),
        default_displ=tuple(-c for c in d.default_displ),
        reliability=d.reliability,
        ncc_peak=d.ncc_peak,
        ncc_width=d.ncc_width,
        ncc_w_range_thr=d.ncc_w_range_thr,
        ncc_inv_width=d.ncc_inv_width,
        delay=d.delay,
    )


def compute_displacements(
    grid: TileGrid,
    overlap_v: int,
    overlap_h: int,
    displ_max_v: int = S_DISPL_SEARCH_RADIUS_DEF,
    displ_max_h: int = S_DISPL_SEARCH_RADIUS_DEF,
    displ_max_d: int = S_DISPL_SEARCH_RADIUS_DEF,
    subvol_dim: int = 100,
    z_range: Optional[Tuple[int, int]] = None,
    params: Optional[NCCParams] = None,
    io_threads: int = 8,
    mesh=None,
    device=None,
) -> Dict[Tuple[int, int, str], List[Displacement]]:
    """Compute NORTH/WEST displacement candidate lists for every adjacent
    pair, one candidate per z-subvolume.

    The NCC maps run on `device` (else the resolved device); with a
    multi-device `mesh` (`parallel.mesh.Mesh`) the NCC-map batches split
    over its "data" devices, the replacement for Parastitcher's MPI
    master_step2 rank fan-out (reference pyscripts/Parastitcher.py:410-470).

    Returns {(row_b, col_b, 'north'|'west'): [Displacement per z chunk]} and
    also attaches nothing to the grid — step 3 (project) consumes the dict.
    """
    params = params or NCCParams()
    rows, cols = grid.n_rows, grid.n_cols
    depth = min(s.depth for s in grid.flattened())
    z0, z1 = z_range or (0, depth)
    n_sub = max(1, (z1 - z0) // max(1, subvol_dim))
    bounds = np.linspace(z0, z1, n_sub + 1).astype(int)

    out: Dict[Tuple[int, int, str], List[Displacement]] = {}
    pairs: List[Tuple[TileStack, TileStack, str, Tuple[int, int]]] = []
    for r in range(rows):
        for c in range(cols):
            if grid.stacks[r][c] is None:
                continue  # sparse cell: no pairs (nominal fill in step 3)
            if r + 1 < rows and grid.stacks[r + 1][c] is not None:
                pairs.append((grid.stacks[r][c], grid.stacks[r + 1][c], "ns",
                              (r + 1, c)))
            if c + 1 < cols and grid.stacks[r][c + 1] is not None:
                pairs.append((grid.stacks[r][c], grid.stacks[r][c + 1], "we",
                              (r, c + 1)))

    delays = (displ_max_v, displ_max_h, displ_max_d)
    for k in range(n_sub):
        zs, ze = int(bounds[k]), int(bounds[k + 1])
        if ze <= zs:
            continue
        with ThreadPoolExecutor(max_workers=io_threads) as pool:
            substacks = {}
            futs = {}
            for a, b, side, _key in pairs:
                for s in (a, b):
                    if id(s) not in futs:
                        futs[id(s)] = pool.submit(_read_substack, s, zs, ze)
            for sid, f in futs.items():
                substacks[sid] = f.result()
        # batch all same-side pairs of this z chunk into three device
        # chains (Parastitcher's rank-per-pair structure collapses into
        # batches), and dispatch both side groups before fetching either,
        # so the six upload->compute->download chains of a chunk overlap
        staged = []
        for side_sel in ("ns", "we"):
            group = [(a, b, rb, cb) for a, b, side, (rb, cb) in pairs
                     if side == side_sel]
            if not group:
                continue
            overlap = overlap_v if side_sel == "ns" else overlap_h
            vols_a = np.stack([substacks[id(a)] for a, _, _, _ in group])
            vols_b = np.stack([substacks[id(b)] for _, b, _, _ in group])
            finalize = align_pairs_batched(
                vols_a, vols_b, side_sel, overlap, displ_max_v, displ_max_h,
                displ_max_d, params, mesh=mesh, _defer=True, device=device)
            staged.append((side_sel, group, finalize))
        for side_sel, group, finalize in staged:
            results = finalize()
            for (a, b, rb, cb), res in zip(group, results):
                # defaults = nominal stage displacement
                # (reference insertDisplacement, vmVirtualVolume.cpp:280-316)
                th, tw = a.plane_shape
                if side_sel == "ns":
                    default = (th - overlap_v, 0, 0)
                    key = (rb, cb, "north")
                else:
                    default = (0, tw - overlap_h, 0)
                    key = (rb, cb, "west")
                disp = _to_displacement(res, delays, default, params)
                # store on the B side, mirrored (B's NORTH/WEST points to A)
                out.setdefault(key, []).append(_mirror(disp))
    return out


def merge_displacement_candidates(dicts):
    """Merge partial candidate dicts from separately-computed z ranges or
    workers into one (the `mergedisplacements` binary's role for MPI step-2
    partial XMLs, reference utils/mergedisplacements)."""
    out: Dict[Tuple[int, int, str], List[Displacement]] = {}
    for d in dicts:
        for key, cands in d.items():
            out.setdefault(key, []).extend(cands)
    return out
