"""Steps 3-5 — displacement projection, thresholding, global placement.

Host-side graph algorithms on tiny data (rows x cols tiles), re-implementing:

- step 3 projectDisplacements (reference StackStitcher.cpp:1563-1618 +
  Displacement::projectDisplacements, Displacement.cpp:84-107 +
  DisplacementMIPNCC::combine, DisplacementMIPNCC.cpp:310-345): per-axis
  keep the most reliable candidate across z-subvolumes; missing neighbors
  get the nominal stage displacement.
- step 4 thresholdDisplacements (reference StackStitcher.cpp:1619-1720):
  reliability below threshold resets that axis to the default displacement
  and zeroes its reliability; tiles with no reliable link on any axis to any
  neighbor are marked NON-STITCHABLE.
- step 5 TPAlgoMST (reference TPAlgoMST.cpp:66-230): per-axis Bellman-Ford
  relaxation over the 4-neighbor grid with weight = 1/reliability (clamped
  at S_UNRELIABLE_WEIGHT), source = stitchable tile nearest the origin;
  absolute positions accumulate displacements along shortest paths.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np

from ..geometry.stacks import Displacement, TileGrid

__all__ = ["project_displacements", "threshold_displacements",
           "place_tiles_mst", "place_tiles_lqp"]

S_UNRELIABLE_WEIGHT = 1000.0  # reference S_config.h:89


def _combine(a: Displacement, b: Displacement) -> Displacement:
    """Per-axis most-reliable merge (reference DisplacementMIPNCC::combine)."""
    displ, default, rel, peak, width, wrt, invw, delay = ([], [], [], [], [],
                                                          [], [], [])
    for k in range(3):
        src = a if a.reliability[k] >= b.reliability[k] else b
        displ.append(src.displ[k])
        default.append(src.default_displ[k])
        rel.append(src.reliability[k])
        peak.append(src.ncc_peak[k])
        width.append(src.ncc_width[k])
        wrt.append(src.ncc_w_range_thr[k])
        invw.append(src.ncc_inv_width[k])
        delay.append(src.delay[k])
    return Displacement(tuple(displ), tuple(default), tuple(rel), tuple(peak),
                        tuple(width), tuple(wrt), tuple(invw), tuple(delay))


def _nominal(grid: TileGrid, side: str, overlap_v: int, overlap_h: int,
             sign: int = 1) -> Displacement:
    th, tw = grid.flattened()[0].plane_shape
    if side == "north":
        d = (-(th - overlap_v), 0, 0)
    else:
        d = (0, -(tw - overlap_h), 0)
    d = tuple(sign * x for x in d)
    # nominal displacements carry zero reliability and max width
    # (reference DisplacementMIPNCC(int,int,int) ctor)
    return Displacement(displ=d, default_displ=d,
                        reliability=(0.0, 0.0, 0.0), ncc_peak=(0.0, 0.0, 0.0),
                        ncc_width=(100, 100, 100),
                        ncc_w_range_thr=(99, 99, 99),
                        ncc_inv_width=(100, 100, 100), delay=(-1, -1, -1))


def project_displacements(
    grid: TileGrid,
    candidates: Dict[Tuple[int, int, str], List[Displacement]],
    overlap_v: int, overlap_h: int,
) -> None:
    """Attach one projected NORTH/WEST displacement to every non-edge stack."""
    for r in range(grid.n_rows):
        for c in range(grid.n_cols):
            s = grid.stacks[r][c]
            if s is None:
                continue
            if r > 0 and grid.stacks[r - 1][c] is not None:
                cands = candidates.get((r, c, "north"), [])
                if cands:
                    d = cands[0]
                    for other in cands[1:]:
                        d = _combine(d, other)
                    s.north = d
                else:
                    s.north = _nominal(grid, "north", overlap_v, overlap_h)
            if c > 0 and grid.stacks[r][c - 1] is not None:
                cands = candidates.get((r, c, "west"), [])
                if cands:
                    d = cands[0]
                    for other in cands[1:]:
                        d = _combine(d, other)
                    s.west = d
                else:
                    s.west = _nominal(grid, "west", overlap_v, overlap_h)


def threshold_displacements(grid: TileGrid, reliability_threshold: float) -> None:
    """Reset unreliable displacement axes to defaults; mark tiles with no
    reliable link as NON-STITCHABLE (reference StackStitcher.cpp:1619-1720)."""

    def threshold_one(d: Displacement) -> Displacement:
        displ = list(d.displ)
        rel = list(d.reliability)
        for k in range(3):
            if rel[k] < reliability_threshold:
                displ[k] = d.default_displ[k]
                rel[k] = 0.0
        return Displacement(tuple(displ), d.default_displ, tuple(rel),
                            d.ncc_peak, d.ncc_width, d.ncc_w_range_thr,
                            d.ncc_inv_width, d.delay)

    rows, cols = grid.n_rows, grid.n_cols
    for r in range(rows):
        for c in range(cols):
            s = grid.stacks[r][c]
            if s is None:
                continue
            if s.north is not None:
                s.north = threshold_one(s.north)
            if s.west is not None:
                s.west = threshold_one(s.west)
    # stitchable check: any axis of any adjacent link >= threshold
    for r in range(rows):
        for c in range(cols):
            s = grid.stacks[r][c]
            if s is None:
                continue
            links = [s.north, s.west]
            if r + 1 < rows and grid.stacks[r + 1][c] is not None:
                links.append(grid.stacks[r + 1][c].north)
            if c + 1 < cols and grid.stacks[r][c + 1] is not None:
                links.append(grid.stacks[r][c + 1].west)
            s.stitchable = any(
                d is not None and max(d.reliability) >= reliability_threshold
                for d in links)


def place_tiles_mst(grid: TileGrid) -> None:
    """Per-axis shortest-path placement (reference TPAlgoMST.cpp:66-230).

    Edge (r,c)->(r+1,c) uses the NORTH displacement stored on (r+1,c)
    (mirrored semantics: child position = parent position - displ) and the
    WEST analog for columns.  Weight = 1/reliability clamped to
    S_UNRELIABLE_WEIGHT.
    """
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import dijkstra

    rows, cols = grid.n_rows, grid.n_cols
    n = rows * cols
    # source: stitchable tile nearest the origin
    src = (0, 0)
    best = math.inf
    for r in range(rows):
        for c in range(cols):
            if grid.stacks[r][c] is not None and \
                    grid.stacks[r][c].stitchable and math.hypot(r, c) < best:
                best = math.hypot(r, c)
                src = (r, c)

    def node(r: int, c: int) -> int:
        return r * cols + c

    # gather the grid's links once: (u, v, displ-per-axis, rel-per-axis)
    # where v is the southern/eastern tile carrying the link
    links = []
    for r in range(rows):
        for c in range(cols):
            if grid.stacks[r][c] is None:
                continue  # sparse cell: contributes no graph edges
            if r + 1 < rows and grid.stacks[r + 1][c] is not None:
                d = grid.stacks[r + 1][c].north
                links.append((node(r, c), node(r + 1, c),
                              d.displ if d else (0, 0, 0),
                              d.reliability if d else (0.0, 0.0, 0.0)))
            if c + 1 < cols and grid.stacks[r][c + 1] is not None:
                d = grid.stacks[r][c + 1].west
                links.append((node(r, c), node(r, c + 1),
                              d.displ if d else (0, 0, 0),
                              d.reliability if d else (0.0, 0.0, 0.0)))
    if not links:  # single-tile grid: nothing to place
        s = grid.stacks[0][0]
        s.abs_v = s.abs_h = s.abs_d = 0
        return
    us = np.array([e[0] for e in links])
    vs = np.array([e[1] for e in links])
    displ = np.array([e[2] for e in links], dtype=np.int64)  # (E, 3)
    rel = np.array([e[3] for e in links], dtype=np.float64)

    abs_coord = np.zeros((rows, cols, 3), dtype=np.int64)
    reachable = None
    for k in range(3):
        w = np.where(rel[:, k] > 1e-9, 1.0 / np.maximum(rel[:, k], 1e-9),
                     S_UNRELIABLE_WEIGHT)
        w = np.minimum(w, S_UNRELIABLE_WEIGHT)
        g = coo_matrix((w, (us, vs)), shape=(n, n))
        dist, pred = dijkstra(g, directed=False, indices=node(*src),
                              return_predecessors=True)
        if reachable is None:
            reachable = np.isfinite(dist)
        # displacement lookup per (parent, child) pair: child = parent - displ
        edge_d = {}
        for (u, v, d) in zip(us, vs, displ[:, k]):
            edge_d[(u, v)] = -int(d)   # moving u -> v
            edge_d[(v, u)] = int(d)
        # accumulate along predecessor chains in distance order: position of
        # each node is defined once its predecessor's is (O(V log V))
        order = np.argsort(dist)
        pos = np.zeros(n, dtype=np.int64)
        for v in order:
            p = pred[v]
            if p < 0:  # the source (or an unreachable node: stays 0)
                continue
            pos[v] = pos[p] + edge_d[(int(p), int(v))]
        abs_coord[:, :, k] = pos.reshape(rows, cols)

    # rebase to non-negative (reference TPAlgoMST step 5 rebases to [0][0];
    # we rebase to the min like the TSV consumer, tsv/volume.py:775-790)
    real = np.array([[grid.stacks[r][c] is not None for c in range(cols)]
                     for r in range(rows)])
    reach_grid = (reachable.reshape(rows, cols)
                  if reachable is not None else np.ones_like(real))
    placed_mask = real & reach_grid
    mins = (abs_coord[placed_mask].min(axis=0) if placed_mask.any()
            else np.zeros(3, int))
    abs_coord -= mins.reshape(1, 1, 3)
    for r in range(rows):
        for c in range(cols):
            s = grid.stacks[r][c]
            if s is None:
                continue
            if not reach_grid[r, c]:
                # disconnected in a sparse grid: keep the nominal stage
                # position (the reference leaves such tiles at defaults
                # and marks them NON-STITCHABLE)
                continue
            s.abs_v = int(abs_coord[r, c, 0])
            s.abs_h = int(abs_coord[r, c, 1])
            s.abs_d = int(abs_coord[r, c, 2])


def place_tiles_lqp(grid: TileGrid) -> None:
    """Global placement as the reference's integer quadratic program
    (TPAlgoLQP.cpp:110-242 + pyscripts/LQP_HE.py:1-702), solved natively.

    The reference optimizes per-edge displacements X_e with loop-closure
    equality constraints A X = 0 (one per grid square), objective
    sum R_e (X_e - D_e)^2, bounds X_e in [default_e - delay, default_e +
    delay], then integer heuristics.  In POSITION space the substitution
    X_e = p[child] - p[parent] makes A X = 0 automatic, so the identical
    program is: minimize sum_e R_e (p_v - p_u - d_e)^2 subject to
    |p_v - p_u - default_e| <= delay_e, p anchored — a bound-constrained
    QP per axis.  Solved as weighted LS; if displacement bounds are
    violated, re-solved with the bounds active (SLSQP).  The integer step
    rounds positions (positions are loop-consistent by construction, like
    the reference's heuristics output) and then coordinate-descends each
    tile +-1 px to minimize the same integer cost the reference's
    heuristic selection minimizes (LQP_HE.py sol_cost).
    """
    rows, cols = grid.n_rows, grid.n_cols
    n = rows * cols

    def node(r: int, c: int) -> int:
        return r * cols + c

    abs_coord = np.zeros((rows, cols, 3), dtype=np.int64)
    for k in range(3):
        # edges: (u, v, measured d, weight=R, default d, delay bound)
        edges = []
        for r in range(rows):
            for c in range(cols):
                s = grid.stacks[r][c]
                if s is None:
                    continue
                # NORTH link: p[r,c] = p[r-1,c] - displ_k
                if r > 0 and s.north is not None:
                    d = s.north
                    edges.append((node(r - 1, c), node(r, c), -d.displ[k],
                                  d.reliability[k], -d.default_displ[k],
                                  d.delay[k]))
                if c > 0 and s.west is not None:
                    d = s.west
                    edges.append((node(r, c - 1), node(r, c), -d.displ[k],
                                  d.reliability[k], -d.default_displ[k],
                                  d.delay[k]))
        if not edges:
            continue
        us = np.array([e[0] for e in edges])
        vs = np.array([e[1] for e in edges])
        ds = np.array([e[2] for e in edges], dtype=np.float64)
        ws = np.array([e[3] for e in edges], dtype=np.float64)
        dflt = np.array([e[4] for e in edges], dtype=np.float64)
        delays = np.array([e[5] for e in edges], dtype=np.float64)

        sol = _solve_axis_qp(n, us, vs, ds, ws, dflt, delays)
        pos = np.rint(sol).astype(np.int64)
        pos = _integer_refine(pos, us, vs, ds, ws, dflt, delays)
        abs_coord[:, :, k] = pos.reshape(rows, cols)

    real = np.array([[grid.stacks[r][c] is not None for c in range(cols)]
                     for r in range(rows)])
    mins = abs_coord[real].min(axis=0) if real.any() else np.zeros(3, int)
    abs_coord -= mins.reshape(1, 1, 3)
    for r in range(rows):
        for c in range(cols):
            s = grid.stacks[r][c]
            if s is None:
                continue
            s.abs_v = int(abs_coord[r, c, 0])
            s.abs_h = int(abs_coord[r, c, 1])
            s.abs_d = int(abs_coord[r, c, 2])


def _solve_axis_qp(n, us, vs, ds, ws, dflt, delays) -> np.ndarray:
    """Continuous relaxation of one axis of the placement LQP in position
    space.  Unreliable edges (R=0) get only an epsilon pull toward their
    default (the reference leaves them free within bounds; the epsilon
    anchors otherwise-disconnected components)."""
    from scipy.sparse import lil_matrix
    from scipy.sparse.linalg import lsqr

    eps = 1e-6
    w_eff = np.where(ws > 0, ws, eps)
    target = np.where(ws > 0, ds, dflt)
    A = lil_matrix((len(us) + 1, n))
    b = np.zeros(len(us) + 1)
    for i in range(len(us)):
        sw = math.sqrt(w_eff[i])
        A[i, vs[i]] = sw
        A[i, us[i]] = -sw
        b[i] = sw * target[i]
    A[len(us), 0] = 1000.0  # anchor p[0] = 0
    sol = lsqr(A.tocsr(), b)[0]

    # displacement bounds |x_e - default_e| <= delay_e (delay < 0 means
    # unbounded, the nominal-displacement marker): if the LS solution
    # violates any, re-solve the QP with the bounds active
    bounded = delays >= 0
    if bounded.any():
        x = sol[vs] - sol[us]
        viol = bounded & (np.abs(x - dflt) > delays + 1e-9)
        if viol.any():
            from scipy.optimize import LinearConstraint, minimize

            def cost(p):
                x = p[vs] - p[us]
                return float(np.sum(w_eff * (x - target) ** 2))

            def grad(p):
                x = p[vs] - p[us]
                g_e = 2.0 * w_eff * (x - target)
                g = np.zeros(n)
                np.add.at(g, vs, g_e)
                np.add.at(g, us, -g_e)
                return g

            bi = np.where(bounded)[0]
            M = np.zeros((len(bi) + 1, n))
            for row, i in enumerate(bi):
                M[row, vs[i]] = 1.0
                M[row, us[i]] = -1.0
            M[len(bi), 0] = 1.0  # keep the anchor
            lc = LinearConstraint(
                M, np.append(dflt[bi] - delays[bi], 0.0),
                np.append(dflt[bi] + delays[bi], 0.0))
            res = minimize(cost, sol, jac=grad, method="SLSQP",
                           constraints=[lc],
                           options={"maxiter": 200, "ftol": 1e-9})
            # accept any solve that actually satisfies the bounds —
            # feasibility is the requirement (res.fun is essentially
            # always finite and success=False can still deliver a
            # feasible near-optimum at maxiter); an infeasible solve
            # falls back to default-displacement positions, which are
            # always feasible (|x_e - default_e| = 0)
            x_res = res.x[vs] - res.x[us]
            feasible = np.all(np.abs(x_res[bounded] - dflt[bounded])
                              <= delays[bounded] + 1e-6)
            if feasible:
                sol = res.x
            else:
                import warnings

                warnings.warn(
                    "placement QP bounds solve infeasible "
                    f"(success={res.success}); falling back to "
                    "default-displacement positions", stacklevel=2)
                sol = _default_positions(n, us, vs, dflt)
    return sol


def _default_positions(n, us, vs, dflt) -> np.ndarray:
    """Positions accumulated from the DEFAULT displacements along a BFS
    spanning tree — the stage-grid layout, which satisfies every bound
    exactly (|x_e - default_e| = 0 on tree edges; defaults are
    loop-consistent, so non-tree edges match too)."""
    from collections import deque

    adj: list = [[] for _ in range(n)]
    for i in range(len(us)):
        adj[us[i]].append((vs[i], dflt[i]))
        adj[vs[i]].append((us[i], -dflt[i]))
    pos = np.zeros(n)
    seen = np.zeros(n, bool)
    for root in range(n):
        if seen[root]:
            continue
        seen[root] = True
        dq = deque([root])
        while dq:
            u = dq.popleft()
            for v, d in adj[u]:
                if not seen[v]:
                    seen[v] = True
                    pos[v] = pos[u] + d
                    dq.append(v)
    return pos


def _integer_refine(pos, us, vs, ds, ws, dflt, delays,
                    max_passes: int = 50) -> np.ndarray:
    """Greedy +-1 coordinate descent on integer positions minimizing
    sum R (x_e - D_e)^2 — the cost by which the reference selects among
    its integer heuristics (LQP_HE.py sol_cost/sol_to_integer).  Steps
    that would push any incident bounded edge outside its
    |x_e - default_e| <= delay_e window are rejected (the reference's
    bounds hold for the integer solution too, LQP_HE.py bnds)."""
    pos = pos.copy()
    n = len(pos)
    inc_all: list = [[] for _ in range(n)]  # every incident edge (bounds)
    inc_w: list = [[] for _ in range(n)]    # weighted edges (cost)
    for i in range(len(us)):
        inc_all[vs[i]].append(i)
        inc_all[us[i]].append(i)
        if ws[i] > 0:
            inc_w[vs[i]].append(i)
            inc_w[us[i]].append(i)

    def edge_viol(i: int, x: float) -> float:
        if delays[i] < 0:
            return 0.0
        return max(0.0, abs(x - dflt[i]) - delays[i])

    def step_ok(j: int, step: int) -> bool:
        """No incident edge's bound violation may INCREASE (monotone:
        repairs a rounding-violated start instead of freezing on it —
        rint of a bound-clamped continuous solution can land 1 px out)."""
        for i in inc_all[j]:
            x = pos[vs[i]] - pos[us[i]]
            s = step if vs[i] == j else -step
            if edge_viol(i, x + s) > edge_viol(i, x) + 1e-9:
                return False
        return True

    def delta_viol(j: int, step: int) -> float:
        d = 0.0
        for i in inc_all[j]:
            x = pos[vs[i]] - pos[us[i]]
            s = step if vs[i] == j else -step
            d += edge_viol(i, x + s) - edge_viol(i, x)
        return d

    def delta_cost(j: int, step: int) -> float:
        d = 0.0
        for i in inc_w[j]:
            x = pos[vs[i]] - pos[us[i]]
            s = step if vs[i] == j else -step
            d += ws[i] * ((x + s - ds[i]) ** 2 - (x - ds[i]) ** 2)
        return d

    # repair pass: greedily reduce total bound violation (strictly
    # decreasing integer total -> terminates)
    for _ in range(max_passes):
        repaired = False
        for j in range(1, n):
            for step in (1, -1):
                if delta_viol(j, step) < -1e-9:
                    pos[j] += step
                    repaired = True
        if not repaired:
            break

    for _ in range(max_passes):
        improved = False
        for j in range(1, n):  # node 0 stays anchored
            for step in (1, -1):
                if delta_cost(j, step) < -1e-12 and step_ok(j, step):
                    pos[j] += step
                    improved = True
        if not improved:
            break
    return pos
