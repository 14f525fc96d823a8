"""Lightsheet artifact removal via local percentile filtering (port of
ipp_tpu/ops/lightsheet.py: local_percentile_1d, grid_percentile,
correct_lightsheet and their helpers):

    ls  = local percentile in an elongated element along the sheet (1 x L)
    bg  = local percentile in a coarse box element on a subsampled grid
    img -= min(img, min(ls, bg * lightsheet_vs_background))

Both fields keep the reference's sparse grid: the window samples of every
grid centre (fixed-size windows, edge-clamped), an order statistic per
window by the reference's counting search, then a linear zoom back to the
plane (scipy.ndimage.zoom(order=1)'s endpoint-aligned taps as two f32
matrix products).

The counting search is the reference's, with its f32 bracket arithmetic:
the K-ary search (K = 16, 5 passes, the two ranks that bracket the
percentile, interpolated) for windows under 1024 samples, 11 bisection
passes for larger ones.  It is not an exact quantile: the result is the
upper end of the last bracket, within range / 2^11 of the order statistic
for the large windows.  Each threshold is counted on its own, so the
reference's (ranks, cells, samples, K) compare tensor is never formed;
the counts are exact integers, so the result is the same.

Plain PyTorch on tensors with leading batch dimensions; integer samples
stay in their device dtype (uint16 as int32, `utils/transfer.py`), and the
compares against f32 thresholds are exact.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch

from ..utils.transfer import host_dtype
from .intensity import round_clip

__all__ = ["correct_lightsheet", "local_percentile_1d", "grid_percentile"]


def local_percentile_1d(img: torch.Tensor, size: int, percentile: float,
                        axis: int = -1) -> torch.Tensor:
    """Per-pixel percentile over a 1D window along `axis` (the elongated
    lightsheet structuring element, selem=(1, artifact_length, 1)), with
    edge clamp; linear interpolation between order statistics, as
    jnp.percentile."""
    x = torch.movedim(img.float(), axis, -1)
    n = x.shape[-1]
    half_l = size // 2
    idx = (torch.arange(n, device=x.device)[:, None]
           + torch.arange(size, device=x.device)[None, :] - half_l)
    win = x[..., idx.clamp(0, n - 1)]                 # (..., n, size)
    v = torch.sort(win, dim=-1).values
    pos = percentile * (size - 1)
    lo = int(math.floor(pos))
    hi = min(lo + 1, size - 1)
    f = np.float32(pos - lo)
    out = v[..., lo] * (np.float32(1.0) - f) + v[..., hi] * f
    return torch.movedim(out, -1, axis)


def _count_le(p: torch.Tensor, thr: torch.Tensor) -> torch.Tensor:
    """count(p <= thr) over the sample axes (2, 4) of p (B, cy, ky, cx, kx)
    for thresholds thr (..., B, cy, cx); f32, exact below 2^24."""
    t = thr[..., :, :, None, :, None]
    return (p <= t).sum(dim=(-3, -1), dtype=torch.int32).float()


def _kary_order_stats(p: torch.Tensor, ranks: Sequence[float], K: int = 16,
                      passes: int = 5) -> torch.Tensor:
    """Order statistics over the sample axes of p (B, cy, ky, cx, kx) by
    K-ary counting search: the smallest sample value v with
    count(p <= v) >= r, for each 1-indexed rank r, as the upper end of a
    bracket narrowed K-fold per pass.  Returns (R, B, cy, cx)."""
    R = len(ranks)
    lo = torch.amin(p, dim=(2, 4)).float()
    hi = torch.amax(p, dim=(2, 4)).float()
    width = hi - lo
    lo = lo[None].expand((R,) + tuple(lo.shape)) - 1e-3 * (width + 1.0)
    hi = hi[None].expand((R,) + tuple(hi.shape))
    rank = torch.tensor(list(ranks), dtype=torch.float32,
                        device=p.device).view(R, 1, 1, 1)
    for _ in range(passes):
        step = (hi - lo) / K
        # the first of the K thresholds lo + j * step whose count reaches
        # the rank (counts are monotone in j); none: j = 0
        jsel = torch.full_like(lo, float(K))
        for j in range(K, 0, -1):
            thr = lo + step * np.float32(j)
            found = torch.stack([_count_le(p, thr[r]) for r in range(R)]) \
                >= rank
            jsel = torch.where(found, np.float32(j - 1), jsel)
        jsel = torch.where(jsel == K, 0.0, jsel)
        lo, hi = lo + jsel * step, lo + (jsel + 1.0) * step
    return hi


def _bisect_rank(p: torch.Tensor, rank: float, iters: int = 11
                 ) -> torch.Tensor:
    """The smallest sample value v with count(p <= v) >= rank over the
    sample axes of p (B, cy, ky, cx, kx), by two-way bisection counting:
    the upper end of the bracket after `iters` passes (range / 2^11).
    Returns (B, cy, cx)."""
    lo = torch.amin(p, dim=(2, 4)).float()
    hi = torch.amax(p, dim=(2, 4)).float()
    lo = lo - 1e-3 * (hi - lo + 1.0)
    r = np.float32(rank)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        take = _count_le(p, mid) >= r
        lo, hi = torch.where(take, lo, mid), torch.where(take, mid, hi)
    return hi


def _quantile(p: torch.Tensor, q: float) -> torch.Tensor:
    """np.percentile-style quantile over the sample axes of p (the
    reference's prctl is np.percentile, pystripe/lightsheet_correct.py:
    240-242): small windows (k < 1024) interpolate linearly between the two
    bracketing order statistics; large ones take the upper order statistic
    from bisection."""
    k = p.shape[2] * p.shape[4]
    pos = q * (k - 1)
    f = pos - math.floor(pos)
    r0 = math.floor(pos) + 1  # 1-indexed count of the lower order stat
    if k >= 1024:
        return _bisect_rank(p, r0 if f < 1e-9 else r0 + f)
    if f < 1e-9 or k == 1:
        return _kary_order_stats(p, [r0])[0]
    v = _kary_order_stats(p, [r0, r0 + 1])
    return v[0] + np.float32(f) * (v[1] - v[0])


def _resize_linear_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) linear-resize weight matrix with endpoint alignment
    x_in = o * (n_in - 1) / (n_out - 1), the scipy.ndimage.zoom(order=1)
    convention the reference interpolates its sparse grids with."""
    if n_out == 1 or n_in == 1:
        A = np.zeros((n_out, n_in), np.float32)
        A[:, 0] = 1.0
        return A
    x = np.arange(n_out) * ((n_in - 1) / (n_out - 1))
    x0 = np.floor(x)
    frac = x - x0
    i0 = np.clip(x0.astype(int), 0, n_in - 1)
    i1 = np.clip(x0.astype(int) + 1, 0, n_in - 1)
    A = np.zeros((n_out, n_in), np.float32)
    A[np.arange(n_out), i0] += (1.0 - frac).astype(np.float32)
    A[np.arange(n_out), i1] += frac.astype(np.float32)
    return A


def _resize_linear_mm(vals: torch.Tensor, shape: Tuple[int, int]
                      ) -> torch.Tensor:
    """Linear 2D upsample of (..., i, j) to (..., y, x) as two f32 matrix
    products with the endpoint-aligned taps."""
    ay = torch.from_numpy(_resize_linear_weights(vals.shape[-2], shape[0]))
    ax = torch.from_numpy(_resize_linear_weights(vals.shape[-1], shape[1]))
    return torch.einsum("yi,...ij,xj->...yx", ay.to(vals.device), vals,
                        ax.to(vals.device))


def _band(centers: np.ndarray, size: int, step: int, k: int, n: int
          ) -> np.ndarray:
    """Indices into an axis of length n of the samples {c, c+step, ...,
    c+(k-1)*step} of every window start c of the edge-padded axis (pad
    size // 2 before), clamped to the axis: the reference's edge padding."""
    idx = np.concatenate([np.arange(c, c + size, step)[:k] for c in centers])
    return np.clip(idx - size // 2, 0, n - 1)


def grid_percentile(img: torch.Tensor, selem: Tuple[int, int],
                    spacing: Tuple[int, int], step: Tuple[int, int],
                    percentile: float) -> torch.Tensor:
    """Background field: percentile of subsampled boxes centred on a coarse
    grid, interpolated back to full resolution (reference
    apply_local_function, pystripe/lightsheet_correct.py:113-237), with
    fixed-size windows clamped at the borders as in the JAX package.
    Returns f32 (..., h, w)."""
    h, w = img.shape[-2], img.shape[-1]
    sh, sw = selem
    gy, gx = spacing
    ty, tx = step
    n_cy = h // gy
    n_cx = w // gx
    cy = ((h - (n_cy - 1) * gy) // 2 + np.arange(n_cy) * gy).astype(int)
    cx = ((w - (n_cx - 1) * gx) // 2 + np.arange(n_cx) * gx).astype(int)
    ky = len(range(0, sh, ty))
    kx = len(range(0, sw, tx))
    lead = tuple(img.shape[:-2])
    B = int(np.prod(lead)) if lead else 1
    x3 = img.reshape(B, h, w)
    if x3.is_floating_point():
        x3 = x3.float()
    rows = torch.from_numpy(_band(cy, sh, ty, ky, h)).to(img.device)
    cols = torch.from_numpy(_band(cx, sw, tx, kx, w)).to(img.device)
    p = x3.index_select(1, rows).index_select(2, cols)
    p = p.reshape(B, n_cy, ky, n_cx, kx)       # samples at axes (2, 4)
    vals = _quantile(p, percentile)            # (B, n_cy, n_cx)
    del p
    out = _resize_linear_mm(vals, (h, w))
    return out.reshape(lead + (h, w))


def correct_lightsheet(
    img: torch.Tensor,
    percentile: float = 0.25,
    artifact_length: int = 150,
    background_window_size: int = 200,
    background_spacing: Tuple[int, int] = (25, 25),
    background_step: Tuple[int, int] = (2, 2),
    lightsheet_vs_background: float = 2.0,
) -> torch.Tensor:
    """img -= min(img, min(ls, bg * w)) (reference correct_lightsheet,
    pystripe/lightsheet_correct.py:31-107; called from process_img,
    pystripe/core.py:1337-1352).  Integer images round half to even and
    clip back to their dtype; float images come back as f32."""
    x = img.float()
    # both fields on sparse grids, from the plane in its own dtype: the
    # lightsheet term on a (1, artifact_length) grid, the background on
    # its spacing grid
    ls = grid_percentile(img, (1, artifact_length), (1, artifact_length),
                         (1, 1), percentile)
    bg = grid_percentile(
        img, (background_window_size, background_window_size),
        tuple(background_spacing), tuple(background_step), percentile)
    sub = torch.minimum(x, torch.minimum(ls, bg * lightsheet_vs_background))
    out = x - sub
    if img.is_floating_point():
        return out.to(img.dtype)
    return round_clip(out, host_dtype(img))
