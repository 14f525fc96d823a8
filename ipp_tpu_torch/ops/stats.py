"""Histogram statistics: Otsu and multi-Otsu thresholds.

Host-side (numpy) equivalents of the skimage calls used by the reference to
auto-estimate dark level, bit shift, and bleach-correction clips
(reference: pystripe/core.py:576-580 threshold_otsu;
process_images.py:594-655 and pystripe/core.py:1071-1078 threshold_multiotsu).

These run on small sample planes, so they stay on the host by design — no
data-dependent device control flow.

A copy of ipp_tpu/ops/stats.py: the original cannot be imported without
jax (ipp_tpu/ops/__init__.py imports ops/deconv.py).
tests/test_torch_process.py pins every function equal to the original.
"""

from __future__ import annotations


import numpy as np

__all__ = ["threshold_otsu", "threshold_multiotsu"]


def _histogram(image: np.ndarray, nbins: int):
    image = np.asarray(image).ravel()
    if np.issubdtype(image.dtype, np.integer):
        lo, hi = int(image.min()), int(image.max())
        if hi - lo + 1 <= nbins:
            centers = np.arange(lo, hi + 1)
            counts = np.bincount((image - lo).astype(np.int64),
                                 minlength=hi - lo + 1)
            return counts.astype(np.float64), centers.astype(np.float64)
    counts, edges = np.histogram(image, bins=nbins)
    centers = (edges[:-1] + edges[1:]) / 2.0
    return counts.astype(np.float64), centers


def threshold_otsu(image: np.ndarray, nbins: int = 256) -> float:
    """Otsu's threshold (maximizes inter-class variance)."""
    counts, centers = _histogram(image, nbins)
    if len(centers) == 1:
        return float(centers[0])
    w1 = np.cumsum(counts)
    w2 = np.cumsum(counts[::-1])[::-1]
    m1 = np.cumsum(counts * centers) / np.maximum(w1, 1e-30)
    m2 = (np.cumsum((counts * centers)[::-1]) / np.maximum(w2[::-1], 1e-30))[::-1]
    var_between = w1[:-1] * w2[1:] * (m1[:-1] - m2[1:]) ** 2
    idx = np.argmax(var_between)
    return float(centers[idx])


def threshold_multiotsu(image: np.ndarray, classes: int = 3,
                        nbins: int = 256) -> np.ndarray:
    """Multi-Otsu thresholds (classes-1 values), dynamic-programming search
    maximizing total inter-class variance — same objective as
    skimage.filters.threshold_multiotsu."""
    counts, centers = _histogram(image, nbins)
    n = len(counts)
    if n < classes:
        # degenerate: fewer distinct values than classes
        vals = np.unique(centers)
        out = vals[: classes - 1]
        return np.pad(out, (0, classes - 1 - len(out)), mode="edge")
    p = counts / counts.sum()
    # prefix sums for O(1) class stats
    P = np.concatenate([[0.0], np.cumsum(p)])
    S = np.concatenate([[0.0], np.cumsum(p * centers)])

    def class_var(i, j):  # bins [i, j)
        w = P[j] - P[i]
        if w <= 0:
            return 0.0
        mu = (S[j] - S[i]) / w
        return w * mu * mu

    k = classes - 1
    # DP over split points
    best = np.full((classes, n + 1), -np.inf)
    arg = np.zeros((classes, n + 1), dtype=np.int64)
    for j in range(1, n + 1):
        best[0, j] = class_var(0, j)
    for c in range(1, classes):
        for j in range(c + 1, n + 1):
            i_vec = np.arange(c, j)
            w = P[j] - P[i_vec]
            s = S[j] - S[i_vec]
            v = np.where(w > 0, s * s / np.maximum(w, 1e-30), 0.0)
            cand = best[c - 1, c:j] + v
            i_best = int(np.argmax(cand)) + c
            best[c, j] = cand[i_best - c]
            arg[c, j] = i_best
    # backtrack
    splits = []
    j = n
    for c in range(classes - 1, 0, -1):
        i = arg[c, j]
        splits.append(i)
        j = i
    splits = sorted(splits)
    return np.array([centers[s - 1] for s in splits], dtype=np.float64)


def estimate_bit_shift(log_img: np.ndarray, threshold: float,
                       percentile: float = 99.9) -> int:
    """Smallest right bit-shift whose 8-bit range covers the image's bright
    percentile (reference estimate_bit_shift, process_images.py:320-332;
    input is a log1p image, threshold usually the upper multi-Otsu clip)."""
    vals = log_img[log_img > threshold]
    if vals.size:
        upper = float(np.percentile(vals, percentile))
    else:
        upper = float(np.max(log_img))
    upper = int(round(np.expm1(upper)))
    for b in range(0, 9):
        if 256 * 2 ** b >= upper:
            return b
    return 8


def estimate_image_params(sample_planes, classes: int = 4,
                          percentile: float = 99.99):
    """Auto-estimate (dark, bit_shift, clip_min, clip_med, clip_max) from
    sample z planes (reference estimate_img_related_params,
    process_images.py:594-655: multi-Otsu on log1p of the 25/50/75% planes,
    max bit shift across them, dark = expm1(clip_min))."""
    bit_shifts = []
    clips = None
    for plane in sample_planes:
        x = np.log1p(np.asarray(plane, dtype=np.float32))
        if np.all(x == x.flat[0]):
            continue
        lb, mb, ub = threshold_multiotsu(x, classes=classes)
        bit_shifts.append(estimate_bit_shift(x, threshold=ub,
                                             percentile=percentile))
        clips = (float(lb), float(mb), float(ub))
    if not bit_shifts or clips is None:
        return 0, 8, None, None, None
    dark = int(round(np.expm1(clips[0])))
    return dark, max(bit_shifts), clips[0], clips[1], clips[2]
