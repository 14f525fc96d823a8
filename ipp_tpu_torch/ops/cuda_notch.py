"""Wrapper of the CUDA kernel K8, the destripe notch, beside its plain
version.

`notch_filter(x, g, axis)` takes every line of length n along axis -1 or
-2 of an f32 tensor (..., H, W) to irfft(rfft(line) * g, n), g the real
(n // 2 + 1) notch of `destripe.notch`: `destripe.filter_coefficient` on
one subband.  `notch_filter_group(xs, gs, axes)` does the same to a list
of subbands in one launch: `destripe.filter_subband` notches every level
of a decomposition (cH along x, cV along y) with it, on the tile chain of
pystripe, process_images, convert, the deconvolution CLI's z-destripe
and the FNT cubes.  It replaces no Pallas kernel: the reference notches
with the XLA FFT (ipp_tpu/ops/destripe.py:168-172).  On the card the
notch ran on cuFFT (`torch.fft.rfft` / `irfft`) until K8, whose algorithm
changes with the batch count, so a destriped tile moved with its batch;
K8 (`csrc/notch.cuh`) computes each line from its own line pair (lines
2i, 2i + 1 of one tile in one complex transform), n and g alone, in an
order fixed by n, so a batch gives bit for bit its single tiles and a
group its one-subband calls.

The wrappers keep the rules of `cuda_fft`: CPU tensors go to the plain
PyTorch version (`notch_filter_plain`, the torch.fft body, one call a
subband); a CUDA tensor launches the kernel or raises, with no fallback;
`LAUNCHES["notch"]` counts kernel launches only: one a group of up to
`MAX_GROUP` subbands, and one for each subband whose buffers exceed
shared memory (n above ~27000, or ~13600 with a generic radix; none on
the destripe chain).  Lengths 1 .. `NOTCH_MAX_N` of any factors.
"""

from __future__ import annotations

import threading
from functools import lru_cache
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from .cuda_fft import _launch, _on_cuda, _stage_twiddles
from .dft_mats import DFT_FFT_RADICES

__all__ = ["LAUNCHES", "NOTCH_MAX_N", "MAX_GROUP", "reset_launch_counts",
           "notch_plan", "notch_geometry", "notch_steps", "notch_gains",
           "notch_filter", "notch_filter_plain", "notch_filter_group",
           "notch_filter_group_plain"]

NOTCH_MAX_N = 32768          # csrc/notch.cuh MAX_N
SMEM_LIMIT = 227 * 1024
THREADS = 256                # every block
VALUES = 24                  # values a thread aims at a pass
TMIN = 16                    # threads a pair at least
MAX_GROUP = 16               # subbands a launch
MAX_PASSES = 12              # csrc/dft_fft.cuh
# the radices with a butterfly of constant roots (csrc/notch.cuh special)
NOTCH_RADICES = DFT_FFT_RADICES + (12,)

LAUNCHES: Dict[str, int] = {"notch": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check_length(n: int) -> None:
    if not 1 <= n <= NOTCH_MAX_N:
        raise ValueError(f"notch: the line length must be in [1, "
                         f"{NOTCH_MAX_N}] (K8's limit), got {n}")


def _pow2_passes(a: int) -> List[int]:
    """The passes of 2^a as `dft_mats.dft_fft_plan` takes them: 8s then
    16s (8, 4 for a = 5; 2 or 4 alone for a = 1, 2)."""
    if a >= 3:
        k = -(-a // 4)
        return [8, 4] if a == 5 else [8] * (4 * k - a) + [16] * (a - 3 * k)
    return [1 << a] if a else []


@lru_cache(maxsize=512)
def notch_plan(n: int) -> Tuple[int, ...]:
    """Radices of K8's passes for lines of length n, in order: t passes of
    12 = 4 * 3 first, then the passes of the 2^(a - 2t) left
    (`_pow2_passes`), then 9s and a 3 for the 3s left, 5, 7, 11, 13 for
    those factors of the odd part, and last what is left of it, if
    anything, as ONE generic pass of that odd radix (n = 1: the generic
    pass of 1).  t gives the fewest passes, the most 12s among equals
    (the fastest plans of scripts/notch_bench.py --sweep on an H100 at
    1344, 1152 and 672; PERF.md §6)."""
    n = int(n)
    _check_length(n)
    a = (n & -n).bit_length() - 1
    m = n >> a
    b = 0
    while m % 3 == 0:
        m //= 3
        b += 1

    def passes(t):
        return t + len(_pow2_passes(a - 2 * t)) + -(-(b - t) // 2)
    t = min(range(min(a // 2, b) + 1), key=lambda t: (passes(t), -t))
    plan = [12] * t + _pow2_passes(a - 2 * t)
    plan += [9] * ((b - t) // 2) + [3] * ((b - t) % 2)
    for r in (5, 7, 11, 13):
        while m % r == 0:
            plan.append(r)
            m //= r
    if m > 1 or not plan:
        plan.append(m)
    return tuple(plan)


def _generic(plan: Tuple[int, ...]) -> bool:
    return plan[-1] not in NOTCH_RADICES


def notch_steps(plan: Tuple[int, ...]) -> List[Tuple[str, int]]:
    """csrc/notch.cuh `step_of`: the steps of an item, (kind, pass), one
    barrier after each.  P specialised passes: DIF 0 .. P-2 (forward; the
    first reads device memory), MID on pass P-1 (forward DFT, gain,
    conjugation, DFT in registers), DIT P-2 .. 0 (the last writes device
    memory); a generic last radix: GEN_DIF into the second buffer and
    GEN_DIT back in place of MID; one pass: LOAD, the middle, STORE
    (GEN_DIT stores itself)."""
    P, gen = len(plan), _generic(plan)
    if P == 1:
        return [("LOAD", 0), ("GEN_DIF" if gen else "MID", 0),
                ("GEN_DIT" if gen else "STORE", 0)]
    mid = [("GEN_DIF", P - 1), ("GEN_DIT", P - 1)] if gen else [("MID",
                                                                 P - 1)]
    return ([("DIF", p) for p in range(P - 1)] + mid
            + [("DIT", p) for p in range(P - 2, -1, -1)])


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _pow2ceil(v: int) -> int:
    return 1 << max(int(v) - 1, 0).bit_length()


def notch_geometry(B: int, H: int, W: int, cols: bool,
                   aligned8: bool = True, generic: bool = False) -> dict:
    """csrc/notch.cuh `geometry` of (B, H, W) along the columns (axis -2,
    n = H) or the rows (n = W): THREADS threads a block, CP line pairs an
    item, T = THREADS / CP threads a pair, the slots of one buffer (`buf`
    float2; `nbuf` 2 for a plan with a generic radix), shared memory
    bytes (0: the buffers of a block live in a device-memory scratch)."""
    return dict(_geometry(int(B), int(H), int(W), bool(cols),
                          bool(aligned8), bool(generic)))


@lru_cache(maxsize=512)
def _geometry(B: int, H: int, W: int, cols: bool, aligned8: bool,
              generic: bool) -> tuple:
    n = H if cols else W
    t0 = min(max(_pow2ceil(_cdiv(n, VALUES)), TMIN), THREADS)
    CP = THREADS // t0
    if not cols:
        pairs = B * _cdiv(H, 2)
        while CP > 1 and CP // 2 >= pairs:
            CP //= 2
        pitch = (n - 1 + ((n - 1) >> 4) + 1) | 1
        buf = CP * pitch
        tiles, vec2 = 0, False
        items = _cdiv(pairs, CP)
    else:
        CP = min(CP, _pow2ceil(_cdiv(W, 2)))
        pitch = 0
        last = CP * n - 1
        buf = last + (last >> 4) + 1
        tiles = _cdiv(_cdiv(W, 2), CP)
        vec2 = bool(aligned8 and W % 2 == 0)
        pairs = B * _cdiv(W, 2)
        items = B * tiles
    nbuf = 2 if generic else 1
    smem = 8 * nbuf * buf if 8 * nbuf * buf <= SMEM_LIMIT else 0
    return tuple(dict(n=n, cols=int(cols), CP=CP, T=THREADS // CP,
                      threads=THREADS, pitch=pitch, buf=buf, nbuf=nbuf,
                      smem=smem, tiles=tiles, vec2=int(vec2), pairs=pairs,
                      items=items).items())


def notch_gains(g: np.ndarray, n: int, plan=None) -> np.ndarray:
    """The kernel's gains (n) f32: G[f] / n = g[min(f, n - f)] / n, float64
    rounded once, at the element where the forward passes of the plan
    (`notch_plan(n)` unless given) leave frequency f: f = k_0 + r_0 k_1 +
    r_0 r_1 k_2 + ... sits at sum_p k_p M_p, M_p = n / (r_0 ... r_p)."""
    plan = notch_plan(n) if plan is None else tuple(plan)
    f = np.arange(n)
    rest, at, M = f.copy(), np.zeros(n, np.int64), n
    for r in plan:
        M //= r
        at += (rest % r) * M
        rest //= r
    gp = np.empty(n, np.float32)
    gp[at] = (np.asarray(g, np.float64)[np.minimum(f, n - f)] / n).astype(
        np.float32)
    return gp


def _check(x: torch.Tensor, g, axis: int
           ) -> Tuple[np.ndarray, int, int, int, int]:
    """Validate the arguments; returns g as f32 numpy and (B, H, W, n) of x
    as (B, H, W).  A tensor g must lie on x's device."""
    name = "notch"
    if isinstance(g, torch.Tensor):
        if g.device != x.device:
            raise ValueError(f"{name}: x and g on two devices ({x.device}, "
                             f"{g.device})")
        g = g.detach().cpu().numpy()
    g = np.ascontiguousarray(g, np.float32)
    if axis not in (-1, -2):
        raise ValueError(f"{name}: axis must be -1 or -2, got {axis}")
    if x.dim() < -axis:
        raise ValueError(f"{name}: axis {axis} of a {x.dim()}-d input")
    if x.dtype != torch.float32:
        raise TypeError(f"{name}: float32 only (got {x.dtype})")
    n = x.shape[axis]
    _check_length(n)
    if tuple(np.shape(g)) != (n // 2 + 1,):
        raise ValueError(f"{name}: g must have n // 2 + 1 = {n // 2 + 1} "
                         f"entries, got shape {tuple(np.shape(g))}")
    W = x.shape[-1]
    H = x.shape[-2] if x.dim() > 1 else 1
    return g, x.numel() // max(H * W, 1), H, W, n


def notch_filter_plain(x: torch.Tensor, g, axis: int = -1) -> torch.Tensor:
    """irfft(rfft(x) * g, n) along `axis` (-1 or -2) with torch.fft; g the
    (n // 2 + 1) real notch (numpy, or a tensor on x's device)."""
    g, _, _, _, n = _check(x, g, axis)
    f = torch.fft.rfft(x, dim=axis)
    gt = torch.from_numpy(g).to(x.device)
    shape = [1] * f.dim()
    shape[axis] = f.shape[axis]
    return torch.fft.irfft(f * gt.reshape(shape), n=n, dim=axis)


def notch_filter_group_plain(xs: Sequence[torch.Tensor], gs,
                             axes: Sequence[int]) -> List[torch.Tensor]:
    """`notch_filter_plain` of every (x, g, axis), in order."""
    return [notch_filter_plain(x, g, a) for x, g, a in zip(xs, gs, axes)]


_gains: Dict[tuple, torch.Tensor] = {}
_gains_lock = threading.Lock()


def _device_gains(device: torch.device, g: np.ndarray, n: int
                  ) -> torch.Tensor:
    """`notch_gains(g, n)` on `device`, uploaded once per (device, n, g)."""
    key = (device, n, g.tobytes())
    with _gains_lock:
        if key not in _gains:
            if len(_gains) >= 256:
                _gains.clear()
            _gains[key] = torch.from_numpy(notch_gains(g, n)).to(device)
        return _gains[key]


def _desc_row(x: torch.Tensor, y: torch.Tensor, g: np.ndarray, B: int,
              H: int, W: int, axis: int) -> Tuple[list, dict, list]:
    """The table row of x -> y for `ipp_notch_group` (csrc/notch.cuh
    `make_group`: x, y, tw, gp, B, H, W, cols, passes, generic, radices),
    its geometry, and the device tables it points into (keep them alive
    until the launch is enqueued)."""
    n = H if axis == -2 else W
    plan = notch_plan(n)
    tw = _stage_twiddles(x.device, n)
    gp = _device_gains(x.device, g, n)
    geo = notch_geometry(B, H, W, axis == -2,
                         x.data_ptr() % 8 == 0 and y.data_ptr() % 8 == 0,
                         _generic(plan))
    row = ([x.data_ptr(), y.data_ptr(), tw.data_ptr(), gp.data_ptr(), B, H,
            W, int(axis == -2), len(plan), int(_generic(plan))]
           + list(plan) + [1] * (MAX_PASSES - len(plan)))
    return row, geo, [tw, gp]


def _launches(xs, checked, axes, ys) -> List[tuple]:
    """The launches of the subbands xs -> ys on the card (`checked`: their
    `_check` results): (table, count, scratch, nscratch, the tensors to
    keep alive) each; subbands whose buffers fit shared memory MAX_GROUP a
    launch in order, each other one alone with a scratch of device memory
    (two blocks an SM)."""
    grouped, alone = [], []
    for x, (g, B, H, W, _), axis, y in zip(xs, checked, axes, ys):
        if x.numel() == 0:
            continue
        row, geo, keep = _desc_row(x, y, g, B, H, W, axis)
        if geo["smem"]:
            grouped.append((row, keep))
            continue
        sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        nscratch = min(geo["items"], 2 * sms)
        scratch = torch.empty(nscratch * geo["nbuf"] * geo["buf"] * 2,
                              dtype=torch.float32, device=x.device)
        alone.append((np.asarray([row], np.int64), 1, scratch.data_ptr(),
                      nscratch, keep + [scratch]))
    return [(np.asarray([r for r, _ in part], np.int64), len(part), None, 0,
             [t for _, k in part for t in k])
            for part in (grouped[i:i + MAX_GROUP]
                         for i in range(0, len(grouped), MAX_GROUP))] + alone


def notch_filter_group(xs: Sequence[torch.Tensor], gs,
                       axes: Sequence[int]) -> List[torch.Tensor]:
    """K8 on every subband (x, g, axis) of the lists: `notch_filter` of
    each, in one launch for up to MAX_GROUP subbands.  x f32 (..., H, W),
    contiguous; every x on the CPU (the plain version) or all on one CUDA
    device; g the (n // 2 + 1) notch of its axis, best on the host."""
    name = "notch"
    xs, axes = list(xs), list(axes)
    gs = list(gs)
    if not (len(xs) == len(gs) == len(axes)):
        raise ValueError(f"{name}: {len(xs)} inputs, {len(gs)} notches and "
                         f"{len(axes)} axes")
    if not xs:
        return []
    checked = [_check(x, g, a) for x, g, a in zip(xs, gs, axes)]
    if not _on_cuda(name, *xs):
        return notch_filter_group_plain(xs, [c[0] for c in checked], axes)
    ys = [torch.empty_like(x) for x in xs]
    from ._build import load_library

    fn = load_library().ipp_notch_group
    for table, count, scratch, nscratch, keep in _launches(xs, checked,
                                                           axes, ys):
        _launch(name, xs[0].device, fn, table.ctypes.data, count, scratch,
                nscratch, counts=LAUNCHES)
        del keep
    return ys


def notch_filter(x: torch.Tensor, g, axis: int = -1) -> torch.Tensor:
    """K8: see `notch_filter_plain`; a group of one subband.  x f32 (...,
    H, W), contiguous on the card; g the (n // 2 + 1) notch, best on the
    host (numpy)."""
    return notch_filter_group([x], [g], [axis])[0]
