"""Wrapper of the CUDA kernel K8, the destripe notch, beside its plain
version.

`notch_filter(x, g, axis)` takes every line of length n along axis -1 or
-2 of an f32 tensor (..., H, W) to irfft(rfft(line) * g, n), g the real
(n // 2 + 1) notch of `destripe.notch`: `destripe.filter_coefficient` on
every wavelet level of the tile chain (pystripe, process_images, convert,
the deconvolution CLI's z-destripe, the FNT cubes).  It replaces no Pallas
kernel: the reference notches with the XLA FFT (ipp_tpu/ops/destripe.py:
168-172).  On the card the notch ran on cuFFT (`torch.fft.rfft` / `irfft`)
until K8, whose algorithm changes with the batch count, so a destriped
tile moved with its batch; K8 (`csrc/notch.cuh`) computes each line from
its own line pair (lines 2i, 2i + 1 of one tile in one complex
transform), n and g alone, in an order fixed by n, so a batch gives bit
for bit its single tiles.

The wrapper keeps the rules of `cuda_fft`: a CPU tensor goes to the plain
PyTorch version (`notch_filter_plain`, the torch.fft body); a CUDA tensor
launches the kernel or raises, with no fallback; `LAUNCHES["notch"]`
counts kernel launches only.  Lengths 1 .. `NOTCH_MAX_N` of any factors.
"""

from __future__ import annotations

import threading
from typing import Dict, Tuple

import numpy as np
import torch

from .cuda_fft import _dft_plan, _launch, _on_cuda, _stage_twiddles

__all__ = ["LAUNCHES", "NOTCH_MAX_N", "reset_launch_counts", "notch_plan",
           "notch_geometry", "notch_filter", "notch_filter_plain"]

NOTCH_MAX_N = 32768          # csrc/notch.cuh MAX_N
SMEM_LIMIT = 227 * 1024
MAX_THREADS = 512
ROWS_THREADS = 160
ROW_PAD = 1
COLS_MAX = 16

LAUNCHES: Dict[str, int] = {"notch": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check_length(n: int) -> None:
    if not 1 <= n <= NOTCH_MAX_N:
        raise ValueError(f"notch: the line length must be in [1, "
                         f"{NOTCH_MAX_N}] (K8's limit), got {n}")


def notch_plan(n: int) -> Tuple[int, ...]:
    """Radices of K8's passes for lines of length n, in order: the passes
    of 2^a as `dft_mats.dft_fft_plan` takes them (8s then 16s; 8, 4 for
    a = 5; 2 or 4 alone for a = 1, 2), then 9, 3, 5, 7, 11, 13 for those
    factors of the odd part, and last what is left of it, if anything, as
    ONE generic pass of that odd radix (n = 1: the generic pass of 1)."""
    n = int(n)
    _check_length(n)
    a = (n & -n).bit_length() - 1
    m = n >> a
    if a >= 3:
        k = -(-a // 4)
        plan = [8, 4] if a == 5 else [8] * (4 * k - a) + [16] * (a - 3 * k)
    else:
        plan = [1 << a] if a else []
    for r in (9, 3, 5, 7, 11, 13):
        while m % r == 0:
            plan.append(r)
            m //= r
    if m > 1 or not plan:
        plan.append(m)
    return tuple(plan)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def notch_geometry(B: int, H: int, W: int, cols: bool,
                   aligned8: bool = True) -> dict:
    """csrc/notch.cuh `geometry` of (B, H, W) along the columns (axis -2,
    n = H) or the rows (n = W): CP line pairs an item, T threads a pair,
    the slots of one buffer (`buf` float2), shared memory bytes (0: the
    two buffers a block live in a device-memory scratch)."""
    n = H if cols else W
    t0 = min(max(n // 16 if n >= 512 else n // 8, 1), MAX_THREADS)
    if not cols:
        pad = ROW_PAD
        pitch = (n - 1 + ((n - 1) >> 4) * pad + 1) | 1
        T = t0
        CP = 1 if t0 >= ROWS_THREADS else ROWS_THREADS // t0
        while CP > 1 and 16 * CP * pitch > SMEM_LIMIT:
            CP -= 1
        if 16 * pitch > SMEM_LIMIT:
            pad, pitch = 0, n | 1
        buf = CP * pitch
        tiles, vec2 = 0, False
        pairs = B * _cdiv(H, 2)
        items = _cdiv(pairs, CP)
    else:
        pad, pitch, CP = 0, n, COLS_MAX
        while CP > 1 and 16 * CP * n > SMEM_LIMIT // 2:
            CP //= 2
        T = min(t0, MAX_THREADS // CP)
        buf = CP * n
        tiles = _cdiv(_cdiv(W, 2), CP)
        vec2 = bool(aligned8 and W % 2 == 0)
        pairs = B * _cdiv(W, 2)
        items = B * tiles
    smem = 16 * buf if 16 * buf <= SMEM_LIMIT else 0
    return dict(n=n, cols=int(cols), CP=CP, T=T, threads=CP * T, pad=pad,
                pitch=pitch, buf=buf, smem=smem, tiles=tiles,
                vec2=int(vec2), pairs=pairs, items=items)


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


_gains: Dict[tuple, torch.Tensor] = {}
_gains_lock = threading.Lock()


def _device_gains(device: torch.device, g: np.ndarray, n: int
                  ) -> torch.Tensor:
    """gs (n) = g[min(k, n - k)] / n on `device`, float64 rounded once to
    f32, uploaded once per (device, n, g)."""
    key = (device, n, g.tobytes())
    with _gains_lock:
        if key not in _gains:
            if len(_gains) >= 256:
                _gains.clear()
            k = np.arange(n)
            gs = (g.astype(np.float64)[np.minimum(k, n - k)] / n).astype(
                np.float32)
            _gains[key] = torch.from_numpy(gs).to(device)
        return _gains[key]


def _kernel_args(x: torch.Tensor, y: torch.Tensor, g: np.ndarray, B: int,
                 H: int, W: int, axis: int):
    """The arguments of the C entry `ipp_notch` for x -> y on the card (but
    the stream), and the scratch they point into (keep it alive until the
    launch is enqueued; the allocator orders its reuse after it)."""
    n = H if axis == -2 else W
    tw, gs = _stage_twiddles(x.device, n), _device_gains(x.device, g, n)
    radices, npass, generic = _dft_plan(notch_plan(n))
    geo = notch_geometry(B, H, W, axis == -2)
    scratch, nscratch = None, 0
    if not geo["smem"]:   # two buffers a block in device memory
        sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        nscratch = min(geo["items"], 2 * sms)
        scratch = torch.empty(nscratch * 2 * geo["buf"] * 2,
                              dtype=torch.float32, device=x.device)
    args = (x.data_ptr(), y.data_ptr(), tw.data_ptr(), gs.data_ptr(), B, H,
            W, int(axis == -2), npass, radices, generic,
            None if scratch is None else scratch.data_ptr(), nscratch)
    return args, scratch


def notch_filter(x: torch.Tensor, g, axis: int = -1) -> torch.Tensor:
    """K8: see `notch_filter_plain`.  x f32 (..., H, W), contiguous on the
    card; g the (n // 2 + 1) notch, best on the host (numpy)."""
    name = "notch"
    g, B, H, W, _ = _check(x, g, axis)
    if not _on_cuda(name, x):
        return notch_filter_plain(x, g, axis)
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    from ._build import load_library

    args, scratch = _kernel_args(x, y, g, B, H, W, axis)
    _launch(name, x.device, load_library().ipp_notch, *args,
            counts=LAUNCHES)
    del scratch
    return y
