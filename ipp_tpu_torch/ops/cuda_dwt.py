"""Wrapper of the DWT analysis CUDA kernel K5, beside its plain version.

`dwt_analysis` runs one level of circular DWT analysis along axis -1 or
-2 (`csrc/dwt.cu`); it replaces the two Pallas entry points of the
reference's DWT:

| axis | Pallas entry point replaced                                   |
|------|---------------------------------------------------------------|
| -1   | `dwt_analysis_pallas` (ipp_tpu/ops/pallas_dwt.py)             |
| -2   | `dwt_y_pallas` (scripts/dwt_ykernel_exp.py)                   |

The kernel (`csrc/dwt.cuh`: R outputs a thread from a sliding register
window, the taps a warp-uniform float4 per tap pair) takes every shape the
wrapper accepts, rows shorter than the filter included, so there is no
route.  The wrapper keeps the rules of `cuda_fft`: a CPU tensor goes to the
plain PyTorch version (`dwt_analysis_plain`, the strided `F.conv1d` form of
wavelets._conv_stride2_last); a CUDA tensor launches the kernel or raises,
with no fallback; `LAUNCHES["dwt_analysis"]` counts kernel launches only.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from .cuda_fft import _launch, _on_cuda

__all__ = ["LAUNCHES", "MAX_TAPS", "reset_launch_counts", "dwt_analysis",
           "dwt_analysis_plain"]

MAX_TAPS = 128  # MAXL of csrc/dwt.cuh

LAUNCHES: Dict[str, int] = {"dwt_analysis": 0}

Pair = Tuple[torch.Tensor, torch.Tensor]


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check(x: torch.Tensor, taps: torch.Tensor, axis: int) -> int:
    """Validate the arguments; returns the transformed axis' length."""
    if axis not in (-1, -2):
        raise ValueError(f"dwt_analysis: axis must be -1 or -2, got {axis}")
    if x.dim() < -axis:
        raise ValueError(f"dwt_analysis: axis {axis} of a {x.dim()}-d input")
    if taps.dim() != 2 or taps.shape[0] != 2:
        raise ValueError("dwt_analysis: taps must be (2, L) = [rec_lo; "
                         f"rec_hi], got {tuple(taps.shape)}")
    n, L = x.shape[axis], taps.shape[1]
    if n % 2 or L % 2 or not 2 <= L <= MAX_TAPS:
        raise ValueError(f"dwt_analysis: needs an even axis length and an "
                         f"even filter length in [2, {MAX_TAPS}] "
                         f"(got n={n}, L={L})")
    return n


def dwt_analysis_plain(x: torch.Tensor, taps: torch.Tensor,
                       axis: int = -1) -> Pair:
    """One circular DWT level along `axis` (-1 or -2): cA[i] =
    sum_k taps[0, k] * x[(2i + k) mod n], cD likewise with taps[1]; both
    (..., n/2) along that axis.  Strided conv1d over the circular
    extension (wavelets._conv_stride2_last of the reference)."""
    n = _check(x, taps, axis)
    if axis == -2:
        ca, cd = dwt_analysis_plain(x.transpose(-1, -2), taps, -1)
        return (ca.transpose(-1, -2).contiguous(),
                cd.transpose(-1, -2).contiguous())
    L = taps.shape[1]
    reps = -(-L // n)  # a short row may need several wraps
    ext = torch.cat([x] * (1 + reps), dim=-1)[..., :n + L]
    out = F.conv1d(ext.reshape(-1, 1, n + L), taps.to(x.dtype).unsqueeze(1),
                   stride=2)[..., :n // 2]
    out = out.reshape(*x.shape[:-1], 2, n // 2)
    return out[..., 0, :], out[..., 1, :]


def dwt_analysis(x: torch.Tensor, taps: torch.Tensor, axis: int = -1) -> Pair:
    """K5: see `dwt_analysis_plain`.  x f32 contiguous, (..., n) for
    axis=-1 or (..., n, w) for axis=-2; taps (2, L) f32 on x's device."""
    name = "dwt_analysis"
    n = _check(x, taps, axis)
    if not _on_cuda(name, x, taps):
        return dwt_analysis_plain(x, taps, axis)
    L = taps.shape[1]
    inner = 1 if axis == -1 else x.shape[-1]
    batch = x.numel() // (n * inner)
    out_shape = list(x.shape)
    out_shape[axis] = n // 2
    ca = torch.empty(out_shape, dtype=torch.float32, device=x.device)
    cd = torch.empty(out_shape, dtype=torch.float32, device=x.device)
    if x.numel():
        from ._build import load_library

        if x.data_ptr() % 16:   # the kernel copies 16 bytes at a time
            x = x.clone()

        _launch(name, x.device, load_library().ipp_dwt_analysis,
                x.data_ptr(), taps.data_ptr(), ca.data_ptr(), cd.data_ptr(),
                batch, n, inner, L, counts=LAUNCHES)
    return ca, cd
