"""Wrappers of the DWT CUDA kernels K5 (analysis) and K5s (synthesis),
each beside its plain version.

`dwt_analysis` runs one level of circular DWT analysis along axis -1 or
-2 (`csrc/dwt.cu`); it replaces the two Pallas entry points of the
reference's DWT:

| axis | Pallas entry point replaced                                   |
|------|---------------------------------------------------------------|
| -1   | `dwt_analysis_pallas` (ipp_tpu/ops/pallas_dwt.py)             |
| -2   | `dwt_y_pallas` (scripts/dwt_ykernel_exp.py)                   |

`dwt_synthesis` runs its inverse, one level of synthesis along the same
axis.  It replaces no Pallas kernel: the reference synthesises with an XLA
convolution (wavelets._idwt_last).  Its plain version, a stride-2
transposed convolution folded mod n, ran on the card until K5s: cuDNN
picks the transposed convolution's algorithm by shape, and some of them
sum in an order that changes with the batch or the run, so a destriped
tile could move a count between runs.  K5s writes each output from one
FMA chain in an order fixed by the filter length alone.

The kernels (`csrc/dwt.cuh`: R outputs a thread from a sliding register
window, the taps a warp-uniform float4 per tap pair) take every shape the
wrappers accept, rows shorter than the filter included, so there is no
route.  The wrappers keep the rules of `cuda_fft`: a CPU tensor goes to
the plain PyTorch version (`dwt_analysis_plain`, the strided `F.conv1d`
form of wavelets._conv_stride2_last; `dwt_synthesis_plain`, the
transposed convolution); a CUDA tensor launches the kernel or raises, with
no fallback; `LAUNCHES[name]` counts kernel launches only.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from .cuda_fft import _launch, _on_cuda

__all__ = ["LAUNCHES", "MAX_TAPS", "reset_launch_counts", "dwt_analysis",
           "dwt_analysis_plain", "dwt_synthesis", "dwt_synthesis_plain"]

MAX_TAPS = 128  # MAXL of csrc/dwt.cuh

LAUNCHES: Dict[str, int] = {"dwt_analysis": 0, "dwt_synthesis": 0}

Pair = Tuple[torch.Tensor, torch.Tensor]


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check(x: torch.Tensor, taps: torch.Tensor, axis: int,
           name: str = "dwt_analysis", n=None) -> int:
    """Validate the arguments; returns the transformed axis' length (the
    output's, 2 m, for the synthesis, which passes it as `n`)."""
    if axis not in (-1, -2):
        raise ValueError(f"{name}: axis must be -1 or -2, got {axis}")
    if x.dim() < -axis:
        raise ValueError(f"{name}: axis {axis} of a {x.dim()}-d input")
    if taps.dim() != 2 or taps.shape[0] != 2:
        raise ValueError(f"{name}: taps must be (2, L) = [rec_lo; "
                         f"rec_hi], got {tuple(taps.shape)}")
    n = x.shape[axis] if n is None else n
    L = taps.shape[1]
    if n % 2 or L % 2 or not 2 <= L <= MAX_TAPS:
        raise ValueError(f"{name}: needs an even axis length and an "
                         f"even filter length in [2, {MAX_TAPS}] "
                         f"(got n={n}, L={L})")
    return n


def _check_synthesis(ca: torch.Tensor, cd: torch.Tensor, taps: torch.Tensor,
                     axis: int) -> int:
    """`_check` for a pair of subbands; returns m, their axis' length."""
    name = "dwt_synthesis"
    if ca.shape != cd.shape:
        raise ValueError(f"{name}: ca and cd differ in shape "
                         f"({tuple(ca.shape)}, {tuple(cd.shape)})")
    if ca.dim() < -axis:
        raise ValueError(f"{name}: axis {axis} of a {ca.dim()}-d input")
    return _check(ca, taps, axis, name, 2 * ca.shape[axis]) // 2


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


def _fold(y: torch.Tensor, n: int, dim: int) -> torch.Tensor:
    """Sum `y` over positions congruent mod n along `dim` (-1 or -2; length
    n out): turns the linear convolution into the circular one."""
    T = y.shape[dim]
    p = -(-T // n) * n
    y = F.pad(y, [0, 0] * (-dim - 1) + [0, p - T])
    d = y.dim() + dim
    return y.reshape(y.shape[:d] + (p // n, n) + y.shape[d + 1:]).sum(d)


def dwt_synthesis_plain(ca: torch.Tensor, cd: torch.Tensor,
                        taps: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Inverse of one analysis level along `axis` (-1 or -2; the transpose
    of analysis): y[t] = sum_i ca[i] lo[(t - 2i) mod n] + cd[i] hi[...],
    n = 2m, the reference's upsample + circular conv (`_idwt_last`), as
    one stride-2 transposed conv over both subbands folded mod n."""
    m = _check_synthesis(ca, cd, taps, axis)
    n = 2 * m
    w = taps.to(ca.dtype)
    if axis == -1:
        lead = ca.shape[:-1]
        inp = torch.stack([ca, cd], -2).reshape(-1, 2, m)
        y = F.conv_transpose1d(inp, w.unsqueeze(1), stride=2)
        return _fold(y, n, -1).reshape(*lead, n)
    lead, width = ca.shape[:-2], ca.shape[-1]
    inp = torch.stack([ca, cd], -3).reshape(-1, 2, m, width)
    y = F.conv_transpose2d(inp, w[:, None, :, None], stride=(2, 1))
    return _fold(y, n, -2).reshape(*lead, n, width)


def dwt_synthesis(ca: torch.Tensor, cd: torch.Tensor, taps: torch.Tensor,
                  axis: int = -1) -> torch.Tensor:
    """K5s: see `dwt_synthesis_plain`.  ca, cd f32 contiguous, one shape,
    (..., m) for axis=-1 or (..., m, w) for axis=-2; taps (2, L) f32 on
    their device.  Returns y, (..., 2m) or (..., 2m, w)."""
    name = "dwt_synthesis"
    m = _check_synthesis(ca, cd, taps, axis)
    if not _on_cuda(name, ca, cd, taps):
        return dwt_synthesis_plain(ca, cd, taps, axis)
    L = taps.shape[1]
    inner = 1 if axis == -1 else ca.shape[-1]
    batch = ca.numel() // (m * inner)
    out_shape = list(ca.shape)
    out_shape[axis] = 2 * m
    y = torch.empty(out_shape, dtype=torch.float32, device=ca.device)
    if ca.numel():
        from ._build import load_library

        # the columns form copies 16 bytes at a time
        ca, cd = (t.clone() if t.data_ptr() % 16 else t for t in (ca, cd))
        _launch(name, ca.device, load_library().ipp_dwt_synthesis,
                ca.data_ptr(), cd.data_ptr(), taps.data_ptr(), y.data_ptr(),
                batch, m, inner, L, counts=LAUNCHES)
    return y
