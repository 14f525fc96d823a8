"""Wrappers of the FFT-walk CUDA kernels, each beside its plain version.

One wrapper per kernel of `csrc/fft_walk.cu`; together they replace the
seven Pallas entry points of the reference's v2-t convolve walk
(ipp_tpu/ops/pallas_fft.py):

| wrapper                | kernel | Pallas entry points replaced               |
|------------------------|--------|--------------------------------------------|
| `rdft_y_fwd`           | K1     | `_v2_rfft_call_t`, `_v2_rfft_ratio_call_t` |
| `rdft_y_inv`           | K2     | `_v2_irfft_call_t`, `_v2_irfft_mul_call_t` |
| `radix2_stage`         | K3     | `_v2_stage_call` (fwd, inv), `fused_stage` |
| `radix2_stage_inv_otf` | K4     | `fused_stage_inv_otf`                      |

Rules every wrapper keeps:
- a CPU tensor goes to the plain PyTorch version (`*_plain`, the same
  function written with `torch.matmul`); a CUDA tensor launches the kernel
  or raises — there is no fallback;
- device, dtype (f32), shape and contiguity are checked before a launch,
  and the C function's cudaGetLastError() is checked after it;
- `LAUNCHES[name]` counts kernel launches (never plain calls), so a run
  can show that its main path went through the kernels.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

__all__ = ["LAUNCHES", "reset_launch_counts", "rdft_y_fwd",
           "rdft_y_fwd_plain", "rdft_y_inv", "rdft_y_inv_plain",
           "radix2_stage", "radix2_stage_plain", "radix2_stage_inv_otf",
           "radix2_stage_inv_otf_plain"]

EPS = float(np.finfo(np.float32).eps)
_GRID_MAX = 65535  # gridDim.y / gridDim.z limit

LAUNCHES: Dict[str, int] = {"rdft_y_fwd": 0, "rdft_y_inv": 0,
                            "radix2_stage": 0, "radix2_stage_inv_otf": 0}

Pair = Tuple[torch.Tensor, torch.Tensor]


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# -- plain versions (CPU path, and the reference on the card) ---------------

def rdft_y_fwd_plain(x: torch.Tensor, fwd: torch.Tensor,
                     den: Optional[torch.Tensor] = None) -> Pair:
    """(nz, ny, nx) -> re, im (kp, nz, nx): the y real DFT against the
    stacked fold fwd (2kp, ny); with `den`, of x / max(den, eps)."""
    if den is not None:
        x = x / torch.clamp(den, min=EPS)
    y = torch.matmul(fwd, x)                      # (nz, 2kp, nx)
    kp = fwd.shape[0] // 2
    return (y[:, :kp].transpose(0, 1).contiguous(),
            y[:, kp:].transpose(0, 1).contiguous())


def rdft_y_inv_plain(re: torch.Tensor, im: torch.Tensor, inv: torch.Tensor,
                     mul: Optional[torch.Tensor] = None) -> torch.Tensor:
    """re, im (kp, nz, nx) -> (nz, ny, nx): the inverse y real DFT through
    the Hermitian fold inv (ny, 2kp); with `mul`, |mul * y|."""
    both = torch.cat([re, im], 0).transpose(0, 1)  # (nz, 2kp, nx)
    y = torch.matmul(inv, both)
    return torch.abs(mul * y) if mul is not None else y


def _cmm(ar, ai, br, bi) -> Pair:
    return ar @ br - ai @ bi, ar @ bi + ai @ br


def radix2_stage_plain(re: torch.Tensor, im: torch.Tensor,
                       mr_t: torch.Tensor, mi_t: torch.Tensor,
                       forward: bool, axis: int) -> Pair:
    """Radix-2 DIF complex DFT stage along the middle axis of (P, n, X)
    (axis=1) or the last axis of (R, n) (axis=-1): the butterfly plus four
    real matmuls per half.  mr_t, mi_t: (2, m, m) stacks of M_s^T."""
    if axis == -1:
        re, im = re.transpose(0, 1), im.transpose(0, 1)   # (n, R) views
    m = re.shape[-2] // 2
    a_r, b_r = re[..., :m, :], re[..., m:, :]
    a_i, b_i = im[..., :m, :], im[..., m:, :]
    if forward:
        v0 = _cmm(mr_t[0], mi_t[0], a_r + b_r, a_i + b_i)
        v1 = _cmm(mr_t[1], mi_t[1], a_r - b_r, a_i - b_i)
        rr = torch.cat([v0[0], v1[0]], -2)
        ii = torch.cat([v0[1], v1[1]], -2)
    else:
        v0 = _cmm(mr_t[0], mi_t[0], a_r, a_i)
        v1 = _cmm(mr_t[1], mi_t[1], b_r, b_i)
        rr = torch.cat([(v0[0] + v1[0]) * 0.5, (v0[0] - v1[0]) * 0.5], -2)
        ii = torch.cat([(v0[1] + v1[1]) * 0.5, (v0[1] - v1[1]) * 0.5], -2)
    if axis == -1:
        rr, ii = rr.transpose(0, 1), ii.transpose(0, 1)
    return rr.contiguous(), ii.contiguous()


def radix2_stage_inv_otf_plain(re: torch.Tensor, im: torch.Tensor,
                               otf_re: torch.Tensor, otf_im: torch.Tensor,
                               mr_t: torch.Tensor, mi_t: torch.Tensor,
                               conj: bool) -> Pair:
    """(re + i*im) * (otf_re +/- i*otf_im), then the inverse stage along
    the last axis of (R, n)."""
    o_i = -otf_im if conj else otf_im
    xr = re * otf_re - im * o_i
    xi = re * o_i + im * otf_re
    return radix2_stage_plain(xr, xi, mr_t, mi_t, False, -1)


# -- launch plumbing ---------------------------------------------------------

def _lib():
    from ._build import load_library

    return load_library()


def _on_cuda(name: str, *tensors: Optional[torch.Tensor]) -> bool:
    """False for CPU tensors (plain path); True for CUDA tensors that the
    kernel takes; raises for anything else."""
    ts = [t for t in tensors if t is not None]
    dev = ts[0].device
    if dev.type == "cpu" and all(t.device.type == "cpu" for t in ts):
        return False
    for t in ts:
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"{name}: all tensors must be on one CUDA "
                             f"device (got {[str(u.device) for u in ts]})")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: float32 only (got {t.dtype})")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
    return True


def _shape(name: str, t: torch.Tensor, shape) -> None:
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")


def _launch(name: str, device: torch.device, fn, *args) -> None:
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed, "
                           f"cudaGetLastError() = {err}")
    LAUNCHES[name] += 1


def _empty(shape, like: torch.Tensor) -> torch.Tensor:
    return torch.empty(shape, dtype=torch.float32, device=like.device)


# -- wrappers ----------------------------------------------------------------

def rdft_y_fwd(x: torch.Tensor, fwd: torch.Tensor,
               den: Optional[torch.Tensor] = None) -> Pair:
    """K1: see `rdft_y_fwd_plain`."""
    name = "rdft_y_fwd"
    if not _on_cuda(name, x, fwd, den):
        return rdft_y_fwd_plain(x, fwd, den)
    nz, ny, nx = x.shape
    kp = fwd.shape[0] // 2
    _shape(name, fwd, (2 * kp, ny))
    if den is not None:
        _shape(name, den, x.shape)
    if nz > _GRID_MAX:
        raise ValueError(f"{name}: nz={nz} exceeds the grid limit")
    re, im = _empty((kp, nz, nx), x), _empty((kp, nz, nx), x)
    _launch(name, x.device, _lib().ipp_rdft_y_fwd, x.data_ptr(),
            den.data_ptr() if den is not None else None, fwd.data_ptr(),
            re.data_ptr(), im.data_ptr(), nz, ny, nx, kp)
    return re, im


def rdft_y_inv(re: torch.Tensor, im: torch.Tensor, inv: torch.Tensor,
               mul: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K2: see `rdft_y_inv_plain`."""
    name = "rdft_y_inv"
    if not _on_cuda(name, re, im, inv, mul):
        return rdft_y_inv_plain(re, im, inv, mul)
    kp, nz, nx = re.shape
    ny = inv.shape[0]
    _shape(name, im, re.shape)
    _shape(name, inv, (ny, 2 * kp))
    if mul is not None:
        _shape(name, mul, (nz, ny, nx))
    if nz > _GRID_MAX:
        raise ValueError(f"{name}: nz={nz} exceeds the grid limit")
    out = _empty((nz, ny, nx), re)
    _launch(name, re.device, _lib().ipp_rdft_y_inv, re.data_ptr(),
            im.data_ptr(), inv.data_ptr(),
            mul.data_ptr() if mul is not None else None, out.data_ptr(),
            nz, ny, nx, kp)
    return out


def _stage_mats_ok(name: str, n: int, mr_t, mi_t) -> None:
    if n % 128:
        raise ValueError(f"{name}: the stage axis must be a multiple of "
                         f"128 (got {n})")
    _shape(name, mr_t, (2, n // 2, n // 2))
    _shape(name, mi_t, (2, n // 2, n // 2))


def radix2_stage(re: torch.Tensor, im: torch.Tensor, mr_t: torch.Tensor,
                 mi_t: torch.Tensor, forward: bool, axis: int) -> Pair:
    """K3: see `radix2_stage_plain`.  axis=1 takes (P, n, X), forward or
    inverse; axis=-1 takes (R, n), forward only (the walk's inverse stage
    over the last axis is K4, with the OTF product)."""
    name = "radix2_stage"
    if axis not in (1, -1) or re.dim() != (3 if axis == 1 else 2):
        raise ValueError(f"{name}: axis=1 needs (P, n, X), axis=-1 (R, n); "
                         f"got axis={axis}, shape {tuple(re.shape)}")
    if axis == -1 and not forward:
        raise ValueError(f"{name}: no inverse stage over the last axis "
                         "(use radix2_stage_inv_otf)")
    if not _on_cuda(name, re, im, mr_t, mi_t):
        return radix2_stage_plain(re, im, mr_t, mi_t, forward, axis)
    _shape(name, im, re.shape)
    if axis == 1:
        batch, n, ncols = re.shape
        bs, ldk, ldc = n * ncols, ncols, 1
    else:
        (ncols, n), batch = re.shape, 1
        bs, ldk, ldc = 0, 1, n
    _stage_mats_ok(name, n, mr_t, mi_t)
    if batch > _GRID_MAX:
        raise ValueError(f"{name}: batch={batch} exceeds the grid limit")
    rr, ii = _empty(re.shape, re), _empty(re.shape, re)
    _launch(name, re.device, _lib().ipp_radix2_stage, re.data_ptr(),
            im.data_ptr(), mr_t.data_ptr(), mi_t.data_ptr(), rr.data_ptr(),
            ii.data_ptr(), int(bool(forward)), batch, n, ncols, bs, ldk, ldc)
    return rr, ii


def radix2_stage_inv_otf(re: torch.Tensor, im: torch.Tensor,
                         otf_re: torch.Tensor, otf_im: torch.Tensor,
                         mr_t: torch.Tensor, mi_t: torch.Tensor,
                         conj: bool) -> Pair:
    """K4: see `radix2_stage_inv_otf_plain`.  All of re, im, otf_re,
    otf_im are (R, n): the unbatched walk's OTF matches the data rows."""
    name = "radix2_stage_inv_otf"
    if re.dim() != 2:
        raise ValueError(f"{name}: expected (R, n), got {tuple(re.shape)}")
    if not _on_cuda(name, re, im, otf_re, otf_im, mr_t, mi_t):
        return radix2_stage_inv_otf_plain(re, im, otf_re, otf_im, mr_t,
                                          mi_t, conj)
    rows, n = re.shape
    for t in (im, otf_re, otf_im):
        _shape(name, t, re.shape)
    _stage_mats_ok(name, n, mr_t, mi_t)
    rr, ii = _empty(re.shape, re), _empty(re.shape, re)
    _launch(name, re.device, _lib().ipp_radix2_stage_inv_otf, re.data_ptr(),
            im.data_ptr(), otf_re.data_ptr(), otf_im.data_ptr(),
            mr_t.data_ptr(), mi_t.data_ptr(), rr.data_ptr(), ii.data_ptr(),
            int(bool(conj)), rows, n)
    return rr, ii
