"""Richardson-Lucy deconvolution on PyTorch (port of ipp_tpu/ops/deconv.py
lines 72-480: gauss3d, make_taper, edge_taper_3d, pad_to_shape, unpad,
fft_shape_for, _tikhonov_kernel, _conv3d_zero, _make_otf, _make_convolver,
_rl_fft_iterations, richardson_lucy).

The RL loop runs eagerly as a Python loop (the reference's
lax.while_loop); early stop reads the relative norm change on the host,
one scalar per iteration.  Each convolution takes one of two routes, chosen
by the FFT work shape alone before anything launches:

- "walk": the hand-written CUDA kernel walk of ops/matmul_fft.py, for
  shapes inside its kernel domain (the reference's MXU v2 walk);
- "fft": torch.fft, the same math as the reference's XLA branch
  (deconv.py:286-302), for every other shape.

On CPU tensors the walk runs the kernels' plain PyTorch versions.
"""

from __future__ import annotations

import logging
import math
from functools import lru_cache
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.device import resolve_device
from .fftutil import next_fast_len
from .matmul_fft import MatmulFFT3, in_kernel_domain

__all__ = ["gauss3d", "make_taper", "edge_taper_3d", "pad_to_shape",
           "unpad", "fft_shape_for", "conv_route", "richardson_lucy"]

_EPS = float(np.finfo(np.float32).eps)
_log = logging.getLogger(__name__)


def _as_f32(a, device: torch.device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=torch.float32)
    return torch.from_numpy(np.array(a, np.float32)).to(device)


def _gauss_kernel(sigma: float) -> np.ndarray:
    """imgaussfilt3-compatible taps: size 2*ceil(2*sigma)+1."""
    radius = int(math.ceil(2.0 * sigma))
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def _conv1d_axis(vol: torch.Tensor, taps: np.ndarray, axis: int
                 ) -> torch.Tensor:
    """'same' 1D convolution along `axis` with replicate padding, as a sum
    of shifted slices (exact f32 products; no TF32 path can touch it)."""
    radius = len(taps) // 2
    x = vol.movedim(axis, -1)
    n = x.shape[-1]
    edge = x.shape[:-1] + (radius,)
    xp = torch.cat([x[..., :1].expand(edge), x, x[..., -1:].expand(edge)],
                   -1)
    out = None
    for i in range(len(taps)):
        term = xp[..., i:i + n] * float(taps[len(taps) - 1 - i])
        out = term if out is None else out + term
    return out.movedim(-1, axis).contiguous()


def gauss3d(vol: torch.Tensor, sigma) -> torch.Tensor:
    """Separable 3D gaussian, replicate boundary (reference gauss3d_gpu.cu;
    MATLAB-compatible kernel size)."""
    if np.isscalar(sigma):
        sigma = (float(sigma),) * 3
    out = vol
    for ax, s in enumerate(sigma):
        if s > 0:
            out = _conv1d_axis(out, _gauss_kernel(s), ax)
    return out


def make_taper(dimsz: int, taper_width: int) -> np.ndarray:
    """1D edge taper: 0->1 ramp, plateau, 1->0 ramp
    (reference make_taper.m:1-36)."""
    taper_width = int(min(taper_width, dimsz // 2))
    if taper_width <= 0:
        return np.ones(dimsz, np.float32)
    ramp = np.linspace(0.0, 1.0, taper_width + 1)
    if 2 * taper_width < dimsz:
        plateau = np.ones(dimsz - 2 * taper_width)
        taper = np.concatenate([ramp, plateau, ramp[:-1][::-1]])
    else:
        taper = np.concatenate([ramp, ramp[:-1][::-1]])
    taper = taper.astype(np.float32)
    if len(taper) > dimsz:
        taper = taper[:dimsz]
    elif len(taper) < dimsz:
        taper = np.concatenate([taper, np.ones(dimsz - len(taper), np.float32)])
    return taper


def conv_route(fft_shape: Sequence[int], device: torch.device,
               route: Optional[str] = None) -> str:
    """"walk" for work shapes in the kernel domain, else "fft"; `route`
    forces one ("walk" raises for a shape outside the domain).  Logged
    once per (shape, device, route)."""
    shape = tuple(int(s) for s in fft_shape)
    if route is None:
        route = "walk" if in_kernel_domain(shape) else "fft"
    if route not in ("walk", "fft"):
        raise ValueError(f"unknown convolution route {route!r}")
    if route == "walk" and not in_kernel_domain(shape):
        raise ValueError(f"work shape {shape} is outside the kernel domain")
    _log_route(shape, torch.device(device).type, route)
    return route


@lru_cache(maxsize=256)
def _log_route(shape, device_type: str, route: str) -> None:
    _log.info("FFT work shape %s on %s: %s route", shape, device_type,
              "kernel walk" if route == "walk" else "torch.fft")


def _fft_conv_same(vol: torch.Tensor, kern: torch.Tensor) -> torch.Tensor:
    """'same' conv via FFT with edge-replicate padding by kernel half-size;
    routed like the RL convolutions (walk on kernel-domain shapes)."""
    hz, hy, hx = (k // 2 for k in kern.shape)
    vp = F.pad(vol[None, None], (hx, hx, hy, hy, hz, hz),
               mode="replicate")[0, 0]
    shape8 = tuple(-(-(s + k - 1) // 8) * 8
                   for s, k in zip(vp.shape, kern.shape))
    if conv_route(shape8, vol.device) == "walk":
        plan = MatmulFFT3(shape8, vol.device)
        kpad = vol.new_zeros(shape8)
        kpad[tuple(slice(0, k) for k in kern.shape)] = kern
        vpad = vol.new_zeros(shape8)
        vpad[tuple(slice(0, s) for s in vp.shape)] = vp
        full = plan.convolve(vpad, plan.otf_packed(kpad))
    else:
        shape = tuple(next_fast_len(s + k - 1)
                      for s, k in zip(vp.shape, kern.shape))
        full = torch.fft.irfftn(torch.fft.rfftn(vp, s=shape)
                                * torch.fft.rfftn(kern, s=shape), s=shape)
    sl = tuple(slice(2 * h, 2 * h + s)
               for h, s in zip((hz, hy, hx), vol.shape))
    return full[sl]


def edge_taper_3d(vol: torch.Tensor, psf: torch.Tensor) -> torch.Tensor:
    """bll = mask*bl + (1-mask)*blur(bl) with separable ramps of width
    max(8, psf_dim/2) per axis (reference edgetaper_3d.m:1-46).  The blur
    is needed only within taper_width of a face, so it runs on the six
    face slabs (each extended by the PSF support)."""
    psf = psf / psf.sum()
    tws = [min(max(8, int(round(psf.shape[d] / 2))), vol.shape[d] // 2)
           for d in range(3)]
    mask = torch.ones((), dtype=vol.dtype, device=vol.device)
    for d in range(3):
        shape = [1, 1, 1]
        shape[d] = vol.shape[d]
        taper = torch.from_numpy(make_taper(vol.shape[d], tws[d]))
        mask = mask * taper.to(vol.device).reshape(shape)
    if any(tw + k > s for tw, k, s in zip(tws, psf.shape, vol.shape)):
        # a slab would not fit: blur the full volume
        blur = _fft_conv_same(vol, psf)
        return mask * vol + (1.0 - mask) * blur
    out = mask * vol
    inv = 1.0 - mask
    for d in range(3):
        k = psf.shape[d]
        tw = tws[d]
        ext = tw + k  # slab depth incl. conv support
        for side in (0, 1):
            sl_read = [slice(None)] * 3
            sl_read[d] = (slice(0, ext) if side == 0
                          else slice(vol.shape[d] - ext, vol.shape[d]))
            blur = _fft_conv_same(vol[tuple(sl_read)].contiguous(), psf)
            sl_keep = [slice(None)] * 3
            sl_keep[d] = slice(0, tw) if side == 0 else slice(ext - tw, ext)
            sl_write = [slice(None)] * 3
            sl_write[d] = (slice(0, tw) if side == 0
                           else slice(vol.shape[d] - tw, vol.shape[d]))
            contrib = inv[tuple(sl_write)] * blur[tuple(sl_keep)]
            # corners/edges shared with slabs of earlier axes were added
            # there already: zero their contribution here
            for dd in range(d):
                sl_lo = [slice(None)] * 3
                sl_lo[dd] = slice(0, tws[dd])
                sl_hi = [slice(None)] * 3
                sl_hi[dd] = slice(contrib.shape[dd] - tws[dd], None)
                contrib[tuple(sl_lo)] = 0.0
                contrib[tuple(sl_hi)] = 0.0
            out[tuple(sl_write)] += contrib
    return out


def fft_shape_for(shape: Sequence[int], psf_shape: Sequence[int]
                  ) -> Tuple[int, int, int]:
    """FFT work shape: block + PSF half-extents, rounded up to
    2,3,5,7-smooth sizes (the reference's XLA-backend rule; the CLI passes
    its overlap-save shape explicitly)."""
    return tuple(next_fast_len(int(s) + int(p) // 2 * 2)
                 for s, p in zip(shape, psf_shape))


def pad_to_shape(vol: torch.Tensor, target: Sequence[int]):
    """Centre zero-pad to target (reference pad_block_to_fft_shape,
    decon.m:323-345).  Returns (padded, pad_pre, pad_post)."""
    missing = [int(t) - s for t, s in zip(target, vol.shape)]
    if any(m < 0 for m in missing):
        raise ValueError(f"cannot pad {tuple(vol.shape)} to {tuple(target)}")
    pre = [m // 2 for m in missing]
    post = [m - p for m, p in zip(missing, pre)]
    pads = []
    for p, q in zip(reversed(pre), reversed(post)):
        pads += [p, q]
    return F.pad(vol, pads), tuple(pre), tuple(post)


def unpad(vol: torch.Tensor, pre: Sequence[int], post: Sequence[int]):
    sl = tuple(slice(p, s - q) for p, q, s in zip(pre, post, vol.shape))
    return vol[sl]


def _tikhonov_kernel() -> np.ndarray:
    """3x3x3 mean kernel with zero center (reference decon.m:44-46)."""
    R = np.full((3, 3, 3), 1.0 / 26.0, np.float32)
    R[1, 1, 1] = 0.0
    return R


def _conv3d_zero(vol: torch.Tensor, kern: torch.Tensor) -> torch.Tensor:
    """3D 'same' convolution with zero boundary (MATLAB convn 'same');
    TF32 is off by the package's precision policy."""
    kd, kh, kw = kern.shape
    vp = F.pad(vol[None, None], (kw // 2, kw - 1 - kw // 2,
                                 kh // 2, kh - 1 - kh // 2,
                                 kd // 2, kd - 1 - kd // 2))
    w = torch.flip(kern, dims=(0, 1, 2))[None, None].to(vol.dtype)
    return F.conv3d(vp, w)[0, 0]


def _rolled_psf(psf: torch.Tensor, fft_shape) -> torch.Tensor:
    """The PSF zero-padded to fft_shape with its centre voxel rolled
    exactly to index 0 (reference _make_otf, deconv.py:328-337)."""
    otf_pad, pre, _ = pad_to_shape(psf, fft_shape)
    center = tuple(p + s // 2 for p, s in zip(pre, psf.shape))
    return torch.roll(otf_pad, tuple(-c for c in center), dims=(0, 1, 2))


def _make_otf(psf: torch.Tensor, fft_shape) -> torch.Tensor:
    """rFFT of the PSF centred at the origin (torch.fft route's OTF)."""
    return torch.fft.rfftn(_rolled_psf(psf, fft_shape))


def _make_convolver(psf: torch.Tensor, fft_shape, route: Optional[str] = None):
    """(conv, conv_conj_ratio, update): `conv(x)` is the circular PSF
    convolution; `conv_conj_ratio(num, den)` the adjoint convolution of
    num / max(den, eps) (decon.m:169); `update(bl, num, den)` the full RL
    step |bl * conv^T(ratio)| (decon.m:169-171), fused into the kernels on
    the walk route."""
    fft_shape = tuple(int(s) for s in fft_shape)
    if conv_route(fft_shape, psf.device, route) == "walk":
        plan = MatmulFFT3(fft_shape, psf.device)
        otf = plan.otf_packed(_rolled_psf(psf, fft_shape))

        def conv(x):
            return plan.convolve(x, otf)

        def conv_conj_ratio(num, den):
            return plan.convolve(den, otf, conj=True, ratio_num=num)

        def update(bl, num, den):
            return plan.convolve(den, otf, conj=True, ratio_num=num,
                                 mul_abs=bl)

        return conv, conv_conj_ratio, update
    otf = _make_otf(psf, fft_shape)
    otf_c = torch.conj_physical(otf)

    def conv(x):
        return torch.fft.irfftn(torch.fft.rfftn(x) * otf, s=fft_shape)

    def conv_conj_ratio(num, den):
        ratio = num / torch.clamp(den, min=_EPS)
        return torch.fft.irfftn(torch.fft.rfftn(ratio) * otf_c, s=fft_shape)

    def update(bl, num, den):
        return torch.abs(bl * conv_conj_ratio(num, den))

    return conv, conv_conj_ratio, update


def _rl_fft_iterations(bl, psf, *, niter, fft_shape, lam, stop_criterion,
                       regularize_interval, classic, route=None):
    """The deconFFT loop (decon.m:127-204); returns (estimate, iterations
    run).  classic=False is the reference's scheme (the ratio numerator
    is the current estimate, decon.m:169); classic=True keeps the observed
    volume as numerator (textbook RL).  Early stop: after iteration i > 1,
    stop once the relative L2-norm change is <= stop_criterion percent."""
    conv, conv_conj_ratio, update = _make_convolver(psf, fft_shape, route)
    R = torch.from_numpy(_tikhonov_kernel()).to(bl.device)
    apply_reg = 0 < regularize_interval < niter
    y_obs = bl
    delta_prev = torch.linalg.vector_norm(bl) if stop_criterion > 0 else None
    i = 1
    while i <= niter:
        if not apply_reg:  # common path: one fully fused RL step
            num_src = y_obs if classic else bl
            bl = update(bl, num_src, conv(bl))
        else:
            is_reg = 1 < i < niter and i % regularize_interval == 0
            if is_reg:
                bl = gauss3d(bl, 0.5)
            # the ratio numerator sees the POST-smoothing estimate
            # (decon.m:160-169)
            num_src = y_obs if classic else bl
            buf = conv_conj_ratio(num_src, conv(bl))
            if is_reg and lam > 0:
                bl = bl * buf * (1.0 - lam) + _conv3d_zero(bl, R) * lam
            else:
                bl = bl * buf
            bl = torch.abs(bl)
        i += 1
        if stop_criterion > 0:
            delta_cur = torch.linalg.vector_norm(bl)
            rel = (torch.abs(delta_prev - delta_cur)
                   / torch.clamp(delta_prev, min=_EPS) * 100.0)
            delta_prev = delta_cur
            if i > 2 and float(rel) <= stop_criterion:
                break
    return bl, i - 1


def richardson_lucy(vol, psf, niter: int = 10, lam: float = 0.0,
                    stop_criterion: float = 0.0, regularize_interval: int = 0,
                    fft_shape: Optional[Tuple[int, int, int]] = None,
                    edge_taper: bool = True, classic: bool = True,
                    device=None, route: Optional[str] = None) -> torch.Tensor:
    """FFT-domain Richardson-Lucy deconvolution of a (D, H, W) block
    (reference decon.m deconFFT path).

    vol/psf are (z, y, x) arrays or tensors; the work runs on `device`,
    else on vol's device when vol is a tensor, else on the package's
    resolved device.  `route` forces the convolution route ("walk" or
    "fft"); by default the work shape decides."""
    if device is None and isinstance(vol, torch.Tensor):
        device = vol.device
    dev = resolve_device(device)
    vol = _as_f32(vol, dev)
    psf = _as_f32(psf, dev)
    if fft_shape is None:
        fft_shape = fft_shape_for(vol.shape, psf.shape)
    psf = psf / psf.sum()
    if edge_taper:
        vol = edge_taper_3d(vol, psf)
    vol, pre, post = pad_to_shape(vol, fft_shape)
    out, _ = _rl_fft_iterations(
        vol.contiguous(), psf, niter=int(niter),
        fft_shape=tuple(int(s) for s in fft_shape), lam=float(lam),
        stop_criterion=float(stop_criterion),
        regularize_interval=int(regularize_interval), classic=bool(classic),
        route=route)
    return unpad(out, pre, post)
