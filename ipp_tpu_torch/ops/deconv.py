"""Richardson-Lucy deconvolution on PyTorch (port of ipp_tpu/ops/deconv.py
lines 72-705: gauss3d, gauss3d_batched, make_taper, edge_taper_3d, pad_to_shape, unpad,
fft_shape_for, _tikhonov_kernel, _conv3d_zero, _make_otf, _make_convolver,
_rl_fft_iterations, richardson_lucy, richardson_lucy_batched,
richardson_lucy_wiener, richardson_lucy_spatial,
richardson_lucy_sharded_z).

The RL loop runs eagerly as a Python loop (the reference's
lax.while_loop); early stop reads the relative norm change on the host,
one scalar per block and iteration.  A batch of blocks (B, D, H, W) runs
the same loop; with early stop each block freezes once it has converged
and the loop ends when all have (the reference's vmapped while_loop).
Each convolution takes one of three routes, chosen by the FFT work shape
before anything launches, by one rule on every device (`conv_route`):

- "walk": the v2 kernel walk of ops/matmul_fft.py, for shapes inside its
  kernel domain (the reference's MXU v2 walk);
- "fft": torch.fft at 2,3,5,7-smooth sizes, the same math as the
  reference's XLA branch (deconv.py:286-302), for every other shape: the
  reference's rule off the TPU (deconv.py:43-55);
- "walk1": the v1 kernel walk (what the reference's MXU branch runs on
  its accelerator outside the v2 domain), only when a caller forces it.

On CPU tensors the walks run the kernels' plain PyTorch versions.
"""

from __future__ import annotations

import logging
import math
from functools import lru_cache
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..parallel.mesh import Sharded
from ..utils.device import resolve_device
from .fftutil import next_fast_len
from .matmul_fft import MatmulFFT3, in_kernel_domain, plan_shape

__all__ = ["gauss3d", "gauss3d_batched", "make_taper", "edge_taper_3d", "pad_to_shape",
           "unpad", "fft_shape_for", "conv_route", "richardson_lucy",
           "richardson_lucy_batched", "richardson_lucy_sharded_z",
           "richardson_lucy_wiener", "richardson_lucy_spatial"]

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
    """Separable 3D gaussian over the last three axes, replicate boundary
    (reference gauss3d_gpu.cu; MATLAB-compatible kernel size); leading
    axes are a batch (the reference's gauss3d_batched)."""
    if np.isscalar(sigma):
        sigma = (float(sigma),) * 3
    out = vol
    for ax, s in enumerate(sigma):
        if s > 0:
            out = _conv1d_axis(out, _gauss_kernel(s), ax - 3)
    return out


def gauss3d_batched(vols: torch.Tensor, sigma) -> torch.Tensor:
    """`gauss3d` over a (B, D, H, W) batch, each block filtered on its own
    (the reference's public name; `gauss3d` itself takes leading axes)."""
    if vols.dim() != 4:
        raise ValueError(f"expected a (B, D, H, W) batch, got shape "
                         f"{tuple(vols.shape)}")
    return gauss3d(vols, sigma)


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


_ROUTES = {"walk": "v2 kernel walk", "walk1": "v1 kernel walk",
           "fft": "torch.fft"}


def conv_route(fft_shape: Sequence[int], device: torch.device,
               route: Optional[str] = None) -> str:
    """"walk" for work shapes in the v2 kernel domain, "fft" for any other,
    on every device.  `route` forces one: "walk" raises for a shape outside
    the domain, "walk1" and "fft" take any shape.  Logged once per (shape,
    device, route)."""
    shape = tuple(int(s) for s in fft_shape)
    device_type = torch.device(device).type
    if route is None:
        route = "walk" if in_kernel_domain(shape) else "fft"
    if route not in _ROUTES:
        raise ValueError(f"unknown convolution route {route!r}")
    if route == "walk" and not in_kernel_domain(shape):
        raise ValueError(f"work shape {shape} is outside the kernel domain")
    _log_route(shape, device_type, route)
    return route


@lru_cache(maxsize=256)
def _log_route(shape, device_type: str, route: str) -> None:
    _log.info("FFT work shape %s on %s: %s route", shape, device_type,
              _ROUTES[route])


def _fft_conv_same(vol: torch.Tensor, kern: torch.Tensor,
                   route: Optional[str] = None) -> torch.Tensor:
    """'same' conv via FFT with edge-replicate padding by kernel half-size;
    routed like the RL convolutions (the v2 walk on a multiple-of-8 shape
    inside its domain, as the reference's MXU branch, deconv.py:219-229;
    torch.fft outside it), or by `route` (see `conv_route`)."""
    hz, hy, hx = (k // 2 for k in kern.shape)
    vp = F.pad(vol[None, None], (hx, hx, hy, hy, hz, hz),
               mode="replicate")[0, 0]
    shape8 = tuple(-(-(s + k - 1) // 8) * 8
                   for s, k in zip(vp.shape, kern.shape))
    if conv_route(shape8, vol.device, route) != "fft":
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


def edge_taper_3d(vol: torch.Tensor, psf: torch.Tensor,
                  face_slabs: bool = True,
                  route: Optional[str] = None) -> torch.Tensor:
    """bll = mask*bl + (1-mask)*blur(bl) with separable ramps of width
    max(8, psf_dim/2) per axis (reference edgetaper_3d.m:1-46).  The blur
    is needed only within taper_width of a face, so it runs on the six
    face slabs (each extended by the PSF support); face_slabs=False blurs
    the full volume, as the reference's batched RL does.  `route` forces
    the blurs' convolution route; by default each blur's work shape and
    the device decide (`conv_route`)."""
    psf = psf / psf.sum()
    tws = [min(max(8, int(round(psf.shape[d] / 2))), vol.shape[d] // 2)
           for d in range(3)]
    mask = torch.ones((), dtype=vol.dtype, device=vol.device)
    for d in range(3):
        shape = [1, 1, 1]
        shape[d] = vol.shape[d]
        taper = torch.from_numpy(make_taper(vol.shape[d], tws[d]))
        mask = mask * taper.to(vol.device).reshape(shape)
    if (not face_slabs
            or any(tw + k > s for tw, k, s in zip(tws, psf.shape, vol.shape))):
        # asked for, or a slab would not fit: blur the full volume
        blur = _fft_conv_same(vol, psf, route)
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
            blur = _fft_conv_same(vol[tuple(sl_read)].contiguous(), psf,
                                  route)
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


def fft_shape_for(shape: Sequence[int], psf_shape: Sequence[int], device,
                  route: Optional[str] = None) -> Tuple[int, int, int]:
    """FFT work shape: block + PSF half-extents, rounded up for the route
    that takes it (the reference's rule per backend, deconv.py:240-251):
    2,3,5,7-smooth sizes for torch.fft, by default on every device (the
    reference's non-TPU rule) and with "fft" forced; `plan_shape`
    (multiples of 8, or of 128 within 5%) with a walk forced.  The CLI
    passes its overlap-save shape explicitly.  `device` is kept for the
    callers; the rule does not depend on it."""
    if route is not None and route != "fft":
        return plan_shape(shape, psf_shape)
    return tuple(next_fast_len(int(s) + int(p) // 2 * 2)
                 for s, p in zip(shape, psf_shape))


def pad_to_shape(vol: torch.Tensor, target: Sequence[int]):
    """Centre zero-pad the last len(target) axes to target (reference
    pad_block_to_fft_shape, decon.m:323-345); leading axes are a batch.
    Returns (padded, pad_pre, pad_post)."""
    missing = [int(t) - s
               for t, s in zip(target, vol.shape[vol.dim() - len(target):])]
    if any(m < 0 for m in missing):
        raise ValueError(f"cannot pad {tuple(vol.shape)} to "
                         f"{tuple(target)}")
    pre = [m // 2 for m in missing]
    post = [m - p for m, p in zip(missing, pre)]
    pads = []
    for p, q in zip(reversed(pre), reversed(post)):
        pads += [p, q]
    return F.pad(vol, pads), tuple(pre), tuple(post)


def unpad(vol: torch.Tensor, pre: Sequence[int], post: Sequence[int]):
    """Undo `pad_to_shape` on the last len(pre) axes."""
    tail = vol.shape[vol.dim() - len(pre):]
    return vol[(Ellipsis,) + tuple(slice(p, s - q)
                                   for p, q, s in zip(pre, post, tail))]


def _tikhonov_kernel() -> np.ndarray:
    """3x3x3 mean kernel with zero center (reference decon.m:44-46)."""
    R = np.full((3, 3, 3), 1.0 / 26.0, np.float32)
    R[1, 1, 1] = 0.0
    return R


def _conv3d_zero(vol: torch.Tensor, kern: torch.Tensor) -> torch.Tensor:
    """3D 'same' convolution with zero boundary (MATLAB convn 'same') over
    the last three axes, each leading index a block; TF32 is off by the
    package's precision policy."""
    kd, kh, kw = kern.shape
    vp = F.pad(vol.reshape((-1, 1) + tuple(vol.shape[-3:])),
               (kw // 2, kw - 1 - kw // 2, kh // 2, kh - 1 - kh // 2,
                kd // 2, kd - 1 - kd // 2))
    w = torch.flip(kern, dims=(0, 1, 2))[None, None].to(vol.dtype)
    return F.conv3d(vp, w).reshape(vol.shape)


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
    the walk route.  Inputs may carry leading batch dims; both routes
    transform the last three axes only and share one block's OTF."""
    fft_shape = tuple(int(s) for s in fft_shape)
    if conv_route(fft_shape, psf.device, route) != "fft":
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
    dims = (-3, -2, -1)

    def conv(x):
        return torch.fft.irfftn(torch.fft.rfftn(x, dim=dims) * otf,
                                s=fft_shape, dim=dims)

    def conv_conj_ratio(num, den):
        ratio = num / torch.clamp(den, min=_EPS)
        return torch.fft.irfftn(torch.fft.rfftn(ratio, dim=dims) * otf_c,
                                s=fft_shape, dim=dims)

    def update(bl, num, den):
        return torch.abs(bl * conv_conj_ratio(num, den))

    return conv, conv_conj_ratio, update


def _block_norms(bl: torch.Tensor) -> torch.Tensor:
    """The L2 norm of a (D, H, W) block, or of each block of a (B, D, H, W)
    batch, each reduced on its own: a block's norm, and so its early-stop
    decision, does not depend on the batch it runs in."""
    if bl.dim() == 3:
        return torch.linalg.vector_norm(bl)[None]
    return torch.stack([torch.linalg.vector_norm(b) for b in bl])


def _rl_fft_iterations(bl, psf, *, niter, fft_shape, lam, stop_criterion,
                       regularize_interval, classic, route=None):
    """The deconFFT loop (decon.m:127-204) on a (D, H, W) block or a
    (B, D, H, W) batch; returns (estimate, iterations run): an int for a
    block, a list of one count per block for a batch.  classic=False is
    the reference's scheme (the ratio numerator is the current estimate,
    decon.m:169); classic=True keeps the observed volume as numerator
    (textbook RL).  Early stop: after iteration i > 1, a block stops once
    its relative L2-norm change is <= stop_criterion percent; in a batch
    it then keeps its estimate while the others go on, and the loop ends
    when every block has stopped (the reference's vmapped while_loop)."""
    conv, conv_conj_ratio, update = _make_convolver(psf, fft_shape, route)
    R = torch.from_numpy(_tikhonov_kernel()).to(bl.device)
    apply_reg = 0 < regularize_interval < niter
    y_obs = bl
    active = [True] * (bl.shape[0] if bl.dim() == 4 else 1)
    iters = [0] * len(active)
    delta_prev = _block_norms(bl) if stop_criterion > 0 else None
    i = 1
    while i <= niter and any(active):
        prev = bl
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
        if not all(active):  # stopped blocks keep their estimate
            keep = torch.tensor(active, device=bl.device).view(-1, 1, 1, 1)
            bl = torch.where(keep, bl, prev)
        iters = [i if a else k for a, k in zip(active, iters)]
        i += 1
        if stop_criterion > 0:
            delta_cur = _block_norms(bl)
            rel = (torch.abs(delta_prev - delta_cur)
                   / torch.clamp(delta_prev, min=_EPS) * 100.0).tolist()
            delta_prev = delta_cur
            if i > 2:
                active = [a and not r <= stop_criterion
                          for a, r in zip(active, rel)]
    return bl, (iters if bl.dim() == 4 else iters[0])


def _inputs(vol, psf, device):
    """vol and the unit-sum psf as f32 tensors on `device`, else on vol's
    device when vol is a tensor, else on the package's resolved device."""
    if device is None and isinstance(vol, torch.Tensor):
        device = vol.device
    dev = resolve_device(device)
    psf = _as_f32(psf, dev)
    return _as_f32(vol, dev), psf / psf.sum()


def _taper_route(route: Optional[str]) -> Optional[str]:
    """The taper blurs' route under an RL route: a forced "fft" or "walk1"
    holds for them too; "walk" names the v2 domain, which their slab
    shapes seldom fit, so they keep the default route."""
    return None if route == "walk" else route


def richardson_lucy(vol, psf, niter: int = 10, lam: float = 0.0,
                    stop_criterion: float = 0.0, regularize_interval: int = 0,
                    fft_shape: Optional[Tuple[int, int, int]] = None,
                    edge_taper: bool = True, classic: bool = True,
                    device=None, route: Optional[str] = None) -> torch.Tensor:
    """FFT-domain Richardson-Lucy deconvolution of a (D, H, W) block
    (reference decon.m deconFFT path).

    vol/psf are (z, y, x) arrays or tensors; the work runs on `device`,
    else on vol's device when vol is a tensor, else on the package's
    resolved device.  `route` forces the convolution route ("walk",
    "walk1" or "fft"); by default the work shape decides."""
    vol, psf = _inputs(vol, psf, device)
    if fft_shape is None:
        fft_shape = fft_shape_for(vol.shape, psf.shape, vol.device, route)
    if edge_taper:
        vol = edge_taper_3d(vol, psf, route=_taper_route(route))
    vol, pre, post = pad_to_shape(vol, fft_shape)
    out, _ = _rl_fft_iterations(
        vol.contiguous(), psf, niter=int(niter),
        fft_shape=tuple(int(s) for s in fft_shape), lam=float(lam),
        stop_criterion=float(stop_criterion),
        regularize_interval=int(regularize_interval), classic=bool(classic),
        route=route)
    return unpad(out, pre, post)


def richardson_lucy_batched(vols, psf, niter: int = 10, lam: float = 0.0,
                            regularize_interval: int = 0,
                            fft_shape: Optional[Tuple[int, int, int]] = None,
                            edge_taper: bool = True, sharding=None,
                            classic: bool = True, stop_criterion: float = 0.0,
                            device=None, route: Optional[str] = None):
    """Richardson-Lucy over a batch of equal-shape blocks (B, D, H, W)
    (reference richardson_lucy_batched, deconv.py:482-552): one walk over
    the whole batch, through the batched kernel forms on the walk route,
    with one OTF for every block.  Each block's edge taper blurs its full
    volume (face_slabs=False).  stop_criterion > 0 stops each block at
    its own iteration (see `_rl_fft_iterations`).

    `sharding` (a `parallel.mesh.Placement` splitting the batch over the
    mesh's "data" axis, e.g. `data_sharding(mesh, 4)`) runs each device's
    share of the blocks as one batch on that device, from its own thread
    (the reference's LsDeconv per-GPU block work, LsDeconv.m:644-706).  A
    whole batch comes back gathered on its own device (numpy: the first
    shard's); a `parallel.mesh.Sharded` batch (this process's rows, from
    `distributed.device_put_global`) comes back `Sharded`."""
    if sharding is not None or isinstance(vols, Sharded):
        return _rl_batched_sharded(
            vols, psf, sharding, niter=niter, lam=lam,
            regularize_interval=regularize_interval, fft_shape=fft_shape,
            edge_taper=edge_taper, classic=classic,
            stop_criterion=stop_criterion, route=route)
    vols, psf = _inputs(vols, psf, device)
    if vols.dim() != 4:
        raise ValueError(f"expected a (B, D, H, W) batch, got "
                         f"{tuple(vols.shape)}")
    if fft_shape is None:
        fft_shape = fft_shape_for(vols.shape[1:], psf.shape, vols.device,
                                  route)
    if edge_taper:
        vols = torch.stack([edge_taper_3d(v, psf, face_slabs=False,
                                          route=_taper_route(route))
                            for v in vols])
    vols, pre, post = pad_to_shape(vols, fft_shape)
    out, _ = _rl_fft_iterations(
        vols.contiguous(), psf, niter=int(niter),
        fft_shape=tuple(int(s) for s in fft_shape), lam=float(lam),
        stop_criterion=float(stop_criterion),
        regularize_interval=int(regularize_interval), classic=bool(classic),
        route=route)
    return unpad(out, pre, post)


def _rl_batched_sharded(vols, psf, sharding, **kw):
    """`richardson_lucy_batched` on each shard of a batch split over the
    "data" axis of a mesh, each on its shard's device."""
    from ..parallel.mesh import Placement, gather, map_shards, put

    if not isinstance(vols, Sharded):
        if not isinstance(sharding, Placement):
            raise TypeError(f"sharding must be a parallel.mesh.Placement, "
                            f"got {type(sharding).__name__}")
        if sharding.spec[0] != "data":
            raise ValueError("richardson_lucy_batched splits the batch "
                             "axis over 'data'")
        # a "z" split of the blocks folds away: each device deconvolves
        # whole blocks (intra-block z splitting is richardson_lucy_sharded_z)
        sharding = Placement(sharding.mesh,
                             ("data",) + (None,) * (len(sharding.spec) - 1))
    sh = vols if isinstance(vols, Sharded) else put(vols, sharding)
    psf_np = (psf.detach().cpu().numpy() if isinstance(psf, torch.Tensor)
              else np.asarray(psf, np.float32))
    out = map_shards(lambda v: richardson_lucy_batched(
        v, psf_np, device=v.device, **kw), sh)
    if isinstance(vols, Sharded):
        return out
    return gather(out, vols.device if isinstance(vols, torch.Tensor)
                  else None)


def richardson_lucy_sharded_z(vol, psf, mesh, niter: int = 10,
                              halo: Optional[int] = None,
                              axis_name: str = "z", classic: bool = True):
    """Sequence-parallel RL (reference richardson_lucy_sharded_z,
    deconv.py:668-705): the volume's z axis splits over the mesh's "z"
    entries, each slab, extended by exchanged real-data halos
    (`parallel.halo`), is deconvolved on its own device as a batch of one
    (`richardson_lucy_batched`, edge-tapered, at the extended slab's work
    shape), and the halos are discarded (overlap-discard: the reference's
    block decomposition with real z padding, LsDeconv.m:173-174).

    vol: (Z, H, W) with Z divisible by the mesh's z size, whole (numpy or
    a tensor: the result is gathered on its device) or a
    `parallel.mesh.Sharded` of this process's slabs (the result is
    `Sharded`).  No early stop, as the reference."""
    from ..parallel.halo import sharded_map_blocks_z

    psf_np = (psf.detach().cpu().numpy() if isinstance(psf, torch.Tensor)
              else np.asarray(psf, np.float32)).astype(np.float32)
    psf_np = psf_np / psf_np.sum()
    if halo is None:
        halo = max(1, psf_np.shape[0] // 2)
    n_sh = mesh.shape[axis_name]
    local_z = vol.shape[0] // n_sh + 2 * halo
    fft_shape = fft_shape_for((local_z,) + tuple(vol.shape[1:]),
                              psf_np.shape, None)

    def local_rl(block_ext):
        return richardson_lucy_batched(block_ext[None], psf_np, niter=niter,
                                       fft_shape=fft_shape, edge_taper=True,
                                       classic=classic,
                                       device=block_ext.device)[0]

    return sharded_map_blocks_z(local_rl, mesh, halo, axis_name)(vol)


def richardson_lucy_wiener(vol, psf, niter: int = 10, lam: float = 0.0,
                           regularize_interval: int = 0,
                           fft_shape: Optional[Tuple[int, int, int]] = None,
                           edge_taper: bool = True, device=None):
    """Blind RL with a Wiener PSF refinement after every update
    (reference richardson_lucy_wiener, deconv.py:555-635, itself
    deconFFT_Wiener, decon.m:206-321, with its two repairs: the observed
    spectrum stays the model's target, and the PSF is cropped after an
    fftshift).  Complex FFTs over the three axes (torch.fft, cuFFT on the
    card):
        otf_new = F{obs} . conj(F{cur}) / max(|F{cur}|^2, eps),
    cropped to the PSF extent, clamped non-negative, renormalised, and
    blended 0.7 old + 0.3 new.  Returns (deconvolved, refined psf)."""
    vol, psf = _inputs(vol, psf, device)
    if fft_shape is None:
        fft_shape = fft_shape_for(vol.shape, psf.shape, vol.device, "fft")
    fft_shape = tuple(int(s) for s in fft_shape)
    if edge_taper:
        vol = edge_taper_3d(vol, psf)
    bl, pre, post = pad_to_shape(vol, fft_shape)
    R = torch.from_numpy(_tikhonov_kernel()).to(bl.device)
    psf_shape = tuple(psf.shape)
    center = tuple((f - p) // 2 for f, p in zip(fft_shape, psf_shape))
    crop = tuple(slice(c, c + s) for c, s in zip(center, psf_shape))

    f_obs = torch.fft.fftn(bl)
    f_prev = f_obs
    for i in range(1, int(niter) + 1):
        is_reg = (0 < regularize_interval < niter and i > 1
                  and i % regularize_interval == 0)
        if is_reg:
            bl = gauss3d(bl, 0.5)
            f_prev = torch.fft.fftn(bl)
        otf = torch.fft.fftn(_rolled_psf(psf, fft_shape))
        buf = torch.clamp(torch.fft.ifftn(f_prev * otf).real, min=_EPS)
        buf = torch.fft.ifftn(torch.fft.fftn(bl / buf)
                              * torch.conj_physical(otf)).real
        if is_reg and lam > 0 and i < niter:
            bl = bl * buf * (1.0 - lam) + _conv3d_zero(bl, R) * lam
        else:
            bl = bl * buf
        bl = torch.abs(bl)
        if i < niter:
            f_cur = torch.fft.fftn(bl)
            denom = torch.clamp((f_cur * torch.conj_physical(f_cur)).real,
                                min=_EPS)
            otf_new = f_obs * torch.conj_physical(f_cur) / denom
            psf_full = torch.fft.fftshift(torch.fft.ifftn(otf_new).real)
            new_psf = torch.clamp(psf_full[crop], min=0.0)
            total = new_psf.sum()
            new_psf = torch.where(total > 0,
                                  new_psf / torch.clamp(total, min=_EPS), psf)
            psf = 0.7 * psf + 0.3 * new_psf
            psf = psf / torch.clamp(psf.sum(), min=_EPS)
            f_prev = f_cur
    return unpad(bl, pre, post), psf


def richardson_lucy_spatial(vol, psf, niter: int = 10, lam: float = 0.0,
                            regularize_interval: int = 0, device=None
                            ) -> torch.Tensor:
    """Spatial-domain RL (reference richardson_lucy_spatial,
    deconv.py:638-665; deconSpatial, decon.m:26-125): direct zero-boundary
    3D convolutions with the PSF and its flip (cuDNN in full f32 on the
    card, TF32 off).  Practical for small PSFs."""
    vol, psf = _inputs(vol, psf, device)
    psf_inv = torch.flip(psf, dims=(0, 1, 2))
    R = torch.from_numpy(_tikhonov_kernel()).to(vol.device)
    bl = edge_taper_3d(vol, psf)
    for i in range(1, int(niter) + 1):
        is_reg = (0 < regularize_interval < niter and 1 < i < niter
                  and i % regularize_interval == 0)
        if is_reg:
            bl = gauss3d(bl, 0.5)
        buf = bl / torch.clamp(_conv3d_zero(bl, psf), min=_EPS)
        buf = _conv3d_zero(buf, psf_inv)
        if is_reg and lam > 0:
            bl = bl * buf * (1.0 - lam) + _conv3d_zero(bl, R) * lam
        else:
            bl = bl * buf
        bl = torch.abs(bl)
    return bl
