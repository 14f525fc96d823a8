"""Tile down/up-sampling (port of ipp_tpu/ops/resample.py: block_reduce,
_aa_sigma, _gauss_blur_axis and resize), for the tile chain's
`--down-sample` and `--new-size`.

- block_reduce: skimage semantics (zero padding to a block multiple, then
  reduce each block).
- resize: the reference's order-1 resize — skimage-style gaussian
  anti-aliasing (sigma = (factor - 1) / 2 per downscaled axis, reflect
  padding) followed by `jax.image.resize(method="linear")`, rebuilt here as
  that function's per-axis weight matrices (triangle kernel, widened by the
  scale on downscale, weights renormalised) contracted in full f32.

The isotropic downsampler of the merge stage is not part of the tile
chain and is not ported here.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from .intensity import conv_last

__all__ = ["block_reduce", "resize"]


def block_reduce(img: torch.Tensor, block_size, func: str = "max") -> torch.Tensor:
    """skimage.measure.block_reduce equivalent (zero padding to a multiple of
    block_size, then reduce each block with func)."""
    if np.isscalar(block_size):
        block_size = (int(block_size),) * img.dim()
    block_size = tuple(int(b) for b in block_size)
    if len(block_size) != img.dim():
        raise ValueError(f"block_size {block_size} for a {img.dim()}-d image")
    pad = []
    for s, b in zip(reversed(img.shape), reversed(block_size)):
        pad += [0, (-s) % b]
    if any(pad):
        img = torch.nn.functional.pad(img, pad)
    new_shape = []
    for s, b in zip(img.shape, block_size):
        new_shape += [s // b, b]
    x = img.reshape(new_shape)
    axes = tuple(range(1, 2 * img.dim(), 2))
    if func == "max":
        return torch.amax(x, dim=axes)
    if func == "min":
        return torch.amin(x, dim=axes)
    if func == "mean":
        return torch.mean(x.float(), dim=axes)
    if func == "sum":
        return torch.sum(x if x.is_floating_point() else x.to(torch.int64),
                         dim=axes)
    if func == "median":
        # jnp.median: the mean of the two middle values of an even count
        lead = [s for i, s in enumerate(x.shape) if i not in axes]
        flat = x.float().permute(
            *[i for i in range(x.dim()) if i not in axes], *axes
        ).reshape(*lead, -1)
        v = torch.sort(flat, dim=-1).values
        k = v.shape[-1]
        return 0.5 * (v[..., (k - 1) // 2] + v[..., k // 2])
    raise ValueError(f"unsupported reduce func {func!r}")


def _aa_sigma(in_len: int, out_len: int) -> float:
    factor = in_len / out_len
    return max(0.0, (factor - 1.0) / 2.0)


def _gauss_blur_axis(x: torch.Tensor, sigma: float, axis: int) -> torch.Tensor:
    if sigma <= 0:
        return x
    radius = max(1, int(4.0 * sigma + 0.5))
    t = np.arange(-radius, radius + 1)
    k = np.exp(-0.5 * (t / sigma) ** 2)
    k = (k / k.sum()).astype(np.float32)
    xm = torch.movedim(x, axis, -1)
    return torch.movedim(conv_last(xm, k, radius, "reflect"), -1, axis)


def _linear_weights(in_len: int, out_len: int) -> np.ndarray:
    """(in_len, out_len) f32 weights of jax.image.resize's linear method
    (antialias on, translation 0) along one axis."""
    f32 = np.float32
    inv_scale = f32(1.0) / f32(out_len / in_len)
    kernel_scale = max(inv_scale, f32(1.0))
    sample_f = (np.arange(out_len, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(in_len, dtype=f32)[:, None]) \
        / kernel_scale
    w = np.maximum(f32(0), f32(1) - np.abs(x))
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(f32).eps),
                 w / np.where(total != 0, total, f32(1)), f32(0))
    inside = (sample_f >= -0.5) & (sample_f <= in_len - 0.5)
    return np.where(inside[None, :], w, f32(0)).astype(f32)


def resize(img: torch.Tensor, out_shape: Sequence[int],
           anti_aliasing: Optional[bool] = None) -> torch.Tensor:
    """Order-1 resize with skimage-style gaussian anti-aliasing on
    downscale.  Output is float32."""
    out_shape = tuple(int(s) for s in out_shape)
    x = img.float()
    if anti_aliasing is None:
        anti_aliasing = any(o < s for o, s in zip(out_shape, x.shape))
    if anti_aliasing:
        for ax, (s, o) in enumerate(zip(x.shape, out_shape)):
            if o < s:
                x = _gauss_blur_axis(x, _aa_sigma(s, o), ax)
    for ax, (s, o) in enumerate(zip(x.shape, out_shape)):
        if s != o:
            w = torch.from_numpy(_linear_weights(s, o)).to(x.device)
            x = torch.movedim(torch.tensordot(x, w, dims=([ax], [0])), -1, ax)
    return x
