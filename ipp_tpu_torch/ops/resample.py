"""Down/up-sampling (port of ipp_tpu/ops/resample.py: block_reduce,
_aa_sigma, _gauss_blur_axis, resize, plan_isotropic_downsampling,
isotropic_downsample_plane and IsotropicAccumulator), for the tile
chain's `--down-sample` and `--new-size` and the merge's isotropic
downsample.

- block_reduce: skimage semantics (zero padding to a block multiple, then
  reduce each block).
- resize: the reference's order-1 resize — skimage-style gaussian
  anti-aliasing (sigma = (factor - 1) / 2 per downscaled axis, reflect
  padding) followed by `jax.image.resize(method="linear")`, rebuilt here as
  that function's per-axis weight matrices (triangle kernel, widened by the
  scale on downscale, weights renormalised) contracted in full f32.
- plan_isotropic_downsampling: the reference's voxel-size-driven plan of
  alternating max/mean halvings (calculate_down_sampling_target,
  parallel_image_processor.py:156-189); host only, copied.
- isotropic_downsample_plane: the planned ladder on one plane on the
  device; IsotropicAccumulator: the streamed plane series with its z
  halvings, which run on small host stacks through the CPU.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.device import resolve_device
from ..utils.transfer import upload
from .intensity import conv_last

__all__ = ["block_reduce", "resize", "plan_isotropic_downsampling",
           "isotropic_downsample_plane", "IsotropicAccumulator",
           "block_reduce_host"]


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


def block_reduce_host(a: np.ndarray, block_size, func: str = "max"
                      ) -> np.ndarray:
    """block_reduce of a host array, computed on the CPU: the reference
    runs these small z stacks through its device and back."""
    return block_reduce(torch.from_numpy(np.ascontiguousarray(a)),
                        block_size, func).numpy()


def plan_isotropic_downsampling(
    plane_shape: Tuple[int, int],
    source_voxel_yx: Tuple[float, float],
    target_voxel: float,
) -> Tuple[Tuple[int, int], List[Tuple[Optional[str], Optional[str]]]]:
    """Plan the alternating max/mean halvings that take merged planes toward
    an isotropic target voxel (reference calculate_down_sampling_target,
    parallel_image_processor.py:156-189).

    Returns (target_shape_yx, [(method_y, method_x) per halving]) where
    methods alternate max/mean starting with max on y and mean on x."""
    reduction = np.array([target_voxel / source_voxel_yx[0],
                          target_voxel / source_voxel_yx[1]])
    target_shape = tuple(max(1, int(round(s / r)))
                         for s, r in zip(plane_shape, reduction))
    factors = np.floor(np.sqrt(reduction)).astype(int)
    meth_y: List[Optional[str]] = ["max" if i % 2 == 0 else "mean"
                                   for i in range(factors[0])]
    meth_x: List[Optional[str]] = ["mean" if i % 2 == 0 else "max"
                                   for i in range(factors[1])]
    if len(meth_y) > len(meth_x):
        meth_x += [None] * (len(meth_y) - len(meth_x))
    elif len(meth_x) > len(meth_y):
        meth_y += [None] * (len(meth_x) - len(meth_y))
    return target_shape, list(zip(meth_y, meth_x))


def isotropic_downsample_plane(img, target_shape: Tuple[int, int],
                               methods, resize_final: bool = True,
                               device=None) -> torch.Tensor:
    """Apply a planned in-plane downsample ladder to one plane: per-axis
    block reductions — y then x, each with its own method and each guarded
    by the target shape — then an anti-aliased resize to the exact target
    (reference parallel_image_processor.py:376-384).  A host plane goes to
    `device` (else the resolved device).  Returns an f32 tensor."""
    if not isinstance(img, torch.Tensor):
        img = upload(np.asarray(img), resolve_device(device))
    small = img.float()
    for my, mx in methods:
        if my is not None and -(-small.shape[0] // 2) >= target_shape[0]:
            small = block_reduce(small, (2, 1), my)
        if mx is not None and -(-small.shape[1] // 2) >= target_shape[1]:
            small = block_reduce(small, (1, 2), mx)
    if resize_final and tuple(small.shape) != tuple(target_shape):
        small = resize(small, target_shape)
    return small


class IsotropicAccumulator:
    """Streamed isotropic downsample of a plane series (reference worker
    z_stack + tail, parallel_image_processor.py:334-435: per-plane xy
    ladder into z chunks of floor(r_z) planes, each reduced by
    ceil(sqrt(r_z)) alternating-from-max z halvings, uniform planes/chunks
    short-circuited to zeros; the merge stage has its own inline twin in
    stitch/merge.py).

    add(plane) returns the reduced chunk plane (float32) when a chunk
    completes, else None; flush() drains a partial tail chunk; volume()
    stacks everything for the exact final z resize (downsampled_npz).
    Planes are downsampled on `device` (else the resolved device)."""

    def __init__(self, plane_shape: Tuple[int, int],
                 voxel_zyx: Tuple[float, float, float],
                 target_voxel: float, alternating: bool = True,
                 device=None):
        self.target_shape, self.methods = plan_isotropic_downsampling(
            plane_shape, (voxel_zyx[1], voxel_zyx[2]), target_voxel)
        if not alternating:
            # the reference converter's non-empty --downsample-method: every
            # rung (mean, mean), None-padded slots included; the per-axis
            # ceil(dim/2) >= target guard stops over-reduction
            # (parallel_image_processor.py:184-187, convert.py:129)
            self.methods = [("mean", "mean") for _ in self.methods]
        self.chunk_len = max(1, int(target_voxel // voxel_zyx[0]))
        self.n_z = int(np.ceil(np.sqrt(target_voxel / voxel_zyx[0])))
        self.device = device
        self._chunk: List[np.ndarray] = []
        self._reduced: List[np.ndarray] = []

    def _reduce_chunk(self) -> np.ndarray:
        stack = np.stack(self._chunk)
        self._chunk.clear()
        if (stack == stack.flat[0]).all():   # is_uniform_3d (:413-415)
            out = np.zeros(self.target_shape, np.float32)
        else:
            for i in range(self.n_z):
                if stack.shape[0] <= 1:
                    break
                stack = block_reduce_host(
                    stack, (2, 1, 1), "max" if i % 2 == 0 else "mean")
            out = stack[0]
        self._reduced.append(out)
        return out

    def add(self, plane: np.ndarray):
        v0 = plane.flat[0]
        if plane.flat[-1] == v0 and (plane == v0).all():
            small = np.zeros(self.target_shape, np.float32)
        else:
            small = isotropic_downsample_plane(
                plane, self.target_shape, self.methods,
                device=self.device).cpu().numpy()
        self._chunk.append(small)
        if len(self._chunk) == self.chunk_len:
            return self._reduce_chunk()
        return None

    def flush(self):
        if self._chunk:
            return self._reduce_chunk()
        return None

    def volume(self) -> np.ndarray:
        if not self._reduced:
            return np.zeros((0,) + tuple(self.target_shape), np.float32)
        return np.stack(self._reduced)
