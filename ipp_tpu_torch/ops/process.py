"""process_img — the per-tile processing chain on one device (port of
ipp_tpu/ops/process.py):

    flat-field divide -> gaussian denoise -> block-reduce downsample ->
    destripe + bleach correction -> dark subtraction -> lightsheet
    correction -> resize -> 16/8-bit conversion -> flip/rotate

with the reference's stages, defaults and dtype rules, batched over a
leading axis.  The uniform-tile short-circuit and unresolved bleach clips
(per-plane multi-Otsu) stay on the host, as in the reference.

`process_batch_fn(cfg)` is the batch callable of the tile CLI: upload,
chain, and a `HostArray` handle back, whose copy the executor's
one-batch-in-flight fetch starts while the next batch runs.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ..utils.device import resolve_device
from ..utils.transfer import HostArray, host_dtype, upload
from . import destripe as ds
from . import intensity as it
from . import lightsheet as lsc
from . import resample as rs

__all__ = ["ProcessConfig", "process_img", "process_batch_fn",
           "is_uniform_2d", "needs_host_stats"]


def is_uniform_2d(img: np.ndarray) -> bool:
    """True if every pixel equals the first one
    (reference numba is_uniform_2d, pystripe/core.py:94-123)."""
    return bool((img == img.flat[0]).all())


@dataclass
class ProcessConfig:
    """Mirror of process_img's keyword surface (pystripe/core.py:1190-1236)."""

    flat: Optional[np.ndarray] = None
    gaussian_filter_2d: bool = False
    down_sample: Optional[Tuple[int, int]] = None
    down_sample_method: str = "max"
    new_size: Optional[Tuple[int, int]] = None
    sigma: Tuple[float, float] = (0.0, 0.0)
    level: int = 0
    wavelet: str = "coif15"
    crossover: float = 10.0
    threshold: Optional[float] = None
    padding_mode: str = "wrap"
    bidirectional: bool = False
    bleach_correction_frequency: Optional[float] = None
    bleach_correction_max_method: bool = False
    bleach_correction_clip_min: Optional[float] = None
    bleach_correction_clip_med: Optional[float] = None
    bleach_correction_clip_max: Optional[float] = None
    dark: float = 0.0
    lightsheet: bool = False
    artifact_length: int = 150
    background_window_size: int = 200
    percentile: float = 0.25
    lightsheet_vs_background: float = 2.0
    rotate: int = 0
    flip_upside_down: bool = False
    convert_to_16bit: bool = False
    convert_to_8bit: bool = False
    bit_shift_to_right: int = 8
    d_type: Optional[str] = None


def _out_meta(img_shape, cfg: ProcessConfig, in_dtype):
    """Output (shape, dtype) for the uniform-tile short-circuit
    (reference: pystripe/core.py:1231-1246)."""
    tile = tuple(img_shape)
    if cfg.new_size is not None:
        tile = tuple(cfg.new_size)
    elif cfg.down_sample is not None:
        tile = tuple(-(-s // d) for s, d in zip(tile, cfg.down_sample))
    if cfg.rotate in (90, 270):
        tile = (tile[1], tile[0])
    if cfg.convert_to_16bit:
        dt = np.uint16
    elif cfg.convert_to_8bit:
        dt = np.uint8
    else:
        dt = np.dtype(cfg.d_type) if cfg.d_type else in_dtype
    return tile, dt


def needs_host_stats(cfg: ProcessConfig) -> bool:
    """True when process_img must run per plane: unresolved bleach clips
    trigger a per-image multi-Otsu (the reference resolves them per plane,
    pystripe/core.py:696-727) — batching such planes would make the clips a
    batch-global statistic."""
    return (cfg.bleach_correction_frequency is not None
            and (cfg.bleach_correction_clip_min is None
                 or cfg.bleach_correction_clip_med is None
                 or cfg.bleach_correction_clip_max is None))


def _chain(x: torch.Tensor, cfg: ProcessConfig, in_dtype) -> torch.Tensor:
    """The device chain on an uploaded tile or batch of tiles; returns the
    output in the device dtype of its host dtype."""
    if cfg.flat is not None and cfg.flat.shape == tuple(x.shape[-2:]):
        # shape mismatch: reference warns and skips (pystripe/core.py:1248-1255)
        flat = torch.from_numpy(np.asarray(cfg.flat)).to(x.device)
        x = it.apply_flat(x.float(), flat)

    if cfg.gaussian_filter_2d:
        # reference: cv2.GaussianBlur ksize 5, sigma 1 (pystripe/core.py:1284)
        x = it.gaussian_blur2d(x.float(), 1.0, radius=2)

    if cfg.down_sample is not None:
        bs = (1,) * (x.dim() - 2) + tuple(cfg.down_sample)
        x = rs.block_reduce(x, bs, cfg.down_sample_method)

    if cfg.bleach_correction_frequency is not None or tuple(cfg.sigma) > (0, 0):
        clip_min = cfg.bleach_correction_clip_min
        clip_med = cfg.bleach_correction_clip_med
        clip_max = cfg.bleach_correction_clip_max
        if needs_host_stats(cfg):
            from .stats import threshold_multiotsu

            lb, mb, ub = threshold_multiotsu(
                np.log1p(x.float().cpu().numpy()), classes=4)
            clip_min = lb if clip_min is None else clip_min
            clip_med = mb if clip_med is None else clip_med
            clip_max = ub if clip_max is None else clip_max
        x = ds.filter_streaks(
            x, sigma=tuple(cfg.sigma), level=cfg.level, wavelet=cfg.wavelet,
            crossover=cfg.crossover, threshold=cfg.threshold,
            padding_mode=cfg.padding_mode, bidirectional=cfg.bidirectional,
            bleach_correction_frequency=cfg.bleach_correction_frequency,
            bleach_correction_max_method=cfg.bleach_correction_max_method,
            bleach_correction_clip_min=clip_min,
            bleach_correction_clip_med=clip_med,
            bleach_correction_clip_max=clip_max)

    if cfg.dark is not None and cfg.dark > 0:
        x = it.subtract_dark(x, cfg.dark)

    if cfg.lightsheet:
        x = lsc.correct_lightsheet(
            x, percentile=cfg.percentile,
            artifact_length=cfg.artifact_length,
            background_window_size=cfg.background_window_size,
            lightsheet_vs_background=cfg.lightsheet_vs_background)

    if cfg.new_size is not None and tuple(x.shape[-2:]) != tuple(cfg.new_size):
        upscaling = tuple(x.shape[-2:]) < tuple(cfg.new_size)
        x = rs.resize(x, x.shape[:-2] + tuple(cfg.new_size),
                      anti_aliasing=not upscaling)

    if cfg.convert_to_16bit and host_dtype(x) != np.uint16:
        x = it.convert_to_16bit(x)
    elif cfg.convert_to_8bit and host_dtype(x) != np.uint8:
        x = it.convert_to_8bit(x, cfg.bit_shift_to_right)
    else:
        x = it.round_clip(x.float(), np.dtype(cfg.d_type) if cfg.d_type
                          else in_dtype)

    if cfg.flip_upside_down:
        x = torch.flip(x, dims=(-2,))
    if cfg.rotate in (90, 180, 270):
        x = torch.rot90(x, cfg.rotate // 90, dims=(-2, -1))
    return x.contiguous()


def process_img(img: np.ndarray, cfg: Optional[ProcessConfig] = None,
                fetch: bool = True, device=None, **kwargs):
    """Apply the full tile pipeline to a host tile or batch of tiles
    (..., H, W); accepts a config or the reference's keyword arguments.

    Returns a numpy array, or with fetch=False the `HostArray` handle of
    the device result (its download not started).  Uniform images
    short-circuit to zeros on the host."""
    if cfg is None:
        cfg = ProcessConfig(**kwargs)
    img = np.asarray(img)
    if is_uniform_2d(img):
        # img may carry leading batch dims; the output geometry math is 2D
        tile, dt = _out_meta(img.shape[-2:], cfg, img.dtype)
        return np.zeros(img.shape[:-2] + tile, dt)
    x = _chain(upload(img, resolve_device(device)), cfg, img.dtype)
    out = HostArray(x)
    return np.asarray(out) if fetch else out


def process_batch_fn(cfg: ProcessConfig, device=None):
    """The batch callable of the tile CLI for `cfg`: (B, H, W) host batch
    -> `HostArray` of the processed batch (of its first `n` tiles when `n`
    is given).  Callers gate on needs_host_stats(cfg) (per-plane clips)
    and handle uniform tiles themselves."""
    if needs_host_stats(cfg):
        raise ValueError("cfg resolves bleach clips per plane — "
                         "gate on needs_host_stats(cfg)")
    dev = resolve_device(device)

    def run(batch: np.ndarray, n: Optional[int] = None) -> HostArray:
        batch = np.asarray(batch)
        x = _chain(upload(batch, dev), cfg, batch.dtype)
        return HostArray(x if n is None else x[:n])

    return run
