"""Wavelet-FFT destriping (port of ipp_tpu/ops/destripe.py):

    log1p -> pad -> wavedec2 -> gaussian-notch the stripe subbands' rFFT
    per level -> waverec2 -> bleach correction -> expm1 -> round/clip

on tensors with leading batch dimensions, on one device.  The DWT analysis
runs through the CUDA kernel K5 on the card (`wavelets`); the notch is the
reference's rfft path through `torch.fft`, with its sigma/2 complex-bin
rule.  The numbers the reference pins are kept: `calculate_pad_size`'s
c = 5e14, the pad planner's min_len = 34 and its level cap of 7.

Integer images follow `utils/transfer.py` (uint16 as int32 on the
device); the output has the input's dtype.

Not ported: the MXU circulant-matmul notch (`_notch_circulant`,
IPP_TPU_NOTCH), a TPU lever; off the TPU the reference takes the rfft
path.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import numpy as np
import torch

from ..utils.transfer import host_dtype
from . import wavelets as wv
from .intensity import (correct_bleaching, expm1_clip, foreground_fraction,
                        log1p_f32, round_clip)
from .padding import pad_trailing

__all__ = [
    "notch",
    "notch_rise_point",
    "calculate_pad_size",
    "filter_coefficient",
    "filter_subband",
    "filter_streaks",
]


def notch(length: int, sigma: float) -> np.ndarray:
    """1D gaussian notch 1 - exp(-x^2 / (2 sigma^2))
    (reference np_notch, pystripe/core.py:657-676)."""
    if length <= 0:
        raise ValueError("notch: length must be positive")
    if sigma <= 0:
        raise ValueError("notch: sigma must be positive")
    g = np.arange(length, dtype=np.float32)
    return (1.0 - np.exp(-(g ** 2) / (2.0 * float(sigma) ** 2))).astype(np.float32)


def notch_rise_point(sigma: float, rise: float) -> int:
    """Length at which the notch reaches `rise`
    (reference: pystripe/core.py:671-679)."""
    return int(math.sqrt(-2.0 * sigma ** 2 * math.log(1.0 - rise)) + 0.5) // 2 * 2


def calculate_pad_size(shape: Tuple[int, int], sigma: int, rise: float = 0.5) -> int:
    """Pad size from the notch rise point, memory-capped
    (reference: pystripe/core.py:681-698; the c=5e14 constant is the
    reference's GPU-memory heuristic, kept for behavioral parity)."""
    if sigma == 0:
        return 0
    x = shape[1] + 1
    y = shape[0] + 1
    c = 5e14
    sqrt_xyc = math.sqrt(x ** 2 - 2 * x * y + y ** 2 + 4 * c)
    rise = min(round(1 - math.exp((x + y - sqrt_xyc) / (4 * sigma ** 2)), 2) - 0.01, rise)
    return notch_rise_point(sigma, rise)


def filter_coefficient(coef: torch.Tensor, width_frac: float,
                       axis: int = -1) -> torch.Tensor:
    """rFFT-notch-irFFT a detail-coefficient array along `axis`
    (reference np_filter_coefficient, pystripe/core.py:749-754: the notch
    sigma is coef.shape[axis+1] * width_frac).

    The notch applied to complex rfft bin k uses sigma/2: the reference's
    production path multiplies scipy.fftpack's packed real-FFT layout
    (bin k at indices 2k-1/2k) by a length-n notch, which is a sigma/2
    notch in complex-bin space (see ipp_tpu/ops/destripe.py)."""
    if axis == -1:
        sigma = coef.shape[-2] * width_frac
    elif axis == -2:
        sigma = coef.shape[-1] * width_frac
    else:
        raise ValueError("axis must be -1 or -2")
    n = coef.shape[axis]
    f = torch.fft.rfft(coef, dim=axis)
    g = torch.from_numpy(notch(f.shape[axis], 0.5 * sigma)).to(coef.device)
    shape = [1] * f.dim()
    shape[axis] = f.shape[axis]
    return torch.fft.irfft(f * g.reshape(shape), n=n, dim=axis)


def filter_subband(img: torch.Tensor, sigma: float, level: int, wavelet: str,
                   axes: Union[int, Tuple[int, ...]] = -1) -> torch.Tensor:
    """Notch-filter the stripe subbands of a wavelet decomposition
    (reference filter_subband, pystripe/core.py:840-940, numpy path).

    img: (..., H, W) float32, H and W divisible by 2**level.
    """
    if isinstance(axes, int):
        axes = (axes,)
    h, w = img.shape[-2], img.shape[-1]
    if level == 0:
        level = wv.dwt_max_level(min(h, w), wavelet)
        level = max(min(level, _max_divisible_level(h, w)), 1)
    coeffs = wv.wavedec2(img, wavelet, level)
    out = [coeffs[0]]
    for det in coeffs[1:]:
        ch, cv, cd = det
        if -1 in axes:
            ch = filter_coefficient(ch, sigma / img.shape[-2], axis=-1)
        if -2 in axes:
            cv = filter_coefficient(cv, sigma / img.shape[-1], axis=-2)
        out.append((ch, cv, cd))
    return wv.waverec2(out, wavelet)


def _max_divisible_level(h: int, w: int) -> int:
    lv = 0
    while h % 2 == 0 and w % 2 == 0 and min(h, w) >> 1 >= 2:
        h >>= 1
        w >>= 1
        lv += 1
    return lv


def _plan_padding(shape: Tuple[int, int], sigma: Tuple[int, int], level: int,
                  wavelet: str) -> Tuple[int, Tuple[int, int], Tuple[int, int], int]:
    """Compute (base_pad, extra(y,x), padded_shape, level) such that the padded
    shape is divisible by 2**level (reference pad logic:
    pystripe/core.py:1083-1110 plus the periodization divisibility rule)."""
    base_pad = calculate_pad_size(shape, max(sigma))
    min_len = 34  # reference min_image_length for db9 (pystripe/core.py:1094)
    py = max(0, min_len - (shape[0] + 2 * base_pad))
    px = max(0, min_len - (shape[1] + 2 * base_pad))
    h = shape[0] + 2 * base_pad + py
    w = shape[1] + 2 * base_pad + px
    if level == 0:
        level = wv.dwt_max_level(min(h, w), wavelet)
        level = max(1, min(level, 7))
    mult = 1 << level
    py += (-h) % mult
    px += (-w) % mult
    return base_pad, (py, px), (shape[0] + 2 * base_pad + py, shape[1] + 2 * base_pad + px), level


def _filter_streaks_impl(img, threshold, bleach_clip_min, bleach_clip_med,
                         bleach_clip_max, *, sigma, level, wavelet, crossover,
                         padding_mode, bidirectional, bleach_correction_frequency,
                         bleach_correction_max_method, log1p_normalization_needed,
                         out_dtype, use_thresholding=False):
    sigma1, sigma2 = sigma
    x = img
    if log1p_normalization_needed:
        x = log1p_f32(x)
    else:
        x = x.float()

    if not (sigma1 == sigma2 == 0):
        base_pad, (py, px), padded_shape, lv = _plan_padding(
            x.shape[-2:], sigma, level, wavelet)
        x = pad_trailing(x, [(base_pad, base_pad + py),
                             (base_pad, base_pad + px)], padding_mode)
        axes = (-1, -2) if bidirectional else (-1,)
        # dual-band logic (reference filter_streak_dual_band,
        # pystripe/core.py:943-979)
        if use_thresholding and sigma1 != sigma2 and threshold is not None:
            # thresholded fg/bg split with sigmoid crossover blend; a band
            # with sigma == 0 stays the unclipped image
            fg = x
            if sigma1 > 0:
                fg = filter_subband(torch.clamp(x, min=threshold), sigma1,
                                    lv, wavelet, axes=axes)
            bg = x
            if sigma2 > 0:
                bg = filter_subband(torch.clamp(x, max=threshold), sigma2,
                                    lv, wavelet, axes=axes)
            # smoothing=0: the reference's shipped foreground mask is
            # unsmoothed (pystripe/core.py:600 discards the blur)
            frac = foreground_fraction(x, threshold, crossover, smoothing=0)
            x = (fg * frac + bg * (1.0 - frac)) * threshold
        elif sigma1 > 0 and sigma1 == sigma2:
            x = filter_subband(x, sigma1, lv, wavelet, axes=axes)
        else:
            if sigma1 > 0:
                x = filter_subband(x, sigma1, lv, wavelet, axes=axes)
            if sigma2 > 0:
                x = filter_subband(x, sigma2, lv, wavelet, axes=axes)
        x = x[..., base_pad: x.shape[-2] - (base_pad + py),
              base_pad: x.shape[-1] - (base_pad + px)]

    if bleach_correction_frequency is not None:
        x = correct_bleaching(
            x, bleach_correction_frequency, bleach_clip_min, bleach_clip_med,
            bleach_clip_max, max_method=bleach_correction_max_method)

    if log1p_normalization_needed:
        return expm1_clip(x, out_dtype)
    return round_clip(x, out_dtype)


def filter_streaks(
    img: torch.Tensor,
    sigma: Union[float, Tuple[float, float]] = (250, 250),
    level: int = 0,
    wavelet: str = "db9",
    crossover: float = 10,
    threshold: Optional[float] = None,
    padding_mode: str = "wrap",
    bidirectional: bool = False,
    bleach_correction_frequency: Optional[float] = None,
    bleach_correction_max_method: bool = False,
    bleach_correction_clip_min: Optional[float] = None,
    bleach_correction_clip_med: Optional[float] = None,
    bleach_correction_clip_max: Optional[float] = None,
    log1p_normalization_needed: bool = True,
    use_thresholding: bool = False,
) -> torch.Tensor:
    """Destripe (and optionally bleach-correct) a tile or batch of tiles
    (reference filter_streaks, pystripe/core.py:982-1160).

    img: (..., H, W) tensor of any image dtype of `utils/transfer.py`
    (uint16 as int32).  Returns the same dtype.  Missing bleach clips are
    the caller's job (host-side: ops.stats.threshold_multiotsu).
    """
    if not isinstance(sigma, (tuple, list)):
        sigma = (sigma, sigma)
    sigma = (float(sigma[0]), float(sigma[1]))
    if sigma[0] == sigma[1] == 0 and bleach_correction_frequency is None:
        return img
    if bleach_correction_frequency is not None and (
            bleach_correction_clip_min is None or bleach_correction_clip_med is None
            or bleach_correction_clip_max is None):
        raise ValueError(
            "bleach correction clips must be resolved host-side first "
            "(use ops.stats.threshold_multiotsu on log1p(img))")
    if use_thresholding and threshold is None:
        raise ValueError(
            "use_thresholding requires an explicit threshold; resolve it "
            "host-side (ops.stats.threshold_otsu) — the reference computes "
            "Otsu inline (pystripe/core.py:948-950)")
    if threshold is not None and threshold <= 0:
        # reference routes non-positive thresholds to a single sigma1-band
        # filter (filter_streak_dual_band, pystripe/core.py:945-946)
        use_thresholding = False
        sigma = (sigma[0], sigma[0])
        if sigma[0] == 0 and bleach_correction_frequency is None:
            return img

    def f32(v):
        return 0.0 if v is None else float(np.float32(v))

    return _filter_streaks_impl(
        img, f32(threshold), f32(bleach_correction_clip_min),
        f32(bleach_correction_clip_med), f32(bleach_correction_clip_max),
        sigma=sigma,
        level=int(level),
        wavelet=wavelet,
        crossover=float(crossover),
        padding_mode=padding_mode,
        bidirectional=bool(bidirectional),
        bleach_correction_frequency=(
            None if bleach_correction_frequency is None else float(bleach_correction_frequency)),
        bleach_correction_max_method=bool(bleach_correction_max_method),
        log1p_normalization_needed=bool(log1p_normalization_needed),
        out_dtype=host_dtype(img),
        use_thresholding=bool(use_thresholding),
    )
