"""Intensity-domain tile operations (port of ipp_tpu/ops/intensity.py):
log-normalization, dark subtraction, flat-field division, bit-depth
conversion, gaussian blur, foreground mask, bleach correction, histogram
matching.

Plain PyTorch on tensors with leading batch dimensions.  Integer images
follow the device convention of `utils/transfer.py` (uint16 as int32);
where the reference's result dtype follows JAX's promotion rules, so does
this port's (noted per function).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.transfer import device_dtype
from .padding import pad_trailing

__all__ = [
    "log1p_f32",
    "expm1_clip",
    "convert_to_16bit",
    "convert_to_8bit",
    "subtract_dark",
    "apply_flat",
    "sigmoid",
    "gaussian_blur2d",
    "foreground_fraction",
    "butter_lowpass_coeffs",
    "filtfilt1",
    "correct_bleaching",
    "hist_match",
]

_U16 = torch.int32  # the device dtype of uint16 images


def log1p_f32(img: torch.Tensor) -> torch.Tensor:
    """log1p in float32 (reference log1p_jit, pystripe/core.py:190)."""
    return torch.log1p(img.float())


def round_clip(x: torch.Tensor, dtype) -> torch.Tensor:
    """Round half to even and clip to numpy integer `dtype`'s range, as
    jnp.clip(jnp.rint(x), min, max).astype(dtype); float dtypes cast."""
    dt = np.dtype(dtype)
    if np.issubdtype(dt, np.integer):
        info = np.iinfo(dt)
        x = torch.clamp(torch.round(x), int(info.min), int(info.max))
    return x.to(device_dtype(dt))


def expm1_clip(img: torch.Tensor, dtype) -> torch.Tensor:
    """expm1 then round/clip back to numpy dtype `dtype`
    (reference: pystripe/core.py:1149-1158)."""
    return round_clip(torch.expm1(img), dtype)


def convert_to_16bit(img: torch.Tensor) -> torch.Tensor:
    """Clip to [0, 65535] and cast (truncating) to u16 (reference:
    pystripe/core.py:397-400)."""
    if not img.is_floating_point():
        img = img.to(_U16)
    return torch.clamp(img, 0, 65535).to(_U16)


def convert_to_8bit(img: torch.Tensor, bit_shift_to_right: int = 8) -> torch.Tensor:
    """16-bit -> 8-bit with right bit-shift; any nonzero value that would
    round to zero maps to 1 so dim-but-real signal survives
    (reference: pystripe/core.py:402-424).  Shift and comparisons in
    int32."""
    if not 0 <= bit_shift_to_right < 9:
        raise ValueError("right shift should be between 0 and 8")
    if img.dtype == torch.uint8:
        return img
    if img.dtype != _U16:
        img = convert_to_16bit(img)
    lower_bound = 1 << bit_shift_to_right
    shifted = img >> bit_shift_to_right
    out = torch.where((img > 0) & (img < lower_bound),
                      torch.ones_like(img), shifted)
    return torch.clamp(out, 0, 255).to(torch.uint8)


def subtract_dark(img: torch.Tensor, dark: float) -> torch.Tensor:
    """img = max(img - dark, 0) (reference: pystripe/core.py:1327-1334).
    As in JAX, an integer image minus a Python float is float32; minus a
    Python int it keeps its dtype."""
    if not img.is_floating_point() and not isinstance(dark, int):
        img = img.float()
    return torch.where(img > dark, img - dark, torch.zeros_like(img))


def apply_flat(img: torch.Tensor, flat: Optional[torch.Tensor]) -> torch.Tensor:
    """Flat-field division (reference: pystripe/core.py:1248-1255)."""
    if flat is None:
        return img
    return img / flat


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """0.5*(tanh(0.5*x)+1) (reference: pystripe/core.py:569-583)."""
    return 0.5 * (torch.tanh(0.5 * x) + 1.0)


def _gaussian_kernel1d(sigma: float, radius: int) -> np.ndarray:
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def conv_last(x: torch.Tensor, k: np.ndarray, radius: int,
              mode: str) -> torch.Tensor:
    """Pad the last axis by `radius` in `mode` (jnp.pad semantics), then
    correlate it with the odd-length kernel `k` (same length out)."""
    xp = pad_trailing(x, [(radius, radius)], mode)
    w = torch.from_numpy(k).to(device=x.device, dtype=x.dtype)
    out = F.conv1d(xp.reshape(-1, 1, xp.shape[-1]), w[None, None, :])
    return out.reshape(x.shape)


def gaussian_blur2d(img: torch.Tensor, sigma: float, radius: Optional[int] = None,
                    mode: str = "reflect") -> torch.Tensor:
    """Separable 2D gaussian blur over the last two axes (OpenCV-style
    truncation at ksize = 2*sigma+1 when radius is None, matching the
    GaussianBlur call in foreground_fraction, pystripe/core.py:586-601)."""
    if radius is None:
        radius = int(sigma)
    k = _gaussian_kernel1d(sigma, radius)
    img = conv_last(img, k, radius, mode)
    return conv_last(img.transpose(-1, -2), k, radius, mode).transpose(-1, -2)


def foreground_fraction(img: torch.Tensor, threshold: float, crossover: float,
                        smoothing: int = 1) -> torch.Tensor:
    """Smooth foreground mask in [0,1] (reference: pystripe/core.py:586-601)."""
    ff = sigmoid((img.float() - threshold) / crossover)
    if smoothing and smoothing > 0:
        ff = gaussian_blur2d(ff, float(smoothing))
    return ff


# ---------------------------------------------------------------------------
# First-order Butterworth filtfilt (for bleach correction)
# ---------------------------------------------------------------------------


def butter_lowpass_coeffs(cutoff: float, order: int = 1) -> Tuple[np.ndarray, np.ndarray]:
    """First-order Butterworth low-pass (b, a), matching
    scipy.signal.butter(1, cutoff) with fs=2 (normalized Nyquist=1).
    Bilinear transform of H(s)=1/(s+1) with prewarping."""
    if order != 1:
        raise NotImplementedError("reference uses order=1 (pystripe/core.py:496)")
    warped = np.tan(np.pi * cutoff / 2.0)
    b0 = warped / (1.0 + warped)
    b = np.array([b0, b0])
    a = np.array([1.0, (warped - 1.0) / (warped + 1.0)])
    return b, a


def _iir1(x: torch.Tensor, b0: float, b1: float, a1: float, zi: float) -> torch.Tensor:
    """First-order IIR y[n] = -a1 y[n-1] + b0 x[n] + b1 x[n-1] along the
    last axis, with scipy-style initial state zi * x[0].  The recurrence
    y[k] = u[k] + c y[k-1], c = -a1, is solved as a scan by doubling
    (the reference runs an associative scan): after the step with shift s,
    y[k] holds sum_{j < 2s} c^j u[k-j], so log2(n) whole-row steps replace
    n single-sample ones.  c^s underflows to 0 for long rows, which only
    ends the sum where its terms have vanished."""
    xm1 = torch.cat([torch.zeros_like(x[..., :1]), x[..., :-1]], dim=-1)
    y = b0 * x + b1 * xm1
    y[..., 0] += zi * x[..., 0]
    n, shift, coef = y.shape[-1], 1, -a1
    while shift < n:
        y = torch.cat([y[..., :shift],
                       y[..., shift:] + coef * y[..., :-shift]], dim=-1)
        shift, coef = 2 * shift, coef * coef
    return y


def filtfilt1(x: torch.Tensor, b: np.ndarray, a: np.ndarray) -> torch.Tensor:
    """Zero-phase first-order filtering along the last axis, equivalent to
    scipy.signal.sosfiltfilt(butter(1, fc, output='sos'), x)
    (reference butter_lowpass_filter, pystripe/core.py:493-499): odd
    extension of length padlen=6 and steady-state initial conditions."""
    b0, b1 = float(b[0]), float(b[1])
    a1 = float(a[1])
    padlen = 6
    n = x.shape[-1]
    if n <= padlen:
        padlen = max(n - 1, 0)
    left = 2 * x[..., :1] - x[..., 1:padlen + 1].flip(-1)
    right = 2 * x[..., -1:] - x[..., -padlen - 1:-1].flip(-1)
    ext = torch.cat([left, x, right], dim=-1)
    # lfilter_zi for a first-order section
    zi = (b1 - b0 * a1) / (1.0 + a1)
    y = _iir1(ext, b0, b1, a1, zi)
    y = _iir1(y.flip(-1), b0, b1, a1, zi).flip(-1)
    return y[..., padlen:padlen + n]


def correct_bleaching(img: torch.Tensor, frequency: float, clip_min: float,
                      clip_med: float, clip_max: float,
                      max_method: bool = False) -> torch.Tensor:
    """Flat-field style bleach correction on a log1p image
    (reference: pystripe/core.py:501-566): a smooth multiplicative flat
    from a Butterworth low-pass of a clipped copy (or of the outer product
    of per-axis maxima with max_method), then img / flat * max(flat)."""
    f32 = np.float32
    clip_min = float(max(f32(clip_min), f32(np.log1p(1.0))))
    clip_med, clip_max = float(f32(clip_med)), float(f32(clip_max))
    b, a = butter_lowpass_coeffs(frequency)
    if max_method:
        fy = torch.amax(img, dim=-1)
        fx = torch.amax(img, dim=-2)
        fy = torch.where(fy == 0, clip_med, fy)
        fx = torch.where(fx == 0, clip_med, fx)
        fy = torch.clamp(fy, clip_min, clip_max)
        fx = torch.clamp(fx, clip_min, clip_max)
        fy = filtfilt1(fy, b, a)
        fx = filtfilt1(fx, b, a)
        flt = fy[..., :, None] * fx[..., None, :]
    else:
        flt = torch.where(img == 0, clip_med, img)
        flt = torch.clamp(flt, clip_min, clip_max)
        flt = filtfilt1(flt, b, a)  # scipy default axis=-1
    fmax = torch.amax(flt, dim=(-2, -1), keepdim=True)
    return img / flt * fmax


def _interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """jnp.interp(x, xp, fp) with its defaults (constant ends)."""
    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1, xp.numel() - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    eps = float(np.spacing(np.finfo(np.float32).eps))
    dx0 = torch.abs(dx) <= eps
    f = torch.where(dx0, fp[i - 1],
                    fp[i - 1] + (delta / torch.where(dx0, 1.0, dx)) * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def hist_match(source: torch.Tensor, template: torch.Tensor) -> torch.Tensor:
    """Histogram matching: map source pixel quantiles onto the template's
    value distribution (reference hist_match, pystripe/core.py:426-463),
    with the reference's sorted-array right-edge ECDF formulation."""
    shape = source.shape
    s = source.reshape(-1).float()
    t = template.reshape(-1).float()
    s_sorted = torch.sort(s).values
    t_sorted = torch.sort(t).values
    ranks = torch.searchsorted(s_sorted, s, right=True).float()
    q = ranks / s.shape[0]
    tq = torch.searchsorted(t_sorted, t_sorted,
                            right=True).float() / t.shape[0]
    return _interp(q, tq, t_sorted).reshape(shape)
