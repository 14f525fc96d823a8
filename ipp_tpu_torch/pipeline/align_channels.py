"""Inter-channel rigid alignment + RGB compositing on one device (port of
ipp_tpu/pipeline/align_channels.py: get_offsets_ecc, roll_pad,
align_volumes, central_sections_streamed, align_big_channels,
write_aligned_series, write_composite_series and the CLI).

Re-design of the reference's channel alignment (align_images.py:1-754 and
process_images.py:788-908):

- per-axis translation estimated by ECC maximization on Sobel gradients of
  central orthogonal slices (get_gradient/get_transformation_matrix,
  process_images.py:788-818).  The JAX package calls OpenCV on the host;
  this port runs the same algorithm in PyTorch on the device
  (`_ecc_translation`), held to OpenCV's results by the twin tests:
  Sobel magnitude (3x3, REFLECT_101 border), ECC's 5x5 Gaussian
  prefilter and central-difference gradient, translation warps
  (bilinear at the exact offset, zero border, nearest-warped validity
  mask), the masked zero-mean update with the illumination factor
  lambda, and phase correlation (zero padding to 2,3,5-smooth sizes,
  normalised cross-power spectrum, 5x5 weighted centroid) where ECC
  fails.  Every sum is accumulated in float64 on the device;
- iterative integer roll-pad moves until convergence or a cycle
  (align_images.py:137-181, 424-502), on the host;
- composite RGB TIFF series writer (merge_all_channels,
  process_images.py:860-1000), whose 8-bit conversion runs on the device;
- a STREAMING variant for volumes that do not fit in RAM
  (align_big_channels / write_aligned_series — the reference's
  process_big_images, align_images.py:343-423): the three orthogonal
  central sections are built from plane strips via the threaded native
  ROI reader, so peak memory is O(sections + one plane), never the
  volume.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..io import tiff as tio
from ..ops import intensity
from ..utils.device import resolve_device
from ..utils.log import Logger
from ..utils.transfer import HostArray, upload

__all__ = ["get_offsets_ecc", "align_volumes", "write_composite_series",
           "central_sections_streamed", "align_big_channels",
           "write_aligned_series"]

# OpenCV's findTransformECC criteria in the reference call
# (TERM_CRITERIA_EPS | TERM_CRITERIA_COUNT, 100, 1e-6)
ECC_ITERATIONS = 100
ECC_EPS = 1e-6
_DBL_EPSILON = float(np.finfo(np.float64).eps)


def _central_slices(vol: np.ndarray, thickness: int = 16):
    """MIP-like central orthogonal sections (reference get_offsets,
    align_images.py:183-240)."""
    d, h, w = vol.shape
    cz, cy, cx = d // 2, h // 2, w // 2
    t = thickness // 2
    xy = vol[max(0, cz - t):cz + t].max(axis=0)
    xz = vol[:, max(0, cy - t):cy + t, :].max(axis=1)
    yz = vol[:, :, max(0, cx - t):cx + t].max(axis=2)
    return xy, xz, yz


def _reflect101(n: int, pad: int) -> np.ndarray:
    """Source indices of [-pad, n + pad) under OpenCV's default border,
    BORDER_REFLECT_101 (gfedcb|abcdefgh|gfedcba)."""
    if n == 1:
        return np.zeros(n + 2 * pad, np.int64)
    period = 2 * (n - 1)
    i = np.abs(np.arange(-pad, n + pad)) % period
    return np.where(i >= n, period - i, i)


def _correlate_sep(x: torch.Tensor, kx: Sequence[float],
                   ky: Sequence[float]) -> torch.Tensor:
    """Separable correlation of a 2D float64 tensor: taps `kx` along x,
    then `ky` along y, anchored at their centres, REFLECT_101 border (the
    border of cv2.Sobel, GaussianBlur and filter2D)."""
    for dim, taps in ((1, kx), (0, ky)):
        if len(taps) == 1:
            continue
        n = x.shape[dim]
        p = x.index_select(dim, torch.as_tensor(
            _reflect101(n, len(taps) // 2), device=x.device))
        x = None
        for i, k in enumerate(taps):
            if k:
                term = p.narrow(dim, i, n)
                x = term * k if x is None else x.add_(term, alpha=k)
    return x


def _sobel_magnitude(img: torch.Tensor) -> torch.Tensor:
    """|grad| of a 2D image as cv2.magnitude(Sobel x, Sobel y) with
    ksize=3 in float32 (reference get_gradient,
    process_images.py:788-795)."""
    x = img.to(torch.float64)
    gx = _correlate_sep(x, (-1.0, 0.0, 1.0), (1.0, 2.0, 1.0)).float()
    gy = _correlate_sep(x, (1.0, 2.0, 1.0), (-1.0, 0.0, 1.0)).float()
    return torch.sqrt(gx.double() ** 2 + gy.double() ** 2).float()


def _translate(img: torch.Tensor, tx: float, ty: float,
               out_hw: Tuple[int, int]) -> torch.Tensor:
    """img (..., H, W) sampled at (y + ty, x + tx) for the output grid
    `out_hw`, bilinear at the exact fractional offset with zeros outside
    the image: cv2.warpAffine(img, [[1, 0, tx], [0, 1, ty]], INTER_LINEAR
    | WARP_INVERSE_MAP) with its constant zero border."""
    hs, ws = out_hw
    hd, wd = img.shape[-2:]
    ix, iy = math.floor(tx), math.floor(ty)
    ax, ay = tx - ix, ty - iy
    # the (hs + 1, ws + 1) source window whose corners interpolate
    win = img.new_zeros(img.shape[:-2] + (hs + 1, ws + 1))
    y0, y1 = max(iy, 0), min(iy + hs + 1, hd)
    x0, x1 = max(ix, 0), min(ix + ws + 1, wd)
    if y0 < y1 and x0 < x1:
        win[..., y0 - iy:y1 - iy, x0 - ix:x1 - ix] = img[..., y0:y1, x0:x1]
    top = torch.lerp(win[..., :-1, :-1], win[..., :-1, 1:], ax)
    bottom = torch.lerp(win[..., 1:, :-1], win[..., 1:, 1:], ax)
    return torch.lerp(top, bottom, ay)


def _valid_rect(tx: float, ty: float, out_hw: Tuple[int, int],
                in_hw: Tuple[int, int]) -> Tuple[slice, slice]:
    """The output pixels whose nearest source pixel lies inside the input
    (the nearest-neighbour warp of an all-ones mask): a rectangle."""
    (hs, ws), (hd, wd) = out_hw, in_hw
    x0 = min(ws, max(0, math.ceil(-0.5 - tx)))
    x1 = max(x0, min(ws, math.ceil(wd - 0.5 - tx)))
    y0 = min(hs, max(0, math.ceil(-0.5 - ty)))
    y1 = max(y0, min(hs, math.ceil(hd - 0.5 - ty)))
    return slice(y0, y1), slice(x0, x1)


def _inv2(h: np.ndarray) -> np.ndarray:
    """2x2 inverse, zeros when singular (cv::invert's DECOMP_LU result)."""
    det = h[0, 0] * h[1, 1] - h[0, 1] * h[1, 0]
    if det == 0:
        return np.zeros((2, 2))
    return np.array([[h[1, 1], -h[0, 1]], [-h[1, 0], h[0, 0]]]) / det


def _ecc(template: torch.Tensor, image: torch.Tensor,
         iterations: int = ECC_ITERATIONS, eps: float = ECC_EPS
         ) -> Optional[Tuple[float, float]]:
    """Translation (tx, ty) that maximises the enhanced correlation
    coefficient of `image` warped onto `template` — cv2.findTransformECC
    with MOTION_TRANSLATION from the identity warp (OpenCV's ecc.cpp:
    5x5 Gaussian prefilter of both images, gradients [-0.5, 0, 0.5] of
    the prefiltered image, per-iteration masked zero-mean template and
    warped image, the 2x2 Hessian of the warped gradients, the
    illumination factor lambda = lambda_n / lambda_d, warp parameters in
    float32).  Stops when |rho - rho_prev| < eps or after `iterations`.

    Returns None where OpenCV raises (and the JAX package falls back to
    phase correlation): the correlation rho is NaN, or lambda_d <= 0."""
    gauss = (1 / 16, 4 / 16, 6 / 16, 4 / 16, 1 / 16)
    tmpl = _correlate_sep(template.double(), gauss, gauss).float().double()
    img = _correlate_sep(image.double(), gauss, gauss).float()
    # the prefiltered image and its gradients, warped together
    stack = torch.stack([
        img,
        _correlate_sep(img.double(), (-0.5, 0.0, 0.5), (1.0,)).float(),
        _correlate_sep(img.double(), (1.0,), (-0.5, 0.0, 0.5)).float()])
    out_hw, in_hw = tuple(tmpl.shape), tuple(img.shape)
    tx = ty = np.float32(0.0)
    rho, last_rho = -1.0, -eps
    it = 1
    while it <= iterations and abs(rho - last_rho) >= eps:
        # rows: the warped image (made zero-mean inside the mask below),
        # the warped x and y gradients
        warped = _translate(stack, float(tx), float(ty), out_hw).double()
        rect = _valid_rect(float(tx), float(ty), out_hw, in_hw)
        n = (rect[0].stop - rect[0].start) * (rect[1].stop - rect[1].start)
        if n == 0:
            return None   # empty mask: OpenCV's rho is 0/0
        # zero-mean inside the mask only; the warped image keeps its
        # values outside it, the template is zero there
        w_r, t_r = warped[0][rect], tmpl[rect]
        w_mean, t_mean = w_r.mean(), t_r.mean()
        w_r -= w_mean
        t_zm = torch.zeros_like(tmpl)
        t_zm[rect] = t_r - t_mean
        w_zm, gxw, gyw = warped.reshape(3, -1)
        t_zm = t_zm.reshape(-1)
        s = torch.stack([
            torch.linalg.vector_norm(w_r), torch.linalg.vector_norm(t_zm),
            torch.dot(gxw, gxw), torch.dot(gxw, gyw), torch.dot(gyw, gyw),
            torch.dot(t_zm, w_zm), torch.dot(gxw, w_zm),
            torch.dot(gyw, w_zm), torch.dot(gxw, t_zm),
            torch.dot(gyw, t_zm)]).tolist()
        img_norm, tmp_norm, hxx, hxy, hyy, corr, ipx, ipy, tpx, tpy = s
        hess_inv = _inv2(np.array([[hxx, hxy], [hxy, hyy]]))
        last_rho = rho
        with np.errstate(divide="ignore", invalid="ignore"):
            rho = float(np.float64(corr) / np.float64(img_norm * tmp_norm))
        if math.isnan(rho):
            return None
        img_proj = np.array([ipx, ipy], np.float32).astype(np.float64)
        tmp_proj = np.array([tpx, tpy], np.float32).astype(np.float64)
        img_proj_hess = hess_inv @ img_proj
        lambda_n = img_norm * img_norm - img_proj @ img_proj_hess
        lambda_d = corr - tmp_proj @ img_proj_hess
        if lambda_d <= 0.0:
            return None
        lam = lambda_n / lambda_d
        delta = (hess_inv @ (lam * tmp_proj - img_proj)).astype(np.float32)
        tx = np.float32(tx + delta[0])
        ty = np.float32(ty + delta[1])
        it += 1
    return float(tx), float(ty)


def _optimal_dft_size(n: int) -> int:
    """The least 2^a 3^b 5^c >= n (cv2.getOptimalDFTSize)."""
    m = max(n, 1)
    while True:
        k = m
        for p in (2, 3, 5):
            while k % p == 0:
                k //= p
        if k == 1:
            return m
        m += 1


def _phase_correlate(a: torch.Tensor, b: torch.Tensor) -> Tuple[float, float]:
    """Sub-pixel shift (x, y) of `b` against `a` by phase correlation, as
    cv2.phaseCorrelate without a window: both zero-padded to optimal DFT
    sizes, the normalised cross-power spectrum F(a) F(b)* / |.|, its
    inverse transform fft-shifted, the peak and a 5x5 weighted centroid
    around it, returned relative to the centre."""
    if a.shape != b.shape:
        raise ValueError(f"phase correlation needs equal shapes, got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    h, w = a.shape
    m, n = _optimal_dft_size(h), _optimal_dft_size(w)
    fa = torch.fft.rfft2(a.double(), s=(m, n))
    fb = torch.fft.rfft2(b.double(), s=(m, n))
    cross = fa * torch.conj(fb)
    c = torch.fft.fftshift(torch.fft.irfft2(
        cross / (torch.abs(cross) + _DBL_EPSILON), s=(m, n)))
    py, px = divmod(int(torch.argmax(c)), n)
    r0, r1 = max(py - 2, 0), min(py + 2, m - 1)
    c0, c1 = max(px - 2, 0), min(px + 2, n - 1)
    win = c[r0:r1 + 1, c0:c1 + 1]
    rows = torch.arange(r0, r1 + 1, dtype=torch.float64, device=c.device)
    cols = torch.arange(c0, c1 + 1, dtype=torch.float64, device=c.device)
    total, sy, sx = torch.stack([win.sum(), (win.sum(1) * rows).sum(),
                                 (win.sum(0) * cols).sum()]).tolist()
    total += _DBL_EPSILON
    return n / 2.0 - sx / total, m / 2.0 - sy / total


def _ecc_translation(ref: np.ndarray, mov: np.ndarray,
                     device=None) -> Tuple[float, float]:
    """Translation (dy, dx) aligning mov to ref via ECC on Sobel gradients
    (reference get_transformation_matrix, process_images.py:788-818), on
    `device` (else the resolved device).  Falls back to phase correlation
    where ECC fails to converge."""
    dev = resolve_device(device)
    g_ref = _sobel_magnitude(torch.as_tensor(
        np.asarray(ref, np.float32), device=dev))
    g_mov = _sobel_magnitude(torch.as_tensor(
        np.asarray(mov, np.float32), device=dev))
    warp = _ecc(g_ref, g_mov)
    if warp is not None:
        return warp[1], warp[0]
    x, y = _phase_correlate(g_ref, g_mov)
    return y, x


def get_offsets_ecc(ref_vol: np.ndarray, mov_vol: np.ndarray,
                    device=None) -> Tuple[int, int, int]:
    """Integer (dz, dy, dx) to roll mov_vol onto ref_vol: each axis is
    estimated from the two orthogonal sections containing it and averaged
    (reference get_offsets, align_images.py:183-240).  The ECC runs on
    `device` (else the resolved device)."""
    xy_r, xz_r, yz_r = _central_slices(ref_vol)
    xy_m, xz_m, yz_m = _central_slices(mov_vol)
    dy1, dx1 = _ecc_translation(xy_r, xy_m, device)
    dz1, dx2 = _ecc_translation(xz_r, xz_m, device)
    dz2, dy2 = _ecc_translation(yz_r, yz_m, device)
    dz = int(round((dz1 + dz2) / 2.0))
    dy = int(round((dy1 + dy2) / 2.0))
    dx = int(round((dx1 + dx2) / 2.0))
    return dz, dy, dx


def roll_pad(vol: np.ndarray, shift: Tuple[int, int, int]) -> np.ndarray:
    """Integer shift with zero fill (reference roll_pad,
    align_images.py:137-181)."""
    out = vol
    for ax, s in enumerate(shift):
        if s == 0:
            continue
        out = np.roll(out, s, axis=ax)
        sl = [slice(None)] * out.ndim
        if s > 0:
            sl[ax] = slice(0, s)
        else:
            sl[ax] = slice(out.shape[ax] + s, out.shape[ax])
        out[tuple(sl)] = 0
    return out


def _sections_similarity(ref_vol: np.ndarray, mov: np.ndarray) -> float:
    """Mean overlap-weighted Pearson correlation of the three central
    sections — the cheap acceptance metric for candidate moves.
    Exactly-zero pixels (roll-pad fill bands) are masked out so
    growing/shrinking bands cannot dominate the correlation, and each
    section's correlation is weighted by its overlap fraction: without
    the weight, a large mis-shift that leaves only one small bright blob
    overlapping can score a near-perfect Pearson over those few pixels
    and out-rank the true alignment.  The weight is comparative-only
    (every candidate state is scored the same way), so the rescaling is
    harmless."""
    corr = []
    for r, m in zip(_central_slices(ref_vol), _central_slices(mov)):
        r = r.astype(np.float64).ravel()
        m = m.astype(np.float64).ravel()
        keep = (r != 0) & (m != 0)
        n_keep = int(keep.sum())
        if n_keep < 16:
            corr.append(0.0)
            continue
        frac = n_keep / keep.size
        r = r[keep] - r[keep].mean()
        m = m[keep] - m[keep].mean()
        denom = np.sqrt((r * r).sum() * (m * m).sum())
        corr.append(float((r * m).sum() / denom) * frac if denom > 0
                    else 0.0)
    return float(np.mean(corr))


def align_volumes(ref_vol: np.ndarray, mov_vol: np.ndarray,
                  max_iter: int = 10, max_shift: int = 50,
                  log: Optional[Logger] = None, device=None
                  ) -> Tuple[np.ndarray, Tuple[int, int, int]]:
    """Iterate roll-pad moves until convergence or a cycle
    (reference align_images, align_images.py:424-502).

    Hardening beyond the reference: ECC is a local optimizer and on
    low-texture sections can return translations tens of pixels off (the
    reference either applies them or dies in cv2's divergence error,
    process_images.py:804).  Here the iteration follows the same
    trajectory — intermediate dips in quality are allowed, they often
    precede the basin of the true optimum — but every visited state is
    scored by the masked Pearson correlation of the central sections and
    the BEST one is returned, so a diverging tail can never be the
    answer; single moves beyond `max_shift` abort as unreliable.  The ECC
    runs on `device` (else the resolved device).
    """
    log = log or Logger()
    dev = resolve_device(device)
    total = np.zeros(3, int)
    seen = set()
    mov = mov_vol.copy()
    sim = _sections_similarity(ref_vol, mov)
    best = (sim, mov, tuple(total))
    for it in range(max_iter):
        dz, dy, dx = get_offsets_ecc(ref_vol, mov, dev)
        # ECC returns the warp taking ref toward mov; roll mov back
        move = (-dz, -dy, -dx)
        if move == (0, 0, 0):
            break
        if max(abs(v) for v in move) > max_shift:
            log.warn(f"channel alignment move {move} exceeds max_shift="
                     f"{max_shift}; treating as unreliable and stopping")
            break
        key = tuple(total + move)
        if key in seen:
            break
        seen.add(tuple(total))
        mov = roll_pad(mov, move)
        total += move
        sim = _sections_similarity(ref_vol, mov)
        if sim > best[0]:
            best = (sim, mov, tuple(total))
    if sim < best[0]:
        log.warn(f"channel alignment ended at section correlation "
                 f"{sim:.4f} < best visited {best[0]:.4f}; reverting to "
                 f"the best state (offsets {best[2]})")
        mov, total = best[1], np.asarray(best[2])
    log.info(f"channel alignment offsets (dz, dy, dx) = {tuple(total)}")
    return mov, tuple(int(v) for v in total)


def central_sections_streamed(directory: Path, thickness: int = 16
                              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The three MIP-like central orthogonal sections of a z-plane TIFF
    series WITHOUT loading the volume: the xy section reads only the
    central `thickness` planes; xz/yz read a y/x strip of every plane
    through the threaded native ROI loader (reference process_big_images
    streams from TifStack, align_images.py:343-423)."""
    from ..utils.tifstack import TifStack

    stack = TifStack(directory)
    nz, (h, w) = stack.nz, stack.nyx
    cz, cy, cx = nz // 2, h // 2, w // 2
    t = thickness // 2

    def read_block(paths, y0, y1, x0, x1):
        from .. import native

        block = native.read_block(paths, y0, y1, x0, x1, dtype=stack.dtype)
        if block is None:
            block = np.stack([tio.imread(p)[y0:y1, x0:x1] for p in paths])
        return block

    zpaths = stack.files[max(0, cz - t):cz + t]
    xy = read_block(zpaths, 0, h, 0, w).max(axis=0)
    xz = read_block(stack.files, max(0, cy - t), cy + t, 0, w).max(axis=1)
    yz = read_block(stack.files, 0, h, max(0, cx - t), cx + t).max(axis=2)
    return xy, xz, yz


def align_big_channels(ref_dir: Path, mov_dirs: Dict[str, Path],
                       max_iter: int = 10, thickness: int = 16,
                       log: Optional[Logger] = None, device=None
                       ) -> Dict[str, Tuple[int, int, int]]:
    """Streaming inter-channel offset estimation: ECC on streamed central
    sections (on `device`, else the resolved device), iterated with
    in-plane section rolls (reference process_big_images role).  Peak
    host memory = sections + one strip."""
    log = log or Logger()
    dev = resolve_device(device)
    secs_ref = central_sections_streamed(ref_dir, thickness)
    offsets: Dict[str, Tuple[int, int, int]] = {}
    for ch, d in mov_dirs.items():
        secs = list(central_sections_streamed(d, thickness))
        total = np.zeros(3, int)
        seen = set()
        for _ in range(max_iter):
            xy_r, xz_r, yz_r = secs_ref
            dy1, dx1 = _ecc_translation(xy_r, secs[0], dev)
            dz1, dx2 = _ecc_translation(xz_r, secs[1], dev)
            dz2, dy2 = _ecc_translation(yz_r, secs[2], dev)
            dz = int(round((dz1 + dz2) / 2.0))
            dy = int(round((dy1 + dy2) / 2.0))
            dx = int(round((dx1 + dx2) / 2.0))
            move = (-dz, -dy, -dx)
            if move == (0, 0, 0):
                break
            key = tuple(total + move)
            if key in seen:
                break
            seen.add(tuple(total))
            # roll each section by the axes it contains
            secs[0] = roll_pad(secs[0][None], (0, move[1], move[2]))[0]
            secs[1] = roll_pad(secs[1][None], (0, move[0], move[2]))[0]
            secs[2] = roll_pad(secs[2][None], (0, move[0], move[1]))[0]
            total += move
        offsets[ch] = tuple(int(v) for v in total)
        log.info(f"streamed alignment {ch}: offsets (dz, dy, dx) = "
                 f"{offsets[ch]}")
    return offsets


def write_aligned_series(mov_dir: Path, out_dir: Path,
                         offset: Tuple[int, int, int],
                         log: Optional[Logger] = None) -> Path:
    """Apply an integer (dz, dy, dx) offset to a TIFF series plane by
    plane (the reference's save_singles leg of process_single_big_image)."""
    from ..utils.tifstack import TifStack

    log = log or Logger()
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    stack = TifStack(mov_dir)
    dz, dy, dx = offset
    for z in range(stack.nz):
        zz = z - dz
        if 0 <= zz < stack.nz:
            img = stack[zz]
            if dy or dx:
                img = roll_pad(img[None].astype(img.dtype), (0, dy, dx))[0]
        else:
            img = np.zeros(stack.nyx, stack.dtype)
        tio.imwrite(out_dir / f"img_{z:06d}.tif", img)
    log.info(f"{stack.nz} aligned planes written to {out_dir}")
    return out_dir


def write_composite_series(
    channels: Dict[str, Path],
    colors: Dict[str, str],
    out_dir: Path,
    offsets: Optional[Dict[str, Tuple[int, int, int]]] = None,
    dtype=np.uint8,
    log: Optional[Logger] = None,
    right_bit_shifts: Optional[Dict[str, int]] = None,
    resume: bool = False,
    device=None,
) -> Path:
    """Merge per-channel TIFF series into multi-plane composites, applying
    integer offsets (reference merge_all_channels / generate_composite_image,
    process_images.py:860-1000).

    Colors may be RGB ("r"/"g"/"b" -> 3-plane composite) or CMYK
    ("c"/"m"/"y"/"k" -> 4-plane, the reference merge_channels.py:76-90
    surface); mixing the two spaces is an error.  ``right_bit_shifts``
    maps channel name -> bit shift and converts that channel to 8-bit
    before compositing (generate_composite_image right_bit_shifts,
    process_images.py:878-879).  The series length is the FIRST
    (reference) channel's plane count — shorter channels contribute
    zeros for their missing planes, as the reference does.  The 8-bit
    conversion runs on `device` (else the resolved device)."""
    log = log or Logger()
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    offsets = offsets or {}
    files = {ch: sorted(Path(p).glob("*.tif")) for ch, p in channels.items()}
    first = next(iter(files))
    depth = len(files[first])
    used = set(colors.get(ch, "g") for ch in channels)
    if used & set("cmyk"):
        if used & set("rgb"):
            raise ValueError("cannot mix RGB and CMYK channel colors")
        color_idx = {"c": 0, "m": 1, "y": 2, "k": 3}
        # the reference emits 3 planes for <=3 stacks and 4 only with a
        # key channel (generate_composite_image, process_images.py:894-903)
        n_planes = 4 if "k" in used else 3
    else:
        color_idx = {"r": 0, "g": 1, "b": 2}
        n_planes = 3
    if right_bit_shifts:
        # the reference's right_bit_shifts is a tuple zipped over ALL
        # channels (process_images.py:878) — a partial dict would blow
        # unconverted u16 channels out against the u8 clip
        missing = set(channels) - set(right_bit_shifts)
        if missing:
            raise ValueError(
                f"right_bit_shifts must cover every channel; missing "
                f"{sorted(missing)}")
        dtype = np.uint8
        dev = resolve_device(device)
    info = np.iinfo(dtype)
    # channels can stitch to slightly different plane sizes: center-pad
    # everything to the common max (reference pad_to_max,
    # align_images.py:366-374)
    shapes = [tio.imread(flist[0]).shape for flist in files.values()]
    max_h = max(s[0] for s in shapes)
    max_w = max(s[1] for s in shapes)

    def pad_to_max(img):
        ph = max_h - img.shape[0]
        pw = max_w - img.shape[1]
        if ph or pw:
            img = np.pad(img, ((ph // 2, ph - ph // 2),
                               (pw // 2, pw - pw // 2)))
        return img

    for z in range(depth):
        out_path = out_dir / f"composite_{z:06d}.tif"
        if resume and out_path.exists():
            # reference merge_channels.py --resume (default True there):
            # completed composite planes are skipped
            continue
        composite = np.zeros((max_h, max_w, n_planes), np.float32)
        for ch, flist in files.items():
            dz, dy, dx = offsets.get(ch, (0, 0, 0))
            zz = z - dz
            if not 0 <= zz < len(flist):
                continue
            img = tio.imread(flist[zz])
            if right_bit_shifts and ch in right_bit_shifts:
                img = np.asarray(HostArray(intensity.convert_to_8bit(
                    upload(img, dev), right_bit_shifts[ch])))
            img = pad_to_max(img.astype(np.float32))
            if dy or dx:
                img = roll_pad(img[None], (0, dy, dx))[0]
            composite[..., color_idx[colors.get(ch, "g")]] += img
        out = np.clip(composite, info.min, info.max).astype(dtype)
        tio.imwrite(out_path, out)
    log.info(f"{depth} composite planes written to {out_dir}")
    return out_dir


def _pad_to_shape(vol: np.ndarray, shape: Tuple[int, ...]) -> np.ndarray:
    """Center-pad with zeros to `shape` (reference align_images.py:103)."""
    if tuple(vol.shape) == tuple(shape):
        return vol
    pad = [(max(0, t - s) // 2, (max(0, t - s) + 1) // 2)
           for s, t in zip(vol.shape, shape)]
    return np.pad(vol, pad)


def _trim_to_shape(vol: np.ndarray, shape: Tuple[int, ...]) -> np.ndarray:
    """Center-crop to `shape` (reference align_images.py:111)."""
    if tuple(vol.shape) == tuple(shape):
        return vol
    sl = tuple(slice((s - t) // 2, s - ((s - t) + 1) // 2)
               for s, t in zip(vol.shape, shape))
    return vol[sl]


def build_parser():
    import argparse

    p = argparse.ArgumentParser(
        description="Align 3D channel images (reference align_images.py)")
    for name, short in (("red", "-r"), ("green", "-g"), ("blue", "-b")):
        p.add_argument(f"--{name}", short, nargs=2, default=[None, None],
                       metavar=("ORIGINAL", "DOWNSAMPLED"))
    p.add_argument("--output", "-o", required=True, type=Path)
    p.add_argument("--write_alignments", action="store_true")
    p.add_argument("--generate_ims", action="store_true")
    p.add_argument("--max_iterations", type=int, default=10)
    p.add_argument("--reference", default="red",
                   choices=["red", "green", "blue"])
    p.add_argument("--num_threads", type=int, default=8,
                   help="accepted for compatibility; plane IO is "
                        "threaded internally")
    p.add_argument("--save_singles", action="store_true")
    p.add_argument("--dtype", default="uint8",
                   choices=["uint8", "uint16", "uint32", "float32",
                            "float64"])
    p.add_argument("--dx", required=True, nargs=2, type=float,
                   metavar=("ORIG_UM", "DOWN_UM"))
    p.add_argument("--dy", required=True, nargs=2, type=float)
    p.add_argument("--dz", required=True, nargs=2, type=float)
    return p


def main(argv=None) -> int:
    """Standalone channel-alignment CLI — the reference align_images.py
    surface (align_images.py:716-756): per channel a pair of paths
    (ORIGINAL series dir, DOWNSAMPLED stack), ECC alignment on the
    downsampled volumes, aligned downsampled RGB (+ singles,
    alignments.txt), offsets scaled by the voxel ratios and applied to
    the original series, optional .ims exports."""
    args = build_parser().parse_args(argv)
    log = Logger()

    def _load(path):
        path = Path(path)
        if path.is_dir():
            from ..utils.tifstack import TifStack

            st = TifStack(path)
            return np.stack([st[z] for z in range(st.nz)])
        return np.asarray(tio.read_tiff_stack(path))

    pairs = {c: getattr(args, c) for c in ("red", "green", "blue")
             if getattr(args, c)[1] is not None}
    if args.reference not in pairs:
        log.error(f"--reference {args.reference} has no input pair")
        return 2
    down = {c: _load(d) for c, (_o, d) in pairs.items()}
    ref = args.reference
    dtype = np.dtype(args.dtype)

    # channels may be downsampled to slightly different shapes; the
    # reference center-pads all to a common shape before aligning and
    # trims the outputs back to the reference channel's original shape
    # (align_images.py:103-119 pad_to_shape/trim_to_shape, :624)
    ref_shape = down[ref].shape
    common = tuple(max(s) for s in zip(*(v.shape for v in down.values())))
    down = {c: _pad_to_shape(v, common) for c, v in down.items()}

    offsets = {c: (0, 0, 0) for c in pairs}
    aligned = dict(down)
    for c in pairs:
        if c == ref:
            continue
        aligned[c], offsets[c] = align_volumes(
            down[ref].astype(np.float32), down[c].astype(np.float32),
            max_iter=args.max_iterations, log=log)
        aligned[c] = aligned[c].astype(down[c].dtype)
    aligned = {c: _trim_to_shape(v, ref_shape) for c, v in aligned.items()}

    # aligned downsampled outputs: RGB composite (+ singles)
    down_dir = args.output / "downsampled"
    rgb_dir = down_dir / "RGB"
    rgb_dir.mkdir(parents=True, exist_ok=True)
    info = np.iinfo(dtype) if np.issubdtype(dtype, np.integer) else None
    depth = max(v.shape[0] for v in aligned.values())
    h = max(v.shape[1] for v in aligned.values())
    w = max(v.shape[2] for v in aligned.values())
    cidx = {"red": 0, "green": 1, "blue": 2}
    for z in range(depth):
        comp = np.zeros((h, w, 3), np.float32)
        for c, v in aligned.items():
            if z < v.shape[0]:
                comp[:v.shape[1], :v.shape[2], cidx[c]] = v[z]
        if info is not None:
            comp = np.clip(comp, info.min, info.max)
        tio.imwrite(rgb_dir / f"img_{z:06d}.tif", comp.astype(dtype))
    if args.save_singles:
        for c, v in aligned.items():
            d = down_dir / c
            d.mkdir(parents=True, exist_ok=True)
            for z in range(v.shape[0]):
                tio.imwrite(d / f"img_{z:06d}.tif", v[z])
    if args.write_alignments:
        with open(args.output / "alignments.txt", "w") as f:
            for c, off in offsets.items():
                f.write(f"{c}: dz,dy,dx = {off}\n")
        log.info(f"alignments -> {args.output / 'alignments.txt'}")

    # scale offsets to the original resolution and apply, streaming
    ratios = [o / d for o, d in (args.dz, args.dy, args.dx)]  # z, y, x
    orig_out = args.output / "original"
    orig_dirs = {}
    for c, (orig, _d) in pairs.items():
        if orig is None:
            continue
        # int() truncation, not round — the reference scales with
        # int(alignment / ratio) (align_images.py:668)
        scaled = tuple(int(offsets[c][i] / ratios[i]) for i in range(3))
        log.info(f"{c}: downsampled offsets {offsets[c]} -> original "
                 f"{scaled} (voxel ratios {ratios})")
        orig_dirs[c] = write_aligned_series(
            Path(orig), orig_out / c, scaled, log=log) \
            if scaled != (0, 0, 0) or args.save_singles else Path(orig)
    if orig_dirs:
        write_composite_series(
            {c: d for c, d in orig_dirs.items()},
            {c: c[0] for c in orig_dirs}, orig_out / "RGB",
            dtype=dtype if info is not None else np.uint16, log=log)

    if args.generate_ims:
        # the .ims writer is single-channel (Imaris5 Channel groups):
        # one .ims per aligned channel, colored accordingly — the
        # reference instead shells its converter at the RGB dir
        # (align_images.py:713-714)
        from ..io.ims import tif_series_to_imaris

        color = {"red": "Red", "green": "Green", "blue": "Blue"}
        for c, v in aligned.items():
            d = down_dir / c
            if not d.exists():
                d.mkdir(parents=True, exist_ok=True)
                for z in range(v.shape[0]):
                    tio.imwrite(d / f"img_{z:06d}.tif", v[z])
            out_ims = down_dir / f"{c}.ims"
            tif_series_to_imaris(d, out_ims,
                                 voxel_um=(args.dz[1], args.dy[1],
                                           args.dx[1]),
                                 channel_color=color[c])
            log.info(f"downsampled {c} .ims -> {out_ims}")
        for c, d in orig_dirs.items():
            if Path(d).exists():
                out_ims = orig_out / f"{c}.ims"
                tif_series_to_imaris(d, out_ims,
                                     voxel_um=(args.dz[0], args.dy[0],
                                               args.dx[0]),
                                     channel_color=color[c])
                log.info(f"original {c} .ims -> {out_ims}")
    return 0


if __name__ == "__main__":
    import sys as _sys

    _sys.exit(main())
