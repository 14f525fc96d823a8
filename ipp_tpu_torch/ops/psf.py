"""Theoretical light-sheet PSF generator.

Port of the reference's optics model (LsDeconvolveMultiGPU/LsMakePSF.m:1-114
and psf_generator.py): widefield objective PSF (Born-Wolf Bessel integral)
multiplied by the cylinder-lens excitation sheet profile; the grid size is
derived from the FWHMs; only the first octant is sampled and mirrored.

Host-side numpy/scipy — the PSF is tiny (typically < 100^3) and computed
once per run.

A copy of ipp_tpu/ops/psf.py: the original cannot be imported without jax
(ipp_tpu/ops/__init__.py imports ops/deconv.py).  tests/test_torch_dft_mats.py
pins it bit-equal to the original.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
from scipy.integrate import quad
from scipy.optimize import brentq
from scipy.special import j0

__all__ = ["make_psf", "psf_value", "gaussian_psf"]


def _psf_integral(x: float, y: float, z: float, NA: float, n: float,
                  wavelength: float) -> float:
    """4 * |integral_0^1 J0(2 pi NA r p / (lambda n)) exp(-i pi p^2 z NA^2 /
    (lambda n^2)) p dp|^2  (reference LsMakePSF.m:100-113)."""
    r = math.hypot(x, y)
    k_r = 2.0 * math.pi * NA * r / (wavelength * n)
    k_z = math.pi * z * NA ** 2 / (wavelength * n ** 2)

    def re_im(p, sign):
        return j0(k_r * p) * (math.cos(-k_z * p * p) if sign == 0
                              else math.sin(-k_z * p * p)) * p

    re, _ = quad(lambda p: re_im(p, 0), 0.0, 1.0, epsabs=1e-3)
    im, _ = quad(lambda p: re_im(p, 1), 0.0, 1.0, epsabs=1e-3)
    return 4.0 * (re * re + im * im)


def psf_value(x: float, y: float, z: float, NA_obj: float, n: float,
              lambda_ex: float, lambda_em: float, NA_ls: float) -> float:
    """Light-sheet PSF at (x, y, z): excitation sheet (propagating along x,
    confined in z) times emission PSF (reference LsPSFeq, LsMakePSF.m:95-98)."""
    return (_psf_integral(z, 0.0, x, NA_ls, n, lambda_ex)
            * _psf_integral(x, y, z, NA_obj, n, lambda_em))


def _mirror8(oct_: np.ndarray) -> np.ndarray:
    """Mirror the first octant to the full symmetric PSF
    (reference mirror8, LsMakePSF.m:66-93)."""
    sx = 2 * oct_.shape[0] - 1
    sy = 2 * oct_.shape[1] - 1
    sz = 2 * oct_.shape[2] - 1
    cx, cy, cz = oct_.shape[0] - 1, oct_.shape[1] - 1, oct_.shape[2] - 1
    out = np.zeros((sx, sy, sz), np.float32)
    out[cx:, cy:, cz:] = oct_
    out[cx:, :cy + 1, cz:] = oct_[:, ::-1, :]
    out[:cx + 1, :cy + 1, cz:] = oct_[::-1, ::-1, :]
    out[:cx + 1, cy:, cz:] = oct_[::-1, :, :]
    out[cx:, cy:, :cz + 1] = oct_[:, :, ::-1]
    out[cx:, :cy + 1, :cz + 1] = oct_[:, ::-1, ::-1]
    out[:cx + 1, :cy + 1, :cz + 1] = oct_[::-1, ::-1, ::-1]
    out[:cx + 1, cy:, :cz + 1] = oct_[::-1, :, ::-1]
    return out


def make_psf(dxy: float, dz: float, NA: float = 0.4, n: float = 1.45,
             lambda_ex: float = 488.0, lambda_em: float = 525.0,
             fcyl: float = 80000.0, slitwidth: float = 12000.0,
             sample_at_data_pitch: bool = False,
             ) -> Tuple[np.ndarray, float, float]:
    """Build the (x, y, z) PSF volume; returns (psf, FWHM_xy, FWHM_z).

    All lengths in nanometers (reference LsMakePSF.m:1-64).  The returned
    array is normalized to unit sum and laid out (nx, ny, nz) like the
    reference (callers transpose to (z, y, x) as needed).

    The xy sampling pitch defaults to the REFERENCE's convention: LsDeconv
    clamps it to a third of the diffraction limit (dxy_corr = min(dxy,
    Rxy/3), LsDeconv.m:161) and passes THAT into LsMakePSF, so when the
    camera pixel is coarser than Rxy/3 the PSF is sampled finer than the
    image grid and the direct convolution sees a correspondingly narrower
    kernel in pixel units — that is the behavior its published results
    carry, so it is the default here.  ``sample_at_data_pitch=True``
    samples (and sizes) the grid at the true voxel pitch instead — the
    equivalent of pycudadecon's OTF-to-data-grid resampling that the
    reference's FNT path relies on (fnt_cube_processor.py:201-222, dxpsf
    passed separately from dxdata).
    """
    NA_ls = math.sin(math.atan(0.5 * slitwidth / fcyl))
    halfmax = 0.5 * psf_value(0, 0, 0, NA, n, lambda_ex, lambda_em, NA_ls)

    def fxy(x):
        return psf_value(x, 0, 0, NA, n, lambda_ex, lambda_em, NA_ls) - halfmax

    def fz(z):
        return psf_value(0, 0, z, NA, n, lambda_ex, lambda_em, NA_ls) - halfmax

    def find_zero(f):
        hi = 100.0
        while f(hi) > 0 and hi < 1e7:
            hi *= 2
        return brentq(f, 1e-3, hi, xtol=1e-2)

    fwhm_xy = 2.0 * abs(find_zero(fxy))
    fwhm_z = 2.0 * abs(find_zero(fz))

    Rxy = 0.61 * lambda_em / NA
    pitch = dxy if sample_at_data_pitch else min(dxy, Rxy / 3.0)
    nxy = math.ceil(2.0 * fwhm_xy / pitch)
    nz = math.ceil(2.0 * fwhm_z / dz)
    nxy += (nxy + 1) % 2  # force odd
    nz += (nz + 1) % 2

    hx = (nxy - 1) // 2 + 1
    hz = (nz - 1) // 2 + 1
    oct_ = np.zeros((hx, hx, hz), np.float32)
    for k in range(hz):
        for j in range(hx):
            for i in range(hx):
                oct_[i, j, k] = psf_value(i * pitch, j * pitch, k * dz, NA, n,
                                          lambda_ex, lambda_em, NA_ls)
    psf = _mirror8(oct_)
    psf /= psf.sum()
    return psf, fwhm_xy, fwhm_z


def gaussian_psf(shape: Tuple[int, int, int], sigma: Tuple[float, float, float]
                 ) -> np.ndarray:
    """Synthetic separable gaussian PSF (odd dims), unit sum — used by tests
    and the BASELINE config-3 benchmark."""
    grids = []
    for npix, s in zip(shape, sigma):
        assert npix % 2 == 1
        x = np.arange(npix) - npix // 2
        grids.append(np.exp(-0.5 * (x / s) ** 2))
    psf = grids[0][:, None, None] * grids[1][None, :, None] * grids[2][None, None, :]
    return (psf / psf.sum()).astype(np.float32)
