"""The v2 FFT convolve walk (port of ipp_tpu/ops/mxu_fft.py MatmulFFT3,
its v2 part: `__init__`, `_fwd_packed_v2`, `_convolve_v2`, `otf_packed`,
`convolve`).

A circular convolution of a (nz, ny, nx) f32 volume with an OTF runs as
six kernel calls (csrc/fft_walk.cu, wrappers in ops/cuda_fft.py):

    x (nz, ny, nx) -> K1 y rDFT -> (kp, nz, nx) -> K3 z -> K3 x   [spectrum]
    spectrum -> K4 (OTF product + inverse x) -> K3 inverse z -> K2 -> out

The spectrum stays in the radix-2 permuted order along z and x
(X[2k+s] at s*m + k, ipp_tpu/ops/pallas_fft.py:267-271), so the OTF must
come from the same walk: `otf_packed` runs the PSF through it.  An OTF from
torch.fft fed to `convolve` would be silently wrong.

Volumes with leading batch dims (..., nz, ny, nx) take the batched forms
of K1, K2 and K4 (the reference's non-`t` kernels, chosen there whenever
`lead != ()`): the spectrum is (..., kp, nz, nx), K3 sees all blocks'
planes at once, and one unbatched OTF (kp, nz, nx) serves every block.

The walk takes only shapes inside the kernel domain of the reference
(mxu_fft.py:321-323): x and z multiples of 256, y a multiple of 8 and at
most 2048, (kp * nz) % 512 == 0.  `in_kernel_domain` is the test; the
deconvolution module routes other shapes to torch.fft.  On CPU tensors
every kernel call takes its plain version.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from . import cuda_fft
from .dft_mats import rfft_fold_mats, stage_mats_t

__all__ = ["MatmulFFT3", "in_kernel_domain", "load_packed_otf"]

Pair = Tuple[torch.Tensor, torch.Tensor]


def _kp(ny: int) -> int:
    """Sublane-padded half spectrum: round8(ny/2 + 1)."""
    return -(-(ny // 2 + 1) // 8) * 8


def in_kernel_domain(shape: Sequence[int]) -> bool:
    """True when a (nz, ny, nx) work shape can take the kernel walk."""
    nz, ny, nx = (int(s) for s in shape)
    return (nx % 256 == 0 and nz % 256 == 0 and nx > 0 and nz > 0
            and ny % 8 == 0 and 0 < ny <= 2048
            and (_kp(ny) * nz) % 512 == 0)


def load_packed_otf(re, im, device) -> Pair:
    """An OTF in the walk's (kp, Z, X) permuted layout, from numpy arrays —
    e.g. the reference's `MatmulFFT3.otf_packed` output, which uses the
    same layout — as f32 tensors on `device`."""
    return (torch.tensor(np.asarray(re, np.float32), device=device),
            torch.tensor(np.asarray(im, np.float32), device=device))


class MatmulFFT3:
    """The convolve walk for one (nz, ny, nx) work shape on one device."""

    def __init__(self, shape: Sequence[int], device):
        self.shape = tuple(int(s) for s in shape)
        if not in_kernel_domain(self.shape):
            raise ValueError(f"work shape {self.shape} is outside the "
                             "kernel domain of the FFT walk")
        self.device = torch.device(device)
        nz, ny, nx = self.shape
        self.kp = _kp(ny)

        def dev(a):  # a copy: the cached numpy constants are read-only
            return torch.tensor(a, device=self.device)

        fwd, inv = rfft_fold_mats(ny, self.kp)
        self._rfwd, self._rinv = dev(fwd), dev(inv)
        self._z = {f: tuple(dev(m) for m in stage_mats_t(nz, f))
                   for f in (True, False)}
        self._x = {f: tuple(dev(m) for m in stage_mats_t(nx, f))
                   for f in (True, False)}

    def _fwd(self, x: torch.Tensor, ratio_num=None) -> Pair:
        """(..., nz, ny, nx) -> spectrum (..., kp, Z, X); with `ratio_num`
        the transform input is ratio_num / max(x, eps), formed inside K1.
        A leading batch takes K1's batched form."""
        nz, ny, nx = self.shape
        lead = tuple(x.shape[:-3])
        rfft = cuda_fft.rdft_y_fwd
        if lead:
            rfft = cuda_fft.rdft_y_fwd_batched
            x = x.reshape(-1, nz, ny, nx)
        if ratio_num is not None:
            re, im = rfft(ratio_num.reshape(x.shape), self._rfwd, den=x)
        else:
            re, im = rfft(x, self._rfwd)
        re, im = cuda_fft.radix2_stage(re.view(-1, nz, nx),
                                       im.view(-1, nz, nx), *self._z[True],
                                       True, 1)
        re, im = cuda_fft.radix2_stage(re.view(-1, nx), im.view(-1, nx),
                                       *self._x[True], True, -1)
        shape = lead + (self.kp, nz, nx)
        return re.view(shape), im.view(shape)

    def otf_packed(self, psf_rolled: torch.Tensor) -> Pair:
        """OTF of an origin-centred padded PSF, in the walk's layout."""
        return self._fwd(psf_rolled.to(self.device, torch.float32)
                         .contiguous())

    def convolve(self, x: torch.Tensor, otf: Pair, conj: bool = False,
                 ratio_num=None, mul_abs=None) -> torch.Tensor:
        """Circular convolution irfftn(rfftn(x) * OTF) (conj: with the
        conjugate OTF, the adjoint).  With `ratio_num` the transformed
        volume is ratio_num / max(x, eps); with `mul_abs` the output is
        |mul_abs * conv| — together the fused RL update.  x may carry
        leading batch dims; the OTF is one block's (or as many blocks')."""
        nz, ny, nx = self.shape
        re, im = self._fwd(x, ratio_num)
        lead = tuple(re.shape[:-3])
        otf_re, otf_im = otf
        inv_x = (cuda_fft.radix2_stage_inv_otf_batched if lead
                 else cuda_fft.radix2_stage_inv_otf)
        rr, ii = inv_x(re.view(-1, nx), im.view(-1, nx),
                       otf_re.reshape(-1, nx), otf_im.reshape(-1, nx),
                       *self._x[False], conj)
        rr, ii = cuda_fft.radix2_stage(rr.view(-1, nz, nx),
                                       ii.view(-1, nz, nx), *self._z[False],
                                       False, 1)
        if not lead:
            return cuda_fft.rdft_y_inv(rr.view(self.kp, nz, nx),
                                       ii.view(self.kp, nz, nx), self._rinv,
                                       mul=mul_abs)
        spec = (-1, self.kp, nz, nx)
        out = cuda_fft.rdft_y_inv_batched(
            rr.view(spec), ii.view(spec), self._rinv,
            mul=None if mul_abs is None else mul_abs.reshape(-1, nz, ny, nx))
        return out.view(lead + (nz, ny, nx))
