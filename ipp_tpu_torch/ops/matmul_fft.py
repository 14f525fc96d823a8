"""The FFT convolve walks (port of ipp_tpu/ops/mxu_fft.py MatmulFFT3:
`plan_shape`, `__init__`, the v2 walk `_fwd_packed_v2` / `_convolve_v2`,
the v1 walk `_fwd_packed` / `_stage` / `_cplx_last` / `convolve`, and
`otf_packed`).

**v2**, for work shapes inside the reference's kernel domain
(mxu_fft.py:321-323: x and z multiples of 256, y a multiple of 8 and at
most 2048, (kp * nz) % 512 == 0; `in_kernel_domain`).  A circular
convolution of a (nz, ny, nx) f32 volume runs as six kernel calls
(csrc/fft_walk.cu, wrappers in ops/cuda_fft.py):

    x (nz, ny, nx) -> K1 y rDFT -> (kp, nz, nx) -> K3 z -> K3 x   [spectrum]
    spectrum -> K4 (OTF product + inverse x) -> K3 inverse z -> K2 -> out

Volumes with leading batch dims (..., nz, ny, nx) take the batched forms
of K1, K2 and K4 (the reference's non-`t` kernels, chosen there whenever
`lead != ()`): the spectrum is (..., kp, nz, nx), K3 sees all blocks'
planes at once, and one unbatched OTF (kp, nz, nx) serves every block.

**v1**, for every other shape (mxu_fft.py:629-694).  The x axis is a
plain f32 matmul against the kxp-padded real DFT (`torch.matmul`, as the
reference leaves it to XLA); z and y are complex stages along the last
axis of a layout that cycles instead of being restored:

    x (..., z, y, x) -> matmul x -> (..., y, kxp, z) -> stage z
      -> (..., Z, kxp, y) -> stage y                            [spectrum]
    spectrum * OTF -> inverse stage y -> (..., y, kxp, Z)
      -> inverse stage z -> (..., z, y, kxp) -> matmul x^-1 -> out

A stage on an axis whose length is a multiple of 256, with the other
axis times kxp a multiple of 512 (mxu_fft.py:340-347, the reference's
rule, kept so that a JAX v1 OTF has the same layout), is a radix-2 stage:
K3 forward, K6 inverse, and K4 for the OTF product with the inverse y
stage.  Every other stage is the dense complex DFT, K7.  The layout moves
are contiguous copies.

On both walks the spectrum stays in the radix-2 permuted order along the
radix-2 axes (X[2k+s] at s*m + k, ipp_tpu/ops/pallas_fft.py:267-271), so
the OTF must come from the same walk: `otf_packed` runs the PSF through it.
An OTF from torch.fft fed to `convolve` would be silently wrong.  On CPU
tensors every kernel call takes its plain version.

`rfftn`, `irfftn` and `otf` are the reference's canonical transforms
(mxu_fft.py:499-527, 696-699): (..., nz, ny, nx) to (re, im) of shape
(..., nz, ny, kx) in natural frequency order and back, for any shape.  x
is a `torch.matmul` against the unpadded real-DFT matrices; y and z are the
dense DFT of the axis moved last, K7.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from . import cuda_fft
from .dft_mats import (cplx_triple, irdft_mats, rdft_mats, rfft_fold_mats,
                       rfft_x_mats, stage_mats_t)

__all__ = ["MatmulFFT3", "in_kernel_domain", "load_packed_otf", "plan_shape",
           "stage_axes"]

Pair = Tuple[torch.Tensor, torch.Tensor]
STAGE_ROWS = 512   # the reference's kernel row tile (pallas_fft.STAGE_TM)


def _kp(ny: int) -> int:
    """Sublane-padded half spectrum: round8(ny/2 + 1)."""
    return -(-(ny // 2 + 1) // 8) * 8


def plan_shape(shape: Sequence[int], psf_shape: Sequence[int]
               ) -> Tuple[int, ...]:
    """FFT work shape of the walks: block + PSF half-extents, rounded up to
    a multiple of 8, or to the next multiple of 128 when that is within 5%
    (mxu_fft.py:42-56)."""
    out = []
    for s, p in zip(shape, psf_shape):
        n = int(s) + int(p) // 2 * 2
        n8 = -(-n // 8) * 8
        n128 = -(-n // 128) * 128
        out.append(n128 if n128 <= n8 * 1.05 else n8)
    return tuple(out)


def in_kernel_domain(shape: Sequence[int]) -> bool:
    """True when a (nz, ny, nx) work shape can take the v2 walk."""
    nz, ny, nx = (int(s) for s in shape)
    return (nx % 256 == 0 and nz % 256 == 0 and nx > 0 and nz > 0
            and ny % 8 == 0 and 0 < ny <= 2048
            and (_kp(ny) * nz) % 512 == 0)


def stage_axes(shape: Sequence[int]) -> Tuple[bool, bool]:
    """(z, y): whether each axis of the v1 walk is a radix-2 stage axis
    (mxu_fft.py:340-347); the others take the dense DFT."""
    nz, ny, nx = (int(s) for s in shape)
    kxp = _kp(nx)
    return (nz % 256 == 0 and (ny * kxp) % STAGE_ROWS == 0,
            ny % 256 == 0 and (nz * kxp) % STAGE_ROWS == 0)


def load_packed_otf(re, im, device) -> Pair:
    """An OTF in a walk's packed layout, from numpy arrays — e.g. the
    reference's `MatmulFFT3.otf_packed` output, which uses the same layout
    on both walks — as f32 tensors on `device`."""
    return (torch.tensor(np.asarray(re, np.float32), device=device),
            torch.tensor(np.asarray(im, np.float32), device=device))


class MatmulFFT3:
    """The convolve walk for one (nz, ny, nx) work shape on one device: v2
    inside the kernel domain, v1 for any other shape."""

    def __init__(self, shape: Sequence[int], device):
        self.shape = tuple(int(s) for s in shape)
        if len(self.shape) != 3 or min(self.shape) < 1:
            raise ValueError(f"work shape {self.shape} is not 3-D")
        self.device = torch.device(device)
        self.v2 = in_kernel_domain(self.shape)
        self._canon = None   # constants of rfftn / irfftn, made on first use
        nz, ny, nx = self.shape
        dev = self._dev

        if self.v2:
            self.kp = _kp(ny)
            fwd, inv = rfft_fold_mats(ny, self.kp)
            self._rfwd, self._rinv = dev(fwd), dev(inv)
            self._z = {f: self._stage_mats(nz, f) for f in (True, False)}
            self._x = {f: self._stage_mats(nx, f) for f in (True, False)}
            return
        self.kxp = _kp(nx)
        fx, ix = rfft_x_mats(nx, self.kxp)
        self._fx, self._ix = dev(fx), dev(ix)
        # per axis: radix-2 stage matrices (M_s^T stacks) or the dense
        # Karatsuba triple, each for forward and inverse
        self._radix, self._dense = {}, {}
        for axis, n, radix in zip("zy", (nz, ny), stage_axes(self.shape)):
            for f in (True, False):
                if radix:
                    self._radix[axis, f] = self._stage_mats(n, f)
                else:
                    self._dense[axis, f] = tuple(
                        dev(m) for m in cplx_triple(n, f))

    def _dev(self, a) -> torch.Tensor:
        """A device copy (the cached numpy constants are read-only)."""
        return torch.tensor(a, device=self.device)

    def _stage_mats(self, n: int, forward: bool) -> Pair:
        """(mr_t, mi_t) of the radix-2 stage along an axis of length n on
        this plan's device; (None, None) on a CUDA device whose stage kernel
        there reads none (every `stage_route` but "dense"): at n = 12544
        the four would hold 1.26 GB."""
        if self.device.type == "cuda" and cuda_fft.stage_route(n) != "dense":
            return None, None
        return tuple(self._dev(m) for m in stage_mats_t(n, forward))

    # -- v2 --------------------------------------------------------------------

    def _fwd_v2(self, x: torch.Tensor, ratio_num=None) -> Pair:
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
            re, im = rfft(ratio_num.reshape(x.shape), self._rfwd, den=x,
                          fold=True)
        else:
            re, im = rfft(x, self._rfwd, fold=True)
        re, im = cuda_fft.radix2_stage(re.view(-1, nz, nx),
                                       im.view(-1, nz, nx), *self._z[True],
                                       True, 1)
        re, im = cuda_fft.radix2_stage(re.view(-1, nx), im.view(-1, nx),
                                       *self._x[True], True, -1)
        shape = lead + (self.kp, nz, nx)
        return re.view(shape), im.view(shape)

    def _convolve_v2(self, x, otf, conj, ratio_num, mul_abs) -> torch.Tensor:
        nz, ny, nx = self.shape
        re, im = self._fwd_v2(x, ratio_num)
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
                                       mul=mul_abs, fold=True)
        spec = (-1, self.kp, nz, nx)
        out = cuda_fft.rdft_y_inv_batched(
            rr.view(spec), ii.view(spec), self._rinv,
            mul=None if mul_abs is None else mul_abs.reshape(-1, nz, ny, nx),
            fold=True)
        return out.view(lead + (nz, ny, nx))

    # -- v1 --------------------------------------------------------------------

    def _stage(self, re: torch.Tensor, im: torch.Tensor, axis: str,
               forward: bool) -> Pair:
        """One complex DFT stage along the last axis of contiguous
        (..., n) tensors: K3 / K6 on a radix-2 axis, else K7
        (mxu_fft.py:480-491, `_cplx_last` :376-401)."""
        shape = re.shape
        n = shape[-1]
        re2, im2 = re.view(-1, n), im.view(-1, n)
        radix = self._radix.get((axis, forward))
        if radix is not None:
            rr, ii = cuda_fft.radix2_stage(re2, im2, *radix, forward, -1)
        else:
            rr, ii = cuda_fft.cplx_matmul(re2, im2,
                                          *self._dense[axis, forward],
                                          dft=forward)
        return rr.view(shape), ii.view(shape)

    def _fwd_v1(self, x: torch.Tensor) -> Pair:
        """(..., z, y, x) -> spectrum (..., Z, kxp, Y), Z and Y in radix-2
        permuted order on radix-2 axes; the padded frequencies kx..kxp-1
        are exactly zero."""
        both = torch.matmul(x, self._fx)                 # (..., z, y, 2kxp)
        k = self.kxp
        re = both[..., :k].movedim(-3, -1).contiguous()  # (..., y, k, z)
        im = both[..., k:].movedim(-3, -1).contiguous()
        re, im = self._stage(re, im, "z", True)
        re = re.transpose(-3, -1).contiguous()           # (..., Z, k, y)
        im = im.transpose(-3, -1).contiguous()
        return self._stage(re, im, "y", True)

    def _convolve_v1(self, x, otf, conj, ratio_num, mul_abs) -> torch.Tensor:
        if ratio_num is not None:
            x = ratio_num / torch.clamp(x, min=cuda_fft.EPS)
        re, im = self._fwd_v1(x)
        shape = re.shape
        ny = shape[-1]
        otf_re, otf_im = otf
        radix_y = self._radix.get(("y", False))
        if radix_y is not None:
            # OTF product + inverse y stage in one pass (K4); one block's
            # OTF serves a batch
            inv = (cuda_fft.radix2_stage_inv_otf_batched if len(shape) > 3
                   else cuda_fft.radix2_stage_inv_otf)
            rr, ii = inv(re.view(-1, ny), im.view(-1, ny),
                         otf_re.reshape(-1, ny), otf_im.reshape(-1, ny),
                         *radix_y, conj)
            rr, ii = rr.view(shape), ii.view(shape)
        else:
            o_im = -otf_im if conj else otf_im
            rr, ii = self._stage(re * otf_re - im * o_im,
                                 re * o_im + im * otf_re, "y", False)
        rr = rr.transpose(-3, -1).contiguous()           # (..., y, k, Z)
        ii = ii.transpose(-3, -1).contiguous()
        rr, ii = self._stage(rr, ii, "z", False)
        both = torch.cat([rr.movedim(-1, -3), ii.movedim(-1, -3)], -1)
        out = torch.matmul(both, self._ix)               # (..., z, y, x)
        return torch.abs(mul_abs * out) if mul_abs is not None else out

    # -- canonical layout --------------------------------------------------------

    def _canonical(self) -> dict:
        if self._canon is None:
            nz, ny, nx = self.shape
            fr, fi = rdft_mats(nx)
            ar, ai = irdft_mats(nx)
            self._canon = {
                "fx": self._dev(np.concatenate([fr, fi], 1)),    # (nx, 2kx)
                "ix": self._dev(np.concatenate([ar, -ai], 0)),   # (2kx, nx)
                **{(axis, f): tuple(self._dev(m) for m in cplx_triple(n, f))
                   for axis, n in ((-3, nz), (-2, ny)) for f in (True, False)}}
        return self._canon

    def _dft_axis(self, re: torch.Tensor, im: torch.Tensor, axis: int,
                  forward: bool) -> Pair:
        """The complex DFT along `axis` (-3 or -2) of (..., nz, ny, kx): the
        axis moved last, K7, and moved back (a view)."""
        re = re.transpose(axis, -1).contiguous()
        im = im.transpose(axis, -1).contiguous()
        shape = re.shape
        n = shape[-1]
        rr, ii = cuda_fft.cplx_matmul(re.view(-1, n), im.view(-1, n),
                                      *self._canonical()[axis, forward],
                                      dft=forward)
        return (rr.view(shape).transpose(axis, -1),
                ii.view(shape).transpose(axis, -1))

    def rfftn(self, x: torch.Tensor) -> Pair:
        """(..., nz, ny, nx) real -> (re, im) of shape (..., nz, ny, kx),
        kx = nx // 2 + 1, frequencies in natural order."""
        both = torch.matmul(x.to(self.device, torch.float32),
                            self._canonical()["fx"])
        kx = self.shape[2] // 2 + 1
        re, im = both[..., :kx], both[..., kx:]
        re, im = self._dft_axis(re, im, -2, True)
        re, im = self._dft_axis(re, im, -3, True)
        return re.contiguous(), im.contiguous()

    def irfftn(self, re: torch.Tensor, im: torch.Tensor) -> torch.Tensor:
        """(re, im) of shape (..., nz, ny, kx) -> real (..., nz, ny, nx)."""
        re, im = self._dft_axis(re, im, -3, False)
        re, im = self._dft_axis(re, im, -2, False)
        return torch.matmul(torch.cat([re, im], -1), self._canonical()["ix"])

    def otf(self, psf_rolled: torch.Tensor) -> Pair:
        """Forward transform of an origin-centred padded PSF in the
        canonical (nz, ny, kx) layout; `convolve` needs `otf_packed`."""
        return self.rfftn(psf_rolled)

    # -- public ------------------------------------------------------------------

    def otf_packed(self, psf_rolled: torch.Tensor) -> Pair:
        """OTF of an origin-centred padded PSF, in the walk's layout
        (f32 on both walks)."""
        x = psf_rolled.to(self.device, torch.float32).contiguous()
        return self._fwd_v2(x) if self.v2 else self._fwd_v1(x)

    def convolve(self, x: torch.Tensor, otf: Pair, conj: bool = False,
                 ratio_num=None, mul_abs=None) -> torch.Tensor:
        """Circular convolution irfftn(rfftn(x) * OTF) (conj: with the
        conjugate OTF, the adjoint).  With `ratio_num` the transformed
        volume is ratio_num / max(x, eps); with `mul_abs` the output is
        |mul_abs * conv| — together the fused RL update.  x may carry
        leading batch dims; the OTF is one block's (or as many blocks')."""
        walk = self._convolve_v2 if self.v2 else self._convolve_v1
        return walk(x, otf, conj, ratio_num, mul_abs)
