"""Wrappers of the FFT-walk CUDA kernels, each beside its plain version.

One wrapper per kernel form of `csrc/fft_walk.cu`, `csrc/stage_fft.cuh`,
`csrc/dft_fft.cuh`, `csrc/rdft_y.cuh`, `csrc/rdft_dense.cu` and
`csrc/cplx_dense.cu`; together they replace the eleven Pallas entry points
of the reference's v2 convolve walk (ipp_tpu/ops/pallas_fft.py), unbatched
(v2-t) and batched, and the two of its v1 walk
(`_fused_stage_call(forward=False)`, `_fused_call`):

| wrapper                        | kernel | Pallas entry points replaced        |
|--------------------------------|--------|-------------------------------------|
| `rdft_y_fwd`                   | K1     | `_v2_rfft_call_t`, `_v2_rfft_ratio_call_t` |
| `rdft_y_inv`                   | K2     | `_v2_irfft_call_t`, `_v2_irfft_mul_call_t` |
| `radix2_stage`                 | K3     | `_v2_stage_call` (fwd, inv), `fused_stage` |
| `radix2_stage_inv_otf`         | K4     | `fused_stage_inv_otf`               |
| `rdft_y_fwd_batched`           | K1     | `_v2_rfft_call`, `_v2_rfft_ratio_call` |
| `rdft_y_inv_batched`           | K2     | `_v2_irfft_call`, `_v2_irfft_mul_call` |
| `radix2_stage_inv_otf_batched` | K4     | `fused_stage_inv_otf` with one OTF wrapped over a batch |
| `radix2_stage(axis=-1, forward=False)` | K6 | `_fused_stage_call(forward=False)` |
| `cplx_matmul`                  | K7     | `fused_cplx_matmul` -> `_fused_call`|

The batched forms take a batch of nb volumes (nb, nz, ny, nx) and keep
each block's spectrum kp-major, (nb, kp, nz, nx), where the TPU kernels
wrote plane-major (nb*nz, kp, nx) and paid an XLA transpose each side of
the z stage (csrc/fft_walk.cu says why CUDA need not).  K3 needs no
batched form: it already takes any number of planes or rows.

The radix-2 stages (K3, K4, K4b, K6) have four kernels each, chosen by
the axis length n alone (`stage_route`): the FFT kernels of
csrc/stage_fft.cuh, whose plans are fixed at compile time, for n in
`STAGE_FFT_LENGTHS` (256 * j up to 2048); the mixed-radix FFT kernel of
csrc/stage_mixed.cuh, whose plan `dft_fft_plan(n)` is passed at run time,
for every other multiple of 128 up to `DFT_FFT_MAX_N` (12288); the
large-axis FFT kernel of csrc/stage_large.cuh (one radix-2 step and two
n/2-point FFTs, in one pass or two, plan `stage_large_plan`) above that;
and the dense stage kernels of csrc/fft_walk.cu (a butterfly and two
(n/2)^2 complex products) for a length with no such plan.  It is a route
by shape: nothing is caught and retried.  Only the dense kernels read the
stage matrices: on the card the others take None for them.

K7 has three kernels.  Every call the walks make multiplies by the dense
DFT matrix of an axis, `cplx_triple(n, forward)`, and says so with `dft=`:
then the function is the n-point DFT along the last axis, and for n a
multiple of 8 up to `DFT_FFT_MAX_N` (`dft_route`) the mixed-radix FFT
kernel of csrc/dft_fft.cuh computes it without reading the matrices, for
a multiple of 64 above that the large-axis kernel in natural order.  An
arbitrary matrix (`dft=None`) and every other length take the dense
Karatsuba kernel of csrc/cplx_dense.cu (f32-grade, three TF32 products a
real product on the tensor cores; any M, K, N and alignment), counted as
`cplx_matmul_dense`.

K1 and K2 (and their batched forms) have two kernels as well.  Every call
the walk makes multiplies by the real-DFT fold of the y axis,
`rfft_fold_mats(ny, kp)`, and says so with `fold=True`: then the function
is the ny-point real DFT along y (or its inverse), and for ny a multiple of
8 up to `RDFT_FFT_MAX_NY` and an even nx (`rdft_route`) the real-FFT kernels
of csrc/rdft_y.cuh compute it without reading the matrix.  Any other matrix
(`fold=False`) and every other shape take the dense GEMM kernels of
csrc/rdft_dense.cu (f32-grade, three TF32 products on the tensor cores;
any matrix, shape and alignment), counted with `_dense` appended.

Rules every wrapper keeps:
- a CPU tensor goes to the plain PyTorch version (`*_plain`, the same
  function written with `torch.matmul`); a CUDA tensor launches the kernel
  or raises — there is no fallback;
- device, dtype (f32), shape and contiguity are checked before a launch,
  and the C function's cudaGetLastError() is checked after it;
- `LAUNCHES[name]` counts kernel launches (never plain calls), so a run
  can show that its main path went through the kernels; the batched
  forms and K6 (`radix2_stage_inv_last`) count under their own names
  (both FFT kernels of a stage form under one), and a launch of a dense
  stage kernel under its name with `_dense` appended; `ENTRY_LAUNCHES`
  counts the same launches by C entry point, so a run can show which
  stage kernel it went through (`ipp_stage_mixed` for the mixed-radix
  one, `ipp_stage_large` for the large-axis one, K7's above 12288 too);
  `cplx_matmul` counts K7's FFT kernel, `cplx_matmul_dense` its dense one;
  `rdft_y_*` count the real-FFT kernels, `rdft_y_*_dense` the dense GEMMs.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .dft_mats import (DFT_FFT_MAX_N, DFT_FFT_RADICES, STAGE_FFT_LENGTHS,
                       dft_fft_plan, stage_large_plan, stage_twiddles)

__all__ = ["LAUNCHES", "ENTRY_LAUNCHES", "reset_launch_counts", "stage_route",
           "dft_route", "rdft_route", "RDFT_FFT_MAX_NY", "rdft_y_fwd_fft",
           "rdft_y_inv_fft", "rdft_y_fwd", "rdft_y_fwd_batched", "rdft_y_fwd_plain", "rdft_y_inv",
           "rdft_y_inv_batched", "rdft_y_inv_plain", "radix2_stage",
           "radix2_stage_plain", "radix2_stage_inv_otf",
           "radix2_stage_inv_otf_batched", "radix2_stage_inv_otf_plain",
           "cplx_matmul", "cplx_matmul_plain", "dft_last_fft",
           "stage_mixed", "stage_large", "stage_dense"]

EPS = float(np.finfo(np.float32).eps)
_GRID_MAX = 65535  # gridDim.y / gridDim.z limit
_BN = 64           # the kernels' column tile (csrc/fft_walk.cuh BN)

LAUNCHES: Dict[str, int] = {
    "rdft_y_fwd": 0, "rdft_y_inv": 0, "radix2_stage": 0,
    "radix2_stage_inv_otf": 0, "rdft_y_fwd_batched": 0,
    "rdft_y_inv_batched": 0, "radix2_stage_inv_otf_batched": 0,
    "radix2_stage_inv_last": 0, "cplx_matmul": 0,
    "radix2_stage_dense": 0, "radix2_stage_inv_otf_dense": 0,
    "radix2_stage_inv_otf_batched_dense": 0,
    "radix2_stage_inv_last_dense": 0, "cplx_matmul_dense": 0,
    "rdft_y_fwd_dense": 0, "rdft_y_inv_dense": 0,
    "rdft_y_fwd_batched_dense": 0, "rdft_y_inv_batched_dense": 0}

# the same launches by C entry point ("ipp_stage_mixed", "ipp_dft_last",
# ...): which kernel ran where one counter name covers two
ENTRY_LAUNCHES: Dict[str, int] = {}

Pair = Tuple[torch.Tensor, torch.Tensor]


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    ENTRY_LAUNCHES.clear()


# -- plain versions (CPU path, and the reference on the card) ---------------

def rdft_y_fwd_plain(x: torch.Tensor, fwd: torch.Tensor,
                     den: Optional[torch.Tensor] = None) -> Pair:
    """(..., nz, ny, nx) -> re, im (..., kp, nz, nx): the y real DFT
    against the stacked fold fwd (2kp, ny), each block's spectrum
    kp-major; with `den`, of x / max(den, eps)."""
    if den is not None:
        x = x / torch.clamp(den, min=EPS)
    y = torch.matmul(fwd, x)                      # (..., nz, 2kp, nx)
    kp = fwd.shape[0] // 2
    return (y[..., :kp, :].transpose(-3, -2).contiguous(),
            y[..., kp:, :].transpose(-3, -2).contiguous())


def rdft_y_inv_plain(re: torch.Tensor, im: torch.Tensor, inv: torch.Tensor,
                     mul: Optional[torch.Tensor] = None) -> torch.Tensor:
    """re, im (..., kp, nz, nx) -> (..., nz, ny, nx): the inverse y real
    DFT through the Hermitian fold inv (ny, 2kp); with `mul`, |mul * y|."""
    both = torch.cat([re, im], -3).transpose(-3, -2)  # (..., nz, 2kp, nx)
    y = torch.matmul(inv, both)
    return torch.abs(mul * y) if mul is not None else y


def _cmm(ar, ai, br, bi) -> Pair:
    return ar @ br - ai @ bi, ar @ bi + ai @ br


def radix2_stage_plain(re: torch.Tensor, im: torch.Tensor,
                       mr_t: torch.Tensor, mi_t: torch.Tensor,
                       forward: bool, axis: int) -> Pair:
    """Radix-2 DIF complex DFT stage along the middle axis of (P, n, X)
    (axis=1) or the last axis of (R, n) (axis=-1): the butterfly plus four
    real matmuls per half.  mr_t, mi_t: (2, m, m) stacks of M_s^T."""
    if axis == -1:
        re, im = re.transpose(0, 1), im.transpose(0, 1)   # (n, R) views
    m = re.shape[-2] // 2
    a_r, b_r = re[..., :m, :], re[..., m:, :]
    a_i, b_i = im[..., :m, :], im[..., m:, :]
    if forward:
        v0 = _cmm(mr_t[0], mi_t[0], a_r + b_r, a_i + b_i)
        v1 = _cmm(mr_t[1], mi_t[1], a_r - b_r, a_i - b_i)
        rr = torch.cat([v0[0], v1[0]], -2)
        ii = torch.cat([v0[1], v1[1]], -2)
    else:
        v0 = _cmm(mr_t[0], mi_t[0], a_r, a_i)
        v1 = _cmm(mr_t[1], mi_t[1], b_r, b_i)
        rr = torch.cat([(v0[0] + v1[0]) * 0.5, (v0[0] - v1[0]) * 0.5], -2)
        ii = torch.cat([(v0[1] + v1[1]) * 0.5, (v0[1] - v1[1]) * 0.5], -2)
    if axis == -1:
        rr, ii = rr.transpose(0, 1), ii.transpose(0, 1)
    return rr.contiguous(), ii.contiguous()


def radix2_stage_inv_otf_plain(re: torch.Tensor, im: torch.Tensor,
                               otf_re: torch.Tensor, otf_im: torch.Tensor,
                               mr_t: torch.Tensor, mi_t: torch.Tensor,
                               conj: bool) -> Pair:
    """(re + i*im) * (otf_re +/- i*otf_im), then the inverse stage along
    the last axis of (R, n).  The OTF has R or fewer rows: data row r
    takes OTF row r % orows (one block's OTF serves a batch)."""
    rows, n = re.shape
    o_r = otf_re
    o_i = -otf_im if conj else otf_im
    shape = (rows // o_r.shape[0],) + tuple(o_r.shape)
    a_r, a_i = re.reshape(shape), im.reshape(shape)
    xr = (a_r * o_r - a_i * o_i).reshape(rows, n)
    xi = (a_r * o_i + a_i * o_r).reshape(rows, n)
    return radix2_stage_plain(xr, xi, mr_t, mi_t, False, -1)


def cplx_matmul_plain(re: torch.Tensor, im: torch.Tensor, mr: torch.Tensor,
                      mi: torch.Tensor, mri: torch.Tensor) -> Pair:
    """(re + i*im) @ (mr + i*mi) for (M, K) data and (K, N) matrices as
    Karatsuba's three real products (mri = mr + mi): t1 = re @ mr,
    t2 = im @ mi, t3 = (re + im) @ mri; rr = t1 - t2, ii = t3 - t1 - t2
    (mxu_fft.py:391-401)."""
    t1 = torch.matmul(re, mr)
    t2 = torch.matmul(im, mi)
    t3 = torch.matmul(re + im, mri)
    return t1 - t2, t3 - t1 - t2


# -- launch plumbing ---------------------------------------------------------

def _lib():
    from ._build import load_library

    return load_library()


def _on_cuda(name: str, *tensors: Optional[torch.Tensor]) -> bool:
    """False for CPU tensors (plain path); True for CUDA tensors that the
    kernel takes; raises for anything else."""
    ts = [t for t in tensors if t is not None]
    dev = ts[0].device
    if dev.type == "cpu" and all(t.device.type == "cpu" for t in ts):
        return False
    for t in ts:
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"{name}: all tensors must be on one CUDA "
                             f"device (got {[str(u.device) for u in ts]})")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: float32 only (got {t.dtype})")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
    return True


def _shape(name: str, t: torch.Tensor, shape) -> None:
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")


def _ndim(name: str, t: torch.Tensor, ndim: int, what: str) -> None:
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {what}, got shape "
                         f"{tuple(t.shape)}")


def _grid(name: str, what: str, n: int) -> None:
    if n > _GRID_MAX:
        raise ValueError(f"{name}: {what}={n} exceeds the grid limit "
                         f"{_GRID_MAX}")


# one lock for every launch count: the mesh paths launch from one thread
# per device, and `counts[name] += 1` is a read and a write
_COUNT_LOCK = threading.Lock()


def _launch(name: str, device: torch.device, fn, *args,
            counts: Optional[Dict[str, int]] = None,
            kernels: int = 1) -> None:
    """Launch on the current stream of `device`, raise on a refused
    launch, then count it in `counts` (default: this module's LAUNCHES),
    `kernels` launches where the entry launches that many kernels."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed, "
                           f"cudaGetLastError() = {err}")
    with _COUNT_LOCK:
        (LAUNCHES if counts is None else counts)[name] += kernels
        if counts is None:
            ENTRY_LAUNCHES[fn.__name__] = ENTRY_LAUNCHES.get(fn.__name__,
                                                             0) + kernels


def _empty(shape, like: torch.Tensor) -> torch.Tensor:
    return torch.empty(shape, dtype=torch.float32, device=like.device)


# -- wrappers ----------------------------------------------------------------

RDFT_FFT_MAX_NY = 2048   # csrc/rdft_y.cuh MAX_NY: the v2 walk's domain


def rdft_route(ny: int, nx: int) -> str:
    """Which kernel K1 / K2 launch on the card for the y real DFT of
    (..., ny, nx) volumes when the caller states `fold=True`: "fft"
    (csrc/rdft_y.cuh) for ny a multiple of 8 up to `RDFT_FFT_MAX_NY` (the v2
    walk's whole domain; two shared-memory buffers of a tile's columns fit)
    and an even nx (two neighbouring columns share one complex transform and
    move as one 8-byte value), "dense" (csrc/rdft_dense.cu) for any other
    shape.  By shape alone: nothing is caught and retried."""
    return ("fft" if ny >= 8 and ny % 8 == 0 and ny <= RDFT_FFT_MAX_NY
            and nx >= 2 and nx % 2 == 0 else "dense")


def _fold_ok(name: str, mat: torch.Tensor, shape, ny: int, kp: int,
             fold: bool) -> None:
    """The matrix has the fold's shape; a stated fold also has room for the
    half spectrum."""
    _shape(name, mat, shape)
    if fold and kp < ny // 2 + 1:
        raise ValueError(f"{name}: fold=True needs kp >= ny/2 + 1 = "
                         f"{ny // 2 + 1} rows for ny={ny}, got kp={kp}")


def _aligned(name: str, *tensors: Optional[torch.Tensor]) -> None:
    for t in tensors:
        if t is not None and t.data_ptr() % 8:
            raise ValueError(f"{name}: the real-FFT kernel moves column "
                             f"pairs as 8-byte values and needs 8-byte "
                             f"aligned tensors")


def rdft_y_fwd_fft(x: torch.Tensor, kp: int,
                   den: Optional[torch.Tensor] = None,
                   name: str = "rdft_y_fwd_batched",
                   threads_per_pair: int = 0, pairs: int = 0) -> Pair:
    """K1's real-FFT kernel on (nb, nz, ny, nx) CUDA volumes -> re, im
    (nb, kp, nz, nx), counted under `name`.  `threads_per_pair` and `pairs`
    (column pairs a block, a power of two) override the kernel's geometry:
    a bench's knobs; 0 and 0 keep its own."""
    _ndim(name, x, 4, "(nb, nz, ny, nx)")
    nb, nz, ny, nx = x.shape
    if (not _on_cuda(name, x, den) or rdft_route(ny, nx) != "fft"
            or kp < ny // 2 + 1 or x.numel() == 0):
        raise ValueError(f"{name}: the real-FFT kernel takes CUDA volumes "
                         f"with rdft_route(ny, nx) == 'fft' and kp >= ny/2 + "
                         f"1; got {tuple(x.shape)}, kp={kp} on {x.device}")
    if den is not None:
        _shape(name, den, x.shape)
    _aligned(name, x, den)
    re, im = _empty((nb, kp, nz, nx), x), _empty((nb, kp, nz, nx), x)
    radices, npass, generic = _dft_plan(dft_fft_plan(ny))
    _launch(name, x.device, _lib().ipp_rdft_y_fwd_fft, x.data_ptr(),
            den.data_ptr() if den is not None else None,
            _stage_twiddles(x.device, ny).data_ptr(), re.data_ptr(),
            im.data_ptr(), nb, nz, ny, nx, kp, npass, radices, generic,
            threads_per_pair, pairs)
    return re, im


def rdft_y_inv_fft(re: torch.Tensor, im: torch.Tensor, ny: int,
                   mul: Optional[torch.Tensor] = None,
                   name: str = "rdft_y_inv_batched",
                   threads_per_pair: int = 0,
                   pairs: int = 0) -> torch.Tensor:
    """K2's real-FFT kernel on (nb, kp, nz, nx) CUDA spectra ->
    (nb, nz, ny, nx), counted under `name`; the knobs as `rdft_y_fwd_fft`."""
    _ndim(name, re, 4, "(nb, kp, nz, nx)")
    nb, kp, nz, nx = re.shape
    if (not _on_cuda(name, re, im, mul) or rdft_route(ny, nx) != "fft"
            or kp < ny // 2 + 1 or re.numel() == 0):
        raise ValueError(f"{name}: the real-FFT kernel takes CUDA spectra "
                         f"with rdft_route(ny, nx) == 'fft' and kp >= ny/2 + "
                         f"1; got {tuple(re.shape)}, ny={ny} on {re.device}")
    _shape(name, im, re.shape)
    if mul is not None:
        _shape(name, mul, (nb, nz, ny, nx))
    _aligned(name, re, im, mul)
    out = _empty((nb, nz, ny, nx), re)
    radices, npass, generic = _dft_plan(dft_fft_plan(ny))
    _launch(name, re.device, _lib().ipp_rdft_y_inv_fft, re.data_ptr(),
            im.data_ptr(), _stage_twiddles(re.device, ny).data_ptr(),
            mul.data_ptr() if mul is not None else None, out.data_ptr(),
            nb, nz, ny, nx, kp, npass, radices, generic, threads_per_pair,
            pairs)
    return out


def _rdft_y_fwd(name: str, x: torch.Tensor, fwd: torch.Tensor,
                den: Optional[torch.Tensor], fold: bool) -> Pair:
    """K1 on (nb, nz, ny, nx) CUDA tensors -> (nb, kp, nz, nx) each: the
    real-FFT kernel for a stated fold on its route, else the dense GEMM."""
    nb, nz, ny, nx = x.shape
    kp = fwd.shape[0] // 2
    if den is not None:
        _shape(name, den, x.shape)
    if fold and rdft_route(ny, nx) == "fft":
        return rdft_y_fwd_fft(x, kp, den, name)
    _grid(name, "nb*nz", nb * nz)
    re, im = _empty((nb, kp, nz, nx), x), _empty((nb, kp, nz, nx), x)
    _launch(name + "_dense", x.device, _lib().ipp_rdft_y_fwd, x.data_ptr(),
            den.data_ptr() if den is not None else None, fwd.data_ptr(),
            re.data_ptr(), im.data_ptr(), nb, nz, ny, nx, kp)
    return re, im


def rdft_y_fwd(x: torch.Tensor, fwd: torch.Tensor,
               den: Optional[torch.Tensor] = None,
               fold: bool = False) -> Pair:
    """K1 on one volume (nz, ny, nx) -> (kp, nz, nx): see
    `rdft_y_fwd_plain`.  `fold=True` is the caller's statement that `fwd` is
    `rfft_fold_mats(ny, kp)[0]`, the real-DFT fold of the axis; its shape
    (2kp, ny) with kp >= ny/2 + 1 is checked, its values are not.  On the
    card the shape then chooses the kernel (`rdft_route`): the real-FFT
    kernel, which does not read the matrix, or the dense GEMM, which also
    serves any matrix with `fold=False` and counts with `_dense` appended."""
    name = "rdft_y_fwd"
    _ndim(name, x, 3, "(nz, ny, nx)")
    _fold_ok(name, fwd, (fwd.shape[0] // 2 * 2, x.shape[-2]), x.shape[-2],
             fwd.shape[0] // 2, fold)
    if not _on_cuda(name, x, fwd, den):
        return rdft_y_fwd_plain(x, fwd, den)
    re, im = _rdft_y_fwd(name, x[None], fwd,
                         None if den is None else den[None], fold)
    return re[0], im[0]


def rdft_y_fwd_batched(x: torch.Tensor, fwd: torch.Tensor,
                       den: Optional[torch.Tensor] = None,
                       fold: bool = False) -> Pair:
    """K1 on a batch (nb, nz, ny, nx) -> (nb, kp, nz, nx): see
    `rdft_y_fwd_plain`; `fold` as `rdft_y_fwd`."""
    name = "rdft_y_fwd_batched"
    _ndim(name, x, 4, "(nb, nz, ny, nx)")
    _fold_ok(name, fwd, (fwd.shape[0] // 2 * 2, x.shape[-2]), x.shape[-2],
             fwd.shape[0] // 2, fold)
    if not _on_cuda(name, x, fwd, den):
        return rdft_y_fwd_plain(x, fwd, den)
    return _rdft_y_fwd(name, x, fwd, den, fold)


def _rdft_y_inv(name: str, re: torch.Tensor, im: torch.Tensor,
                inv: torch.Tensor, mul: Optional[torch.Tensor], fold: bool
                ) -> torch.Tensor:
    """K2 on (nb, kp, nz, nx) CUDA tensors -> (nb, nz, ny, nx): the
    real-FFT kernel for a stated fold on its route, else the dense GEMM."""
    nb, kp, nz, nx = re.shape
    ny = inv.shape[0]
    _shape(name, im, re.shape)
    if mul is not None:
        _shape(name, mul, (nb, nz, ny, nx))
    if fold and rdft_route(ny, nx) == "fft":
        return rdft_y_inv_fft(re, im, ny, mul, name)
    _grid(name, "nb*nz", nb * nz)
    out = _empty((nb, nz, ny, nx), re)
    _launch(name + "_dense", re.device, _lib().ipp_rdft_y_inv, re.data_ptr(),
            im.data_ptr(), inv.data_ptr(),
            mul.data_ptr() if mul is not None else None, out.data_ptr(),
            nb, nz, ny, nx, kp)
    return out


def rdft_y_inv(re: torch.Tensor, im: torch.Tensor, inv: torch.Tensor,
               mul: Optional[torch.Tensor] = None,
               fold: bool = False) -> torch.Tensor:
    """K2 on one spectrum (kp, nz, nx) -> (nz, ny, nx): see
    `rdft_y_inv_plain`.  `fold=True` states that `inv` is
    `rfft_fold_mats(ny, kp)[1]` (shape (ny, 2kp), kp >= ny/2 + 1 checked):
    the Hermitian fold, which ignores im at k = 0 and ny/2 and the rows
    kx..kp-1; the kernel is then chosen as in `rdft_y_fwd`."""
    name = "rdft_y_inv"
    _ndim(name, re, 3, "(kp, nz, nx)")
    _fold_ok(name, inv, (inv.shape[0], 2 * re.shape[-3]), inv.shape[0],
             re.shape[-3], fold)
    if not _on_cuda(name, re, im, inv, mul):
        return rdft_y_inv_plain(re, im, inv, mul)
    return _rdft_y_inv(name, re[None], im[None], inv,
                       None if mul is None else mul[None], fold)[0]


def rdft_y_inv_batched(re: torch.Tensor, im: torch.Tensor,
                       inv: torch.Tensor,
                       mul: Optional[torch.Tensor] = None,
                       fold: bool = False) -> torch.Tensor:
    """K2 on a batch of spectra (nb, kp, nz, nx) -> (nb, nz, ny, nx): see
    `rdft_y_inv_plain`; `fold` as `rdft_y_inv`."""
    name = "rdft_y_inv_batched"
    _ndim(name, re, 4, "(nb, kp, nz, nx)")
    _fold_ok(name, inv, (inv.shape[0], 2 * re.shape[-3]), inv.shape[0],
             re.shape[-3], fold)
    if not _on_cuda(name, re, im, inv, mul):
        return rdft_y_inv_plain(re, im, inv, mul)
    return _rdft_y_inv(name, re, im, inv, mul, fold)


def stage_route(n: int) -> str:
    """Which kernel a radix-2 stage along an axis of length n launches on
    the card: "fft" (csrc/stage_fft.cuh) for the lengths 256 * j up to
    2048, "mixed" (csrc/stage_mixed.cuh) for every other multiple of 128 up
    to `DFT_FFT_MAX_N`, "large" (csrc/stage_large.cuh) for a multiple of 128
    above it with a `stage_large_plan` (every one up to 196608), "dense"
    (csrc/fft_walk.cu) for any other length.  (The wrappers refuse a length
    that is no multiple of 128.)"""
    if n in STAGE_FFT_LENGTHS:
        return "fft"
    if n % 128 == 0 and 0 < n <= DFT_FFT_MAX_N:
        return "mixed"
    if n % 128 == 0 and stage_large_plan(n, False) is not None:
        return "large"
    return "dense"


_twiddles: Dict[Tuple[torch.device, int], torch.Tensor] = {}


def _stage_twiddles(device: torch.device, n: int) -> torch.Tensor:
    """The FFT kernels' (n, 2) twiddle table on `device`, uploaded once."""
    key = (device, n)
    if key not in _twiddles:
        _twiddles[key] = torch.tensor(stage_twiddles(n), device=device)
    return _twiddles[key]


def _stage_mats_ok(name: str, n: int, mr_t, mi_t) -> None:
    """The stage matrices: (2, n/2, n/2) each, or None for both where the
    kernel of `stage_route(n)` reads none (every route but "dense")."""
    if n % 128:
        raise ValueError(f"{name}: the stage axis must be a multiple of "
                         f"128 (got {n})")
    if mr_t is None and mi_t is None and stage_route(n) != "dense":
        return
    if mr_t is None or mi_t is None:
        raise ValueError(f"{name}: at n={n} the {stage_route(n)} stage "
                         f"kernel needs the stage matrices mr_t, mi_t")
    _shape(name, mr_t, (2, n // 2, n // 2))
    _shape(name, mi_t, (2, n // 2, n // 2))


def _plain_mats(name: str, mr_t, mi_t) -> None:
    if mr_t is None or mi_t is None:
        raise ValueError(f"{name}: the plain version (CPU tensors) needs "
                         f"the stage matrices mr_t, mi_t")


def _otf_rows(name: str, otf: Optional[Pair], ncols: int, n: int):
    """(orows, otf_re, otf_im) of an (orows, n) OTF pair whose orows
    divides the data's ncols rows, or (0, None, None)."""
    if otf is None:
        return 0, None, None
    o_r, o_i = otf
    orows = o_r.shape[0]
    _shape(name, o_i, o_r.shape)
    if o_r.dim() != 2 or o_r.shape[1] != n or orows == 0 or ncols % orows:
        raise ValueError(f"{name}: the OTF {tuple(o_r.shape)} must be "
                         f"(orows, {n}) with orows dividing {ncols}")
    return orows, o_r, o_i


def stage_mixed(re: torch.Tensor, im: torch.Tensor, forward: bool,
                axis: int, otf: Optional[Pair] = None, conj: bool = False,
                name: str = "radix2_stage", threads_per_col: int = 0,
                cols: int = 0) -> Pair:
    """The radix-2 stage's mixed-radix FFT kernel (csrc/stage_mixed.cuh) on
    CUDA tensors, counted under `name`: the n-point DFT along axis 1 of
    (P, n, X) or axis -1 of (R, n), the spectrum in the walk's permuted
    order (forward out, inverse in, with 1/n); with `otf` (an (orows, n)
    pair, orows dividing R; inverse over the last axis only) the input is
    first multiplied by otf_re +/- i otf_im (`conj`), row r by OTF row
    r % orows.  The plan is `dft_fft_plan(n)`.  `threads_per_col` and
    `cols` override the kernel's threads a column (row) and columns (rows)
    a block: a bench's knobs; 0 and 0 keep its own (the kernel refuses a
    geometry it cannot run)."""
    ndim = 3 if axis == 1 else 2
    n = re.shape[axis] if re.dim() == ndim else 0
    if (not _on_cuda(name, re, im, *(otf or ())) or stage_route(n) != "mixed"
            or re.numel() == 0
            or (otf is not None and (forward or axis != -1))):
        raise ValueError(f"{name}: the mixed-radix stage kernel takes CUDA "
                         f"tensors with a multiple of 128 up to "
                         f"{DFT_FFT_MAX_N} off {STAGE_FFT_LENGTHS}, an OTF "
                         f"only inverse over the last axis; got "
                         f"{tuple(re.shape)}, axis={axis} on {re.device}")
    _shape(name, im, re.shape)
    batch, ncols = (re.shape[0], re.shape[2]) if axis == 1 else (1,
                                                                 re.shape[0])
    _grid(name, "batch", batch)
    orows, o_r, o_i = _otf_rows(name, otf, ncols, n)
    mode = 0 if forward else (2 if otf is not None else 1)
    radices, npass, generic = _dft_plan(dft_fft_plan(n))
    rr, ii = _empty(re.shape, re), _empty(re.shape, re)
    _launch(name, re.device, _lib().ipp_stage_mixed, re.data_ptr(),
            im.data_ptr(), None if o_r is None else o_r.data_ptr(),
            None if o_i is None else o_i.data_ptr(),
            _stage_twiddles(re.device, n).data_ptr(), rr.data_ptr(),
            ii.data_ptr(), mode, int(axis == -1), batch, ncols, n, npass,
            radices, generic, orows, int(bool(conj)), threads_per_col, cols)
    return rr, ii


def stage_large(re: torch.Tensor, im: torch.Tensor, forward: bool,
                axis: int, otf: Optional[Pair] = None, conj: bool = False,
                name: str = "radix2_stage", natural: bool = False,
                threads_per_col1: int = 0, cols1: int = 0,
                threads_per_col: int = 0, cols: int = 0) -> Pair:
    """The large-axis FFT kernel (csrc/stage_large.cuh) on CUDA tensors,
    counted under `name`: the n-point DFT along axis 1 of (P, n, X) or axis
    -1 of (R, n) for n above `DFT_FFT_MAX_N`, the spectrum in the walk's
    permuted order (forward out, inverse in, with 1/n) or, with `natural`
    (K7's DFT, last axis only), in natural order; with `otf` (an (orows, n)
    pair, orows dividing R; inverse over the last axis only) the input is
    first multiplied by otf_re +/- i otf_im (`conj`), row r by OTF row
    r % orows.  The plan is `stage_large_plan(n, axis == -1)`: one pass
    (Form A) or two through a scratch the size of the data (Form B).  The
    four knobs override pass 1's and pass 2's (Form A's: the second pair)
    threads a column and columns a block: a bench's; 0 keeps the kernel's
    own (it refuses a geometry it cannot run)."""
    ndim = 3 if axis == 1 else 2
    n = re.shape[axis] if re.dim() == ndim else 0
    plan = stage_large_plan(n, axis == -1) if n > DFT_FFT_MAX_N else None
    if (not _on_cuda(name, re, im, *(otf or ())) or plan is None
            or re.numel() == 0 or (not natural and n % 128)
            or (otf is not None and (forward or axis != -1 or natural))
            or (natural and axis != -1)):
        raise ValueError(f"{name}: the large-axis kernel takes CUDA tensors "
                         f"with an axis above {DFT_FFT_MAX_N} that has a "
                         f"stage_large_plan (a multiple of 128; 64 with "
                         f"natural=True, last axis only), an OTF only "
                         f"inverse over the last axis; got "
                         f"{tuple(re.shape)}, axis={axis} on {re.device}")
    _shape(name, im, re.shape)
    batch, ncols = (re.shape[0], re.shape[2]) if axis == 1 else (1,
                                                                 re.shape[0])
    orows, o_r, o_i = _otf_rows(name, otf, ncols, n)
    plan1, plan2 = plan
    m1, m2 = int(np.prod(plan1)), int(np.prod(plan2)) if plan2 else 0
    r1, np1, g1 = _dft_plan(plan1)
    r2, np2, g2 = _dft_plan(plan2) if plan2 else (None, 0, 0)
    dev = re.device
    scratch = (torch.empty((re.numel(), 2), dtype=torch.float32, device=dev)
               if plan2 else None)
    mode = 0 if forward else (2 if otf is not None else 1)
    rr, ii = _empty(re.shape, re), _empty(re.shape, re)
    _launch(name, dev, _lib().ipp_stage_large, re.data_ptr(), im.data_ptr(),
            None if o_r is None else o_r.data_ptr(),
            None if o_i is None else o_i.data_ptr(),
            _stage_twiddles(dev, n).data_ptr(),
            _stage_twiddles(dev, m1).data_ptr(),
            _stage_twiddles(dev, m2).data_ptr() if m2 else None,
            None if scratch is None else scratch.data_ptr(), rr.data_ptr(),
            ii.data_ptr(), mode, int(bool(natural)), int(axis == -1), batch,
            ncols, n, np1, r1, g1, np2, r2, g2, orows, int(bool(conj)),
            threads_per_col1, cols1, threads_per_col, cols)
    return rr, ii


def stage_dense(re: torch.Tensor, im: torch.Tensor, mr_t: torch.Tensor,
                mi_t: torch.Tensor, forward: bool, axis: int,
                otf: Optional[Pair] = None, conj: bool = False,
                name: str = "radix2_stage") -> Pair:
    """The dense stage kernels of csrc/fft_walk.cu (a butterfly and two
    (n/2)^2 complex products against mr_t, mi_t) at any multiple of 128,
    whatever `stage_route` says, counted under `name` with `_dense`
    appended: the route's own for a length with no FFT plan, and a bench's
    yardstick ("<-" in PERF.md) elsewhere.  `otf` as `stage_large` (an OTF
    of the data's rows, or of a multiple of 64 rows)."""
    ndim = 3 if axis == 1 else 2
    n = re.shape[axis] if re.dim() == ndim else 0
    if (not _on_cuda(name, re, im, mr_t, mi_t, *(otf or ())) or n % 128
            or n == 0 or re.numel() == 0
            or (otf is not None and (forward or axis != -1))):
        raise ValueError(f"{name}: the dense stage kernel takes CUDA tensors "
                         f"with a multiple of 128, an OTF only inverse over "
                         f"the last axis; got {tuple(re.shape)}, axis={axis} "
                         f"on {re.device}")
    _shape(name, im, re.shape)
    _shape(name, mr_t, (2, n // 2, n // 2))
    _shape(name, mi_t, (2, n // 2, n // 2))
    rr, ii = _empty(re.shape, re), _empty(re.shape, re)
    if otf is not None:
        rows = re.shape[0]
        orows, o_r, o_i = _otf_rows(name, otf, rows, n)
        if orows != rows and orows % _BN:
            raise ValueError(f"{name}: the dense stage kernel wraps the OTF "
                             f"per column tile: its {orows} rows must equal "
                             f"the data's {rows} or be a multiple of {_BN}")
        _launch(name + "_dense", re.device, _lib().ipp_radix2_stage_inv_otf,
                re.data_ptr(), im.data_ptr(), o_r.data_ptr(), o_i.data_ptr(),
                mr_t.data_ptr(), mi_t.data_ptr(), rr.data_ptr(),
                ii.data_ptr(), int(bool(conj)), rows, orows, n)
        return rr, ii
    if axis == 1:
        batch, _, ncols = re.shape
        bs, ldk, ldc = n * ncols, ncols, 1
    else:
        (ncols, _), batch = re.shape, 1
        bs, ldk, ldc = 0, 1, n
    _grid(name, "batch", batch)
    _launch(name + "_dense", re.device, _lib().ipp_radix2_stage,
            re.data_ptr(), im.data_ptr(), mr_t.data_ptr(), mi_t.data_ptr(),
            rr.data_ptr(), ii.data_ptr(), int(bool(forward)), batch, n,
            ncols, bs, ldk, ldc)
    return rr, ii


def radix2_stage(re: torch.Tensor, im: torch.Tensor,
                 mr_t: Optional[torch.Tensor], mi_t: Optional[torch.Tensor],
                 forward: bool, axis: int) -> Pair:
    """K3, and K6 for the inverse over the last axis: see
    `radix2_stage_plain`.  axis=1 takes (P, n, X), axis=-1 takes (R, n),
    each forward or inverse.  The inverse over the last axis (the v1
    walk's, without an OTF) counts as `radix2_stage_inv_last`.  On the
    card the length chooses the kernel (`stage_route`): one of the three
    FFT kernels, which do not read mr_t, mi_t (None will do), or for a
    length without an FFT plan the dense kernel, counted with `_dense`
    appended."""
    name = "radix2_stage"
    if axis not in (1, -1) or re.dim() != (3 if axis == 1 else 2):
        raise ValueError(f"{name}: axis=1 needs (P, n, X), axis=-1 (R, n); "
                         f"got axis={axis}, shape {tuple(re.shape)}")
    if axis == -1 and not forward:
        name = "radix2_stage_inv_last"
    if not _on_cuda(name, re, im, mr_t, mi_t):
        _plain_mats(name, mr_t, mi_t)
        return radix2_stage_plain(re, im, mr_t, mi_t, forward, axis)
    _shape(name, im, re.shape)
    if axis == 1:
        batch, n, ncols = re.shape
    else:
        (ncols, n), batch = re.shape, 1
    _stage_mats_ok(name, n, mr_t, mi_t)
    _grid(name, "batch", batch)
    route = stage_route(n)
    if route == "mixed":
        return stage_mixed(re, im, forward, axis, name=name)
    if route == "large":
        return stage_large(re, im, forward, axis, name=name)
    if route == "dense":
        return stage_dense(re, im, mr_t, mi_t, forward, axis, name=name)
    rr, ii = _empty(re.shape, re), _empty(re.shape, re)
    lib = _lib()
    _launch(name, re.device,
            lib.ipp_stage_fft_fwd if forward else lib.ipp_stage_fft_inv,
            re.data_ptr(), im.data_ptr(),
            _stage_twiddles(re.device, n).data_ptr(), rr.data_ptr(),
            ii.data_ptr(), int(axis == -1), batch, n, ncols)
    return rr, ii


def dft_route(n: int) -> str:
    """Which kernel K7 launches on the card for the dense DFT of an axis of
    length n (`cplx_matmul(..., dft=...)`): "fft" (csrc/dft_fft.cuh) for a
    multiple of 8 up to `DFT_FFT_MAX_N` (two buffers of one row fit in
    shared memory), "large" (csrc/stage_large.cuh, natural order) for a
    multiple of 64 above it with a `stage_large_plan` (every one up to
    98304), "dense" (csrc/cplx_dense.cu, the complex product on the
    tensor cores) for any other length."""
    if n >= 8 and n % 8 == 0 and n <= DFT_FFT_MAX_N:
        return "fft"
    if n % 64 == 0 and stage_large_plan(n, True) is not None:
        return "large"
    return "dense"


_dft_plans: Dict[Tuple[int, ...], Tuple[ctypes.Array, int, int]] = {}


def _dft_plan(plan: Tuple[int, ...]) -> Tuple[ctypes.Array, int, int]:
    """(radices as a C int array, passes, 1 if the last is the generic
    pass) of a pass list."""
    if plan not in _dft_plans:
        _dft_plans[plan] = ((ctypes.c_int * len(plan))(*plan), len(plan),
                            int(plan[-1] not in DFT_FFT_RADICES))
    return _dft_plans[plan]


def dft_last_fft(re: torch.Tensor, im: torch.Tensor, forward: bool,
                 pad: int = -1, threads_per_row: int = 0,
                 rows_per_block: int = 0,
                 plan: Optional[Tuple[int, ...]] = None) -> Pair:
    """K7's FFT kernel on (rows, n) CUDA planes: the n-point DFT (forward)
    or inverse DFT with 1/n along the last axis, counted as `cplx_matmul`.
    `pad`, `threads_per_row`, `rows_per_block` and `plan` override the
    kernel's shared-memory pad, its block geometry and `dft_fft_plan(n)`
    (a bench's knobs; -1, 0, 0 and None keep its own; the kernel refuses a
    pass list it cannot run)."""
    name = "cplx_matmul"
    _ndim(name, re, 2, "(rows, n)")
    _shape(name, im, re.shape)
    rows, n = re.shape
    if not _on_cuda(name, re, im) or dft_route(n) != "fft" or rows == 0:
        raise ValueError(f"{name}: the FFT kernel takes CUDA planes of "
                         f"(rows >= 1, n) with dft_route(n) == 'fft'; got "
                         f"{tuple(re.shape)} on {re.device}")
    radices, npass, generic = _dft_plan(
        dft_fft_plan(n) if plan is None else tuple(plan))
    rr, ii = _empty((rows, n), re), _empty((rows, n), re)
    _launch(name, re.device, _lib().ipp_dft_last, re.data_ptr(),
            im.data_ptr(), _stage_twiddles(re.device, n).data_ptr(),
            rr.data_ptr(), ii.data_ptr(), int(not forward), rows, n, npass,
            radices, generic, pad, threads_per_row, rows_per_block)
    return rr, ii


def cplx_matmul(re: torch.Tensor, im: torch.Tensor, mr: torch.Tensor,
                mi: torch.Tensor, mri: torch.Tensor,
                dft: Optional[bool] = None) -> Pair:
    """K7: the complex product (re + i*im) @ (mr + i*mi) of (M, K) data and
    (K, N) matrices (mri = mr + mi): see `cplx_matmul_plain`.  `dft=True`
    (`False`) is the caller's statement that the matrices are
    `cplx_triple(n, True)` (`False`), the dense forward (inverse) DFT of
    the axis; K == N == n is checked, the values are not.  On the card the
    length then chooses the kernel (`dft_route`): the FFT kernel, which does
    not read the matrices, or the dense Karatsuba kernel on the tensor
    cores (csrc/cplx_dense.cu), which also serves any matrix with
    `dft=None` and counts as `cplx_matmul_dense`."""
    name = "cplx_matmul"
    _ndim(name, re, 2, "(M, K)")
    rows, k = re.shape
    n = mr.shape[-1]
    if dft is not None and k != n:
        raise ValueError(f"{name}: dft={dft} needs the square DFT matrix of "
                         f"the axis, got K={k}, N={n}")
    if not _on_cuda(name, re, im, mr, mi, mri):
        return cplx_matmul_plain(re, im, mr, mi, mri)
    _shape(name, im, re.shape)
    for m in (mr, mi, mri):
        _shape(name, m, (k, n))
    if rows == 0 or k == 0 or n == 0:
        raise ValueError(f"{name}: empty operand {(rows, k, n)}")
    if dft is not None and dft_route(n) == "fft":
        return dft_last_fft(re, im, bool(dft))
    if dft is not None and dft_route(n) == "large":
        return stage_large(re, im, bool(dft), -1, name=name, natural=True)
    rr, ii = _empty((rows, n), re), _empty((rows, n), re)
    _launch(name + "_dense", re.device, _lib().ipp_cplx_matmul,
            re.data_ptr(), im.data_ptr(), mr.data_ptr(), mi.data_ptr(),
            mri.data_ptr(), rr.data_ptr(), ii.data_ptr(), rows, k, n)
    return rr, ii


def _radix2_stage_inv_otf(name: str, re, im, otf_re, otf_im, mr_t, mi_t,
                          conj: bool) -> Pair:
    """K4 on (rows, n) CUDA data and an (orows, n) OTF, rows a multiple
    of orows.  The FFT kernels (`stage_route` "fft", "mixed" or "large")
    take the OTF row of each data row by one modulo, so any such orows will
    do, and read no stage matrices (None will do); the dense kernel (a
    length with no FFT plan, counted with `_dense` appended) wraps the OTF
    once per column tile and needs orows == rows or a multiple of the
    tile."""
    rows, n = re.shape
    route = stage_route(n)
    _shape(name, im, re.shape)
    _otf_rows(name, (otf_re, otf_im), rows, n)
    _stage_mats_ok(name, n, mr_t, mi_t)
    if route == "mixed":
        return stage_mixed(re, im, False, -1, (otf_re, otf_im), conj, name)
    if route == "large":
        return stage_large(re, im, False, -1, (otf_re, otf_im), conj, name)
    if route == "dense":
        return stage_dense(re, im, mr_t, mi_t, False, -1, (otf_re, otf_im),
                           conj, name)
    rr, ii = _empty(re.shape, re), _empty(re.shape, re)
    _launch(name, re.device, _lib().ipp_stage_fft_inv_otf, re.data_ptr(),
            im.data_ptr(), otf_re.data_ptr(), otf_im.data_ptr(),
            _stage_twiddles(re.device, n).data_ptr(), rr.data_ptr(),
            ii.data_ptr(), int(bool(conj)), rows, otf_re.shape[0], n)
    return rr, ii


def radix2_stage_inv_otf(re: torch.Tensor, im: torch.Tensor,
                         otf_re: torch.Tensor, otf_im: torch.Tensor,
                         mr_t: Optional[torch.Tensor],
                         mi_t: Optional[torch.Tensor],
                         conj: bool) -> Pair:
    """K4: see `radix2_stage_inv_otf_plain`.  All of re, im, otf_re,
    otf_im are (R, n): the unbatched walk's OTF matches the data rows.
    The kernel is chosen by n (`stage_route`); mr_t, mi_t as
    `radix2_stage`."""
    name = "radix2_stage_inv_otf"
    _ndim(name, re, 2, "(R, n)")
    _shape(name, otf_re, re.shape)
    if not _on_cuda(name, re, im, otf_re, otf_im, mr_t, mi_t):
        _plain_mats(name, mr_t, mi_t)
        return radix2_stage_inv_otf_plain(re, im, otf_re, otf_im, mr_t,
                                          mi_t, conj)
    return _radix2_stage_inv_otf(name, re, im, otf_re, otf_im, mr_t, mi_t,
                                 conj)


def radix2_stage_inv_otf_batched(re: torch.Tensor, im: torch.Tensor,
                                 otf_re: torch.Tensor, otf_im: torch.Tensor,
                                 mr_t: Optional[torch.Tensor],
                                 mi_t: Optional[torch.Tensor],
                                 conj: bool) -> Pair:
    """K4 with an OTF period: re, im (nb * R, n), the OTF (R, n), data row
    r taking OTF row r % R, so one block's OTF serves nb blocks without a
    broadcast copy (`_fused_stage_otf_call`'s wrapped OTF blocks).  See
    `radix2_stage_inv_otf_plain`; the kernel is chosen by n
    (`stage_route`), mr_t, mi_t as `radix2_stage`."""
    name = "radix2_stage_inv_otf_batched"
    _ndim(name, re, 2, "(rows, n)")
    if not _on_cuda(name, re, im, otf_re, otf_im, mr_t, mi_t):
        _plain_mats(name, mr_t, mi_t)
        return radix2_stage_inv_otf_plain(re, im, otf_re, otf_im, mr_t,
                                          mi_t, conj)
    return _radix2_stage_inv_otf(name, re, im, otf_re, otf_im, mr_t, mi_t,
                                 conj)
