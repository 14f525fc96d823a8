"""Constant DFT matrices of the FFT walk, built in numpy as f32.

The same constructions as the reference (ipp_tpu/ops/mxu_fft.py:59-181
`_dft_mats`, `_rdft_mats`, `_irdft_mats`, `_radix_fwd_mats`,
`_radix_inv_mats`; ipp_tpu/ops/pallas_fft.py:148-162,378-410 `prep_*`),
bit for bit.  The reference splits each matrix into bf16 hi/lo halves for
3-pass MXU matmuls; the CUDA kernels multiply in plain f32, so the port
keeps the f32 matrices themselves.

Results are cached and read-only: every caller shares one array.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np

__all__ = ["dft_mats", "rdft_mats", "irdft_mats", "radix_fwd_mats",
           "radix_inv_mats", "rfft_fold_mats", "stage_mats_t"]


def _frozen(*arrays):
    for a in arrays:
        a.setflags(write=False)
    return arrays if len(arrays) > 1 else arrays[0]


@lru_cache(maxsize=64)
def dft_mats(n: int) -> Tuple[np.ndarray, np.ndarray]:
    """(Cr, Ci) with F[j,k] = exp(-2*pi*i*j*k/n) = Cr + i*Ci, float32."""
    jk = np.outer(np.arange(n), np.arange(n)) % n
    w = np.exp(-2j * np.pi * jk / n)
    return _frozen(np.ascontiguousarray(w.real.astype(np.float32)),
                   np.ascontiguousarray(w.imag.astype(np.float32)))


@lru_cache(maxsize=64)
def rdft_mats(n: int) -> Tuple[np.ndarray, np.ndarray]:
    """Forward half-spectrum matrices: (n, n//2+1)."""
    k = n // 2 + 1
    cr, ci = dft_mats(n)
    return _frozen(np.ascontiguousarray(cr[:, :k]),
                   np.ascontiguousarray(ci[:, :k]))


@lru_cache(maxsize=64)
def irdft_mats(n: int) -> Tuple[np.ndarray, np.ndarray]:
    """Inverse half-spectrum reconstruction: x[j] = Re X @ Ar[k,j] +
    Im X @ Ai[k,j] (Ai applied with a minus), Hermitian weights and the
    1/n folded in; (k, n) matrices."""
    k = n // 2 + 1
    jk = np.outer(np.arange(k), np.arange(n))
    wts = np.full(k, 2.0)
    wts[0] = 1.0
    if n % 2 == 0:
        wts[-1] = 1.0
    ar = wts[:, None] * np.cos(2 * np.pi * jk / n) / n
    ai = wts[:, None] * np.sin(2 * np.pi * jk / n) / n
    return _frozen(np.ascontiguousarray(ar.astype(np.float32)),
                   np.ascontiguousarray(ai.astype(np.float32)))


@lru_cache(maxsize=64)
def radix_fwd_mats(n: int, r: int) -> Tuple[np.ndarray, np.ndarray]:
    """Twiddle-folded forward matrices, stacked (r, m, m):
    M_s[t, k] = exp(-2i*pi*t*s/n) * exp(-2i*pi*t*k/m)."""
    m = n // r
    t = np.arange(m)[:, None]
    k = np.arange(m)[None, :]
    mats = [np.exp(-2j * np.pi * (t * s / n + (t * k % m) / m))
            for s in range(r)]
    M = np.stack(mats)
    return _frozen(np.ascontiguousarray(M.real.astype(np.float32)),
                   np.ascontiguousarray(M.imag.astype(np.float32)))


@lru_cache(maxsize=64)
def radix_inv_mats(n: int, r: int) -> Tuple[np.ndarray, np.ndarray]:
    """Twiddle-folded inverse matrices, stacked (r, m, m):
    Minv_s[k, t] = (1/m) exp(+2i*pi*k*t/m) * exp(+2i*pi*s*t/n)
    (the 1/r of the full inverse is the butterfly's (v0 +/- v1)/2)."""
    m = n // r
    t = np.arange(m)[None, :]
    k = np.arange(m)[:, None]
    mats = [np.exp(2j * np.pi * ((k * t % m) / m + s * t / n)) / m
            for s in range(r)]
    M = np.stack(mats)
    return _frozen(np.ascontiguousarray(M.real.astype(np.float32)),
                   np.ascontiguousarray(M.imag.astype(np.float32)))


@lru_cache(maxsize=16)
def rfft_fold_mats(n: int, kp: int) -> Tuple[np.ndarray, np.ndarray]:
    """(fwd, inv) of the y real DFT (pallas_fft.prep_v2_rfft_mats in f32):
    fwd (2*kp, n) stacks [re rows; im rows], zero rows pad kx -> kp;
    inv (n, 2*kp) is the Hermitian fold consuming [re; im], 1/n included."""
    kx = n // 2 + 1
    fr, fi = rdft_mats(n)
    fwd = np.zeros((2 * kp, n), np.float32)
    fwd[:kx] = fr.T
    fwd[kp:kp + kx] = fi.T
    ar, ai = irdft_mats(n)
    inv = np.zeros((n, 2 * kp), np.float32)
    inv[:, :kx] = ar.T
    inv[:, kp:kp + kx] = -ai.T
    return _frozen(fwd, inv)


@lru_cache(maxsize=16)
def stage_mats_t(n: int, forward: bool) -> Tuple[np.ndarray, np.ndarray]:
    """(Mr^T, Mi^T), each stacked (2, m, m), of the radix-2 stage along an
    axis of length n: entry [s, k, t] = M_s[t, k].  Both stage forms use
    them as the constant left operand — the middle-axis stage computes
    out_s = M_s^T @ u_s, the last-axis stage (u_s @ M_s)^T — so one set
    serves prep_v2_stage_mats' and prep_stage_mats' roles."""
    mr, mi = radix_fwd_mats(n, 2) if forward else radix_inv_mats(n, 2)
    return _frozen(np.ascontiguousarray(mr.transpose(0, 2, 1)),
                   np.ascontiguousarray(mi.transpose(0, 2, 1)))
