"""Constant DFT matrices of the FFT walk, built in numpy as f32.

The same constructions as the reference (ipp_tpu/ops/mxu_fft.py:59-181
`_dft_mats`, `_rdft_mats`, `_irdft_mats`, `_idft_mats`, `_radix_fwd_mats`,
`_radix_inv_mats`, the Karatsuba triples and the kxp-padded x matrices of
`MatmulFFT3.__init__` (:267-299); ipp_tpu/ops/pallas_fft.py:148-162,378-410
`prep_*`), bit for bit.  The reference splits each matrix into bf16 hi/lo halves for
3-pass MXU matmuls; the CUDA kernels multiply in plain f32, so the port
keeps the f32 matrices themselves.

Results are cached and read-only: every caller shares one array.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional, Tuple

import numpy as np

__all__ = ["dft_mats", "rdft_mats", "irdft_mats", "idft_mats",
           "cplx_triple", "rfft_x_mats", "radix_fwd_mats", "radix_inv_mats",
           "rfft_fold_mats", "stage_mats_t", "STAGE_FFT_LENGTHS",
           "stage_fft_plan", "stage_twiddles", "DFT_FFT_MAX_N",
           "DFT_FFT_RADICES", "dft_fft_plan", "LARGE_A_MAX_N",
           "stage_large_plan"]


def _frozen(*arrays):
    for a in arrays:
        a.setflags(write=False)
    return arrays if len(arrays) > 1 else arrays[0]


@lru_cache(maxsize=64)
def dft_mats(n: int) -> Tuple[np.ndarray, np.ndarray]:
    """(Cr, Ci) with F[j,k] = exp(-2*pi*i*j*k/n) = Cr + i*Ci, float32."""
    jk = np.outer(np.arange(n), np.arange(n)) % n
    # exp once per distinct angle, then gathered: the same values, bit for
    # bit, as exp over the whole (n, n) array
    w = np.exp(-2j * np.pi * np.arange(n) / n)[jk]
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
def idft_mats(n: int) -> Tuple[np.ndarray, np.ndarray]:
    """Full inverse DFT matrices (1/n * conj(F)), float32 (n, n)."""
    cr, ci = dft_mats(n)
    return _frozen(np.ascontiguousarray(cr.T / n),
                   np.ascontiguousarray(-ci.T / n))


@lru_cache(maxsize=32)
def cplx_triple(n: int, forward: bool
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(mr, mi, mr + mi) of the dense n-point DFT (forward) or its inverse:
    the Karatsuba operands of a complex product along the last axis, the
    sum formed in f32 (mxu_fft.py:267-272)."""
    mr, mi = dft_mats(n) if forward else idft_mats(n)
    return _frozen(mr, mi, mr + mi)


@lru_cache(maxsize=16)
def rfft_x_mats(n: int, kxp: int) -> Tuple[np.ndarray, np.ndarray]:
    """(fwd, inv) of the v1 walk's x axis with the half spectrum padded to
    kxp (mxu_fft.py:286-299): fwd (n, 2*kxp) gives [re | im] columns, inv
    (2*kxp, n) folds the stacked [re; im] rows back (1/n included).  The
    padded frequencies kx..kxp-1 are columns / rows of exact zeros."""
    kx = n // 2 + 1
    fr, fi = rdft_mats(n)
    fwd = np.zeros((n, 2 * kxp), np.float32)
    fwd[:, :kx] = fr
    fwd[:, kxp:kxp + kx] = fi
    ar, ai = irdft_mats(n)
    inv = np.zeros((2 * kxp, n), np.float32)
    inv[:kx] = ar
    inv[kxp:kxp + kx] = -ai
    return _frozen(fwd, inv)


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


# -- the stage as an FFT (csrc/stage_fft.cuh) --------------------------------

STAGE_FFT_LENGTHS = (256, 512, 768, 1024, 1280, 1536, 1792, 2048)


def stage_fft_plan(n: int) -> Tuple[int, ...]:
    """Radices of the stage FFT kernel's passes for an axis of length n, in
    order (csrc/stage_fft.cuh `radix`): 8, 8, then 4 or 8, then what is
    left (3, 4, 5 or 7; the odd factor last, so every pass's stride is a
    power of two)."""
    if n not in STAGE_FFT_LENGTHS:
        raise ValueError(f"no stage FFT plan for n={n}: the lengths are "
                         f"{STAGE_FFT_LENGTHS}")
    rest = n // 64
    third = 8 if rest in (8, 24, 32) else 4
    last = rest // third
    return (8, 8, third) + ((last,) if last > 1 else ())


@lru_cache(maxsize=16)
def stage_twiddles(n: int) -> np.ndarray:
    """(n, 2) f32 table of exp(-2*pi*i*j/n), j < n, as (re, im) pairs:
    computed in float64 and rounded once, for any n.  The stage FFT kernel
    reads every twiddle and every root of its odd-radix pass from it, the
    dense-axis FFT kernel every twiddle and the roots of its generic pass
    (conjugated for the inverse)."""
    w = np.exp(-2j * np.pi * np.arange(n) / n)
    return _frozen(np.ascontiguousarray(
        np.stack([w.real, w.imag], -1).astype(np.float32)))


# -- a dense axis as an FFT (csrc/dft_fft.cuh) -------------------------------

DFT_FFT_MAX_N = 12288                      # csrc/dft_fft.cuh MAX_N
# the specialised butterflies
DFT_FFT_RADICES = (2, 3, 4, 5, 7, 8, 9, 11, 13, 16)


@lru_cache(maxsize=256)
def dft_fft_plan(n: int) -> Tuple[int, ...]:
    """Radices of the dense-axis FFT kernel's passes for an axis of length
    n = 2^a * m (a >= 3, m odd, n <= DFT_FFT_MAX_N), in order
    (csrc/dft_fft.cuh): the passes of 2^a first, ceil(a / 4) of them, 8s
    then 16s (8, 4 for a = 5); then 9 for every pair of threes in m, 3, and
    every 5, 7, 11 and 13; and last what is left of m, if anything, as ONE
    generic pass of that odd radix (17, 67, 251, 17 * 19, ...: the only
    radix outside `DFT_FFT_RADICES`).  So every stride up to the first odd pass is a
    power of two, and the generic pass reads no twiddle."""
    n = int(n)
    if n < 8 or n % 8 or n > DFT_FFT_MAX_N:
        raise ValueError(f"no dense-axis FFT plan for n={n}: a multiple of "
                         f"8 up to {DFT_FFT_MAX_N} is needed")
    a = (n & -n).bit_length() - 1
    m = n >> a
    k = -(-a // 4)
    plan = [8, 4] if a == 5 else [8] * (4 * k - a) + [16] * (a - 3 * k)
    for r in (9, 3, 5, 7, 11, 13):
        while m % r == 0:
            plan.append(r)
            m //= r
    if m > 1:
        plan.append(m)
    return tuple(plan)


# -- an axis above DFT_FFT_MAX_N (csrc/stage_large.cuh) ----------------------

LARGE_A_MAX_N = 24576      # csrc/stage_large.cuh A_MAX_N: one (n) float2 row
LARGE_M1_MAX = 512         # csrc/stage_large.cuh M1_MAX
LARGE_M2_COLS16 = 1792     # the longest m2 whose pass 2 keeps 16 columns


@lru_cache(maxsize=256)
def stage_large_plan(n: int, last_axis: bool = True,
                     lo: int = DFT_FFT_MAX_N, a_max: int = LARGE_A_MAX_N,
                     m2_max: int = LARGE_M2_COLS16
                     ) -> Optional[Tuple[Tuple[int, ...], Tuple[int, ...]]]:
    """Passes of the large-axis kernel (csrc/stage_large.cuh) for an n-point
    DFT along the last axis (`last_axis`) or the middle one, n a multiple
    of 64 above `lo`; None where it has none.  One radix-2 step leaves two
    transforms of m = n/2:
    - Form A, (dft_fft_plan(m), ()): the last axis up to `a_max`, one row
      a block;
    - Form B, (plan of m1, dft_fft_plan(m2)): the four-step FFT with m =
      m1 * m2, m1 = 2^b (4 <= m1 <= 512, its radices 4, 8 or 16 and no
      generic pass) and m2 a multiple of 8 up to DFT_FFT_MAX_N: the
      smallest b >= 3 (b = 2 only where m has five factors of two) whose
      m2 is at most `m2_max` (pass 2 then keeps 16 columns a block), else
      the largest b.
    Every multiple of 128 above 12288 up to 196608 has a plan, and every
    multiple of 64 up to 98304.  `lo`, `a_max` and `m2_max` are the
    kernel's limits; the tests lower them to run both forms' maps at small
    n."""
    n = int(n)
    if n <= lo or n % 64:
        return None
    m = n // 2
    if last_axis and n <= a_max:
        return dft_fft_plan(m), ()
    a = (m & -m).bit_length() - 1
    bs = [b for b in range(2, LARGE_M1_MAX.bit_length()) if a - b >= 3]
    bs = [b for b in bs if b >= 3] or bs
    if not bs:
        return None
    b = next((b for b in bs if m >> b <= m2_max), bs[-1])
    m1, m2 = 1 << b, m >> b
    if m2 > DFT_FFT_MAX_N:
        return None
    plan1 = (4,) if m1 == 4 else dft_fft_plan(m1)
    return plan1, dft_fft_plan(m2)
