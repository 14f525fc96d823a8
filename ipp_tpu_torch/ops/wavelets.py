"""Orthogonal wavelet filter banks and the 2D periodised DWT (port of
ipp_tpu/ops/wavelets.py).

Filter banks are built in numpy float64 exactly as the reference builds
them (Daubechies by spectral factorisation, symlets by least phase
nonlinearity, coiflets from the published tables and `coif_data`);
tests/test_torch_wavelets.py pins them bit-equal.

The transform is the reference's periodisation DWT with its raw phase
(cA[i] = <x[2i:2i+L], rec_lo>) and its per-level parity rolls, batched
over leading dimensions.  Analysis runs through `cuda_dwt.dwt_analysis`:
the CUDA kernel K5 on the card, along the last axis and along axis -2
directly (no transposes); on the CPU its plain version
`cuda_dwt.dwt_analysis_plain`, the reference's conv `_dwt_last`.
Synthesis runs through `cuda_dwt.dwt_synthesis` the same way: the CUDA
kernel K5s on the card, whose outputs never depend on the batch or the
run; on the CPU its plain version `cuda_dwt.dwt_synthesis_plain`, a
stride-2 transposed conv folded mod n (the reference's `_idwt_last`, an
XLA convolution outside any Pallas kernel).

Coefficient layout is pywt's: ``wavedec2`` returns ``[cA_L, (cH_L, cV_L,
cD_L), ..., (cH_1, cV_1, cD_1)]``, cH detail along y (axes[0]) and
approximation along x (axes[1]).

Not ported: the MXU circulant-matmul DWT (`ops/mxu_dwt.py`,
`IPP_TPU_DWT=matmul`), a TPU lever; off the TPU the reference takes the
conv path too.
"""

from __future__ import annotations

import functools
from math import comb
from typing import List, Sequence, Tuple

import numpy as np
import torch

from .cuda_dwt import dwt_analysis, dwt_synthesis

__all__ = [
    "scaling_filter",
    "filter_bank",
    "filter_taps",
    "dwt_max_level",
    "dwt2",
    "idwt2",
    "wavedec2",
    "waverec2",
]


# ---------------------------------------------------------------------------
# Filter-bank construction (host-side, float64 numpy), as the reference
# ---------------------------------------------------------------------------

# Published coiflet scaling filters (Daubechies, "Ten Lectures on Wavelets",
# table 8.1; standard public tables).  Length 6N.  Normalized to sum sqrt(2).
_COIF_TABLE = {
    1: [
        -0.0156557281354645, -0.0727326195128561, 0.3848648468648578,
        0.8525720202122554, 0.3378976624578092, -0.0727326195128561,
    ],
    2: [
        -0.000720549445364512, -0.0018232088707029932, 0.0056114348193944995,
        0.023680171946334084, -0.0594344186464569, -0.0764885990783064,
        0.41700518442169254, 0.8127236354455423, 0.3861100668211622,
        -0.06737255472196302, -0.04146493678175915, 0.016387336463522112,
    ],
    3: [
        -3.459977283621256e-05, -7.098330313814125e-05, 0.0004662169601128863,
        0.0011175187708906016, -0.0025745176887502236, -0.00900797613666158,
        0.015880544863615904, 0.03455502757306163, -0.08230192710688598,
        -0.07179982161931202, 0.42848347637761874, 0.7937772226256206,
        0.4051769024096169, -0.06112339000267287, -0.0657719112818555,
        0.023452696141836267, 0.007782596427325418, -0.003793512864491014,
    ],
    4: [
        -1.7849850030882614e-06, -3.2596802368833675e-06, 3.1229875865345646e-05,
        6.233903446100713e-05, -0.00025997455248771324, -0.0005890207562443383,
        0.0012665619292989445, 0.003751436157278457, -0.00565828668661072,
        -0.015211731527946259, 0.025082261844864097, 0.03933442712333749,
        -0.09622044203398798, -0.06662747426342504, 0.4343860564914685,
        0.782238930920499, 0.41530840703043026, -0.05607731331675481,
        -0.08126669968087875, 0.026682300156053072, 0.016068943964776348,
        -0.0073461663276420935, -0.0016294920126017326, 0.0008923136685823146,
    ],
    5: [
        -9.517657273819165e-08, -1.6744288576823017e-07, 2.0637618513646814e-06,
        3.7346551751414047e-06, -2.1315026809955787e-05, -4.134043227251251e-05,
        0.00014054114970203437, 0.00030225958181306315, -0.0006381313430451114,
        -0.0016628637020130838, 0.0024333732126576722, 0.006764185448053083,
        -0.009164231162481846, -0.01976177894257264, 0.03268357426711183,
        0.0412892087501817, -0.10557420870333893, -0.06203596396290357,
        0.4379916261718371, 0.7742896036529562, 0.4215662066908515,
        -0.05204316317624377, -0.09192001055969624, 0.02816802897093635,
        0.023408156785839195, -0.010131117519849788, -0.004159358781386048,
        0.0021782363581090178, 0.00035858968789573785, -0.00021208083980379827,
    ],
}


def _daub_scaling(p: int) -> np.ndarray:
    """Daubechies-p minimum-phase scaling filter (length 2p, sum sqrt(2)).

    Spectral factorization of the maximally-flat half-band product filter.
    """
    if p < 1:
        raise ValueError("daubechies order must be >= 1")
    if p == 1:
        return np.array([1.0, 1.0]) / np.sqrt(2.0)
    pcoef = np.array([comb(p - 1 + k, k) for k in range(p)][::-1], dtype=np.float64)
    yroots = np.roots(pcoef)
    zroots = []
    for y in yroots:
        # y = (2 - z - 1/z)/4  =>  z^2 + (4y - 2) z + 1 = 0
        zr = np.roots([1.0, 4.0 * y - 2.0, 1.0])
        zroots.append(zr[np.argmin(np.abs(zr))])  # min-phase root
    poly = np.array([1.0 + 0.0j])
    for _ in range(p):
        poly = np.convolve(poly, [1.0, 1.0])
    for z in zroots:
        poly = np.convolve(poly, [1.0, -z])
    h = np.real(poly)
    return h * np.sqrt(2.0) / h.sum()


def _sym_scaling(p: int) -> np.ndarray:
    """Symlet-p scaling filter: same product-filter roots as db-p, but the
    root subset per conjugate pair is chosen to minimize phase nonlinearity."""
    if p < 2:
        raise ValueError("symlet order must be >= 2")
    pcoef = np.array([comb(p - 1 + k, k) for k in range(p)][::-1], dtype=np.float64)
    yroots = np.roots(pcoef)
    # group y-roots: real roots and conjugate pairs
    reals = [y for y in yroots if abs(y.imag) < 1e-10]
    pairs: List[Tuple[complex, complex]] = []
    used = np.zeros(len(yroots), bool)
    ylist = list(yroots)
    for i, y in enumerate(ylist):
        if used[i] or abs(y.imag) < 1e-10:
            continue
        for j in range(i + 1, len(ylist)):
            if not used[j] and abs(ylist[j] - np.conj(y)) < 1e-8:
                pairs.append((y, ylist[j]))
                used[i] = used[j] = True
                break

    def z_of(y, inside: bool):
        zr = np.roots([1.0, 4.0 * y - 2.0, 1.0])
        order = np.argsort(np.abs(zr))
        return zr[order[0]] if inside else zr[order[1]]

    best = None
    n_pairs = len(pairs)
    for mask in range(1 << n_pairs):
        zroots = [z_of(y, True) for y in reals]
        for b, (y1, y2) in enumerate(pairs):
            inside = not (mask >> b) & 1
            zroots.append(z_of(y1, inside))
            zroots.append(z_of(y2, inside))
        poly = np.array([1.0 + 0.0j])
        for _ in range(p):
            poly = np.convolve(poly, [1.0, 1.0])
        for z in zroots:
            poly = np.convolve(poly, [1.0, -z])
        h = np.real(poly)
        h = h * np.sqrt(2.0) / h.sum()
        # phase-nonlinearity score: deviation of group delay from constant
        w = np.linspace(0.02, np.pi - 0.02, 256)
        H = np.polyval(h[::-1], np.exp(-1j * w))
        phase = np.unwrap(np.angle(H * np.exp(1j * w * (len(h) - 1) / 2)))
        score = np.ptp(phase)
        if best is None or score < best[0]:
            best = (score, h)
    return best[1]


@functools.lru_cache(maxsize=64)
def scaling_filter(name: str) -> np.ndarray:
    """Return the orthogonal scaling (lowpass synthesis) filter for `name`.

    Supported: haar, dbN (1..34), symN (2..20), coifN (1..17 — 1..5 from
    the published tables, 6..17 from ops/coif_data.py; the reference's
    process_img default 'coif15' is exact).  coifN>17 maps to the nearest
    symlet.
    """
    name = name.lower().strip()
    if name == "haar":
        return _daub_scaling(1)
    if name.startswith("db"):
        p = int(name[2:])
        if not 1 <= p <= 34:
            raise ValueError(f"unsupported wavelet {name!r}")
        return _daub_scaling(p)
    if name.startswith("sym"):
        p = int(name[3:])
        if not 2 <= p <= 20:
            raise ValueError(f"unsupported wavelet {name!r}")
        return _sym_scaling(p)
    if name.startswith("coif"):
        p = int(name[4:])
        if p in _COIF_TABLE:
            h = np.array(_COIF_TABLE[p], dtype=np.float64)
            return h * np.sqrt(2.0) / h.sum()
        from .coif_data import COIF_HIGH

        if p in COIF_HIGH:
            h = np.array(COIF_HIGH[p], dtype=np.float64)
            return h * np.sqrt(2.0) / h.sum()
        # nearest-symlet fallback beyond the derived orders
        return _sym_scaling(min(max(2 * p, 2), 20))
    raise ValueError(f"unsupported wavelet {name!r}")


@functools.lru_cache(maxsize=64)
def filter_bank(name: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(dec_lo, dec_hi, rec_lo, rec_hi), pywt orthogonal convention."""
    h = scaling_filter(name)
    L = len(h)
    rec_lo = h
    rec_hi = np.array([(-1.0) ** k * h[L - 1 - k] for k in range(L)])
    dec_lo = rec_lo[::-1].copy()
    dec_hi = rec_hi[::-1].copy()
    return dec_lo, dec_hi, rec_lo, rec_hi


def dwt_max_level(data_len: int, filter_len_or_wavelet) -> int:
    """Maximum useful decomposition level (pywt formula)."""
    if isinstance(filter_len_or_wavelet, str):
        flen = len(scaling_filter(filter_len_or_wavelet))
    else:
        flen = int(filter_len_or_wavelet)
    if data_len < flen - 1 or flen < 2:
        return 0
    return int(np.floor(np.log2(data_len / (flen - 1.0))))


def filter_taps(wavelet: str, device) -> torch.Tensor:
    """(2, L) f32 [rec_lo; rec_hi] of `wavelet` on `device`: K5's taps and
    the plain versions' conv weights (the reference casts the float64
    filters to the data's f32 the same way)."""
    _, _, rec_lo, rec_hi = filter_bank(wavelet)
    return torch.from_numpy(
        np.stack([rec_lo, rec_hi]).astype(np.float32)).to(device)


# ---------------------------------------------------------------------------
# 2D transforms
# ---------------------------------------------------------------------------


def _to_last2(t: torch.Tensor, axes) -> torch.Tensor:
    """`t` with `axes` moved to (-2, -1), contiguous (K5 takes no views)."""
    ax = tuple(a % t.dim() for a in axes)
    if ax != (t.dim() - 2, t.dim() - 1):
        t = torch.movedim(t, ax, (-2, -1))
    return t.contiguous()


def _from_last2(t: torch.Tensor, axes) -> torch.Tensor:
    ax = tuple(a % t.dim() for a in axes)
    if ax != (t.dim() - 2, t.dim() - 1):
        t = torch.movedim(t, (-2, -1), ax)
    return t


def _dwt2_once(img: torch.Tensor, taps: torch.Tensor):
    """One 2D level over the last two axes: x first, then y on both
    halves, each through K5 (3 launches), no transposes."""
    a1, d1 = dwt_analysis(img, taps, -1)
    aa, da = dwt_analysis(a1, taps, -2)
    ad, dd = dwt_analysis(d1, taps, -2)
    return aa, (da, ad, dd)


def _idwt2_once(cA, details, taps):
    """The inverse of `_dwt2_once`: y on both halves, then x, each
    through K5s (3 launches)."""
    da, ad, dd = details
    a1 = dwt_synthesis(cA, da, taps, -2)
    d1 = dwt_synthesis(ad, dd, taps, -2)
    return dwt_synthesis(a1, d1, taps, -1)


def dwt2(img: torch.Tensor, wavelet: str, axes: Tuple[int, int] = (-2, -1)):
    """One 2D DWT level: returns (cA, (cH, cV, cD)) with pywt meaning:
    cH = detail along axes[0], approx along axes[1]."""
    taps = filter_taps(wavelet, img.device)
    a, det = _dwt2_once(_to_last2(img.float(), axes), taps)
    return (_from_last2(a, axes),
            tuple(_from_last2(c, axes) for c in det))


def idwt2(cA, details, wavelet: str, axes: Tuple[int, int] = (-2, -1)):
    taps = filter_taps(wavelet, cA.device)
    x = _idwt2_once(_to_last2(cA, axes),
                    tuple(_to_last2(c, axes) for c in details), taps)
    return _from_last2(x, axes)


def _parity_rolls(filter_len: int, level: int) -> List[bool]:
    """Whether to roll cA by +1 (per transformed axis) before decomposing at
    each level 1..level (level 1 is always False).

    The raw grid sits s = (L-2)/2 coefficients early of pywt's
    symmetric-mode interior grid; when the accumulated offset t is odd,
    recursing on the raw cA would decompose the opposite polyphase branch
    from pywt, and a +1 roll restores even offset (the reference's
    function, computed the same way)."""
    s = (filter_len - 2) // 2
    rolls = [False]
    t = s
    for _ in range(1, level):
        r = bool(t & 1)
        rolls.append(r)
        t = (t - int(r)) // 2 + s
    return rolls


def wavedec2(img: torch.Tensor, wavelet: str, level: int,
             axes: Tuple[int, int] = (-2, -1)):
    """Multi-level 2D DWT (periodization).  Both transformed axis lengths
    must be divisible by 2**level.  Returns [cA_L, (cH,cV,cD)_L, ...,
    (cH,cV,cD)_1] (coarse -> fine, pywt layout).  Level-2+ decompositions
    follow pywt's polyphase branch (_parity_rolls)."""
    for ax in axes:
        n = img.shape[ax]
        if n % (1 << level):
            raise ValueError(
                f"axis {ax} length {n} not divisible by 2**{level}; pad first")
    taps = filter_taps(wavelet, img.device)
    rolls = _parity_rolls(taps.shape[1], level)
    coeffs: List = []
    a = _to_last2(img.float(), axes)
    for lv in range(level):
        if rolls[lv]:
            a = torch.roll(a, (1, 1), (-2, -1))
        a, det = _dwt2_once(a, taps)
        coeffs.append(tuple(_from_last2(c, axes) for c in det))
    return [_from_last2(a, axes)] + coeffs[::-1]


def waverec2(coeffs: Sequence, wavelet: str, axes: Tuple[int, int] = (-2, -1)):
    """Inverse of :func:`wavedec2`."""
    a = _to_last2(coeffs[0], axes)
    taps = filter_taps(wavelet, a.device)
    level = len(coeffs) - 1
    rolls = _parity_rolls(taps.shape[1], level)
    for i, det in enumerate(coeffs[1:]):
        a = _idwt2_once(a, tuple(_to_last2(c, axes) for c in det), taps)
        if rolls[level - 1 - i]:
            a = torch.roll(a, (-1, -1), (-2, -1))
    return _from_last2(a, axes)
