"""Wrapper of the CUDA kernel K8, the destripe notch, beside its plain
version.

`notch_filter(x, g, axis)` takes every line of length n along axis -1 or
-2 of an f32 tensor (..., H, W) to irfft(rfft(line) * g, n), g the real
(n // 2 + 1) notch of `destripe.notch`: `destripe.filter_coefficient` on
one subband.  `notch_filter_group(xs, gs, axes)` does the same to a list
of subbands in one launch: `destripe.filter_subband` notches every level
of a decomposition (cH along x, cV along y) with it, on the tile chain of
pystripe, process_images, convert, the deconvolution CLI's z-destripe
and the FNT cubes.  It replaces no Pallas kernel: the reference notches
with the XLA FFT (ipp_tpu/ops/destripe.py:168-172).  On the card the
notch ran on cuFFT (`torch.fft.rfft` / `irfft`) until K8, whose algorithm
changes with the batch count, so a destriped tile moved with its batch;
K8 (`csrc/notch.cuh`) computes each line from its own line pair (lines
2i, 2i + 1 of one tile in one complex transform), n and g alone, in an
order fixed by n, so a batch gives bit for bit its single tiles and a
group its one-subband calls.

Lengths 1 .. `NOTCH_MAX_N` (2^20) of any factors.  Lines whose buffers
fit shared memory run in the shared-memory kernel on the mixed-radix
passes of `notch_plan(n)`, MAX_GROUP subbands a launch.  Longer ones
(above ~27000 values, or ~13600 with a generic radix; `notch_is_long`)
run in the long form K8l, each subband in launches of its own: the
four-step split n1 x n2 of `notch_long_plan(n)` over three kernels (the
strided passes of n1, the rows of n2 with the gains, the strided inverse
passes), many blocks a line pair.  A row whose odd factor p passes
`GENERIC_MAX` runs it inside the row: Rader's algorithm where p is prime
and p - 1 has a plan of specialised radices (521 of 33344 on 520 = 8 5
13), else Bluestein's chirp-z transform.  A line with no split
(`notch_route(n)` "chirp": a prime past `ROW_MAX`, 65537) runs the
chirp-z transform of the whole line, the three kernels twice.

The wrappers keep the rules of `cuda_fft`: CPU tensors go to the plain
PyTorch version (`notch_filter_plain`, the torch.fft body, one call a
subband); a CUDA tensor launches the kernel or raises, with no fallback;
`LAUNCHES` counts kernel launches only: "notch" one a group of up to
`MAX_GROUP` shared-memory subbands, "notch_long" one for each kernel of
the long form (3 a subband, 6 on the chirp route; none on the destripe
chain of camera tiles).
"""

from __future__ import annotations

import math
import threading
from functools import lru_cache
from typing import Dict, List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from .cuda_fft import _launch, _on_cuda, _stage_twiddles
from .dft_mats import DFT_FFT_RADICES

__all__ = ["LAUNCHES", "NOTCH_MAX_N", "GENERIC_MAX",
           "MAX_GROUP", "reset_launch_counts", "notch_route",
           "notch_length", "notch_plan", "notch_long_plan",
           "notch_long_launches", "notch_is_long",
           "notch_geometry", "notch_long_geometry", "notch_steps",
           "notch_gains", "notch_long_tables", "notch_filter",
           "notch_filter_plain", "notch_filter_group",
           "notch_filter_group_plain"]

# 2^20 (csrc/notch.cuh MAX_N): a level-1 line of a padded side of 2^21
# px, 88 cm at 0.42 um, which no stitched plane reaches
NOTCH_MAX_N = 1 << 20
SMEM_LIMIT = 227 * 1024
THREADS = 256                # every block
VALUES = 24                  # values a thread aims at a pass
TMIN = 16                    # threads a pair at least
MAX_GROUP = 16               # subbands a launch
MAX_PASSES = 12              # csrc/dft_fft.cuh
# the long form (csrc/notch.cuh mirrors these): the strided sub-transform
# n1 and a row's transform (n2, or its chirp's) at most; a strided tile's
# slots and columns at most; a row block's bytes (but one row); rows a
# block along y at least (8-byte runs of 8 column pairs)
LONG_N1_MAX = 1024
ROW_MAX = 4096
TILE_VALUES = 8192
TILE_CMAX = 32
ROW_SMEM = 100 * 1024
ROWS_Y = 8
# a sub-plan's generic odd radix at most: a larger odd factor p runs in
# its row as Rader's cyclic convolution of p - 1 (p prime, p - 1 on the
# specialised radices) or else Bluestein's chirp-z transform
# (pow2ceil(2 n2 - 1) points) in place of a generic pass of ~p / 2
# products a value.  On an H100, on the same split, the rows' generic
# pass of 59 was 1.4x faster than their chirp-z transform and that of 127
# 1.3-1.4x slower than Rader's or the chirp-z transform
# (scripts/notch_bench.py --long, PERF.md): the limit sits between, near
# their geometric mean.  A constant of the route, not a knob
GENERIC_MAX = 87
# the radices with a butterfly of constant roots (csrc/notch.cuh special)
NOTCH_RADICES = DFT_FFT_RADICES + (12,)

LAUNCHES: Dict[str, int] = {"notch": 0, "notch_long": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check_length(n: int) -> None:
    if not 1 <= n <= NOTCH_MAX_N:
        raise ValueError(f"notch: the line length must be in [1, "
                         f"{NOTCH_MAX_N}] (K8's limit), got {n}")


def _pow2_passes(a: int) -> List[int]:
    """The passes of 2^a as `dft_mats.dft_fft_plan` takes them: 8s then
    16s (8, 4 for a = 5; 2 or 4 alone for a = 1, 2)."""
    if a >= 3:
        k = -(-a // 4)
        return [8, 4] if a == 5 else [8] * (4 * k - a) + [16] * (a - 3 * k)
    return [1 << a] if a else []


@lru_cache(maxsize=512)
def notch_plan(n: int) -> Tuple[int, ...]:
    """Radices of K8's mixed-radix passes for a transform of n, in order:
    t passes of 12 = 4 * 3 first, then the passes of the 2^(a - 2t) left
    (`_pow2_passes`), then 9s and a 3 for the 3s left, 5, 7, 11, 13 for
    those factors of the odd part, and last what is left of it, if
    anything, as ONE generic pass of that odd radix (n = 1: the generic
    pass of 1).  t gives the fewest passes, the most 12s among equals
    (the fastest plans of scripts/notch_bench.py --sweep on an H100 at
    1344, 1152 and 672; PERF.md §6).  The shared-memory kernel runs it on
    a line; the long form on each sub-transform of its split."""
    n = int(n)
    _check_length(n)
    a = (n & -n).bit_length() - 1
    m = n >> a
    b = 0
    while m % 3 == 0:
        m //= 3
        b += 1

    def passes(t):
        return t + len(_pow2_passes(a - 2 * t)) + -(-(b - t) // 2)
    t = min(range(min(a // 2, b) + 1), key=lambda t: (passes(t), -t))
    plan = [12] * t + _pow2_passes(a - 2 * t)
    plan += [9] * ((b - t) // 2) + [3] * ((b - t) % 2)
    for r in (5, 7, 11, 13):
        while m % r == 0:
            plan.append(r)
            m //= r
    if m > 1 or not plan:
        plan.append(m)
    return tuple(plan)


def _generic(plan: Tuple[int, ...]) -> bool:
    return plan[-1] not in NOTCH_RADICES


ROWS = ("mixed", "chirp", "rader")   # the kernel's codes of the rows' kinds


class LongPlan(NamedTuple):
    """The long form's split of a line of n: route "mixed" (m = n) or
    "chirp" (the whole line's chirp-z transform, m = pow2ceil(2n - 1)); m =
    n1 n2, plan1 the passes of the strided n1; rows "mixed" (m2 = n2),
    "rader" (n2 prime, Rader's cyclic convolution of m2 = n2 - 1) or
    "chirp" (the row's chirp-z transform, m2 = pow2ceil(2 n2 - 1)), plan2
    the passes of m2."""
    route: str
    m: int
    n1: int
    plan1: Tuple[int, ...]
    n2: int
    rows: str
    m2: int
    plan2: Tuple[int, ...]


def _divisors(n: int) -> List[int]:
    out = [1]
    d, rest = 2, n
    while d * d <= rest:
        k = 0
        while rest % d == 0:
            rest //= d
            k += 1
        out = [v * d ** i for v in out for i in range(k + 1)]
        d += 1
    if rest > 1:
        out += [v * rest for v in out]
    return sorted(out)


@lru_cache(maxsize=1024)
def _long_plan(n: int) -> LongPlan:
    def sub_ok(k):
        plan = notch_plan(k)
        return not _generic(plan) or plan[-1] <= GENERIC_MAX

    def top(k):   # the generic radix of k's plan, 0 without one
        plan = notch_plan(k)
        return plan[-1] if _generic(plan) else 0
    best = None
    for n1 in _divisors(n):
        n2 = n // n1
        if not (2 <= n1 <= LONG_N1_MAX and n2 >= 2) or not sub_ok(n1):
            continue
        if n2 <= ROW_MAX and sub_ok(n2):
            rows, m2, plan2 = "mixed", n2, notch_plan(n2)
        elif (n2 <= ROW_MAX and _divisors(n2) == [1, n2]
              and not _generic(notch_plan(n2 - 1))
              and len(notch_plan(n2 - 1)) >= 2):
            rows, m2, plan2 = "rader", n2 - 1, notch_plan(n2 - 1)
        else:
            m2 = _pow2ceil(2 * n2 - 1)
            plan2 = tuple(_pow2_passes(m2.bit_length() - 1))
            rows = "chirp"
            if m2 > ROW_MAX or len(plan2) < 2:
                continue
        key = (("mixed", "rader", "chirp").index(rows),
               m2 if rows == "chirp" else 0,
               max(top(n1), top(n2) if rows == "mixed" else 0),
               top(n1) > 0, max(n1, n2) / min(n1, n2), n1)
        if best is None or key < best[0]:
            best = (key, LongPlan("mixed", n, n1, notch_plan(n1), n2, rows,
                                  m2, plan2))
    if best is not None:
        return best[1]
    m = _pow2ceil(2 * n - 1)
    a = m.bit_length() - 1
    n1 = 1 << max(min(a // 2, LONG_N1_MAX.bit_length() - 1), a - (
        ROW_MAX.bit_length() - 1), 1)
    n2 = m // n1
    return LongPlan("chirp", m, n1, tuple(_pow2_passes(n1.bit_length() - 1)),
                    n2, "mixed", n2, tuple(_pow2_passes(n2.bit_length() - 1)))


def notch_long_plan(n: int) -> LongPlan:
    """The long form's split of a line of n (2 .. NOTCH_MAX_N), a function
    of n alone: among the divisors n1 <= LONG_N1_MAX of n (n2 = n / n1 >=
    2) whose sub-plans have no generic radix past GENERIC_MAX (n2's
    otherwise, n2 prime, on Rader's cyclic convolution of n2 - 1 on the
    specialised radices, else on the row's chirp-z transform of
    pow2ceil(2 n2 - 1) points; each at most ROW_MAX), mixed-radix rows
    first, then Rader's, then the smallest row chirp, the smallest generic
    radix, n1 without one, n1 nearest n2, the smaller n1; no such split:
    the whole line's chirp-z transform, m = pow2ceil(2n - 1) split into
    powers of two, n1 = 2^(log2(m) // 2) within the limits."""
    n = int(n)
    _check_length(n)
    if n < 2:
        raise ValueError("notch: the long form takes lines of 2 or more")
    return _long_plan(n)


def notch_route(n: int) -> str:
    """The long form's route for lines of n: "chirp" where n has no split
    (`notch_long_plan`), else "mixed" (also n = 1; the shared-memory
    kernel always runs `notch_plan(n)`)."""
    n = int(n)
    _check_length(n)
    return "mixed" if n < 2 else notch_long_plan(n).route


def notch_length(n: int) -> int:
    """The length of the long form's transform for lines of n: n, or on
    the chirp route pow2ceil(2n - 1), where the circular convolution of n
    values with the chirp's 2n - 1 is linear."""
    return int(n) if int(n) < 2 else notch_long_plan(n).m


def notch_long_launches(n: int) -> int:
    """The long form's launches for a subband of lines of n: kernels a, b,
    c, twice on the chirp route."""
    return 6 if notch_route(n) == "chirp" else 3


def notch_is_long(shape: Sequence[int], axis: int) -> bool:
    """Whether K8 notches a contiguous (..., H, W) subband of `shape` along
    `axis` in the long form: a line pair's buffers past shared memory,
    launches of its own ("notch_long")."""
    n = int(shape[axis])
    return notch_geometry(
        math.prod(shape[:-2]), shape[-2], shape[-1], axis == -2,
        generic=_generic(notch_plan(n)))["smem"] == 0


def notch_steps(plan: Tuple[int, ...],
                chirp: bool = False) -> List[Tuple[str, int]]:
    """csrc/notch.cuh `step_of`: the steps of an item, (kind, pass), one
    barrier after each.  P specialised passes: DIF 0 .. P-2 (forward; the
    first reads device memory), MID on pass P-1 (forward DFT, gain,
    conjugation, DFT in registers), DIT P-2 .. 0 (the last writes device
    memory); a generic last radix: GEN_DIF into the second buffer and
    GEN_DIT back in place of MID; one pass: LOAD, the middle, STORE
    (GEN_DIT stores itself).  The chirp-z transform (a row chirp): the
    2P - 1 steps twice, MIDC (the complex gains) in the middle."""
    P, gen = len(plan), _generic(plan)
    if chirp:
        half = ([("DIF", p) for p in range(P - 1)] + [("MIDC", P - 1)]
                + [("DIT", p) for p in range(P - 2, -1, -1)])
        return half + half
    if P == 1:
        return [("LOAD", 0), ("GEN_DIF" if gen else "MID", 0),
                ("GEN_DIT" if gen else "STORE", 0)]
    mid = [("GEN_DIF", P - 1), ("GEN_DIT", P - 1)] if gen else [("MID",
                                                                 P - 1)]
    return ([("DIF", p) for p in range(P - 1)] + mid
            + [("DIT", p) for p in range(P - 2, -1, -1)])


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _pow2ceil(v: int) -> int:
    return 1 << max(int(v) - 1, 0).bit_length()


def notch_geometry(B: int, H: int, W: int, cols: bool,
                   aligned8: bool = True, generic: bool = False) -> dict:
    """csrc/notch.cuh `geometry` of (B, H, W) along the columns (axis -2,
    n = H) or the rows (n = W): THREADS threads a block, CP line pairs an
    item, T = THREADS / CP threads a pair, the slots of one buffer (`buf`
    float2; `nbuf` 2 for a plan with a generic radix), shared memory bytes
    (0: the buffers of a pair pass shared memory, the long form)."""
    return dict(_geometry(int(B), int(H), int(W), bool(cols),
                          bool(aligned8), bool(generic)))


@lru_cache(maxsize=512)
def _geometry(B: int, H: int, W: int, cols: bool, aligned8: bool,
              generic: bool) -> tuple:
    n = H if cols else W
    t0 = min(max(_pow2ceil(_cdiv(n, VALUES)), TMIN), THREADS)
    CP = THREADS // t0
    if not cols:
        pairs = B * _cdiv(H, 2)
        while CP > 1 and CP // 2 >= pairs:
            CP //= 2
        pitch = (n - 1 + ((n - 1) >> 4) + 1) | 1
        buf = CP * pitch
        tiles, vec2 = 0, False
        items = _cdiv(pairs, CP)
    else:
        CP = min(CP, _pow2ceil(_cdiv(W, 2)))
        pitch = 0
        last = CP * n - 1
        buf = last + (last >> 4) + 1
        tiles = _cdiv(_cdiv(W, 2), CP)
        vec2 = bool(aligned8 and W % 2 == 0)
        pairs = B * _cdiv(W, 2)
        items = B * tiles
    nbuf = 2 if generic else 1
    smem = 8 * nbuf * buf if 8 * nbuf * buf <= SMEM_LIMIT else 0
    return tuple(dict(n=n, cols=int(cols), CP=CP, T=THREADS // CP,
                      threads=THREADS, pitch=pitch, buf=buf, nbuf=nbuf,
                      smem=smem, tiles=tiles, vec2=int(vec2), pairs=pairs,
                      items=items).items())


def _ystore(H: int, W: int, cols: bool, aligned8: bool, chirp: bool) -> bool:
    """Whether y holds the long form's storage between its kernels: every
    line pair has both lines (and float2 columns), off the chirp route."""
    return not chirp and (W % 2 == 0 and aligned8 if cols else H % 2 == 0)


def notch_long_geometry(B: int, H: int, W: int, cols: bool,
                        aligned8: bool = True, plan: LongPlan = None) -> dict:
    """csrc/notch.cuh `long_geometry` of (B, H, W) along the columns or the
    rows on the split `plan` (`notch_long_plan(n)` unless given): the
    strided kernels' tiles (C columns: CPt column pairs by TJ j2 along y,
    C j2 along x; T threads a column; items), the row kernel's blocks (R
    rows, Tb threads a row, slots, items), shared memory bytes of each
    kernel, whether y is the storage (`ystore`, else a scratch of
    `scratch` float2)."""
    return dict(_long_geometry(int(B), int(H), int(W), bool(cols),
                               bool(aligned8), plan or notch_long_plan(
                                   H if cols else W)))


@lru_cache(maxsize=512)
def _long_geometry(B: int, H: int, W: int, cols: bool, aligned8: bool,
                   lp: LongPlan) -> tuple:
    n = H if cols else W
    n1, n2, m2 = lp.n1, lp.n2, lp.m2
    WP = _cdiv(W, 2) if cols else 0
    pairs = B * WP if cols else B * _cdiv(H, 2)
    ystore = _ystore(H, W, cols, aligned8, lp.route == "chirp")
    nbufc = 2 if _generic(lp.plan1) else 1
    C = TILE_CMAX
    while C > 1 and C * n1 * nbufc > TILE_VALUES:
        C //= 2
    CPt = min(C, _pow2ceil(WP)) if cols else 1
    TJ = C // CPt
    ntj = _cdiv(n2, TJ)
    ngp = _cdiv(WP, CPt) if cols else 0
    lc = C * n1 - 1
    bufc = lc + (lc >> 4) + 1
    nbufb = 2 if _generic(lp.plan2) or lp.rows == "rader" else 1
    # Rader's rows: buffers of the row's n2 values, a[0] and two sums a row
    scalars = 3 if lp.rows == "rader" else 0
    length = n2 if lp.rows == "rader" else m2
    R = THREADS // min(max(_pow2ceil(_cdiv(m2, VALUES)), TMIN), THREADS)
    if cols:
        R = min(max(R, ROWS_Y), _pow2ceil(WP))
    while True:
        if cols:
            pitch, last = 0, R * length - 1
            bufb = last + (last >> 4) + 1
        else:
            pitch = (length - 1 + ((length - 1) >> 4) + 1) | 1
            bufb = R * pitch
        smem_b = 8 * (nbufb * bufb + scalars * R)
        if R == 1 or smem_b <= ROW_SMEM:
            break
        R //= 2
    ngr = _cdiv(WP, R) if cols else 0
    return tuple(dict(
        n=n, m=lp.m, n1=n1, n2=n2, m2=m2, chirp=int(lp.route == "chirp"),
        rows=ROWS.index(lp.rows), cols=int(cols), pairs=pairs,
        WP=WP, ystore=int(ystore), scratch=0 if ystore else pairs * lp.m,
        C=C, T=THREADS // C, CPt=CPt, TJ=TJ, ntj=ntj, ngp=ngp, bufc=bufc,
        nbufc=nbufc, smem_a=8 * bufc, smem_c=8 * nbufc * bufc,
        items_ac=B * ngp * ntj if cols else pairs * ntj, R=R,
        Tb=THREADS // R, pitch=pitch, bufb=bufb, nbufb=nbufb, ngr=ngr,
        smem_b=smem_b,
        items_b=B * ngr * n1 if cols else _cdiv(pairs * n1, R)).items())


def _spectrum_order(m: int, plan) -> np.ndarray:
    """The element where the forward passes of `plan` (radices multiplying
    to m) leave frequency f, for every f < m: f = k_0 + r_0 k_1 + r_0 r_1
    k_2 + ... sits at sum_p k_p M_p, M_p = m / (r_0 ... r_p)."""
    rest, at, M = np.arange(m), np.zeros(m, np.int64), m
    for r in plan:
        M //= r
        at += (rest % r) * M
        rest //= r
    return at


def notch_gains(g: np.ndarray, n: int, plan=None) -> np.ndarray:
    """The shared-memory kernel's gains (n) f32: G[f] / n = g[min(f, n -
    f)] / n, float64 rounded once, at the element where the forward passes
    of the plan (`notch_plan(n)` unless given) leave frequency f
    (`_spectrum_order`)."""
    gp = np.empty(n, np.float32)
    gp[_spectrum_order(n, notch_plan(n) if plan is None else plan)] = \
        _gains64(g, n).astype(np.float32)
    return gp


def _gains64(g: np.ndarray, n: int) -> np.ndarray:
    """G[f] / n = g[min(f, n - f)] / n, f < n, in float64."""
    f = np.arange(n)
    return np.asarray(g, np.float64)[np.minimum(f, n - f)] / n


@lru_cache(maxsize=8)
def _chirp(L: int) -> Tuple[np.ndarray, np.ndarray]:
    """The chirp-z transform of length L in float64: c[j] = exp(-i pi (j^2
    mod 2L) / L), j < L (phases in integers), and Hm = DFT_M(h) / M in
    natural order, M = pow2ceil(2L - 1), h = conj(c) laid out circularly
    (h[j] at j and M - j, j < L; 0 between)."""
    M = _pow2ceil(2 * L - 1)
    j = np.arange(L, dtype=np.int64)
    c = np.exp(-1j * np.pi * ((j * j) % (2 * L)) / L)
    h = np.zeros(M, np.complex128)
    h[:L] = np.conj(c)
    h[M - L + 1:] = np.conj(c[1:])[::-1]
    return c, np.fft.fft(h) / M


def _frozen(tables: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """the arrays read-only: the cache hands out the same ones"""
    for v in tables.values():
        v.flags.writeable = False
    return tables


@lru_cache(maxsize=8)
def _rader_perm(p: int) -> np.ndarray:
    """g^q mod p, q < p - 1, for the smallest primitive root g of the
    prime p (int64, read-only)."""
    for g in range(2, p):
        v, order = 1, 0
        while True:
            v = v * g % p
            order += 1
            if v == 1:
                break
        if order == p - 1:
            break
    perm = np.empty(p - 1, np.int64)
    v = 1
    for q in range(p - 1):
        perm[q] = v
        v = v * g % p
    perm.flags.writeable = False
    return perm


def _pairs(v: np.ndarray) -> np.ndarray:
    """complex (k) -> (k, 2) f32 (re, im), rounded once."""
    return np.ascontiguousarray(np.stack([v.real, v.imag], -1).astype(
        np.float32))


def notch_long_tables(g: np.ndarray, n: int, plan: LongPlan = None
                      ) -> Dict[str, np.ndarray]:
    """The long form's tables for lines of n on the split `plan`
    (`notch_long_plan(n)` unless given: n1, n2, m2, the plans), float64
    rounded once: rev1 (n1) int32, the frequency k1 that plan1's forward
    passes leave at row r; twr (m, 2) f32, the four-step's twiddles
    w_m^(j2 k1) by row (at r n2 + j2); gp f32: the direct route's gains
    G[k1 + n1 k2] / n at r m2 + the element where plan2's passes leave k2
    (with a row chirp at r n2 + k2), the chirp route's G / n in natural
    order (the first (c) stores them); on the chirp route chirp (n, 2) =
    c and hm (m, 2) = Hm[k1 + n1 k2] in the direct route's order; with a
    row chirp c2 (n2, 2) and hm2 (m2, 2) of the row's chirp-z transform
    in plan2's order; with Rader's rows perm (m2) int32, g^q mod n2 for a
    primitive root g, hm2 (m2, 2) = DFT(t) / m2 in plan2's order, t[s] =
    w_n2^(g^-s), and gp G[k1] / n then G[k1 + n1 g^q] / n a row (n2 a
    row)."""
    return _long_tables(np.ascontiguousarray(g, np.float32).tobytes(), n,
                        plan or notch_long_plan(n))


@lru_cache(maxsize=4)
def _long_tables(gbytes: bytes, n: int, lp: LongPlan
                 ) -> Dict[str, np.ndarray]:
    """notch_long_tables of g as bytes (the cache's key); read-only."""
    g = np.frombuffer(gbytes, np.float32)
    n1, n2, m2 = lp.n1, lp.n2, lp.m2
    rev1 = np.argsort(_spectrum_order(n1, lp.plan1)).astype(np.int32)
    j2 = np.arange(n2)[None, :]
    freq = rev1[:, None].astype(np.int64) + n1 * j2
    out = dict(rev1=rev1, twr=_pairs(np.exp(
        -2j * np.pi * (j2 * rev1[:, None].astype(np.int64)).reshape(-1)
        / lp.m)))
    if lp.route == "chirp":
        c, H = _chirp(n)
        hm = np.empty((n1, m2), np.complex128)
        hm[:, _spectrum_order(m2, lp.plan2)] = H[freq]
        out.update(gp=_gains64(g, n).astype(np.float32), chirp=_pairs(c),
                   hm=_pairs(hm.reshape(-1)))
        return _frozen(out)
    G = _gains64(g, n)
    if lp.rows == "rader":
        perm = _rader_perm(n2)
        t = np.exp(-2j * np.pi * perm[(-np.arange(m2)) % m2] / n2)
        hm2 = np.empty(m2, np.complex128)
        hm2[_spectrum_order(m2, lp.plan2)] = np.fft.fft(t) / m2
        gp = np.concatenate([G[rev1][:, None], G[freq[:, 0:1] + n1 * perm[
            None, :]]], 1)
        out.update(gp=gp.astype(np.float32).reshape(-1),
                   perm=perm.astype(np.int32), hm2=_pairs(hm2))
        return _frozen(out)
    if lp.rows == "chirp":
        c2, H2 = _chirp(n2)
        hm2 = np.empty(m2, np.complex128)
        hm2[_spectrum_order(m2, lp.plan2)] = H2
        out.update(gp=G[freq].astype(np.float32).reshape(-1),
                   c2=_pairs(c2), hm2=_pairs(hm2))
        return _frozen(out)
    gp = np.empty((n1, m2), np.float32)
    gp[:, _spectrum_order(m2, lp.plan2)] = G[freq]
    out.update(gp=gp.reshape(-1))
    return _frozen(out)


def _check(x: torch.Tensor, g, axis: int
           ) -> Tuple[np.ndarray, int, int, int, int]:
    """Validate the arguments; returns g as f32 numpy and (B, H, W, n) of x
    as (B, H, W).  A tensor g must lie on x's device."""
    name = "notch"
    if isinstance(g, torch.Tensor):
        if g.device != x.device:
            raise ValueError(f"{name}: x and g on two devices ({x.device}, "
                             f"{g.device})")
        g = g.detach().cpu().numpy()
    g = np.ascontiguousarray(g, np.float32)
    if axis not in (-1, -2):
        raise ValueError(f"{name}: axis must be -1 or -2, got {axis}")
    if x.dim() < -axis:
        raise ValueError(f"{name}: axis {axis} of a {x.dim()}-d input")
    if x.dtype != torch.float32:
        raise TypeError(f"{name}: float32 only (got {x.dtype})")
    n = x.shape[axis]
    _check_length(n)
    if tuple(np.shape(g)) != (n // 2 + 1,):
        raise ValueError(f"{name}: g must have n // 2 + 1 = {n // 2 + 1} "
                         f"entries, got shape {tuple(np.shape(g))}")
    W = x.shape[-1]
    H = x.shape[-2] if x.dim() > 1 else 1
    return g, x.numel() // max(H * W, 1), H, W, n


def notch_filter_plain(x: torch.Tensor, g, axis: int = -1) -> torch.Tensor:
    """irfft(rfft(x) * g, n) along `axis` (-1 or -2) with torch.fft; g the
    (n // 2 + 1) real notch (numpy, or a tensor on x's device)."""
    g, _, _, _, n = _check(x, g, axis)
    f = torch.fft.rfft(x, dim=axis)
    gt = torch.from_numpy(g).to(x.device)
    shape = [1] * f.dim()
    shape[axis] = f.shape[axis]
    return torch.fft.irfft(f * gt.reshape(shape), n=n, dim=axis)


def notch_filter_group_plain(xs: Sequence[torch.Tensor], gs,
                             axes: Sequence[int]) -> List[torch.Tensor]:
    """`notch_filter_plain` of every (x, g, axis), in order."""
    return [notch_filter_plain(x, g, a) for x, g, a in zip(xs, gs, axes)]


_tables: Dict[tuple, Tuple[np.ndarray, torch.Tensor]] = {}
_tables_lock = threading.Lock()


def _device_table(key: tuple, make, g: np.ndarray = None) -> torch.Tensor:
    """make() as a tensor on key[0], the device, uploaded once per key;
    with g, once per key and notch g: the entry keeps a copy of g and a hit
    compares it in full (a long line's g is up to 2 MB, whose bytes took ~1
    ms a call to hash as a key; the key holds a sample of it)."""
    with _tables_lock:
        kept = _tables.get(key)
        if kept is None or g is not None and not np.array_equal(kept[0], g):
            if len(_tables) >= 256:
                _tables.clear()
            kept = _tables[key] = (None if g is None else g.copy(),
                                   torch.tensor(make()).to(key[0]))
        return kept[1]


def _sample(g: np.ndarray) -> bytes:
    """32 values of g, spread over it: a key that tells notches apart"""
    return g[::max(1, g.size // 32)].tobytes()


def _desc_row(x: torch.Tensor, y: torch.Tensor, g: np.ndarray, B: int,
              H: int, W: int, axis: int) -> Tuple[list, list]:
    """The table row of x -> y for `ipp_notch_group` (csrc/notch.cuh
    `make_group`: x, y, tw, gp, B, H, W, cols, passes, generic, radices)
    and the device tables it points into (keep them alive until the
    launch is enqueued)."""
    n = H if axis == -2 else W
    plan = notch_plan(n)
    tw = _stage_twiddles(x.device, n)
    gp = _device_table((x.device, "gains", n, g.tobytes()),
                       lambda: notch_gains(g, n))
    row = ([x.data_ptr(), y.data_ptr(), tw.data_ptr(), gp.data_ptr(), B, H,
            W, int(axis == -2), len(plan), int(_generic(plan))]
           + list(plan) + [1] * (MAX_PASSES - len(plan)))
    return row, [tw, gp]


def _long_row(x: torch.Tensor, y: torch.Tensor, g: np.ndarray, B: int,
              H: int, W: int, axis: int, plan: LongPlan = None
              ) -> Tuple[list, list]:
    """The row of x -> y for `ipp_notch_long` (csrc/notch.cuh `make_long`:
    x, y, the scratch, twr, tw1, tw2, gp, chirp, hm, c2 or perm, hm2,
    B, H, W, cols, n1, n2, chirp route, the rows' kind (`ROWS`), npass and
    generic of each plan, the radices of each) on the split `plan`
    (`notch_long_plan(n)` unless given) and the tensors it points into:
    the device tables and, where y cannot hold the storage between the
    kernels, a scratch of the subband's pairs x m complex values."""
    n = H if axis == -2 else W
    lp = plan or notch_long_plan(n)
    aligned8 = x.data_ptr() % 8 == 0 and y.data_ptr() % 8 == 0
    geo = notch_long_geometry(B, H, W, axis == -2, aligned8, lp)
    names = ["twr", "gp"] + (["chirp", "hm"] if lp.route == "chirp" else
                              ["c2", "hm2"] if lp.rows == "chirp" else
                              ["perm", "hm2"] if lp.rows == "rader" else [])
    tables = {name: _device_table((x.device, "long", name, n, lp),
                                  lambda name=name: notch_long_tables(
                                      g, n, lp)[name])
              for name in names if name != "gp"}
    tables["gp"] = _device_table((x.device, "long gains", n, lp, _sample(g)),
                                 lambda: notch_long_tables(g, n, lp)["gp"], g)
    tw1, tw2 = (_stage_twiddles(x.device, v) for v in (lp.n1, lp.m2))
    scratch = None if geo["ystore"] else torch.empty(
        2 * geo["scratch"], dtype=torch.float32, device=x.device)

    def ptr(t):
        return 0 if t is None else t.data_ptr()
    row = [x.data_ptr(), y.data_ptr(), ptr(scratch), ptr(tables["twr"]),
           tw1.data_ptr(), tw2.data_ptr(), ptr(tables["gp"]),
           ptr(tables.get("chirp")), ptr(tables.get("hm")),
           ptr(tables.get("c2", tables.get("perm"))), ptr(tables.get("hm2")),
           B, H, W, int(axis == -2), lp.n1, lp.n2, int(lp.route == "chirp"),
           ROWS.index(lp.rows)]
    for plan in (lp.plan1, lp.plan2):
        row += [len(plan), int(_generic(plan))]
    for plan in (lp.plan1, lp.plan2):
        row += list(plan) + [1] * (MAX_PASSES - len(plan))
    return row, [tw1, tw2, scratch, *tables.values()]


def _launches(xs, checked, axes, ys) -> List[tuple]:
    """The launches of the subbands xs -> ys on the card (`checked`: their
    `_check` results): (counter, C entry, its arguments but the stream,
    the kernels it launches, the tensors to keep alive) each; subbands
    whose buffers fit shared memory MAX_GROUP a launch in order ("notch",
    `ipp_notch_group`), each other one in the long form ("notch_long",
    one call of `ipp_notch_long` for its kernels a, b, c, twice on the
    chirp route)."""
    grouped, alone = [], []
    for x, (g, B, H, W, _), axis, y in zip(xs, checked, axes, ys):
        if x.numel() == 0:
            continue
        if not notch_is_long((B, H, W), axis):
            grouped.append(_desc_row(x, y, g, B, H, W, axis))
            continue
        row, keep = _long_row(x, y, g, B, H, W, axis)
        table = np.asarray(row, np.int64)
        kernels = notch_long_launches(H if axis == -2 else W)
        alone.append(("notch_long", "ipp_notch_long",
                      (table.ctypes.data,), kernels,
                      [table] + keep))
    out = []
    for i in range(0, len(grouped), MAX_GROUP):
        part = grouped[i:i + MAX_GROUP]
        table = np.asarray([r for r, _ in part], np.int64)
        out.append(("notch", "ipp_notch_group",
                    (table.ctypes.data, len(part)), 1,
                    [table] + [t for _, k in part for t in k]))
    return out + alone


def notch_filter_group(xs: Sequence[torch.Tensor], gs,
                       axes: Sequence[int]) -> List[torch.Tensor]:
    """K8 on every subband (x, g, axis) of the lists: `notch_filter` of
    each, in one launch for up to MAX_GROUP subbands whose buffers fit
    shared memory, three (six on the chirp route) of the long form for
    each other one.  x f32 (..., H, W), contiguous; every x on the CPU
    (the plain version) or all on one CUDA device; g the (n // 2 + 1)
    notch of its axis, best on the host."""
    name = "notch"
    xs, axes = list(xs), list(axes)
    gs = list(gs)
    if not (len(xs) == len(gs) == len(axes)):
        raise ValueError(f"{name}: {len(xs)} inputs, {len(gs)} notches and "
                         f"{len(axes)} axes")
    if not xs:
        return []
    checked = [_check(x, g, a) for x, g, a in zip(xs, gs, axes)]
    if not _on_cuda(name, *xs):
        return notch_filter_group_plain(xs, [c[0] for c in checked], axes)
    ys = [torch.empty_like(x) for x in xs]
    from ._build import load_library

    lib = load_library()
    for counter, entry, args, kernels, keep in _launches(xs, checked, axes,
                                                         ys):
        _launch(counter, xs[0].device, getattr(lib, entry), *args,
                counts=LAUNCHES, kernels=kernels)
        del keep
    return ys


def notch_filter(x: torch.Tensor, g, axis: int = -1) -> torch.Tensor:
    """K8: see `notch_filter_plain`; a group of one subband.  x f32 (...,
    H, W), contiguous on the card; g the (n // 2 + 1) notch, best on the
    host (numpy)."""
    return notch_filter_group([x], [g], [axis])[0]
