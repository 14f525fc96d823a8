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

Lengths 1 .. `NOTCH_MAX_N` (2^20) of any factors, by a route of n alone
(`notch_route`): "mixed", the mixed-radix passes of `notch_plan(n)`, for
every n up to `NOTCH_SHORT_N` and above it where the odd factor left
after 3, 5, 7, 11 and 13 is at most `CHIRP_P`; "chirp", Bluestein's
chirp-z transform on the power-of-two passes of pow2ceil(2n - 1), for
the other lines above `NOTCH_SHORT_N`.  Lines whose buffers fit shared
memory run in the shared-memory kernel, MAX_GROUP subbands a launch;
longer ones (above ~27000 values, or ~13600 with a generic radix) in
the long form K8l, their buffers in a device-memory scratch, one launch
each.

The wrappers keep the rules of `cuda_fft`: CPU tensors go to the plain
PyTorch version (`notch_filter_plain`, the torch.fft body, one call a
subband); a CUDA tensor launches the kernel or raises, with no fallback;
`LAUNCHES` counts kernel launches only: "notch" one a group of up to
`MAX_GROUP` shared-memory subbands, "notch_long" one for each subband of
the long form (none on the destripe chain of camera tiles).
"""

from __future__ import annotations

import threading
from functools import lru_cache
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from .cuda_fft import _launch, _on_cuda, _stage_twiddles
from .dft_mats import DFT_FFT_RADICES

__all__ = ["LAUNCHES", "NOTCH_MAX_N", "NOTCH_SHORT_N", "CHIRP_P",
           "MAX_GROUP", "reset_launch_counts", "notch_route",
           "notch_length", "notch_plan", "notch_is_long",
           "notch_geometry", "notch_steps", "notch_gains", "chirp_tables",
           "notch_filter", "notch_filter_plain", "notch_filter_group",
           "notch_filter_group_plain"]

# 2^20 (csrc/notch.cuh MAX_N): a level-1 line of a padded side of 2^21
# px, 88 cm at 0.42 um, which no stitched plane reaches; the longest length
# the card tests hold to the plain version, where a chirp line's buffer is
# already 17.8 MB a block (a transform of 2^21)
NOTCH_MAX_N = 1 << 20
NOTCH_SHORT_N = 32768        # lengths up to it: the mixed-radix plans only
# above NOTCH_SHORT_N, an odd factor left above CHIRP_P takes the chirp
# route: a generic pass costs ~p loads a value each way, and its f32 sums
# grow with p (held to 1e-5 on the card up to p = 32749).  The widest real
# planes give p = 521 (n = 33344), kept on the mixed-radix passes; on an
# H100 the chirp route was 1.75x faster there and slower at p = 23 and 59
# (scripts/notch_bench.py --long, PERF.md), so the threshold could fall
# between those
CHIRP_P = 1024
SMEM_LIMIT = 227 * 1024
THREADS = 256                # every block
VALUES = 24                  # values a thread aims at a pass
TMIN = 16                    # threads a pair at least
MINB_LONG = 2                # the long form's blocks an SM
SCRATCH_BYTES = 1 << 29      # the long form's scratch, at most
MAX_GROUP = 16               # subbands a launch
MAX_PASSES = 12              # csrc/dft_fft.cuh
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


def _odd_rest(n: int) -> int:
    """What is left of n after its factors 2, 3, 5, 7, 11 and 13."""
    for r in (2, 3, 5, 7, 11, 13):
        while n % r == 0:
            n //= r
    return n


def notch_route(n: int) -> str:
    """K8's route for lines of n: "chirp" above NOTCH_SHORT_N where the
    odd factor left after 3, 5, 7, 11 and 13 passes CHIRP_P, else
    "mixed"."""
    n = int(n)
    _check_length(n)
    return ("chirp" if n > NOTCH_SHORT_N and _odd_rest(n) > CHIRP_P
            else "mixed")


def notch_length(n: int) -> int:
    """The length of K8's transforms for lines of n: n, or on the chirp
    route pow2ceil(2n - 1), where the circular convolution of n values
    with the chirp's 2n - 1 is linear."""
    return _pow2ceil(2 * int(n) - 1) if notch_route(n) == "chirp" else int(n)


@lru_cache(maxsize=512)
def notch_plan(n: int) -> Tuple[int, ...]:
    """Radices of K8's passes for lines of length n, in order.  On the
    chirp route the passes of notch_length(n) (`_pow2_passes`).  Else t
    passes of 12 = 4 * 3 first, then the passes of the 2^(a - 2t) left
    (`_pow2_passes`), then 9s and a 3 for the 3s left, 5, 7, 11, 13 for
    those factors of the odd part, and last what is left of it, if
    anything, as ONE generic pass of that odd radix (n = 1: the generic
    pass of 1).  t gives the fewest passes, the most 12s among equals
    (the fastest plans of scripts/notch_bench.py --sweep on an H100 at
    1344, 1152 and 672; PERF.md §6)."""
    n = int(n)
    if notch_route(n) == "chirp":
        return tuple(_pow2_passes(notch_length(n).bit_length() - 1))
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


def _flags(n: int) -> dict:
    """`generic` and `chirp` of `notch_geometry` for lines of n."""
    chirp = notch_route(n) == "chirp"
    return dict(generic=not chirp and _generic(notch_plan(n)), chirp=chirp)


def notch_is_long(shape: Sequence[int], axis: int) -> bool:
    """Whether K8 notches a contiguous (..., H, W) subband of `shape` along
    `axis` in the long form: a line pair's buffers past shared memory,
    one "notch_long" launch of its own."""
    return notch_geometry(
        int(np.prod(shape[:-2], dtype=np.int64)), shape[-2], shape[-1],
        axis == -2, **_flags(int(shape[axis])))["smem"] == 0


def notch_steps(plan: Tuple[int, ...],
                chirp: bool = False) -> List[Tuple[str, int]]:
    """csrc/notch.cuh `step_of`: the steps of an item, (kind, pass), one
    barrier after each.  P specialised passes: DIF 0 .. P-2 (forward; the
    first reads device memory), MID on pass P-1 (forward DFT, gain,
    conjugation, DFT in registers), DIT P-2 .. 0 (the last writes device
    memory); a generic last radix: GEN_DIF into the second buffer and
    GEN_DIT back in place of MID; one pass: LOAD, the middle, STORE
    (GEN_DIT stores itself).  The chirp route: the 2P - 1 steps twice,
    MIDC (the complex gains) in the middle."""
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
                   aligned8: bool = True, generic: bool = False,
                   chirp: bool = False) -> dict:
    """csrc/notch.cuh `geometry` of (B, H, W) along the columns (axis -2,
    n = H) or the rows (n = W): THREADS threads a block, CP line pairs an
    item, T = THREADS / CP threads a pair, the slots of one buffer (`buf`
    float2 for a transform of m, `notch_length(n)` on the chirp route,
    else n; `nbuf` 2 for a plan with a generic radix), shared memory bytes
    (0: the buffers of a block live in a device-memory scratch, the long
    form)."""
    return dict(_geometry(int(B), int(H), int(W), bool(cols),
                          bool(aligned8), bool(generic), bool(chirp)))


@lru_cache(maxsize=512)
def _geometry(B: int, H: int, W: int, cols: bool, aligned8: bool,
              generic: bool, chirp: bool) -> tuple:
    n = H if cols else W
    m = _pow2ceil(2 * n - 1) if chirp else n
    t0 = min(max(_pow2ceil(_cdiv(m, VALUES)), TMIN), THREADS)
    CP = THREADS // t0
    if not cols:
        pairs = B * _cdiv(H, 2)
        while CP > 1 and CP // 2 >= pairs:
            CP //= 2
        pitch = (m - 1 + ((m - 1) >> 4) + 1) | 1
        buf = CP * pitch
        tiles, vec2 = 0, False
        items = _cdiv(pairs, CP)
    else:
        CP = min(CP, _pow2ceil(_cdiv(W, 2)))
        pitch = 0
        last = CP * m - 1
        buf = last + (last >> 4) + 1
        tiles = _cdiv(_cdiv(W, 2), CP)
        vec2 = bool(aligned8 and W % 2 == 0)
        pairs = B * _cdiv(W, 2)
        items = B * tiles
    nbuf = 2 if generic else 1
    smem = 8 * nbuf * buf if 8 * nbuf * buf <= SMEM_LIMIT else 0
    return tuple(dict(n=n, m=m, chirp=int(chirp), cols=int(cols), CP=CP,
                      T=THREADS // CP, threads=THREADS, pitch=pitch, buf=buf,
                      nbuf=nbuf, smem=smem, tiles=tiles, vec2=int(vec2),
                      pairs=pairs, items=items).items())


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
    """The kernel's gains (n) f32: G[f] / n = g[min(f, n - f)] / n, float64
    rounded once, at the element where the forward passes of the plan
    (`notch_plan(n)` unless given) leave frequency f (`_spectrum_order`);
    on the chirp route (without a plan) in natural order, where the first
    transform's store takes them."""
    f = np.arange(n)
    G = (np.asarray(g, np.float64)[np.minimum(f, n - f)] / n).astype(
        np.float32)
    if plan is None and notch_route(n) == "chirp":
        return G
    gp = np.empty(n, np.float32)
    gp[_spectrum_order(n, notch_plan(n) if plan is None else plan)] = G
    return gp


@lru_cache(maxsize=4)
def chirp_tables(n: int) -> Tuple[np.ndarray, np.ndarray]:
    """The chirp route's tables for lines of n (past NOTCH_SHORT_N, the
    kernel's rule; `notch_route` picks the lines that take them), m =
    pow2ceil(2n - 1): the chirp c (n, 2) f32, c[j] = exp(-i pi (j^2 mod
    2n) / n), and the complex gains (m, 2) f32, Hm = DFT_m(h) / m of h =
    conj(c) laid out circularly (h[j] at j and m - j, j < n; 0 between), at
    the elements of the forward passes' order (`_spectrum_order` of the
    passes of m).  Phases in integers, everything in float64, rounded
    once."""
    if not NOTCH_SHORT_N < n <= NOTCH_MAX_N:
        raise ValueError(f"notch: the chirp route takes lines of "
                         f"{NOTCH_SHORT_N + 1} to {NOTCH_MAX_N}, got {n}")
    m = _pow2ceil(2 * n - 1)
    j = np.arange(n, dtype=np.int64)
    c = np.exp(-1j * np.pi * ((j * j) % (2 * n)) / n)
    h = np.zeros(m, np.complex128)
    h[:n] = np.conj(c)
    h[m - n + 1:] = np.conj(c[1:])[::-1]
    hm = np.empty(m, np.complex128)
    hm[_spectrum_order(m, _pow2_passes(m.bit_length() - 1))] = \
        np.fft.fft(h) / m

    def pairs(v):   # read-only: the cache hands out the same arrays
        out = np.ascontiguousarray(np.stack([v.real, v.imag], -1).astype(
            np.float32))
        out.flags.writeable = False
        return out
    return pairs(c), pairs(hm)


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


_tables: Dict[tuple, torch.Tensor] = {}
_tables_lock = threading.Lock()


def _device_table(key: tuple, make) -> torch.Tensor:
    """make() as a tensor on key[0], the device, uploaded once per key."""
    with _tables_lock:
        if key not in _tables:
            if len(_tables) >= 256:
                _tables.clear()
            _tables[key] = torch.tensor(make()).to(key[0])
        return _tables[key]


def _desc_row(x: torch.Tensor, y: torch.Tensor, g: np.ndarray, B: int,
              H: int, W: int, axis: int) -> Tuple[list, dict, list]:
    """The table row of x -> y for `ipp_notch_group` (csrc/notch.cuh
    `make_group`: x, y, tw, gp, B, H, W, cols, passes, generic, radices,
    chirp, hm), its geometry, and the device tables it points into (keep
    them alive until the launch is enqueued)."""
    n = H if axis == -2 else W
    plan = notch_plan(n)
    flags = _flags(n)
    chirp = flags["chirp"]
    tw = _stage_twiddles(x.device, notch_length(n))
    gp = _device_table((x.device, "gains", n, chirp, g.tobytes()),
                       lambda: notch_gains(g, n))
    keep = [tw, gp]
    ptrs = [0, 0]
    if chirp:
        keep += [_device_table((x.device, kind, n),
                               lambda k=k: chirp_tables(n)[k])
                 for k, kind in enumerate(("chirp", "hm"))]
        ptrs = [t.data_ptr() for t in keep[2:]]
    geo = notch_geometry(B, H, W, axis == -2,
                         x.data_ptr() % 8 == 0 and y.data_ptr() % 8 == 0,
                         **flags)
    row = ([x.data_ptr(), y.data_ptr(), tw.data_ptr(), gp.data_ptr(), B, H,
            W, int(axis == -2), len(plan), int(flags["generic"])]
           + list(plan) + [1] * (MAX_PASSES - len(plan)) + ptrs)
    return row, geo, keep


def _launches(xs, checked, axes, ys) -> List[tuple]:
    """The launches of the subbands xs -> ys on the card (`checked`: their
    `_check` results): (counter, table, count, scratch, nscratch, the
    tensors to keep alive) each; subbands whose buffers fit shared memory
    MAX_GROUP a launch in order ("notch"), each other one alone in the
    long form ("notch_long") with a scratch of device memory: a block's
    buffers each for up to MINB_LONG blocks an SM, SCRATCH_BYTES at most
    (at least one block)."""
    grouped, alone = [], []
    for x, (g, B, H, W, _), axis, y in zip(xs, checked, axes, ys):
        if x.numel() == 0:
            continue
        row, geo, keep = _desc_row(x, y, g, B, H, W, axis)
        if geo["smem"]:
            grouped.append((row, keep))
            continue
        sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        slots = geo["nbuf"] * geo["buf"]
        nscratch = max(1, min(geo["items"], MINB_LONG * sms,
                              SCRATCH_BYTES // (8 * slots)))
        scratch = torch.empty(nscratch * slots * 2, dtype=torch.float32,
                              device=x.device)
        alone.append(("notch_long", np.asarray([row], np.int64), 1,
                      scratch.data_ptr(), nscratch, keep + [scratch]))
    return [("notch", np.asarray([r for r, _ in part], np.int64), len(part),
             None, 0, [t for _, k in part for t in k])
            for part in (grouped[i:i + MAX_GROUP]
                         for i in range(0, len(grouped), MAX_GROUP))] + alone


def notch_filter_group(xs: Sequence[torch.Tensor], gs,
                       axes: Sequence[int]) -> List[torch.Tensor]:
    """K8 on every subband (x, g, axis) of the lists: `notch_filter` of
    each, in one launch for up to MAX_GROUP subbands.  x f32 (..., H, W),
    contiguous; every x on the CPU (the plain version) or all on one CUDA
    device; g the (n // 2 + 1) notch of its axis, best on the host."""
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

    fn = load_library().ipp_notch_group
    for counter, table, count, scratch, nscratch, keep in _launches(
            xs, checked, axes, ys):
        _launch(counter, xs[0].device, fn, table.ctypes.data, count,
                scratch, nscratch, counts=LAUNCHES)
        del keep
    return ys


def notch_filter(x: torch.Tensor, g, axis: int = -1) -> torch.Tensor:
    """K8: see `notch_filter_plain`; a group of one subband.  x f32 (...,
    H, W), contiguous on the card; g the (n // 2 + 1) notch, best on the
    host (numpy)."""
    return notch_filter_group([x], [g], [axis])[0]
