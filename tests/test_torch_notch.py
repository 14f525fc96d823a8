"""K8, the destripe notch (ipp_tpu_torch/csrc/notch.cuh), its wrapper
`cuda_notch.notch_filter` and `destripe.filter_coefficient`, on the CPU and
on the card.

- The plain version (`notch_filter_plain`, torch.fft) and
  `filter_coefficient` against the JAX package's `filter_coefficient`
  (jnp.fft on the CPU) at every line length the destripe planner gives
  (2000 x 2000 tiles: 1344 ... 21; 1600 x 2000 along y: 1152 ... 18; the
  128^3 FNT cubes: 368 ... 23; a stitched plane of 2048 x 66000: 33344;
  a prime on the long form's chirp route: 65537), on both axes, two tiles
  of three lines (an odd last line): within 1e-5 of the reference's max
  (tighter than the 1e-4 of tests/test_torch_destripe.py; both f32 FFTs).
- `notch_plan`: the radices multiply to n, every pass is a specialised
  radix but one generic odd pass last, for every n up to 4096 and a sample
  up to `NOTCH_MAX_N`; the lengths of the paths, the wide planes' among
  them.  `notch_long_plan` and `notch_route`, functions of n alone: the
  split n1 x n2 within the limits, the sub-plans' generic radices within
  GENERIC_MAX, Rader's rows for a prime past it, the rows' chirp-z
  transform or the whole line's exactly where neither applies, over the
  domain; the splits of the paths' long lengths.
- `emulate_k8`, a PyTorch emulation of the shared-memory kernel: the
  geometry (`notch_geometry`, the header's, printed by the host check),
  the item -> line pair -> line address maps of both layouts, the slot
  maps, the steps of `notch_steps` in complex64 with the f32 twiddle
  table: the in-place forward passes (DFT, then the twiddle), the middle
  (the last forward DFT, the gains of `notch_gains` in the plan's
  digit-reversed order, the conjugation, the first inverse DFT in one
  step), the inverse passes on the conjugated data (the twiddle, then the
  forward DFT), the store of y_b = -Im; against float64 numpy at every
  planner length, every output written exactly once: 1e-5 of max.
- `emulate_k8l`, the long form's: the maps of its three kernels (tiles
  of columns, rows; every column and row of every pair taken once), the
  strided passes of plan1 with the twiddle w_m^(j2 k1) at the store, the
  rows' middle on plan2 (or Rader's, or the rows' chirp-z transform) with
  the tables of `notch_long_tables`, the strided inverse passes, the
  whole-line chirp route's two rounds; against float64 at the long lengths (33344,
  35328, 65537, 131072, 16672, 2^20 - 1) on 1-2 lines and at small
  lengths of every path (on splits given explicitly too), every output
  written exactly once: 1e-5 of max.
- The header itself, built with g++ against the stand-in
  `cuda_runtime.h` (tests/torch_notch_host/check.cpp) and run thread by
  thread against a float64 irfft(rfft(x) g): the planner lengths on both
  axes, odd line counts, n = 1 and 2, primes, lines past shared memory
  (the long form, both layouts, y or a scratch as its storage, both
  routes, Rader's rows, the rows' chirp-z transform, generic radices in
  either sub-plan); each tile alone bit-equal to its place in the batch; the 14
  notches of a 2000^2 decomposition and two FNT lengths in one table
  (`make_group`, as `ipp_notch_group` launches them), and the 14 of a
  padded (2688, 66688) plane as the wrapper launches them (one table, the
  two long subbands in the long form), each bit-equal to its one-subband
  run; the wrapper's long-form rows as the header reads them.
- `notch_filter_group`'s plain version against the one-subband calls and
  `filter_subband` against the JAX package's at small shapes; the
  wrapper route of `filter_subband`: one grouped call with all 2L
  subbands.
- The wrapper: CPU calls take the plain version and count nothing; it
  refuses other dtypes, mixed devices, axes and lengths outside its
  domain.
The card's own checks are in tests/test_torch_notch_card.py (`gpu`; no
JAX there).
"""

import shutil
import subprocess
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ipp_tpu.ops import destripe as J
from ipp_tpu_torch.ops import cuda_notch as K
from ipp_tpu_torch.ops import destripe as P
from ipp_tpu_torch.ops.dft_mats import stage_twiddles

ROOT = Path(__file__).resolve().parent.parent
TOL = 1e-5
# the planner's line lengths (`destripe._plan_padding`, levels 1-7 of the
# padded shape): 2000^2 tiles (2688 both axes), 1600 x 2000 along y (2304),
# 128^3 FNT cubes (736)
TILE_2000 = (1344, 672, 336, 168, 84, 42, 21)
TILE_1600_Y = (1152, 576, 288, 144, 72, 36, 18)
FNT = (368, 184, 92, 46, 23)
LENGTHS = TILE_2000 + TILE_1600_Y + FNT
# lines past 32768: a stitched plane of 2048 x 66000 padded to 66688 (cH
# at level 1, 521 on Rader's rows), of 20000 x 70000 (a generic radix of
# 23), a prime on the chirp route, a power of two
LONG = (33344, 35328, 65537, 131072)


def _coef(rng, axis, n, lines=3, tiles=2):
    shape = (tiles, lines, n) if axis == -1 else (tiles, n, lines)
    return rng.standard_normal(shape).astype(np.float32)


def _notch(n, sigma=None):
    return P.notch(n // 2 + 1, n / 8.0 if sigma is None else sigma)


def _ref64(x, g, axis):
    """float64 irfft(rfft(x) * g, n) along `axis`."""
    n = x.shape[axis]
    f = np.fft.rfft(x.astype(np.float64), axis=axis)
    shape = [1] * f.ndim
    shape[axis] = f.shape[axis]
    return np.fft.irfft(f * g.astype(np.float64).reshape(shape), n=n,
                        axis=axis)


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


# -- the plain version and filter_coefficient against the JAX package -----------

@pytest.mark.parametrize("n", LENGTHS + (33344, 65537))
@pytest.mark.parametrize("axis", (-1, -2))
def test_filter_coefficient_matches_jax_at_the_planner_lengths(axis, n):
    rng = np.random.default_rng(n - axis)
    c = _coef(rng, axis, n)
    frac = 0.3 * n / 3     # sigma = 0.3 n: the notch spans the spectrum
    got = P.filter_coefficient(torch.from_numpy(c), frac, axis=axis)
    ref = np.asarray(J.filter_coefficient(jnp.asarray(c), frac, axis=axis))
    assert got.shape == c.shape and got.dtype == torch.float32
    assert _rel(got.numpy(), ref) <= TOL
    g = P.notch(n // 2 + 1, 0.5 * 0.3 * n)
    plain = K.notch_filter_plain(torch.from_numpy(c), g, axis)
    assert torch.equal(plain, got)   # the CPU takes the plain version


# -- the plan ------------------------------------------------------------------

def check_plan(n):
    plan = K.notch_plan(n)
    assert int(np.prod(plan)) == n
    assert all(r in K.NOTCH_RADICES for r in plan[:-1])
    last = plan[-1]
    if last not in K.NOTCH_RADICES:       # the one generic pass: odd, last
        assert last % 2 == 1
        assert last == 1 or all(last % f for f in (3, 5, 7, 11, 13))
        assert (last == 1) == (n == 1)
    return plan


@pytest.mark.parametrize("n,plan", [
    (1344, (12, 16, 7)), (672, (12, 8, 7)), (84, (12, 7)), (42, (2, 3, 7)),
    (21, (3, 7)), (1152, (12, 12, 8)), (72, (8, 9)), (36, (12, 3)),
    (18, (2, 9)), (368, (16, 23)),
    (92, (4, 23)), (46, (2, 23)), (23, (23,)), (1, (1,)), (2, (2,)),
    (32768, (8, 16, 16, 16)), (32749, (32749,)),
    # level-1 lines of padded stitched planes (H, W): (2048, 66000),
    # (20000, 70000), (24000, 90000), (12000, 131000) at levels 1 and 2
    (33344, (8, 8, 521)), (35328, (12, 8, 16, 23)),
    (45312, (12, 8, 8, 59)), (65856, (12, 16, 7, 7, 7)),
    (32928, (12, 8, 7, 7, 7)), (1 << 20, (16, 16, 16, 16, 16)),
    # no specialised factor past the odd part
    (65537, (65537,)), (34023, (3, 11, 1031))])
def test_plan_at_the_lengths_of_the_paths(n, plan):
    assert check_plan(n) == plan


@pytest.mark.parametrize("n,route,m", [
    (32749, "chirp", 65536), (32768, "mixed", 32768),
    (33344, "mixed", 33344), (2 ** 6 * 1021, "mixed", 2 ** 6 * 1021),
    (34023, "mixed", 34023), (65537, "chirp", 262144),
    (2 * 32771, "chirp", 262144), ((1 << 20) - 1, "mixed", (1 << 20) - 1),
    (1 << 20, "mixed", 1 << 20), (23, "chirp", 64), (1, "mixed", 1)])
def test_route_by_length(n, route, m):
    """The long form's route is a function of n alone: every n with a
    split (`notch_long_plan`: 1031 = 34023 / 33 and 1021 on their rows'
    chirp-z transform, 2^20 - 1 = 1023 x 1025) keeps its own length; a
    prime past ROW_MAX's row (32749, 65537, 32771) or a small prime takes
    the chirp route on the passes of pow2ceil(2n - 1)."""
    assert K.notch_route(n) == route and K.notch_length(n) == m


def check_long_plan(n):
    lp = K.notch_long_plan(n)
    assert lp.n1 * lp.n2 == lp.m == K.notch_length(n)
    assert 2 <= lp.n1 <= K.LONG_N1_MAX and lp.n2 >= 2
    assert lp.plan1 == K.notch_plan(lp.n1)
    assert int(np.prod(lp.plan2)) == lp.m2 <= K.ROW_MAX

    def generic_ok(plan):
        return plan[-1] in K.NOTCH_RADICES or plan[-1] <= K.GENERIC_MAX
    assert generic_ok(lp.plan1)
    if lp.rows == "chirp":     # the row's chirp-z transform: 2+ passes of 2^k
        assert lp.route == "mixed" and not generic_ok(K.notch_plan(lp.n2))
        assert lp.m2 == 1 << (2 * lp.n2 - 2).bit_length()
        assert len(lp.plan2) >= 2 and all(r in (4, 8, 16) for r in lp.plan2)
    elif lp.rows == "rader":   # n2 prime, n2 - 1 on 2+ specialised passes
        assert lp.route == "mixed" and not generic_ok(K.notch_plan(lp.n2))
        assert all(lp.n2 % d for d in range(2, int(lp.n2 ** 0.5) + 1))
        assert lp.m2 == lp.n2 - 1 and lp.plan2 == K.notch_plan(lp.m2)
        assert len(lp.plan2) >= 2 and not K._generic(lp.plan2)
    else:
        assert lp.m2 == lp.n2 and lp.plan2 == K.notch_plan(lp.n2)
        assert generic_ok(lp.plan2)
    if lp.route == "chirp":    # no split: every divisor pair fails a limit
        assert lp.m == 1 << (2 * n - 2).bit_length()
        for n1 in range(2, min(n // 2, K.LONG_N1_MAX) + 1):
            if n % n1 == 0:
                n2 = n // n1
                assert (not generic_ok(K.notch_plan(n1))
                        or 1 << (2 * n2 - 2).bit_length() > K.ROW_MAX
                        and not (n2 <= K.ROW_MAX
                                 and generic_ok(K.notch_plan(n2))))
    return lp


@pytest.mark.parametrize("n,split", [
    (33344, (64, 521, "rader", 520)), (16672, (32, 521, "rader", 520)),
    (35328, (192, 184, "mixed", 184)), (45312, (192, 236, "mixed", 236)),
    (65536, (256, 256, "mixed", 256)), (65856, (224, 294, "mixed", 294)),
    (131072, (256, 512, "mixed", 512)),
    (1 << 20, (1024, 1024, "mixed", 1024)),
    ((1 << 20) - 1, (1023, 1025, "mixed", 1025)),
    (34023, (33, 1031, "chirp", 4096)), (32512, (256, 127, "rader", 126)),
    (32128, (128, 251, "rader", 250)), (27347, (29, 943, "chirp", 2048)),
    (65537, (512, 512, "mixed", 512)), (32749, (256, 256, "mixed", 256))])
def test_long_plan_at_the_lengths_of_the_paths(n, split):
    lp = check_long_plan(n)
    assert (lp.n1, lp.n2, lp.rows, lp.m2) == split


def test_plan_factors_every_length_of_the_domain():
    for n in list(range(1, 4097)) + list(range(4097, K.NOTCH_MAX_N + 1, 97)):
        check_plan(n)
    for n in list(range(2, 4097, 7)) + list(range(4097, K.NOTCH_MAX_N + 1,
                                                  389)):
        check_long_plan(n)
    for n in (0, -4, K.NOTCH_MAX_N + 1):
        with pytest.raises(ValueError, match=str(K.NOTCH_MAX_N)):
            K.notch_plan(n)


# -- the kernel's index maps and passes --------------------------------------------

def _roots(radix):
    jk = np.outer(np.arange(radix), np.arange(radix)) % radix
    return torch.from_numpy(np.exp(-2j * np.pi * jk / radix).astype(
        np.complex64))


def _butterflies(plan, p, m, w):
    """Pass p of `plan` (radices multiplying to m): the elements of every
    butterfly (NB, R), their twiddles from the table w (1 where m == 0)
    and the pass's roots (a specialised radix's constants; the generic
    last radix's from the table at ((j k) % r) m / r)."""
    radix, L = plan[p], int(np.prod(plan[p:]))
    M = L // radix
    i = torch.arange(m // radix)
    b, mm = i // M, i % M
    k = torch.arange(radix)
    e = (b * L + mm)[:, None] + k[None, :] * M          # (NB, R)
    tw = w[(mm * (m // L))[:, None] * k[None, :]]
    if radix in K.NOTCH_RADICES:
        return e, tw, _roots(radix)
    assert p == len(plan) - 1 and L == radix
    return e, tw, w[(k[:, None] * k[None, :]) % radix * (m // radix)]


def _transform(z, plan, m, steps, w, gain):
    """The steps of one transform on z (..., m) complex64: in-place pass p
    of radix R and span L (M = L / R) takes butterfly i = b M + m to the
    elements b L + m + k M; forward (DIF): DFT_R, then the twiddle; the
    middle (MID, MIDC, GEN_DIF): the last forward DFT (M = 1, no twiddle),
    times gain(v, e), conjugated, and (but GEN_DIF) the first inverse DFT;
    inverse (DIT, GEN_DIT) on the conjugated data: the twiddle, then the
    forward DFT.  Returns what the last pass leaves."""
    for kind, p in steps:
        if kind in ("LOAD", "STORE"):
            continue
        e, tw, roots = _butterflies(plan, p, m, w)
        v = z[..., e]
        if kind in ("DIT", "GEN_DIT"):
            v = (v * tw) @ roots
        elif kind == "DIF":
            v = (v @ roots) * tw
        else:                                              # the middle
            assert bool((tw == 1).all())
            v = torch.conj(gain(v @ roots, e))
            if kind != "GEN_DIF":
                v = v @ roots
        z = z.clone()
        z[..., e] = v
    return z


def _table(m):
    tab = torch.from_numpy(stage_twiddles(m).copy())
    return torch.complex(tab[:, 0], tab[:, 1])


def _complex(t):
    t = torch.from_numpy(np.array(t))
    return torch.complex(t[:, 0], t[:, 1])


def emulate_passes(z, g, n):
    """The shared-memory kernel's arithmetic on z (..., n) complex64, step
    by step (`notch_steps`), the twiddles from the f32 table of n: one
    transform with the gains of `notch_gains(g, n)` (the spectrum's
    digit-reversed order); y_a + i y_b is the conjugate of what it
    leaves.  Returns y_a + i y_b."""
    plan = K.notch_plan(n)
    gp = torch.from_numpy(K.notch_gains(g, n))
    return torch.conj(_transform(z, plan, n, K.notch_steps(plan), _table(n),
                                 lambda v, e: v * gp[e]))


def _chirp_k(v, L, plan, w, hm):
    """K(pad(v)) of the chirp-z transform of L: v (..., L) padded with zeros
    to M = prod(plan), the passes of M with the complex gains hm (plan's
    order) in the middle (one half of `notch_steps(plan, chirp=True)`);
    its first L values."""
    M = int(np.prod(plan))
    steps = K.notch_steps(plan, chirp=True)
    half = steps[:len(steps) // 2]
    assert steps == half + half
    v = torch.cat([v, v.new_zeros(v.shape[:-1] + (M - L,))], -1)
    return _transform(v, plan, M, half, w, lambda u, e: u * hm[e])[..., :L]


def emulate_long(z, g, n, plan=None):
    """The long form's arithmetic on z (P, n) complex64: the split `plan`
    (`notch_long_plan(n)` unless given), element j = n2 j1 + j2.  (a) plan1's forward
    passes over every column j2 (rows r end where frequency rev1[r]
    lands), times w_m^(j2 rev1[r]); (b) on every row (P, n1, n2): plan2's
    steps with the gains of `notch_long_tables` (G / n, or the whole line's
    Hm in its place), or with a row chirp c2 . conj(K(G / n . K(c2 . a)))
    (`_chirp_k`), or Rader's (`_rader_rows`); times w_m^(j2 rev1[r]); (c)
    plan1's inverse passes over
    every column.  Direct route: y_a + i y_b is the conjugate of what (c)
    leaves; chirp route: (a)-(c) on c . z padded to m, G / n times its
    first n values, (a)-(c) again, times conj(c).  Twiddles from the f32
    tables of m, n1 and m2.  Returns y_a + i y_b (P, n)."""
    lp = plan or K.notch_long_plan(n)
    tabs = K.notch_long_tables(g, n, lp)
    n1, n2, m2, m = lp.n1, lp.n2, lp.m2, lp.m
    P = z.shape[0]
    w, w1, w2 = _table(m), _table(n1), _table(m2)
    rev1 = torch.from_numpy(tabs["rev1"].astype(np.int64))
    assert torch.equal(torch.sort(rev1).values, torch.arange(n1))
    tw = w[torch.arange(n2)[None, :] * rev1[:, None]]      # (n1, n2)
    assert torch.equal(tw.reshape(-1), _complex(tabs["twr"]))
    P1 = len(lp.plan1)

    def four_step(v, mid):
        a = v.reshape(P, n1, n2).transpose(1, 2)           # columns j2
        a = _transform(a, lp.plan1, n1, [("DIF", p) for p in range(P1)],
                       w1, None)
        b = mid(a.transpose(1, 2) * tw) * tw                # rows r
        c = _transform(b.transpose(1, 2), lp.plan1, n1,
                       [("DIT", p) for p in range(P1 - 1, -1, -1)], w1, None)
        return c.transpose(1, 2).reshape(P, m)

    gp = torch.from_numpy(np.array(tabs["gp"]))
    if lp.route == "chirp":
        c, hm = _complex(tabs["chirp"]), _complex(tabs["hm"]).reshape(n1,
                                                                      m2)

        def mid(a):
            return _transform(a, lp.plan2, m2, K.notch_steps(lp.plan2), w2,
                              lambda u, e: u * hm[:, e])

        def pad(v):
            return torch.cat([v, v.new_zeros((P, m - n))], -1)
        first = four_step(pad(z * c), mid)[:, :n] * gp
        return torch.conj(c) * four_step(pad(first), mid)[:, :n]
    if lp.rows == "rader":
        def mid(a):
            return _rader_rows(a, lp, w2, tabs)
    elif lp.rows == "chirp":
        c2, hm2 = _complex(tabs["c2"]), _complex(tabs["hm2"])
        gr = gp.reshape(n1, n2)

        def mid(a):
            u = _chirp_k(a * c2, n2, lp.plan2, w2, hm2)
            return c2 * torch.conj(_chirp_k(u * gr, n2, lp.plan2, w2, hm2))
    else:
        g2 = gp.reshape(n1, m2)

        def mid(a):
            return _transform(a, lp.plan2, m2, K.notch_steps(lp.plan2), w2,
                              lambda u, e: u * g2[:, e])
    return torch.conj(four_step(z, mid))


def _rader_rows(a, lp, w2, tabs):
    """Rader's rows on a (P, n1, p): u[q] = a[g^q] (perm), K of m2 = p - 1
    points with the convolution's gains hm2; A[0] = a[0] + sum u, A[g^-q]
    = a[0] + conj(K(u))[q]; u2[r] = G[g^r] (conj(a[0]) + K(u)[(m2 - r) %
    m2]); D[0] = conj(G[0] A[0]) + sum u2, D[g^-q] = conj(G[0] A[0]) +
    conj(K(u2))[q]: the conjugate of the rows' inverse of G / n . DFT(a),
    gains G per row from `notch_long_tables` (G[k1] / n, then at g^q)."""
    L = lp.m2
    perm = torch.from_numpy(tabs["perm"].astype(np.int64))
    hm2 = _complex(tabs["hm2"])
    gr = torch.from_numpy(np.array(tabs["gp"])).reshape(lp.n1, lp.n2)
    steps = K.notch_steps(lp.plan2, chirp=True)
    half = steps[:len(steps) // 2]

    def k_of(u):
        return _transform(u, lp.plan2, L, half, w2, lambda v, e: v * hm2[e])
    back = (L - torch.arange(L)) % L
    a0 = a[..., :1]
    u = a[..., perm]
    v = k_of(u)
    u2 = gr[:, 1:] * (torch.conj(a0) + v[..., back])
    v2 = k_of(u2)
    v0 = gr[:, :1] * torch.conj(a0 + u.sum(-1, keepdim=True))
    d = torch.empty_like(a)
    d[..., perm[back]] = v0 + torch.conj(v2)
    d[..., :1] = v0 + u2.sum(-1, keepdim=True)
    return d


def pair_maps(geo, B, H, W):
    """`pair_of` of csrc/notch.cuh for every item and pair c < CP: the
    element offsets of line a and line b, their stride, valid, has_b."""
    k = torch.arange(geo["items"])[:, None]
    c = torch.arange(geo["CP"])[None, :]
    if not geo["cols"]:
        q = k * geo["CP"] + c
        hp = -(-H // 2)
        b, i = q // hp, q % hp
        valid = q < geo["pairs"]
        has_b = 2 * i + 1 < H
        a = (b * H + 2 * i) * W
        return a, a + W, 1, valid, has_b
    b = k // geo["tiles"]
    jp = (k % geo["tiles"]) * geo["CP"] + c
    valid = jp < -(-W // 2)
    has_b = 2 * jp + 1 < W
    a = b * H * W + 2 * jp
    return a, a + 1, W, valid, has_b


def _scatter(x, z, a, b, stride, valid, has_b, n):
    """Gather helper's inverse: the line pairs z (..., n) complex back into
    a tensor like x (real parts at line a, imaginary at line b), and how
    often each output was written."""
    e = torch.arange(n) * stride
    ia = torch.where(valid, a, 0)[..., None] + e
    ib = torch.where(valid & has_b, b, 0)[..., None] + e
    y = torch.full((x.numel(),), float("nan"))
    hits = torch.zeros(x.numel(), dtype=torch.int64)
    for idx, keep, v in ((ia, valid, z.real), (ib, valid & has_b, z.imag)):
        keep = keep[..., None].expand_as(idx)
        y[idx[keep]] = v[keep]
        hits.index_put_((idx[keep],), torch.ones_like(idx[keep]),
                        accumulate=True)
    return y.reshape(x.shape), hits.reshape(x.shape)


def _gather(x, a, b, stride, valid, has_b, n):
    """z = line a + i line b of every pair (0 for a missing line b and
    for pairs past the input)."""
    e = torch.arange(n) * stride
    flat = x.reshape(-1)
    ia = torch.where(valid, a, 0)[..., None] + e
    ib = torch.where(valid & has_b, b, 0)[..., None] + e
    re = torch.where(valid[..., None], flat[ia], 0.0)
    im = torch.where((valid & has_b)[..., None], flat[ib], 0.0)
    return torch.complex(re, im)


def emulate_k8(x, g, axis):
    """The shared-memory kernel on x (B, H, W) f32 along `axis`: every
    item's CP line pairs gathered through `pair_maps`, `emulate_passes`,
    and the real and imaginary parts scattered back.  Returns y and how
    often each output was written."""
    B, H, W = x.shape
    n = H if axis == -2 else W
    geo = K.notch_geometry(B, H, W, axis == -2,
                           generic=K._generic(K.notch_plan(n)))
    maps = pair_maps(geo, B, H, W)
    z = emulate_passes(_gather(x, *maps, n), g, n)
    return _scatter(x, z, *maps, n)


def long_maps(geo, B, H, W):
    """csrc/notch.cuh `long_col` / `long_row` / `pair_at` for every block
    item and column (kernels a, c) or row (b): the pair (its number: row
    pairs q along x, b WP + jp along y), j2 or r, valid."""
    def pairs_of(bt, jp):
        return bt * geo["WP"] + jp
    k = torch.arange(geo["items_ac"])[:, None]
    c = torch.arange(geo["C"])[None, :]
    if not geo["cols"]:
        q, jt = k // geo["ntj"], k % geo["ntj"]
        j2 = jt * geo["TJ"] + c
        cols = (q.expand_as(j2), j2, j2 < geo["n2"])
    else:
        per = geo["ngp"] * geo["ntj"]
        bt, rem = k // per, k % per
        pg, jt = rem // geo["ntj"], rem % geo["ntj"]
        jp = pg * geo["CPt"] + c % geo["CPt"]
        j2 = jt * geo["TJ"] + c // geo["CPt"]
        cols = (pairs_of(bt, jp), j2, (jp < geo["WP"]) & (j2 < geo["n2"]))
    k = torch.arange(geo["items_b"])[:, None]
    c = torch.arange(geo["R"])[None, :]
    if not geo["cols"]:
        u = k * geo["R"] + c
        rows = (u // geo["n1"], u % geo["n1"], u // geo["n1"] < geo["pairs"])
    else:
        per = geo["ngr"] * geo["n1"]
        bt, rem = k // per, k % per
        pg, r = rem // geo["n1"], rem % geo["n1"]
        jp = pg * geo["R"] + c
        rows = (pairs_of(bt, jp), r.expand_as(jp), jp < geo["WP"])
    return cols, rows


def emulate_k8l(x, g, axis, plan=None):
    """The long form on x (B, H, W) f32 along `axis` on the split `plan`
    (`notch_long_plan(n)` unless given): every column of
    kernels a / c and every row of kernel b taken exactly once (their
    maps, `long_maps`), the line pairs gathered (lines 2i, 2i + 1 of a
    tile; column pairs), `emulate_long`, and y scattered where kernel c
    stores: element n2 j1 + j2 of each of its columns (the first n on the
    chirp route).  Returns y and how often each output was written."""
    B, H, W = x.shape
    cols = axis == -2
    n = H if cols else W
    geo = K.notch_long_geometry(B, H, W, cols, plan=plan)
    (cp, cj, cv), (rp, rr, rv) = long_maps(geo, B, H, W)
    pairs, n1, n2 = geo["pairs"], geo["n1"], geo["n2"]
    for p, j, v, width in ((cp, cj, cv, n2), (rp, rr, rv, n1)):
        seen = torch.zeros(pairs * width, dtype=torch.int64)
        seen.index_put_(((p * width + j)[v],), torch.ones_like(p[v]),
                        accumulate=True)
        assert bool((seen == 1).all()), "a column or row taken 0 or 2 times"
    q = torch.arange(pairs)
    if not cols:
        hp = -(-H // 2)
        bt, i = q // hp, q % hp
        a = (bt * H + 2 * i) * W
        maps = (a, a + W, 1, torch.ones_like(q, dtype=torch.bool),
                2 * i + 1 < H)
    else:
        bt, jp = q // geo["WP"], q % geo["WP"]
        a = bt * H * W + 2 * jp
        maps = (a, a + 1, W, torch.ones_like(q, dtype=torch.bool),
                2 * jp + 1 < W)
    z = emulate_long(_gather(x, *maps, n), g, n, plan)
    # kernel c's stores: element n2 j1 + j2 of its valid columns, e < n
    stored = torch.zeros(pairs, geo["m"], dtype=torch.int64)
    e = torch.arange(n1)[None, None, :] * n2 + cj[..., None]
    pe = cp[..., None].expand_as(e)
    keep = cv[..., None].expand_as(e)
    stored.index_put_((pe[keep], e[keep]), torch.ones_like(e[keep]),
                      accumulate=True)
    assert bool((stored[:, :n] == 1).all())
    return _scatter(x, z, *maps, n)


@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("axis", (-1, -2))
def test_emulation_matches_float64_at_the_planner_lengths(axis, n):
    rng = np.random.default_rng(10 * n - axis)
    x = _coef(rng, axis, n, lines=5)
    g = _notch(n)
    y, hits = emulate_k8(torch.from_numpy(x), g, axis)
    assert bool((hits == 1).all()), "an output written 0 or 2 times"
    assert _rel(y.numpy(), _ref64(x, g, axis)) <= TOL


@pytest.mark.parametrize("n,lines", [(n, 3 if n < 65536 else 2)
                                     for n in LONG]
                         + [(16672, 2), (34023, 1), ((1 << 20) - 1, 1)])
@pytest.mark.parametrize("axis", (-1, -2))
def test_emulation_matches_float64_at_the_long_lengths(axis, n, lines):
    """Lines past shared memory in the long form, 1-3 lines a tile: its
    three kernels' maps and passes, Rader's rows (521 of 33344, 16672),
    the rows' chirp-z transform (1031 of 34023), generic radices in both
    sub-plans (2^20 - 1), the whole line's chirp route (65537)."""
    rng = np.random.default_rng(3 * n - axis)
    x = _coef(rng, axis, n, lines=lines, tiles=1)
    g = _notch(n)
    y, hits = emulate_k8l(torch.from_numpy(x), g, axis)
    assert bool((hits == 1).all()), "an output written 0 or 2 times"
    assert _rel(y.numpy(), _ref64(x, g, axis)) <= TOL


# the splits the plan's rules give at small n with GENERIC_MAX at 16 (an
# odd factor past 16 inside its row): Rader's rows (23 of 368 and 46, 71
# of 1562 = 22 x 71), the rows' chirp-z transform (943 of 2829), the
# whole-line chirp route (667 = 23 x 29); the kernels take any split
FORCED_SMALL = {
    368: K.LongPlan("mixed", 368, 16, (16,), 23, "rader", 22, (2, 11)),
    46: K.LongPlan("mixed", 46, 2, (2,), 23, "rader", 22, (2, 11)),
    1562: K.LongPlan("mixed", 1562, 22, (2, 11), 71, "rader", 70,
                     (2, 5, 7)),
    2829: K.LongPlan("mixed", 2829, 3, (3,), 943, "chirp", 2048,
                     (8, 16, 16)),
    667: K.LongPlan("chirp", 2048, 32, (8, 4), 64, "mixed", 64, (8, 8))}


@pytest.mark.parametrize("B,H,W,axis", [
    (2, 3, 60, -1), (1, 60, 5, -2), (2, 2, 23, -1), (1, 23, 4, -2),
    (3, 2, 368, -1), (1, 667, 3, -2), (2, 5, 2829, -1), (1, 1562, 40, -2),
    (2, 1, 46, -1)])
@pytest.mark.parametrize("forced", (False, True), ids=("plan", "forced"))
def test_long_emulation_at_small_lengths(B, H, W, axis, forced):
    """Every path of the long form at small n (the wrapper sends only
    lines past shared memory; the passes take any): a split with no
    generic radix (60), the whole-line chirp route (23), a generic radix
    in the rows (368) or in both sub-plans, alone (667 = 23 x 29) or last
    (2829 = 41 x 69); `forced`: the splits of FORCED_SMALL in their place;
    odd line counts, odd column counts, one line."""
    rng = np.random.default_rng(B * 1000 + H + W)
    x = rng.standard_normal((B, H, W)).astype(np.float32)
    n = H if axis == -2 else W
    plan = FORCED_SMALL.get(n) if forced else None
    g = _notch(n, max(n / 8.0, 0.5))
    y, hits = emulate_k8l(torch.from_numpy(x), g, axis, plan)
    assert bool((hits == 1).all())
    ref = _ref64(x, g, axis)
    np.testing.assert_allclose(y.numpy(), ref,
                               atol=TOL * max(np.abs(ref).max(), 1e-6))


@pytest.mark.parametrize("B,H,W,axis", [
    (3, 1, 21, -1), (1, 7, 1, -1), (2, 1, 5, -2), (1, 1, 1, -1),
    (2, 4, 2, -2), (1, 3, 10, -2), (2, 9, 24, -2), (1, 40, 7, -2)])
def test_emulation_at_odd_and_tiny_shapes(B, H, W, axis):
    """One line a tile, n = 1 and 2, odd line counts, column counts that
    leave an item part-filled."""
    rng = np.random.default_rng(B * 100 + H * 10 + W)
    x = rng.standard_normal((B, H, W)).astype(np.float32)
    n = H if axis == -2 else W
    g = _notch(n, max(n / 8.0, 0.5))
    y, hits = emulate_k8(torch.from_numpy(x), g, axis)
    assert bool((hits == 1).all())
    ref = _ref64(x, g, axis)
    np.testing.assert_allclose(y.numpy(), ref,
                               atol=TOL * max(np.abs(ref).max(), 1e-6))


@pytest.mark.parametrize("n", LENGTHS + (1, 2, 3000, 14000, 14528, 14600,
                                        27000, 28000) + LONG)
@pytest.mark.parametrize("cols", (False, True))
def test_slots_are_distinct_and_threads_cover_every_element(n, cols):
    """The slot map `at` of both layouts sends each (pair, element) of an
    item to its own slot of the buffer; the block's THREADS threads (whole
    warps) split into CP pairs of T (lane_of) and take every (pair, j)
    once; every step's butterflies take each element of a pair's
    transform exactly once; shared memory within the limit, or none (the
    long form) only where one pair's buffers do not fit."""
    plan = K.notch_plan(n)
    geo = K.notch_geometry(8, n, n, cols, generic=K._generic(plan))
    CP, T, e = geo["CP"], geo["T"], torch.arange(n)
    assert CP * T == geo["threads"] == K.THREADS and K.THREADS % 32 == 0
    c = torch.arange(CP)[:, None]
    if cols:
        lin = e[None, :] * CP + c
        slots = lin + (lin >> 4)
    else:
        slots = c * geo["pitch"] + e + (e >> 4)
    assert int(slots.max()) < geo["buf"]
    assert torch.unique(slots).numel() == slots.numel()
    tid = torch.arange(geo["threads"])
    lc, lj = (tid % CP, tid // CP) if cols else (tid // T, tid % T)
    assert torch.unique(lc * T + lj).numel() == geo["threads"]
    assert int(lc.max()) == CP - 1 and int(lj.max()) == T - 1
    for _, p in K.notch_steps(plan):
        radix, L = plan[p], int(np.prod(plan[p:]))
        i = torch.arange(n // radix)
        elems = ((i // (L // radix)) * L + i % (L // radix))[:, None] \
            + torch.arange(radix)[None, :] * (L // radix)
        assert torch.equal(torch.sort(elems.reshape(-1)).values, e)
    fits = 8 * geo["nbuf"] * geo["buf"] <= K.SMEM_LIMIT
    assert (geo["smem"] > 0) == fits
    assert fits or CP == 1
    assert geo["smem"] <= K.SMEM_LIMIT
    assert fits or n > 13000          # every long line past ~13600


@pytest.mark.parametrize("n", LONG + (16672, 13674, 32749, 34023,
                                      (1 << 20) - 1))
@pytest.mark.parametrize("B,lines,cols", [(2, 2688, False), (1, 3, False),
                                          (2, 2688, True), (1, 5, True)])
def test_long_slots_and_threads_cover_every_element(n, B, lines, cols):
    """The long form's buffers: a strided tile's C columns of n1 values and
    a row block's R rows of m2 in distinct slots within its buffer, the
    THREADS threads split into columns (rows) of T (Tb) and take every
    (column, j) once, shared memory within the limit for each kernel (2
    buffers for a generic radix); y the storage only where every pair has
    both lines, else a scratch of pairs x m; the tiles' loads 4C-byte runs
    along x, 8 CPt-byte runs along y."""
    H, W = (n, lines) if cols else (lines, n)
    geo = K.notch_long_geometry(B, H, W, cols)
    C, T, R, Tb = geo["C"], geo["T"], geo["R"], geo["Tb"]
    assert C * T == R * Tb == K.THREADS
    rader = geo["rows"] == K.ROWS.index("rader")
    for width, length, pitch, buf in ((C, geo["n1"], 0, geo["bufc"]),
                                      (R, geo["n2"] if rader else geo["m2"],
                                       geo["pitch"], geo["bufb"])):
        e, c = torch.arange(length)[None, :], torch.arange(width)[:, None]
        if pitch:
            slots = c * pitch + e + (e >> 4)
        else:
            lin = e * width + c
            slots = lin + (lin >> 4)
        assert torch.unique(slots).numel() == slots.numel()
        assert int(slots.max()) < buf
    assert geo["smem_b"] == 8 * (geo["nbufb"] * geo["bufb"] + 3 * R * rader)
    assert geo["nbufb"] == 1 + (rader
                                or K._generic(K.notch_long_plan(n).plan2))
    assert max(geo["smem_b"], geo["smem_c"]) <= K.SMEM_LIMIT
    assert geo["smem_a"] * geo["nbufc"] == geo["smem_c"]
    assert geo["ystore"] == int(K.notch_route(n) == "mixed"
                                and lines % 2 == 0)
    assert geo["scratch"] == (0 if geo["ystore"] else geo["pairs"] * geo["m"])
    assert geo["CPt"] * geo["TJ"] == C
    assert geo["CPt"] == (min(C, 1 << (-(-lines // 2) - 1).bit_length())
                          if cols else 1)


# -- the header on the host ------------------------------------------------------

# (axis, B, H, W): every planner length on both axes, three lines a tile
# (an odd last line) and two tiles; n = 1, 2; primes; a row without its
# pad (14000); lines past shared memory (the long form: n >= 14528 with a
# generic radix, 13674 along x only; both layouts, y or a scratch as the
# storage, Rader's rows of 521, the rows' chirp-z transform of 1031, the
# whole-line chirp route of 32749, 2^20 - 1 on one line), each tile alone
# too
HOST_CASES = ([(-1, 2, 3, n) for n in LENGTHS]
              + [(-2, 2, n, 3) for n in LENGTHS]
              + [(-1, 2, 1, 1), (-2, 1, 2, 5), (-1, 3, 2, 97), (-2, 2, 97, 37),
                 (-1, 1, 2, 14000), (-1, 1, 1, 14530), (-2, 1, 14600, 2),
                 (-1, 1, 1, 4099), (-2, 2, 1344, 37), (-1, 2, 2, 13674),
                 (-2, 1, 13674, 3),
                 (-1, 2, 2, 33344), (-2, 1, 33344, 2), (-1, 2, 3, 34023),
                 (-2, 1, 34023, 3), (-1, 2, 1, 32749), (-2, 1, 32749, 4),
                 (-1, 1, 1, (1 << 20) - 1)])


@pytest.fixture(scope="module")
def host_check(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    exe = tmp_path_factory.mktemp("notch_host") / "check"
    subprocess.run(
        [gxx, "-std=c++17", "-O2", "-I",
         str(ROOT / "tests" / "torch_dft_fft_host"), "-I",
         str(ROOT / "ipp_tpu_torch" / "csrc"),
         str(ROOT / "tests" / "torch_notch_host" / "check.cpp"), "-o",
         str(exe)], check=True, capture_output=True)
    return exe


def _host_args(cases, long=None, plans={}):
    """The check's arguments: AXIS B H W GENERIC and the plan of every
    case in the shared-memory kernel; AXIS B H W long CHIRP ROWS N1 R1 ...
    : R2 ... for the split `plans[n]` (else `notch_long_plan(n)`) where the
    case is long (`notch_is_long`, or `long` True); "/" between cases."""
    args = []
    for axis, B, H, W in cases:
        n = H if axis == -2 else W
        if long or long is None and K.notch_is_long((B, H, W), axis):
            lp = plans.get(n) or K.notch_long_plan(n)
            args += [str(v) for v in (axis, B, H, W, "long",
                                      int(lp.route == "chirp"),
                                      K.ROWS.index(lp.rows), lp.n1,
                                      *lp.plan1, ":", *lp.plan2)]
        else:
            plan = K.notch_plan(n)
            args += [str(v) for v in (axis, B, H, W, int(K._generic(plan)),
                                      *plan)]
        args.append("/")
    return args[:-1]


def _long_geometry_line(g):
    return (f"n1 {g['n1']} n2 {g['n2']} m2 {g['m2']} ystore {g['ystore']} "
            f"C {g['C']} CPt {g['CPt']} TJ {g['TJ']} ntj {g['ntj']} bufc "
            f"{g['bufc']} nbufc {g['nbufc']} items {g['items_ac']} R "
            f"{g['R']} pitch {g['pitch']} bufb {g['bufb']} nbufb "
            f"{g['nbufb']} items {g['items_b']} smem {g['smem_a']} "
            f"{g['smem_b']} {g['smem_c']}")


def _host_geometry(axis, B, H, W, long=None, plan=None):
    """The geometry line the host check prints for a case (on the split
    `plan` where it is long, else `notch_long_plan(n)`)."""
    n = H if axis == -2 else W
    if long or long is None and K.notch_is_long((B, H, W), axis):
        return "long " + _long_geometry_line(K.notch_long_geometry(
            B, H, W, axis == -2, plan=plan)) + ";"
    plan = K.notch_plan(n)
    g = K.notch_geometry(B, H, W, axis == -2, generic=K._generic(plan))
    return (f"CP {g['CP']} T {g['T']} pitch {g['pitch']} buf {g['buf']} "
            f"nbuf {g['nbuf']} smem {g['smem']} tiles {g['tiles']} vec2 "
            f"{g['vec2']} items {g['items']} steps "
            f"{len(K.notch_steps(plan))};")


def test_header_on_the_host_matches_float64(host_check):
    out = subprocess.run([str(host_check), *_host_args(HOST_CASES)],
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stdout + out.stderr
    lines = out.stdout.splitlines()
    assert len(lines) == len(HOST_CASES)
    for case, line in zip(HOST_CASES, lines):
        # the header's geometry is the one the wrapper and emulation mirror
        want = _host_geometry(*case)
        assert want in line, (want, line)


# the long form's paths at small n (`long` forces it): a split without a
# generic radix, the whole-line chirp route, generic radices in the rows,
# in both sub-plans, alone and last; both layouts, odd line counts
LONG_SMALL = [(-1, 2, 3, 60), (-2, 2, 60, 3), (-1, 1, 4, 23), (-2, 1, 23, 5),
              (-1, 2, 2, 368), (-2, 1, 368, 4), (-1, 2, 3, 667),
              (-2, 2, 667, 3), (-1, 1, 3, 2829), (-2, 1, 2829, 5)]


@pytest.mark.parametrize("forced", (False, True), ids=("plan", "forced"))
def test_header_long_form_at_small_lengths(host_check, forced):
    """Kernels a, b, c of the long form thread by thread at small n, each
    tile alone bit-equal to the batch; `forced`: the splits of
    FORCED_SMALL, Rader's rows (23 of 368), the rows' chirp-z transform
    (943 of 2829) and the whole-line chirp route (667) in place of generic
    radices."""
    plans = FORCED_SMALL if forced else {}
    out = subprocess.run([str(host_check), *_host_args(LONG_SMALL, True,
                                                       plans)],
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stdout + out.stderr
    lines = out.stdout.splitlines()
    assert len(lines) == len(LONG_SMALL)
    for (axis, B, H, W), line in zip(LONG_SMALL, lines):
        plan = plans.get(H if axis == -2 else W)
        assert _host_geometry(axis, B, H, W, True, plan) in line, line


# splits of 33344 other than its plan's, which scripts/notch_bench.py
# --long times through rows of `_long_row` with the split given
SPLIT_33344 = K.notch_long_plan(33344)
GENERIC_33344 = SPLIT_33344._replace(rows="mixed", m2=521, plan2=(521,))
CHIRP_33344 = SPLIT_33344._replace(rows="chirp", m2=2048, plan2=(8, 16, 16))


@pytest.mark.parametrize("shape,axis,plan", [
    ((2, 2688, 33344), -1, None), ((2, 33344, 2688), -2, None),
    ((1, 3, 35328), -1, None), ((1, 45312, 3), -2, None),
    ((1, 4, 65537), -1, None), ((2, 65537, 2), -2, None),
    ((1, 1, (1 << 20) - 1), -1, None), ((1, 1 << 20, 2), -2, None),
    ((2, 2688, 33344), -1, GENERIC_33344), ((1, 33344, 3), -2, CHIRP_33344)])
def test_wrapper_long_rows_are_what_the_header_takes(host_check, shape,
                                                     axis, plan):
    """`cuda_notch._long_row` (on CPU tensors: the pointers are only
    checked) read by the header's make_long: the geometry of
    `notch_long_geometry`, y as the storage or a scratch of pairs x m
    complex values, the step counts of each kernel; on `notch_long_plan`
    or on a split given (the rows' generic pass of 521, their chirp-z
    transform)."""
    B, H, W = shape
    n = shape[axis]
    x = torch.zeros(shape)
    y = torch.empty_like(x)
    g = _notch(n)
    row, keep = K._long_row(x, y, g, B, H, W, axis, plan)
    assert len(row) == 47
    lp = plan or K.notch_long_plan(n)
    assert row[15:19] == [lp.n1, lp.n2, int(lp.route == "chirp"),
                          K.ROWS.index(lp.rows)]
    geo = K.notch_long_geometry(B, H, W, axis == -2, plan=lp)
    assert (row[2] == 0) == bool(geo["ystore"])
    if not geo["ystore"]:
        assert keep[2].numel() == 2 * geo["pairs"] * geo["m"]
    out = subprocess.run([str(host_check), "row", *map(str, row)],
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stdout + out.stderr
    steps_b = (len(K.notch_steps(lp.plan2, lp.rows != "mixed"))
               + 2 * (lp.rows == "rader"))   # Rader's load and store
    P1, gen1 = len(lp.plan1), K._generic(lp.plan1)
    assert out.stdout.strip() == (
        _long_geometry_line(geo) + f" steps {P1 + (gen1 and P1 == 1)} "
        f"{steps_b} {P1 + gen1}")


# the 14 notch lengths of a padded 2000^2 decomposition (cH along x, cV
# along y at levels 1-7) and two FNT lengths with a generic radix
# (three rows or five columns a tile: the float64 reference is O(n^2) a
# line)
GROUP_CASES = ([(-1, 2, 3, n) for n in TILE_2000]
               + [(-2, 2, n, 5) for n in TILE_2000]
               + [(-1, 2, 3, 23), (-2, 1, 368, 5)])


def test_header_group_on_the_host_equals_lone_runs(host_check):
    """The 16 subbands in one table (`make_group`: longest first), each
    bit-equal to its one-subband run and within 1e-5 of float64."""
    assert len(GROUP_CASES) == K.MAX_GROUP
    out = subprocess.run([str(host_check), "group",
                          *_host_args(GROUP_CASES)], capture_output=True,
                         text=True, timeout=240)
    assert out.returncode == 0, out.stdout + out.stderr
    lines = out.stdout.splitlines()
    assert len(lines) == len(GROUP_CASES) + 1
    for case, line in zip(GROUP_CASES, lines):
        assert _host_geometry(*case) in line, (case, line)
    order = sorted((H if a == -2 else W for a, _, H, W in GROUP_CASES),
                   reverse=True)
    assert lines[-1].startswith(f"group of {K.MAX_GROUP}:")
    assert f"order {' '.join(map(str, order))};" in lines[-1]
    assert "; 0 alone; 0 differ from their lone runs" in lines[-1]


# the 14 notches of a padded (2688, 66688) plane (a stitched 2048 x 66000
# plane at sigma 250, 7 levels): cH along x, two rows, cV along y, five
# columns; 33344 and 16672 (past shared memory, 64 x 521 and 32 x 521) in
# the long form
WIDE_CASES = ([(-1, 1, 2, 66688 >> lv) for lv in range(1, 8)]
              + [(-2, 1, 2688 >> lv, 5) for lv in range(1, 8)])


def test_header_wide_plane_group_on_the_host_equals_lone_runs(host_check):
    """A decomposition with long subbands as the wrapper launches it
    (`cuda_notch._launches`): the 12 that fit shared memory in one table,
    33344 and 16672 each in the long form (y as the storage, Rader's rows
    of 521); every output bit-equal to its one-subband
    run and within 1e-5 of float64."""
    out = subprocess.run([str(host_check), "group",
                          *_host_args(WIDE_CASES)], capture_output=True,
                         text=True, timeout=240)
    assert out.returncode == 0, out.stdout + out.stderr
    lines = out.stdout.splitlines()
    assert len(lines) == len(WIDE_CASES) + 1
    for case, line in zip(WIDE_CASES, lines):
        assert _host_geometry(*case) in line, (case, line)
    assert lines[-1].startswith("group of 12:")
    assert "; 2 alone 33344 16672; 0 differ from their lone runs" in lines[-1]


# -- the wrapper -------------------------------------------------------------------

def test_cpu_calls_take_the_plain_version_and_count_nothing(rng):
    K.reset_launch_counts()
    for axis in (-1, -2):
        x = torch.from_numpy(rng.standard_normal((2, 12, 10)).astype(
            np.float32))
        g = _notch(x.shape[axis])
        assert torch.equal(K.notch_filter(x, g, axis),
                           K.notch_filter_plain(x, g, axis))
    assert K.LAUNCHES == {"notch": 0, "notch_long": 0}


@pytest.mark.parametrize("shape,dtype,glen,axis,err", [
    ((2, 8, 10), torch.float64, 6, -1, TypeError),     # not f32
    ((2, 8, 10), torch.float16, 6, -1, TypeError),
    ((2, 8, 10), torch.float32, 5, -1, ValueError),    # g of another length
    ((2, 8, 10), torch.float32, 6, 0, ValueError),     # not an axis it takes
    ((10,), torch.float32, 6, -2, ValueError),         # no axis -2
    ((2, 0), torch.float32, 1, -1, ValueError),        # n = 0
    ((1, 1048577), torch.float32, 524289, -1, ValueError),  # past the limit
])
def test_wrapper_refuses_what_the_kernel_does_not_take(shape, dtype, glen,
                                                       axis, err):
    with pytest.raises(err):
        K.notch_filter(torch.zeros(shape, dtype=dtype),
                       np.ones(glen, np.float32), axis)


def test_wrapper_refuses_devices_it_cannot_launch_on():
    with pytest.raises(ValueError):
        K.notch_filter(torch.empty((2, 8, 10), device="meta"),
                       np.ones(6, np.float32), -1)
    with pytest.raises(ValueError):   # x on the CPU, g not
        K.notch_filter(torch.zeros((2, 8, 10)),
                       torch.ones(6, device="meta"), -1)
    x = torch.ones((2, 8, 10))        # a tensor g on x's device is taken
    assert torch.equal(K.notch_filter(x, torch.ones(6), -1),
                       K.notch_filter_plain(x, np.ones(6, np.float32), -1))


def test_filter_subband_notches_through_the_wrapper(rng, monkeypatch):
    """filter_subband reaches the notch through one `notch_filter_group`
    call with all 2L subbands: the x notch on cH, the y notch on cV of
    every level, deepest level first."""
    calls = []

    def counted(xs, gs, axes):
        calls.append([(a, tuple(x.shape)) for x, a in zip(xs, axes)])
        return K.notch_filter_group_plain(xs, gs, axes)

    monkeypatch.setattr(P, "notch_filter_group", counted)
    img = torch.from_numpy(rng.standard_normal((2, 64, 96)).astype(
        np.float32))
    P.filter_subband(img, 20.0, 3, "db3", axes=(-1, -2))
    assert calls == [[(a, (2, 64 >> lv, 96 >> lv)) for lv in (3, 2, 1)
                      for a in (-1, -2)]]
    calls.clear()
    P.filter_subband(img, 20.0, 3, "db3", axes=-1)
    assert calls == [[(-1, (2, 64 >> lv, 96 >> lv)) for lv in (3, 2, 1)]]


@pytest.mark.parametrize("shape,level,axes", [
    ((2, 64, 96), 3, (-1, -2)), ((1, 48, 40), 2, -1)])
def test_group_plain_equals_single_calls_and_jax_filter_subband(
        rng, shape, level, axes):
    """`notch_filter_group` on the CPU is `notch_filter` of each subband,
    bit for bit, and `filter_subband` through it agrees with the JAX
    package's within 1e-5 of max."""
    img = rng.standard_normal(shape).astype(np.float32)
    xs = [torch.from_numpy(rng.standard_normal((2, 24 >> k, 40 >> k))
                           .astype(np.float32)) for k in range(3)]
    axes_l = [-1, -2, -1]
    gs = [_notch(x.shape[a]) for x, a in zip(xs, axes_l)]
    K.reset_launch_counts()
    got = K.notch_filter_group(xs, gs, axes_l)
    for x, g, a, y in zip(xs, gs, axes_l, got):
        assert torch.equal(y, K.notch_filter(x, g, a))
    assert K.LAUNCHES == {"notch": 0, "notch_long": 0}
    assert K.notch_filter_group([], [], []) == []
    with pytest.raises(ValueError):
        K.notch_filter_group(xs, gs[:2], axes_l)
    ours = P.filter_subband(torch.from_numpy(img), 30.0, level, "db3",
                            axes=axes)
    ref = np.asarray(J.filter_subband(jnp.asarray(img), 30.0, level, "db3",
                                      axes=axes))
    assert ours.shape == img.shape
    assert _rel(ours.numpy(), ref) <= TOL
