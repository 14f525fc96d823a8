"""K8, the destripe notch (ipp_tpu_torch/csrc/notch.cuh), its wrapper
`cuda_notch.notch_filter` and `destripe.filter_coefficient`, on the CPU and
on the card.

- The plain version (`notch_filter_plain`, torch.fft) and
  `filter_coefficient` against the JAX package's `filter_coefficient`
  (jnp.fft on the CPU) at every line length the destripe planner gives
  (2000 x 2000 tiles: 1344 ... 21; 1600 x 2000 along y: 1152 ... 18; the
  128^3 FNT cubes: 368 ... 23; a stitched plane of 2048 x 66000: 33344;
  a prime past the mixed-radix route: 65537), on both axes, two tiles of
  three lines (an odd last line): within 1e-5 of the reference's max
  (tighter than the 1e-4 of tests/test_torch_destripe.py; both f32 FFTs).
- `notch_route` and `notch_plan`: the radices multiply to the transform
  length, every pass is a specialised radix but one generic odd pass
  last, for every n up to 4096 and a sample up to `NOTCH_MAX_N`; the
  lengths of the paths, the wide planes' among them.
- `emulate_k8`, a PyTorch emulation of the kernel: the geometry
  (`notch_geometry`, the header's, printed by the host check), the item
  -> line pair -> line address maps of both layouts, the slot maps, the
  steps of `notch_steps` in complex64 with the f32 twiddle table: the
  in-place forward passes (DFT, then the twiddle), the middle (the last
  forward DFT, the gains of `notch_gains` in the plan's digit-reversed
  order, the conjugation, the first inverse DFT in one step), the inverse
  passes on the conjugated data (the twiddle, then the forward DFT), the
  store of y_b = -Im; on the chirp route the same passes twice around the
  tables of `chirp_tables`; against float64 numpy at every planner
  length and at long lengths of both routes, every output written
  exactly once: 1e-5 of max.
- The header itself, built with g++ against the stand-in
  `cuda_runtime.h` (tests/torch_notch_host/check.cpp) and run thread by
  thread against a float64 irfft(rfft(x) g): the planner lengths on both
  axes, odd line counts, n = 1 and 2, primes, lengths whose buffers live
  in the device-memory scratch (the long form) and the chirp route; each
  tile alone bit-equal to its place in the batch; the 14 notches of a
  2000^2 decomposition and two FNT lengths in one table (`make_group`, as
  `ipp_notch_group` launches them), and the 14 of a padded (2688, 66688)
  plane as the wrapper launches them (one table, the two long subbands
  alone), each bit-equal to its one-subband run.
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
# at level 1, generic pass of 521), of 20000 x 70000 (23), a power of two,
# and a prime on the chirp route
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
    m = K.notch_length(n)
    assert int(np.prod(plan)) == m
    if K.notch_route(n) == "chirp":     # the power-of-two passes of m
        assert n > K.NOTCH_SHORT_N and m == 1 << (2 * n - 2).bit_length()
        assert all(r in (4, 8, 16) for r in plan)
        return plan
    assert m == n
    assert all(r in K.NOTCH_RADICES for r in plan[:-1])
    last = plan[-1]
    if last not in K.NOTCH_RADICES:       # the one generic pass: odd, last
        assert last % 2 == 1
        assert last == 1 or all(last % f for f in (3, 5, 7, 11, 13))
        assert (last == 1) == (n == 1)
        assert n <= K.NOTCH_SHORT_N or last <= K.CHIRP_P
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
    # the chirp route: the passes of pow2ceil(2n - 1)
    (65537, (8, 8, 16, 16, 16)), (34023, (8, 8, 8, 16, 16))])
def test_plan_at_the_lengths_of_the_paths(n, plan):
    assert check_plan(n) == plan


@pytest.mark.parametrize("n,route,m", [
    (32749, "mixed", 32749), (32768, "mixed", 32768),
    (33344, "mixed", 33344), (2 ** 6 * 1021, "mixed", 2 ** 6 * 1021),
    (34023, "chirp", 131072), (65537, "chirp", 262144),
    (2 * 32771, "chirp", 262144), ((1 << 20) - 1, "chirp", 1 << 21),
    (1 << 20, "mixed", 1 << 20)])
def test_route_by_length(n, route, m):
    """Up to 32768 every length keeps its mixed-radix plan; above it an
    odd factor left past CHIRP_P (1031 = 34023 / 33, 1271 = 31 * 41 of
    2^20 - 1) takes the chirp route on the passes of pow2ceil(2n - 1)."""
    assert K.notch_route(n) == route and K.notch_length(n) == m


def test_plan_factors_every_length_of_the_domain():
    for n in list(range(1, 4097)) + list(range(4097, K.NOTCH_MAX_N + 1, 97)):
        check_plan(n)
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


def emulate_passes(z, g, n):
    """K8's arithmetic on z (..., n) complex64, step by step
    (`notch_steps`), the twiddles from the f32 table of the transform's
    length.  Mixed-radix route: one transform with the gains of
    `notch_gains(g, n)` (the spectrum's digit-reversed order); y_a + i y_b
    is the conjugate of what it leaves.  Chirp route (m =
    `notch_length(n)`, tables of `chirp_tables(n)`): K(v), one transform
    of m with the complex gains hm, on c . z padded with zeros; G / n
    times its first n values, padded; K again; times conj(c).  Returns y_a
    + i y_b."""
    plan, m = K.notch_plan(n), K.notch_length(n)
    tab = torch.from_numpy(stage_twiddles(m).copy())
    w = torch.complex(tab[:, 0], tab[:, 1])
    gp = torch.from_numpy(K.notch_gains(g, n))
    if K.notch_route(n) == "mixed":
        return torch.conj(_transform(z, plan, n, K.notch_steps(plan), w,
                                     lambda v, e: v * gp[e]))
    c, hm = (torch.from_numpy(t.copy()) for t in K.chirp_tables(n))
    c, hm = torch.complex(c[:, 0], c[:, 1]), torch.complex(hm[:, 0],
                                                           hm[:, 1])
    steps = K.notch_steps(plan, chirp=True)
    half = steps[:len(steps) // 2]
    assert steps == half + half

    def k_of(v):   # K(pad(v)), its first n values
        v = torch.cat([v, v.new_zeros(v.shape[:-1] + (m - n,))], -1)
        return _transform(v, plan, m, half, w, lambda u, e: u * hm[e])[
            ..., :n]
    return torch.conj(c) * k_of(k_of(z * c) * gp)


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


def emulate_k8(x, g, axis):
    """The kernel on x (B, H, W) f32 along `axis`: every item's CP line
    pairs gathered through `pair_maps` (z = line a + i line b, 0 for a
    missing line b and for pairs past the input), `emulate_passes`, and
    the real and imaginary parts scattered back.  Returns y and how often
    each output was written."""
    B, H, W = x.shape
    n = H if axis == -2 else W
    geo = K.notch_geometry(B, H, W, axis == -2, **K._flags(n))
    a, b, stride, valid, has_b = pair_maps(geo, B, H, W)
    e = torch.arange(n) * stride
    flat = x.reshape(-1)
    ia = torch.where(valid, a, 0)[..., None] + e
    ib = torch.where(valid & has_b, b, 0)[..., None] + e
    re = torch.where(valid[..., None], flat[ia], 0.0)
    im = torch.where((valid & has_b)[..., None], flat[ib], 0.0)
    z = emulate_passes(torch.complex(re, im), g, n)
    y = torch.full((x.numel(),), float("nan"))
    hits = torch.zeros(x.numel(), dtype=torch.int64)
    for idx, keep, v in ((ia, valid, z.real), (ib, valid & has_b, z.imag)):
        keep = keep[..., None].expand_as(idx)
        y[idx[keep]] = v[keep]
        hits.index_put_((idx[keep],), torch.ones_like(idx[keep]),
                        accumulate=True)
    return y.reshape(x.shape), hits.reshape(x.shape)


@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("axis", (-1, -2))
def test_emulation_matches_float64_at_the_planner_lengths(axis, n):
    rng = np.random.default_rng(10 * n - axis)
    x = _coef(rng, axis, n, lines=5)
    g = _notch(n)
    y, hits = emulate_k8(torch.from_numpy(x), g, axis)
    assert bool((hits == 1).all()), "an output written 0 or 2 times"
    assert _rel(y.numpy(), _ref64(x, g, axis)) <= TOL


@pytest.mark.parametrize("n", LONG)
@pytest.mark.parametrize("axis", (-1, -2))
def test_emulation_matches_float64_at_the_long_lengths(axis, n):
    """Lines past 32768 on both routes, 2-3 lines a tile: the long
    form's geometry (one pair a block item) and passes, the chirp
    route's two transforms."""
    rng = np.random.default_rng(3 * n - axis)
    x = _coef(rng, axis, n, lines=3 if n < 65536 else 2, tiles=1)
    g = _notch(n)
    y, hits = emulate_k8(torch.from_numpy(x), g, axis)
    assert bool((hits == 1).all()), "an output written 0 or 2 times"
    assert _rel(y.numpy(), _ref64(x, g, axis)) <= TOL


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
    once; every step's butterflies take each element of a pair's transform
    (m = notch_length(n)) exactly once; shared memory within the limit, or
    none (the scratch) only where one pair's buffers do not fit."""
    plan = K.notch_plan(n)
    flags = K._flags(n)
    geo = K.notch_geometry(8, n, n, cols, **flags)
    m = geo["m"]
    assert m == K.notch_length(n)
    CP, T, e = geo["CP"], geo["T"], torch.arange(m)
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
    for _, p in K.notch_steps(plan, flags["chirp"]):
        radix, L = plan[p], int(np.prod(plan[p:]))
        i = torch.arange(m // radix)
        elems = ((i // (L // radix)) * L + i % (L // radix))[:, None] \
            + torch.arange(radix)[None, :] * (L // radix)
        assert torch.equal(torch.sort(elems.reshape(-1)).values, e)
    fits = 8 * geo["nbuf"] * geo["buf"] <= K.SMEM_LIMIT
    assert (geo["smem"] > 0) == fits
    assert fits or CP == 1
    assert geo["smem"] <= K.SMEM_LIMIT
    assert fits or n > 13000          # every long line past ~13600


# -- the header on the host ------------------------------------------------------

# (axis, B, H, W): every planner length on both axes, three lines a tile
# (an odd last line) and two tiles; n = 1, 2; primes; a row without its
# pad (14000) and the scratch (n >= 14528; two lines); a columns item
# part-filled (W = 37); lines past 32768 on both routes
HOST_CASES = ([(-1, 2, 3, n) for n in LENGTHS]
              + [(-2, 2, n, 3) for n in LENGTHS]
              + [(-1, 2, 1, 1), (-2, 1, 2, 5), (-1, 3, 2, 97), (-2, 2, 97, 37),
                 (-1, 1, 2, 14000), (-1, 1, 1, 14530), (-2, 1, 14600, 2), (-1, 1, 1, 4099),
                 (-2, 2, 1344, 37),
                 # the long form past 32768 (generic pass of 521) and the
                 # chirp route (34023 = 33 * 1031), each tile alone too
                 (-1, 1, 2, 33344), (-2, 1, 33344, 2), (-1, 2, 3, 34023),
                 (-2, 1, 34023, 3)])


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


def _host_args(cases):
    """The check's arguments: AXIS B H W ROUTE (0, 1 generic, 2 chirp)
    and the plan of every case, "/" between cases."""
    args = []
    for axis, B, H, W in cases:
        n = H if axis == -2 else W
        flags = K._flags(n)
        route = 2 if flags["chirp"] else int(flags["generic"])
        args += [str(v) for v in (axis, B, H, W, route, *K.notch_plan(n))]
        args.append("/")
    return args[:-1]


def _host_geometry(axis, B, H, W):
    """The geometry line the host check prints for a case."""
    n = H if axis == -2 else W
    flags = K._flags(n)
    g = K.notch_geometry(B, H, W, axis == -2, **flags)
    return (f"CP {g['CP']} T {g['T']} pitch {g['pitch']} buf {g['buf']} "
            f"nbuf {g['nbuf']} smem {g['smem']} tiles {g['tiles']} vec2 "
            f"{g['vec2']} items {g['items']} steps "
            f"{len(K.notch_steps(K.notch_plan(n), flags['chirp']))};")


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
# columns; 33344 and 16672 (generic pass of 521, two buffers) in the long
# form
WIDE_CASES = ([(-1, 1, 2, 66688 >> lv) for lv in range(1, 8)]
              + [(-2, 1, 2688 >> lv, 5) for lv in range(1, 8)])


def test_header_wide_plane_group_on_the_host_equals_lone_runs(host_check):
    """A decomposition with long subbands as the wrapper launches it
    (`cuda_notch._launches`): the 12 that fit shared memory in one table,
    33344 and 16672 each alone in the long form; every output bit-equal
    to its one-subband run and within 1e-5 of float64."""
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
