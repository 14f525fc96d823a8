"""K8, the destripe notch (ipp_tpu_torch/csrc/notch.cuh), its wrapper
`cuda_notch.notch_filter` and `destripe.filter_coefficient`, on the CPU and
on the card.

- The plain version (`notch_filter_plain`, torch.fft) and
  `filter_coefficient` against the JAX package's `filter_coefficient`
  (jnp.fft on the CPU) at every line length the destripe planner gives
  (2000 x 2000 tiles: 1344 ... 21; 1600 x 2000 along y: 1152 ... 18; the
  128^3 FNT cubes: 368 ... 23), on both axes, two tiles of three lines
  (an odd last line): within 1e-5 of the reference's max (tighter than
  the 1e-4 of tests/test_torch_destripe.py; both f32 FFTs).
- `notch_plan`: the radices multiply to n, every pass is a specialised
  radix but one generic odd pass last, for every n up to 4096 and a
  sample up to `NOTCH_MAX_N`.
- `emulate_k8`, a PyTorch emulation of the kernel: the geometry
  (`notch_geometry`, the header's, printed by the host check), the item
  -> line pair -> line address maps of both layouts, the slot maps, the
  Stockham passes of the plan in complex64 with the f32 twiddle table,
  the product with G / n, the inverse passes; against float64 numpy at
  every planner length, every output written exactly once: 1e-5 of max.
- The header itself, built with g++ against the stand-in
  `cuda_runtime.h` (tests/torch_notch_host/check.cpp) and run thread by
  thread against a float64 irfft(rfft(x) g): the planner lengths on both
  axes, odd line counts, n = 1 and 2, primes, and lengths whose buffers
  live in the device-memory scratch; each tile alone bit-equal to its
  place in the batch.
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
from ipp_tpu_torch.ops.dft_mats import DFT_FFT_RADICES, stage_twiddles

ROOT = Path(__file__).resolve().parent.parent
TOL = 1e-5
# the planner's line lengths (`destripe._plan_padding`, levels 1-7 of the
# padded shape): 2000^2 tiles (2688 both axes), 1600 x 2000 along y (2304),
# 128^3 FNT cubes (736)
TILE_2000 = (1344, 672, 336, 168, 84, 42, 21)
TILE_1600_Y = (1152, 576, 288, 144, 72, 36, 18)
FNT = (368, 184, 92, 46, 23)
LENGTHS = TILE_2000 + TILE_1600_Y + FNT


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

@pytest.mark.parametrize("n", LENGTHS)
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
    assert all(r in DFT_FFT_RADICES for r in plan[:-1])
    last = plan[-1]
    if last not in DFT_FFT_RADICES:       # the one generic pass: odd, last
        assert last % 2 == 1
        assert last == 1 or all(last % f for f in (3, 5, 7, 11, 13))
        assert (last == 1) == (n == 1)
    return plan


@pytest.mark.parametrize("n,plan", [
    (1344, (8, 8, 3, 7)), (84, (4, 3, 7)), (21, (3, 7)), (1152, (8, 16, 9)),
    (72, (8, 9)), (36, (4, 9)), (18, (2, 9)), (368, (16, 23)),
    (92, (4, 23)), (46, (2, 23)), (23, (23,)), (1, (1,)), (2, (2,)),
    (32768, (8, 16, 16, 16)), (32749, (32749,))])
def test_plan_at_the_lengths_of_the_paths(n, plan):
    assert check_plan(n) == plan


def test_plan_factors_every_length_of_the_domain():
    for n in list(range(1, 4097)) + list(range(4097, K.NOTCH_MAX_N + 1, 97)):
        check_plan(n)
    for n in (0, -4, K.NOTCH_MAX_N + 1):
        with pytest.raises(ValueError, match=str(K.NOTCH_MAX_N)):
            K.notch_plan(n)


# -- the kernel's index maps and passes --------------------------------------------

def _roots(radix, forward):
    jk = np.outer(np.arange(radix), np.arange(radix)) % radix
    ang = (-2 if forward else 2) * np.pi * jk / radix
    return torch.from_numpy(np.exp(1j * ang).astype(np.complex64))


def emulate_passes(z, gs, n):
    """K8's arithmetic on z (..., n) complex64: the Stockham passes of
    `notch_plan(n)` (butterfly i reads i + k n / R, writes q + S (R p + k)
    with the twiddle w^(p k S) from `stage_twiddles(n)`; the roots of a
    specialised radix are constants, those of the generic last pass come
    from the table at ((j k) % r) S), the product with gs = G / n at the
    last forward pass, then the same passes conjugated."""
    tab = torch.from_numpy(stage_twiddles(n).copy())
    w_fwd = torch.complex(tab[:, 0], tab[:, 1])
    plan = K.notch_plan(n)
    for forward in (True, False):
        w = w_fwd if forward else w_fwd.conj()
        stride = 1
        for at, radix in enumerate(plan):
            nb = n // radix
            i = torch.arange(nb)
            k = torch.arange(radix)
            a = z[..., i[:, None] + k[None, :] * nb]        # (..., nb, R)
            if radix in DFT_FFT_RADICES:
                roots = _roots(radix, forward)
            else:
                assert at == len(plan) - 1 and stride * radix == n
                roots = w[(k[:, None] * k[None, :]) % radix * stride]
            b = a @ roots
            q, p = i % stride, i // stride
            b = b * w[p[:, None] * k[None, :] * stride]     # 1 where p == 0
            out = torch.empty_like(z)
            out[..., q[:, None] + stride * (radix * p[:, None] + k[None, :])] = b
            z, stride = out, stride * radix
        assert stride == n
        if forward:
            z = z * gs
    return z


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
    geo = K.notch_geometry(B, H, W, axis == -2)
    a, b, stride, valid, has_b = pair_maps(geo, B, H, W)
    e = torch.arange(n) * stride
    flat = x.reshape(-1)
    ia = torch.where(valid, a, 0)[..., None] + e
    ib = torch.where(valid & has_b, b, 0)[..., None] + e
    re = torch.where(valid[..., None], flat[ia], 0.0)
    im = torch.where((valid & has_b)[..., None], flat[ib], 0.0)
    k = np.arange(n)
    gs = torch.from_numpy((g.astype(np.float64)[np.minimum(k, n - k)] / n)
                          .astype(np.float32))
    z = emulate_passes(torch.complex(re, im), gs, n)
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


@pytest.mark.parametrize("n", LENGTHS + (1, 2, 3000, 14000, 14528, 14600))
@pytest.mark.parametrize("cols", (False, True))
def test_slots_are_distinct_and_threads_cover_every_element(n, cols):
    """The slot map `at` of both layouts sends each (pair, element) of an
    item to its own slot of the buffer; the threads of a pair (lane_of)
    take every element once; shared memory within the limit, or none (the
    scratch) only where one pair's buffers do not fit."""
    geo = K.notch_geometry(8, n, n, cols)
    CP, T, e = geo["CP"], geo["T"], torch.arange(n)
    c = torch.arange(CP)[:, None]
    if cols:
        slots = e[None, :] * CP + c
    else:
        slots = c * geo["pitch"] + e + (e >> 4) * geo["pad"]
    assert int(slots.max()) < geo["buf"]
    assert torch.unique(slots).numel() == slots.numel()
    tid = torch.arange(geo["threads"])
    lc, lj = (tid % CP, tid // CP) if cols else (tid // T, tid % T)
    assert torch.unique(lc * T + lj).numel() == geo["threads"]
    assert int(lc.max()) == CP - 1 and int(lj.max()) == T - 1
    assert geo["threads"] <= K.MAX_THREADS
    fits = 16 * (n if cols else n | 1) <= K.SMEM_LIMIT
    assert (geo["smem"] > 0) == fits
    assert geo["smem"] <= K.SMEM_LIMIT


# -- the header on the host ------------------------------------------------------

# (axis, B, H, W): every planner length on both axes, three lines a tile
# (an odd last line) and two tiles; n = 1, 2; primes; a row without its
# pad (14000) and the scratch (n >= 14528; two lines); a columns item
# part-filled (W = 37)
HOST_CASES = ([(-1, 2, 3, n) for n in LENGTHS]
              + [(-2, 2, n, 3) for n in LENGTHS]
              + [(-1, 2, 1, 1), (-2, 1, 2, 5), (-1, 3, 2, 97), (-2, 2, 97, 37),
                 (-1, 1, 2, 14000), (-1, 1, 1, 14530), (-2, 1, 14600, 2), (-1, 1, 1, 4099),
                 (-2, 2, 1344, 37)])


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


def test_header_on_the_host_matches_float64(host_check):
    args = []
    for axis, B, H, W in HOST_CASES:
        n = H if axis == -2 else W
        plan = K.notch_plan(n)
        generic = int(plan[-1] not in DFT_FFT_RADICES)
        args += [str(v) for v in (axis, B, H, W, generic, *plan)] + ["/"]
    out = subprocess.run([str(host_check), *args[:-1]], capture_output=True,
                         text=True, timeout=240)
    assert out.returncode == 0, out.stdout + out.stderr
    lines = out.stdout.splitlines()
    assert len(lines) == len(HOST_CASES)
    for (axis, B, H, W), line in zip(HOST_CASES, lines):
        # the header's geometry is the one the wrapper and emulation mirror
        g = K.notch_geometry(B, H, W, axis == -2)
        want = (f"CP {g['CP']} T {g['T']} threads {g['threads']} pitch "
                f"{g['pitch']} buf {g['buf']} smem {g['smem']} tiles "
                f"{g['tiles']} vec2 {g['vec2']} items {g['items']};")
        assert want in line, (want, line)


# -- the wrapper -------------------------------------------------------------------

def test_cpu_calls_take_the_plain_version_and_count_nothing(rng):
    K.reset_launch_counts()
    for axis in (-1, -2):
        x = torch.from_numpy(rng.standard_normal((2, 12, 10)).astype(
            np.float32))
        g = _notch(x.shape[axis])
        assert torch.equal(K.notch_filter(x, g, axis),
                           K.notch_filter_plain(x, g, axis))
    assert K.LAUNCHES == {"notch": 0}


@pytest.mark.parametrize("shape,dtype,glen,axis,err", [
    ((2, 8, 10), torch.float64, 6, -1, TypeError),     # not f32
    ((2, 8, 10), torch.float16, 6, -1, TypeError),
    ((2, 8, 10), torch.float32, 5, -1, ValueError),    # g of another length
    ((2, 8, 10), torch.float32, 6, 0, ValueError),     # not an axis it takes
    ((10,), torch.float32, 6, -2, ValueError),         # no axis -2
    ((2, 0), torch.float32, 1, -1, ValueError),        # n = 0
    ((1, 32769), torch.float32, 16385, -1, ValueError),   # past the limit
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
    """filter_subband reaches the notch through `notch_filter` alone: one
    call a level and axis, the x notch on cH, the y notch on cV."""
    calls = []

    def counted(x, g, axis):
        calls.append((axis, tuple(x.shape)))
        return K.notch_filter_plain(x, g, axis)

    monkeypatch.setattr(P, "notch_filter", counted)
    img = torch.from_numpy(rng.standard_normal((2, 64, 96)).astype(
        np.float32))
    P.filter_subband(img, 20.0, 3, "db3", axes=(-1, -2))
    assert calls == [(a, (2, 64 >> lv, 96 >> lv)) for lv in (3, 2, 1)
                     for a in (-1, -2)]
