"""K5s, the DWT synthesis kernel (ipp_tpu_torch/csrc/dwt.cuh), and its
wrapper `cuda_dwt.dwt_synthesis`, on the CPU and on the card.

- The plain synthesis (K5s's CPU version, the transposed convolution
  folded mod n) against the JAX package's `_idwt_last` (its conv path, as
  off the TPU) at six filter lengths on both axes, rows shorter than the
  filter and odd lengths among them: atol 2e-5, as the analysis twins.
- `emulate_syn_rows` / `emulate_syn_cols`, a PyTorch emulation of the
  kernel's index maps with the geometry of the header
  (`syn_rows_geometry`, `cols_geometry`, mirrored by `syn_rows_geo` and
  test_torch_dwt_kernel's `cols_geo`): each item's window of pairs
  [i0 - (H - 1), i0 + cnt) mod m copied into its padded slots of a
  shared memory that is NaN everywhere else, R output pairs a thread
  reading the reversed taps at slot q + s, the interleaved stores;
  against the plain version at 1e-6 of max, every output written exactly
  once.
- The header itself, built with g++ against the stand-in
  `cuda_runtime.h` and run thread by thread against a float64 synthesis
  (tests/torch_dwt_host/check.cpp `syn` cases), its geometry equal to the
  mirror here.
- The wrapper: CPU calls take the plain version and count nothing; it
  refuses shapes and devices the kernel does not take; waverec2 / idwt2
  reach it three times a level.
- On a CUDA card only (`gpu`): the kernel against its plain version (rel
  1e-5, both f32), a batch bit-equal to its single calls, two calls
  bit-equal, and waverec2 with no transposed convolution.
"""

import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ipp_tpu.ops import wavelets as J
from ipp_tpu_torch.ops import cuda_dwt as K
from ipp_tpu_torch.ops import wavelets as P
from tests.test_torch_dwt_kernel import (ROOT, SMEM_LIMIT, TAP_BYTES, TS,
                                         cdiv, cols_geo, padded)

TOL = 1e-6
# filter lengths 2, 6, 18, 68, 90, 102
WAVELETS = ("haar", "db3", "db9", "db34", "coif15", "coif17")
# the destripe CLI's level lengths 2688 -> 42, the shortest row, rows
# shorter than every filter but haar, odd m (21, 5, 43), m past one tile
LENGTHS = (2, 10, 16, 42, 86, 336, 2688, 4098)


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K5s has no CPU mode")
    return torch.device("cuda", 0)


def _taps(name, device="cpu"):
    return P.filter_taps(name, device)


def _subbands(rng, shape):
    return tuple(torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)) for _ in range(2))


# -- the plain version against the JAX package ---------------------------------

@pytest.mark.parametrize("m", (1, 5, 21, 64))
@pytest.mark.parametrize("name", WAVELETS)
def test_plain_last_axis_matches_jax(name, m):
    """m = 1, 5, 21: rows shorter than most filters (several wraps), odd m."""
    _, _, lo, hi = J.filter_bank(name)
    rng = np.random.default_rng(m)
    ca, cd = _subbands(rng, (3, m))
    got = K.dwt_synthesis_plain(ca, cd, _taps(name), -1)
    ref = J._idwt_last(jnp.asarray(ca.numpy()), jnp.asarray(cd.numpy()),
                       lo, hi)
    assert got.shape == (3, 2 * m)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5)


@pytest.mark.parametrize("m", (5, 21, 48))
@pytest.mark.parametrize("name", WAVELETS)
def test_plain_axis_minus2_matches_jax(name, m):
    """Axis -2 against `_idwt_last` on moved axes."""
    _, _, lo, hi = J.filter_bank(name)
    rng = np.random.default_rng(100 + m)
    ca, cd = _subbands(rng, (2, m, 7))
    got = K.dwt_synthesis_plain(ca, cd, _taps(name), -2)
    ref = J._idwt_last(jnp.moveaxis(jnp.asarray(ca.numpy()), -2, -1),
                       jnp.moveaxis(jnp.asarray(cd.numpy()), -2, -1), lo, hi)
    assert got.shape == (2, 2 * m, 7)
    np.testing.assert_allclose(got.numpy(),
                               np.moveaxis(np.asarray(ref), -1, -2),
                               atol=2e-5)


def test_synthesis_inverts_analysis():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((3, 84, 40)).astype(np.float32))
    for axis in (-1, -2):
        ca, cd = K.dwt_analysis_plain(x, _taps("db9"), axis)
        back = K.dwt_synthesis_plain(ca, cd, _taps("db9"), axis)
        np.testing.assert_allclose(back.numpy(), x.numpy(), atol=2e-5)


# -- the kernel's index maps -----------------------------------------------------

def syn_rows_geo(nrows, n, L):
    """csrc/dwt.cuh `syn_rows_geometry`: `rows_geometry`'s segments and rows
    an item at its defaults (R = 8); shared memory holds the taps and two
    buffers of rows x (ca, cd) windows of Wp floats, seg + H - 1 pairs
    padded."""
    R, threads = 8, 512 if L > 32 else 256
    H, m = L // 2, n // 2
    tpr = min(cdiv(m, R), threads)
    seg = tpr * R
    Wp = padded(seg + H - 1, R)
    rows = min(nrows, threads // tpr)
    while rows > 1 and TAP_BYTES + 2 * rows * 2 * Wp * 4 > SMEM_LIMIT:
        rows -= 1
    return dict(R=R, H=H, m=m, tpr=tpr, seg=seg, tiles=cdiv(m, seg),
                rows=rows, Wp=Wp, threads=cdiv(rows * tpr, 32) * 32,
                smem=TAP_BYTES + 2 * rows * 2 * Wp * 4,
                items=cdiv(nrows, rows) * cdiv(m, seg))


def _syn_taps4(taps):
    """(H, 4) rows (lo[2r], hi[2r], lo[2r+1], hi[2r+1]), r = H - 1 - s:
    `stage_syn_taps`, in float64."""
    H = taps.shape[1] // 2
    t = taps.double().reshape(2, H, 2)          # (lo/hi, r, parity)
    t4 = torch.stack([t[0, :, 0], t[1, :, 0], t[0, :, 1], t[1, :, 1]], -1)
    return t4.flip(0)


def _pairs(q0, need, m, count):
    """Window slot p -> pair (q0 + p) mod m, and whether the copy stages
    it (p < need): (items, count) each."""
    p = torch.arange(count)
    return (q0[:, None] + p) % m, p < need[:, None]


NAN = float("nan")


def emulate_syn_rows(ca, cd, taps):
    """The last-axis kernel on ca, cd (nrows, m), float64, all items at
    once: item k holds rows row0 .. row0 + rows - 1 and output pairs i0 ..
    i0 + cnt - 1; each row's ca and cd window holds pair (i0 - (H - 1) + p)
    mod m at slot padded(p) for p < cnt + H - 1, NaN elsewhere (and past
    Wp); thread t of row rl reads slot t (R + 1) + c + c // R for window
    pair c = r + s of output pair tR + r, s < H; pairs < cnt are stored at
    y[2j], y[2j + 1].  Returns y and how often each output was written."""
    nrows, m = ca.shape
    n = 2 * m
    g = syn_rows_geo(nrows, n, taps.shape[1])
    R, H, seg, rows = g["R"], g["H"], g["seg"], g["rows"]
    Wp, tpr = g["Wp"], g["tpr"]
    k = torch.arange(g["items"])
    row0, i0 = (k // g["tiles"]) * rows, (k % g["tiles"]) * seg
    cnt = torch.clamp(m - i0, max=seg)
    pair, staged = _pairs(i0 - (H - 1), cnt + H - 1, m, seg + H - 1)
    slot = padded(torch.arange(seg + H - 1), R)
    row = row0[:, None] + torch.arange(rows)                   # (k, rows)
    rowc = torch.clamp(row, max=nrows - 1)
    spare = Wp + R + H       # NaN past the window: a read there shows
    wins = []
    for band in (ca, cd):
        src = band.double()[rowc]                               # (k, rows, m)
        val = src.gather(-1, pair[:, None].expand(-1, rows, -1))
        val = torch.where(staged[:, None], val, torch.tensor(NAN,
                                                             dtype=val.dtype))
        w = torch.full((len(k), rows, Wp + spare), NAN, dtype=torch.float64)
        w[:, :, slot] = val
        wins.append(w)
    t = torch.arange(tpr)
    c = torch.arange(R)[:, None] + torch.arange(H)              # (R, H)
    addr = t[:, None, None] * (R + 1) + c + c // R              # (tpr, R, H)
    assert int(addr.max()) < Wp + spare
    va, vd = (w[:, :, addr] for w in wins)                      # (k, rows, tpr, R, H)
    tap = _syn_taps4(taps)
    even = (va * tap[:, 0] + vd * tap[:, 1]).sum(-1)
    odd = (va * tap[:, 2] + vd * tap[:, 3]).sum(-1)
    out = t[:, None] * R + torch.arange(R)                      # (tpr, R)
    busy = (t * R)[:, None].expand(-1, R)
    keep = ((row < nrows)[:, :, None, None]
            & (busy < cnt[:, None, None])[:, None]
            & (out < cnt[:, None, None])[:, None])
    kk, rr, tt, oo = keep.nonzero(as_tuple=True)
    y = torch.full((nrows, n), NAN, dtype=torch.float64)
    hits = torch.zeros((nrows, n), dtype=torch.int64)
    ri, jj = row[kk, rr], i0[kk] + out[tt, oo]
    for p, v in ((0, even), (1, odd)):
        y[ri, 2 * jj + p] = v[kk, rr, tt, oo]
        hits.index_put_((ri, 2 * jj + p), torch.ones_like(ri),
                        accumulate=True)
    return y, hits


def emulate_syn_cols(ca, cd, taps):
    """The axis -2 kernel on ca, cd (B, m, S), float64: item (b, ti, ts)
    holds output pairs i0 .. i0 + cnt - 1 of columns s0 .. s0 + 31; its
    window rows hold pair rows (i0 - (H - 1) + p) mod m of ca (rows 0 .. W
    - 1) and cd (W .. 2W - 1) for p < cnt + H - 1, NaN below, columns past
    S as 0; lane c of warp w computes pairs wR + r of column s0 + c from
    window rows wR + r + s."""
    B, m, S = ca.shape
    n = 2 * m
    g = cols_geo(B, n, S, taps.shape[1])
    H, TI, R, W = g["H"], g["TI"], g["R"], g["TI"] + g["H"] - 1
    k = torch.arange(g["items"])
    ts, rest = k % g["tiles_s"], k // g["tiles_s"]
    ti, b = rest % g["tiles_i"], rest // g["tiles_i"]
    s0, i0 = ts * TS, ti * TI
    cnt = torch.clamp(m - i0, max=TI)
    pair, staged = _pairs(i0 - (H - 1), cnt + H - 1, m, W)      # (k, W)
    col = s0[:, None] + torch.arange(TS)                        # (k, 32)
    wins = []
    for band in (ca, cd):
        xp = torch.nn.functional.pad(band.double(), (0, g["tiles_s"] * TS - S))
        v = xp[b[:, None, None], pair[:, :, None], col[:, None, :]]
        wins.append(torch.where(staged[:, :, None], v,
                                torch.tensor(NAN, dtype=v.dtype)))
    w = torch.arange(g["warps"])
    out = (w[:, None] * R + torch.arange(R)).reshape(-1)        # (TI,)
    busy = (w * R)[:, None].expand(-1, R).reshape(-1)
    rows = out[:, None] + torch.arange(H)                       # (TI, H)
    va, vd = (x[:, rows] for x in wins)                         # (k, TI, H, 32)
    tap = _syn_taps4(taps)[:, :, None]
    even = (va * tap[:, 0] + vd * tap[:, 1]).sum(-2)
    odd = (va * tap[:, 2] + vd * tap[:, 3]).sum(-2)
    keep = ((busy < cnt[:, None]) & (out < cnt[:, None]))[:, :, None] & (
        col < S)[:, None]                                       # (k, TI, 32)
    kk, oo, cc = keep.nonzero(as_tuple=True)
    y = torch.full((B, n, S), NAN, dtype=torch.float64)
    hits = torch.zeros((B, n, S), dtype=torch.int64)
    jj = i0[kk] + out[oo]
    for p, v in ((0, even), (1, odd)):
        idx = (b[kk], 2 * jj + p, col[kk, cc])
        y[idx] = v[kk, oo, cc]
        hits.index_put_(idx, torch.ones_like(kk), accumulate=True)
    return y, hits


def _check(y, hits, ref):
    assert bool((hits == 1).all()), "an output written 0 or 2 times"
    assert not torch.isnan(y).any()
    err = float((y - ref.double()).abs().max())
    scale = float(ref.abs().max())
    assert err <= TOL * scale, err / scale


@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("name", WAVELETS)
def test_rows_emulation_matches_plain(name, n):
    rng = np.random.default_rng(n)
    nrows = 3 if n >= 2688 else 37
    ca, cd = _subbands(rng, (nrows, n // 2))
    taps = _taps(name)
    _check(*emulate_syn_rows(ca, cd, taps),
           K.dwt_synthesis_plain(ca, cd, taps, -1))


@pytest.mark.parametrize("S", (1, 33, 42))
@pytest.mark.parametrize("n", LENGTHS[:-1])
@pytest.mark.parametrize("name", ("haar", "db9", "coif17"))
def test_cols_emulation_matches_plain(name, n, S):
    rng = np.random.default_rng(n * 100 + S)
    B = 1 if n >= 2688 else 2
    ca, cd = _subbands(rng, (B, n // 2, S))
    taps = _taps(name)
    _check(*emulate_syn_cols(ca, cd, taps),
           K.dwt_synthesis_plain(ca, cd, taps, -2))


@pytest.mark.parametrize("axis", (-1, -2))
@pytest.mark.parametrize("name", WAVELETS)
def test_every_filter_on_both_axes_keeps_the_index_maps(name, axis):
    """Every instance launch_syn has (R = 8 rows; R = 8 columns up to 64
    taps, R = 16 above), at the odd m and ragged width of a deep level."""
    rng = np.random.default_rng(10 * WAVELETS.index(name) - axis)
    taps = _taps(name)
    if axis == -1:
        ca, cd = _subbands(rng, (5, 1101))
        _check(*emulate_syn_rows(ca, cd, taps),
               K.dwt_synthesis_plain(ca, cd, taps, -1))
    else:
        ca, cd = _subbands(rng, (2, 151, 40))
        assert cols_geo(2, 302, 40, taps.shape[1])["R"] == (
            16 if taps.shape[1] > 64 else 8)
        _check(*emulate_syn_cols(ca, cd, taps),
               K.dwt_synthesis_plain(ca, cd, taps, -2))


def test_destripe_levels_fit_the_card():
    """Every level shape of the destripe CLI's batches (8, 2688, 2688) and
    (8, 2304, 2688) at every filter length here: shared memory within a
    block's 227 KB, at most 512 threads (K5s runs the same shapes as K5:
    rows of w on (8 h, w / 2) pairs, columns of h on (8, h / 2, w / 2))."""
    for L in (2, 6, 18, 68, 90, 102):
        for h, w in ((2688, 2688), (2304, 2688)):
            for lv in range(7):
                hh, ww = h >> lv, w >> lv
                for g in (syn_rows_geo(8 * hh, ww, L),
                          cols_geo(8, hh, ww // 2, L)):
                    assert g["smem"] <= SMEM_LIMIT and g["threads"] <= 512


# -- the header on the host ------------------------------------------------------

# (axis, B, n, S, L, aligned): every filter length; the CLI's first and
# last level; a row past one tile; rows shorter than the filter; odd m;
# ragged widths; 4-byte copies and stores; R = 16 columns
HOST_CASES = [
    (-1, 3, 2688, 1, 18, 1), (-1, 3, 2688, 1, 6, 0),
    (-1, 5, 2688, 1, 90, 1), (-1, 9, 42, 1, 102, 1),
    (-1, 7, 84, 1, 2, 1), (-1, 6, 16, 1, 18, 1),
    (-1, 4, 2, 1, 68, 1), (-1, 3, 10004, 1, 90, 1),
    (-1, 4, 336, 1, 68, 1), (-1, 4, 338, 1, 6, 0),
    (-2, 2, 2688, 42, 18, 1), (-2, 2, 2688, 64, 90, 1),
    (-2, 2, 336, 33, 6, 0), (-2, 3, 16, 31, 18, 1),
    (-2, 2, 42, 21, 102, 1), (-2, 2, 2, 1, 2, 1),
    (-2, 2, 1344, 40, 68, 1), (-2, 2, 602, 36, 90, 0),
]


@pytest.fixture(scope="module")
def host_check(tmp_path_factory):
    import shutil

    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    exe = tmp_path_factory.mktemp("dwt_syn_host") / "check"
    subprocess.run(
        [gxx, "-std=c++17", "-O2", "-I",
         str(ROOT / "tests" / "torch_dft_fft_host"), "-I",
         str(ROOT / "ipp_tpu_torch" / "csrc"),
         str(ROOT / "tests" / "torch_dwt_host" / "check.cpp"), "-o",
         str(exe)], check=True, capture_output=True)
    return exe


def test_header_synthesis_on_the_host_matches_float64(host_check):
    args = []
    for case in HOST_CASES:
        args += ["syn"] + [str(v) for v in case] + ["/"]
    out = subprocess.run([str(host_check), *args[:-1]], capture_output=True,
                         text=True)
    assert out.returncode == 0, out.stdout + out.stderr
    lines = out.stdout.splitlines()
    assert len(lines) == len(HOST_CASES)
    for (axis, B, n, S, L, _), line in zip(HOST_CASES, lines):
        # the header's geometry is the one the emulation above mirrors
        if axis == -1:
            g = syn_rows_geo(B, n, L)
            want = (f"syn rows tpr {g['tpr']} seg {g['seg']} tiles "
                    f"{g['tiles']} rows {g['rows']} Wp {g['Wp']} threads "
                    f"{g['threads']} smem {g['smem']}")
        else:
            g = cols_geo(B, n, S, L)
            want = (f"syn cols R {g['R']} TI {g['TI']} warps {g['warps']} tiles_i "
                    f"{g['tiles_i']} tiles_s {g['tiles_s']} threads "
                    f"{g['threads']} smem {g['smem']}")
        assert want in line, (want, line)
        assert f"items {g['items']};" in line, line


# -- the wrapper -------------------------------------------------------------------

def test_cpu_calls_take_the_plain_version_and_count_nothing(rng):
    K.reset_launch_counts()
    for axis, shape in ((-1, (4, 16)), (-2, (2, 16, 5))):
        ca, cd = _subbands(rng, shape)
        got = K.dwt_synthesis(ca, cd, _taps("db9"), axis)
        assert torch.equal(got, K.dwt_synthesis_plain(ca, cd, _taps("db9"),
                                                      axis))
    assert K.LAUNCHES == {"dwt_analysis": 0, "dwt_synthesis": 0}


@pytest.mark.parametrize("ca,cd,taps,axis", [
    ((4, 16), (4, 16), (2, 17), -1),     # odd filter
    ((4, 16), (4, 16), (2, 130), -1),    # filter longer than the kernel takes
    ((4, 16), (4, 16), (3, 18), -1),     # not a (lo, hi) pair
    ((4, 16), (4, 15), (2, 18), -1),     # subbands of two shapes
    ((16,), (16,), (2, 18), -2),         # no axis -2
    ((4, 16), (4, 16), (2, 18), 0),      # not an axis the kernel takes
])
def test_wrapper_refuses_what_the_kernel_does_not_take(ca, cd, taps, axis):
    with pytest.raises(ValueError):
        K.dwt_synthesis(torch.zeros(ca), torch.zeros(cd), torch.zeros(taps),
                        axis)


def test_wrapper_refuses_devices_it_cannot_launch_on():
    ca = torch.empty((4, 16), device="meta")
    with pytest.raises(ValueError):
        K.dwt_synthesis(ca, ca, torch.empty((2, 18), device="meta"), -1)
    with pytest.raises(ValueError):   # one subband on the CPU, one not
        K.dwt_synthesis(torch.zeros(4, 16), ca, torch.zeros(2, 18), -1)


def test_waverec2_and_idwt2_synthesise_through_the_wrapper(rng, monkeypatch):
    """Three calls a level, and no other synthesis: the module reaches K5s
    on the card through `dwt_synthesis` alone."""
    calls = []

    def counted(ca, cd, taps, axis):
        calls.append(axis)
        return K.dwt_synthesis(ca, cd, taps, axis)

    monkeypatch.setattr(P, "dwt_synthesis", counted)
    img = torch.from_numpy(rng.standard_normal((2, 64, 96)).astype(
        np.float32))
    rec = P.waverec2(P.wavedec2(img, "db3", 4), "db3")
    assert calls == [-2, -2, -1] * 4
    np.testing.assert_allclose(rec.numpy(), img.numpy(), atol=2e-5)
    a, det = P.dwt2(img, "db3")
    np.testing.assert_allclose(P.idwt2(a, det, "db3").numpy(), img.numpy(),
                               atol=2e-5)
    assert len(calls) == 15
    assert not hasattr(P, "_idwt_axis") and not hasattr(P, "F")


# -- on the card -------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("name,shape,axis", [
    ("db9", (3, 2688, 1344), -1), ("db9", (3, 1344, 2688), -2),
    ("coif15", (2, 84, 1344), -2), ("db3", (2, 100, 21), -1),
    ("db9", (5, 8), -1), ("db9", (2, 8, 40), -2),
    # every other filter length, both axes, ragged widths, odd m
    ("haar", (4, 1344), -1), ("haar", (2, 42, 33), -2),
    ("db34", (3, 672), -1), ("db34", (2, 168, 31), -2),
    ("coif17", (3, 21), -1), ("coif17", (2, 672, 42), -2),
    ("coif15", (2, 1344), -1), ("db9", (2, 1, 21), -2),
])
def test_kernel_matches_plain_on_the_card(cuda, name, shape, axis, rng):
    ca, cd = (t.to(cuda) for t in _subbands(rng, shape))
    taps = _taps(name, cuda)
    K.reset_launch_counts()
    got = K.dwt_synthesis(ca, cd, taps, axis)
    assert K.LAUNCHES == {"dwt_analysis": 0, "dwt_synthesis": 1}
    ref = K.dwt_synthesis_plain(ca, cd, taps, axis)
    torch.cuda.synchronize()
    assert got.shape == ref.shape
    rel = float((got - ref).abs().max() / ref.abs().max())
    assert rel <= 1e-5, rel


@pytest.mark.gpu
@pytest.mark.parametrize("axis", [-1, -2])
def test_kernel_batch_equals_single_calls_on_the_card(cuda, axis, rng):
    """Each output is one FMA chain in an order fixed by the filter, so a
    batch gives bit for bit its single calls, and a call its repeat."""
    ca, cd = (t.to(cuda) for t in _subbands(rng, (8, 168, 336)))
    taps = _taps("coif15", cuda)
    got = K.dwt_synthesis(ca, cd, taps, axis)
    assert torch.equal(got, K.dwt_synthesis(ca, cd, taps, axis))
    for i in range(ca.shape[0]):
        assert torch.equal(got[i:i + 1], K.dwt_synthesis(
            ca[i:i + 1], cd[i:i + 1], taps, axis))


@pytest.mark.gpu
def test_waverec2_runs_no_transposed_convolution_on_the_card(cuda, rng,
                                                            monkeypatch):
    def refused(*a, **k):
        raise AssertionError("a transposed convolution ran on the card")

    img = torch.from_numpy(rng.standard_normal((2, 256, 384)).astype(
        np.float32)).to(cuda)
    coeffs = P.wavedec2(img, "db9", 3)
    monkeypatch.setattr(torch.nn.functional, "conv_transpose1d", refused)
    monkeypatch.setattr(torch.nn.functional, "conv_transpose2d", refused)
    K.reset_launch_counts()
    rec = P.waverec2(coeffs, "db9")
    assert K.LAUNCHES["dwt_synthesis"] == 9
    rel = float((rec - img).abs().max() / img.abs().max())
    assert rel <= 1e-5, rel
