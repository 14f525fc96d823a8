"""K5, the register-tiled DWT analysis kernel (ipp_tpu_torch/csrc/dwt.cuh),
on the CPU.

The CUDA kernel runs only on a card.  What is held here:
- `emulate_dwt`, a PyTorch emulation of the kernel's index maps with the
  geometry of the header (`rows_geometry` / `cols_geometry`, mirrored by
  `rows_geo` / `cols_geo`): items of whole or partial rows and several
  rows an item on the last axis, items of TI output rows x 32 columns on
  axis -2, the window of cnt + H - 1 pairs copied mod m (the rest of shared
  memory NaN, so a read past the halo shows), R outputs a thread, the
  ragged last column item, rows shorter than the filter; against
  `dwt_analysis_plain` at 1e-6 of max, every output written exactly once;
- the header itself, compiled with the host compiler against the stand-in
  `cuda_runtime.h` of tests/torch_dft_fft_host/ and run block by block,
  thread by thread (the copies into both windows, the sliding-window tap
  loop in both forms, the stores) against a naive float64 DWT
  (tests/torch_dwt_host/check.cpp), its geometry equal to the mirror here.
The card's own checks are in tests/test_torch_wavelets.py (`gpu`).
"""

import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from ipp_tpu_torch.ops import cuda_dwt as K
from ipp_tpu_torch.ops import wavelets as P

ROOT = Path(__file__).resolve().parent.parent
TOL = 1e-6
TS = 32                       # columns a block on axis -2
TAP_BYTES = 64 * 16
SMEM_LIMIT = 227 * 1024
# filter lengths 2, 6, 18, 68, 90, 102
WAVELETS = ("haar", "db3", "db9", "db34", "coif15", "coif17")
# the destripe CLI's level lengths (2688 -> 42) and others: the shortest
# row, rows shorter than every filter but haar, odd m, m past one tile
LENGTHS = (2, 16, 42, 84, 168, 336, 672, 1344, 2688, 10, 4098)


def cdiv(a, b):
    return -(-a // b)


def padded(p, R):
    return p + p // R


def max_threads(R):
    return 512 if R <= 8 else 256


def rows_geo(nrows, n, L, R=8, threads=0):
    """csrc/dwt.cuh `rows_geometry`: an item is `rows` rows x one segment of
    tpr * R outputs; shared memory holds the taps, the copy of each row's
    seg + H - 1 pairs (an even count of float2 slots) and its padded
    window."""
    threads = threads or min(512 if L > 32 else 256, max_threads(R))
    H, m = L // 2, n // 2
    tpr = min(cdiv(m, R), threads)
    seg = tpr * R
    Rq = cdiv(seg + H - 1, 2) * 2
    Wq = padded(Rq, R) + 1
    rows = min(nrows, threads // tpr)
    while rows > 1 and TAP_BYTES + rows * (Rq + Wq) * 8 > SMEM_LIMIT:
        rows -= 1
    return dict(R=R, H=H, m=m, tpr=tpr, seg=seg, tiles=cdiv(m, seg),
                rows=rows, threads=cdiv(rows * tpr, 32) * 32,
                smem=TAP_BYTES + rows * (Rq + Wq) * 8,
                items=cdiv(nrows, rows) * cdiv(m, seg))


def cols_geo(B, n, S, L, R=0, threads=0):
    """csrc/dwt.cuh `cols_geometry` with `launch`'s default R (16 for
    filters longer than 64 taps, else 8): an item is TI output rows x 32
    columns; shared memory holds the taps and two windows of e and o
    rows."""
    R = R or (16 if L > 64 else 8)
    threads = threads or min(512, max_threads(R))
    H, m = L // 2, n // 2
    tiles_i = cdiv(m, (threads // TS) * R)
    TI = cdiv(cdiv(m, tiles_i), R) * R
    W = TI + H - 1
    return dict(R=R, H=H, m=m, TI=TI, warps=TI // R, tiles_i=tiles_i,
                tiles_s=cdiv(S, TS), threads=TS * (TI // R),
                smem=TAP_BYTES + 2 * 2 * W * TS * 4,
                items=B * tiles_i * cdiv(S, TS))


def _taps4(taps):
    """(H, 4) rows (lo[2j], lo[2j+1], hi[2j], hi[2j+1]), the kernel's
    float4 taps, in float64."""
    H = taps.shape[1] // 2
    return taps.double().reshape(2, H, 2).permute(1, 0, 2).reshape(H, 4)


def _sums(tap, e, o):
    """cA, cD of gathered windows e, o (..., H)."""
    a = (e * tap[:, 0] + o * tap[:, 1]).sum(-1)
    d = (e * tap[:, 2] + o * tap[:, 3]).sum(-1)
    return a, d


def emulate_rows(x, taps, R=8, threads=0):
    """The last-axis kernel on x (nrows, n), float64, all items at once:
    item k holds rows row0 .. row0 + rows - 1 and outputs i0 .. i0 + cnt - 1
    of them; its window, pairs [i0, i0 + cnt + H - 1) mod m, is NaN past
    that (what the copy leaves); thread t of row rl computes outputs
    tR + r, r < R, from window slots tR + r + j; those < cnt are stored.
    Returns ca, cd and how often each output was written."""
    nrows, n = x.shape
    g = rows_geo(nrows, n, taps.shape[1], R, threads)
    m, H, seg, rows = g["m"], g["H"], g["seg"], g["rows"]
    k = torch.arange(g["items"])
    row0, i0 = (k // g["tiles"]) * rows, (k % g["tiles"]) * seg
    cnt = torch.clamp(m - i0, max=seg)
    rl = torch.arange(rows)
    t = torch.arange(g["tpr"])
    out = (t[:, None] * R + torch.arange(R)).reshape(-1)        # slot order
    busy = (t * R)[:, None].expand(-1, R).reshape(-1)           # thread's tR
    row = row0[:, None] + rl                                    # (k, rows)
    slot = out[:, None] + torch.arange(H)                       # (tpr R, H)
    pair = (i0[:, None, None] + slot) % m                       # (k, ., H)
    staged = slot < (cnt + H - 1)[:, None, None]
    xr = x.double()[torch.clamp(row, max=nrows - 1)]            # (k, rows, n)
    e = xr[:, :, 0::2].gather(-1, pair.reshape(len(k), 1, -1).expand(
        -1, rows, -1)).reshape(len(k), rows, len(out), H)
    o = xr[:, :, 1::2].gather(-1, pair.reshape(len(k), 1, -1).expand(
        -1, rows, -1)).reshape(len(k), rows, len(out), H)
    nan = torch.tensor(float("nan"), dtype=torch.float64)
    e = torch.where(staged[:, None], e, nan)
    o = torch.where(staged[:, None], o, nan)
    a, d = _sums(_taps4(taps), e, o)                            # (k, rows, .)
    keep = ((row < nrows)[:, :, None] & (busy < cnt[:, None])[:, None]
            & (out < cnt[:, None])[:, None])
    kk, rr, oo = keep.nonzero(as_tuple=True)
    ca = torch.full((nrows, m), float("nan"), dtype=torch.float64)
    cd = ca.clone()
    hits = torch.zeros((nrows, m), dtype=torch.int64)
    ri, ii = row[kk, rr], i0[kk] + out[oo]
    ca[ri, ii] = a[kk, rr, oo]
    cd[ri, ii] = d[kk, rr, oo]
    hits.index_put_((ri, ii), torch.ones_like(ri), accumulate=True)
    return ca, cd, hits


def emulate_cols(x, taps, R=0, threads=0):
    """The axis -2 kernel on x (B, n, S), float64, all items at once: item
    (b, ti, ts) holds output rows i0 .. i0 + cnt - 1 of columns s0 .. s0 +
    31 (columns past S copied as 0); its window of pair rows is NaN past
    cnt + H - 1; lane c of warp w computes rows wR + r of column s0 + c."""
    B, n, S = x.shape
    g = cols_geo(B, n, S, taps.shape[1], R, threads)
    m, H, TI, R = g["m"], g["H"], g["TI"], g["R"]
    k = torch.arange(g["items"])
    ts, rest = k % g["tiles_s"], k // g["tiles_s"]
    ti, b = rest % g["tiles_i"], rest // g["tiles_i"]
    s0, i0 = ts * TS, ti * TI
    cnt = torch.clamp(m - i0, max=TI)
    w = torch.arange(g["warps"])
    out = (w[:, None] * R + torch.arange(R)).reshape(-1)
    busy = (w * R)[:, None].expand(-1, R).reshape(-1)
    slot = out[:, None] + torch.arange(H)                       # (TI, H)
    pair = (i0[:, None, None] + slot) % m                       # (k, TI, H)
    staged = slot < (cnt + H - 1)[:, None, None]
    xp = torch.nn.functional.pad(x.double(), (0, g["tiles_s"] * TS - S))
    col = s0[:, None] + torch.arange(TS)                        # (k, 32)
    bb = b[:, None, None, None]
    nan = torch.tensor(float("nan"), dtype=torch.float64)
    e = torch.where(staged[..., None],
                    xp[bb, 2 * pair[..., None], col[:, None, None]], nan)
    o = torch.where(staged[..., None],
                    xp[bb, 2 * pair[..., None] + 1, col[:, None, None]], nan)
    a, d = _sums(_taps4(taps), e.transpose(-1, -2), o.transpose(-1, -2))
    keep = ((busy < cnt[:, None]) & (out < cnt[:, None]))[:, :, None] & (
        col < S)[:, None]                                       # (k, TI, 32)
    kk, oo, cc = keep.nonzero(as_tuple=True)
    ca = torch.full((B, m, S), float("nan"), dtype=torch.float64)
    cd = ca.clone()
    hits = torch.zeros((B, m, S), dtype=torch.int64)
    idx = (b[kk], i0[kk] + out[oo], col[kk, cc])
    ca[idx] = a[kk, oo, cc]
    cd[idx] = d[kk, oo, cc]
    hits.index_put_(idx, torch.ones_like(kk), accumulate=True)
    return ca, cd, hits


def _check(ca, cd, hits, ref):
    assert bool((hits == 1).all()), "an output written 0 or 2 times"
    scale = max(float(r.abs().max()) for r in ref)
    for got, want in zip((ca, cd), ref):
        assert not torch.isnan(got).any()
        err = float((got - want.double()).abs().max())
        assert err <= TOL * scale, err / scale


@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("name", WAVELETS)
def test_rows_emulation_matches_plain(name, n):
    rng = np.random.default_rng(n)
    nrows = 3 if n >= 1344 else 37
    x = torch.from_numpy(rng.standard_normal((nrows, n)).astype(np.float32))
    taps = P.filter_taps(name, "cpu")
    ref = K.dwt_analysis_plain(x, taps, -1)
    _check(*emulate_rows(x, taps), ref)


@pytest.mark.parametrize("S", (1, 31, 33, 42))
@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("name", ("haar", "db9", "coif17"))
def test_cols_emulation_matches_plain(name, n, S):
    rng = np.random.default_rng(n * 100 + S)
    B = 1 if n >= 1344 else 2
    x = torch.from_numpy(rng.standard_normal((B, n, S)).astype(np.float32))
    taps = P.filter_taps(name, "cpu")
    ref = K.dwt_analysis_plain(x, taps, -2)
    _check(*emulate_cols(x, taps), ref)


@pytest.mark.parametrize("R,threads", [(4, 128), (16, 256), (8, 64)])
@pytest.mark.parametrize("name", ("db3", "coif15"))
def test_other_knobs_keep_the_index_maps(name, R, threads):
    """The knobs scripts/dwt_bench.py --sweep times: R outputs a thread and
    the most threads a block, on both axes (a row past one tile)."""
    rng = np.random.default_rng(R + threads)
    taps = P.filter_taps(name, "cpu")
    x = torch.from_numpy(rng.standard_normal((5, 2 * 1100)).astype(np.float32))
    _check(*emulate_rows(x, taps, R, threads),
           K.dwt_analysis_plain(x, taps, -1))
    x = torch.from_numpy(rng.standard_normal((2, 300, 40)).astype(np.float32))
    _check(*emulate_cols(x, taps, R, threads),
           K.dwt_analysis_plain(x, taps, -2))


def test_destripe_levels_fit_the_card():
    """Every level shape of the destripe CLI's batch (8, 2688, 2688) and of
    the 1600 x 2000 tiles' (8, 2304, 2688), at every filter length the tests
    name: shared memory within a block's 227 KB, at most 512 threads."""
    for L in (2, 6, 18, 68, 90, 102):
        for h, w in ((2688, 2688), (2304, 2688)):
            for lv in range(7):
                hh, ww = h >> lv, w >> lv
                r = rows_geo(8 * hh, ww, L)
                c = cols_geo(8, hh, ww // 2, L)
                for g in (r, c):
                    assert g["smem"] <= SMEM_LIMIT and g["threads"] <= 512


# -- the header on the host ------------------------------------------------------

# (axis, B, n, S, L, R, threads, aligned): every filter length; the CLI's
# first and last level; a row past one tile; rows shorter than the filter;
# ragged widths; 4-byte staging; the knobs the sweep times
HOST_CASES = [
    (-1, 3, 2688, 1, 18, 8, 0, 1), (-1, 3, 2688, 1, 6, 8, 0, 0),
    (-1, 5, 2688, 1, 90, 8, 0, 1), (-1, 9, 42, 1, 102, 8, 0, 1),
    (-1, 7, 84, 1, 2, 8, 0, 1), (-1, 6, 16, 1, 18, 8, 0, 1),
    (-1, 4, 2, 1, 68, 8, 0, 1), (-1, 3, 10004, 1, 90, 8, 128, 1),
    (-1, 4, 336, 1, 68, 16, 256, 1), (-1, 4, 336, 1, 6, 4, 128, 0),
    (-2, 2, 2688, 42, 18, 8, 0, 1), (-2, 2, 2688, 64, 90, 8, 0, 1),
    (-2, 2, 336, 33, 6, 8, 0, 0), (-2, 3, 16, 31, 18, 8, 0, 1),
    (-2, 2, 42, 21, 102, 8, 0, 1), (-2, 2, 2, 1, 2, 8, 0, 1),
    (-2, 2, 1344, 40, 68, 16, 256, 1), (-2, 2, 600, 36, 90, 4, 128, 1),
]


@pytest.fixture(scope="module")
def host_check(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    exe = tmp_path_factory.mktemp("dwt_host") / "check"
    subprocess.run(
        [gxx, "-std=c++17", "-O2", "-I",
         str(ROOT / "tests" / "torch_dft_fft_host"), "-I",
         str(ROOT / "ipp_tpu_torch" / "csrc"),
         str(ROOT / "tests" / "torch_dwt_host" / "check.cpp"), "-o",
         str(exe)], check=True, capture_output=True)
    return exe


def test_header_on_the_host_matches_float64(host_check):
    args = []
    for case in HOST_CASES:
        args += [str(v) for v in case] + ["/"]
    out = subprocess.run([str(host_check), *args[:-1]], capture_output=True,
                         text=True)
    assert out.returncode == 0, out.stdout + out.stderr
    lines = out.stdout.splitlines()
    assert len(lines) == len(HOST_CASES)
    for (axis, B, n, S, L, R, threads, _), line in zip(HOST_CASES, lines):
        # the header's geometry is the one the emulation above mirrors
        if axis == -1:
            g = rows_geo(B, n, L, R, threads)
            want = (f"rows tpr {g['tpr']} seg {g['seg']} tiles {g['tiles']} "
                    f"rows {g['rows']} threads {g['threads']} smem "
                    f"{g['smem']}")
        else:
            g = cols_geo(B, n, S, L, R, threads)
            want = (f"cols TI {g['TI']} warps {g['warps']} tiles_i "
                    f"{g['tiles_i']} tiles_s {g['tiles_s']} threads "
                    f"{g['threads']} smem {g['smem']}")
        assert want in line, (want, line)
        assert f"items {g['items']};" in line, line
