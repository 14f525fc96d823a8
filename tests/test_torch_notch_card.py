"""K8, the destripe notch (ipp_tpu_torch/csrc/notch.cuh), on a CUDA card
(`gpu`; skipped without one).  No JAX here: the CPU twins are in
tests/test_torch_notch.py.

- The kernel against its plain version (torch.fft's rfft * g, irfft) at
  every level shape of the destripe chain's padded batches of 8 (2000 x
  2000 and 1600 x 2000 tiles), on both axes, and at lengths whose buffers
  live in the device-memory scratch, a large prime, odd line counts:
  within 1e-5 of the plain version's max (both f32), one launch a call.
- The long form K8l on both axes: the level-1 lines of wide stitched
  planes (33344 with Rader's rows of 521, 35328, 45312,
  65856), 65536, 131072 and 2^20, 2^20 - 1 (generic passes of 31 and 41),
  a prime on the chirp route (65537), within 1e-5 of max; three
  "notch_long" launches a call, six on the chirp route.
- A batch of 8 bit-equal to its 8 single tiles and a call to its repeat
  (cuFFT was not, at n = 672 and 21 along y); a batch of 4 wide subbands
  (33344 on both axes, 65537 along x, 2^20 - 1 on two lines) the same.
- The 14 notches of a padded decomposition of each tile shape in one
  `notch_filter_group` call: one launch, each output bit-equal to its
  one-subband call and within 1e-5 of its plain version; the 14 of a
  padded (2, 2688, 66688) plane: one launch and the long form's three
  for each of 33344 and 16672.
- `filter_coefficient` on a CUDA tensor with every torch.fft entry
  refused, at short and long lengths.

    python -m pytest -m gpu tests/test_torch_notch_card.py
"""

import numpy as np
import pytest
import torch

from ipp_tpu_torch.ops import cuda_notch as K
from ipp_tpu_torch.ops import destripe as P

TOL = 1e-5


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K8 has no CPU mode")
    return torch.device("cuda", 0)


def _notch(n):
    return P.notch(n // 2 + 1, n / 8.0)


def _rel(got, ref):
    """max |got - ref| over max |ref| (over 1 where ref is 0: n = 1, whose
    notch removes the line's one value)."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1.0))


def _level_shapes():
    """(shape, axis) of every notch the destripe chain runs on a batch of
    8 padded tiles: cH (8, h, w) along x, cV along y, h = H >> level."""
    out = []
    for H, W in ((2688, 2688), (2304, 2688)):
        for lv in range(1, 8):
            out += [((8, H >> lv, W >> lv), -1), ((8, H >> lv, W >> lv), -2)]
    return out


def _want(shape, axis):
    """The launches of one `notch_filter` call: the shared-memory kernel,
    or the long form where a line pair's buffers do not fit."""
    long = K.notch_is_long(shape, axis)
    return {"notch": int(not long),
            "notch_long": K.notch_long_launches(shape[axis]) if long else 0}


# lines past 32768: (2, 2688, 33344) is level 1 of two padded 2048 x 66000
# planes, (2, 33344, 2688) of two 66000 x 2048; 35328, 45312 and 65856 of
# 20000 x 70000, 24000 x 90000 and 12000 x 131000; 65537 on the chirp
# route; 2^20 - 1 split 1023 x 1025
LONG_SHAPES = [((2, 2688, 33344), -1), ((2, 33344, 2688), -2),
               ((1, 3, 35328), -1), ((1, 45312, 3), -2),
               ((1, 2, 65536), -1), ((1, 65536, 3), -2),
               ((1, 3, 65537), -1), ((2, 65537, 2), -2),
               ((1, 3, 65856), -1), ((1, 131072, 2), -2),
               ((1, 2, 131072), -1), ((1, 2, 1 << 20), -1),
               ((1, 1 << 20, 2), -2), ((1, 3, (1 << 20) - 1), -1),
               ((1, (1 << 20) - 1, 2), -2), ((1, 2, 32512), -1),
               ((1, 32128, 4), -2), ((1, 3, 34023), -1), ((1, 2, 13674), -1)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape,axis", _level_shapes() + [
    ((2, 16, 14000), -1), ((2, 14600, 6), -2), ((1, 3, 32749), -1),
    ((1, 2, 30000), -1), ((3, 97, 37), -2), ((5, 7, 1), -1)] + LONG_SHAPES)
def test_kernel_matches_plain_on_the_card(cuda, shape, axis):
    rng = np.random.default_rng(sum(shape) - axis)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(
        cuda)
    g = _notch(shape[axis])
    K.reset_launch_counts()
    got = K.notch_filter(x, g, axis)
    assert K.LAUNCHES == _want(shape, axis)
    ref = K.notch_filter_plain(x, g, axis)
    torch.cuda.synchronize()
    assert _rel(got.cpu().numpy(), ref.cpu().numpy()) <= TOL


@pytest.mark.gpu
@pytest.mark.parametrize("n,axis", [(672, -2), (21, -2), (1344, -1),
                                    (576, -2), (23, -1)])
def test_kernel_batch_equals_single_tiles_on_the_card(cuda, n, axis):
    """Each line pair is two lines of one tile, in an order fixed by n: a
    batch of 8 gives its 8 single tiles bit for bit, and a call its
    repeat (cuFFT did not at n = 672 and 21 along y)."""
    rng = np.random.default_rng(n)
    shape = (8, 333, n) if axis == -1 else (8, n, 333)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(
        cuda)
    g = _notch(n)
    got = K.notch_filter(x, g, axis)
    assert torch.equal(got, K.notch_filter(x, g, axis))
    for i in range(8):
        assert torch.equal(got[i:i + 1], K.notch_filter(x[i:i + 1], g, axis))


@pytest.mark.gpu
@pytest.mark.parametrize("shape,axis", [((4, 64, 33344), -1),
                                        ((4, 33344, 64), -2),
                                        ((4, 4, 65537), -1),
                                        ((4, 3, 35328), -1),
                                        ((2, 2, (1 << 20) - 1), -1)])
def test_long_batch_equals_single_tiles_on_the_card(cuda, shape, axis):
    """The long form (three kernels over device memory, many blocks a
    line pair, y as the storage between them where every pair has both
    lines, else a scratch of the subband's size) and the chirp route: a
    batch of 4 gives its single tiles bit for bit, a call its repeat."""
    rng = np.random.default_rng(shape[axis])
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(
        cuda)
    g = _notch(shape[axis])
    K.reset_launch_counts()
    got = K.notch_filter(x, g, axis)
    assert K.LAUNCHES == {"notch": 0,
                          "notch_long": K.notch_long_launches(shape[axis])}
    assert torch.equal(got, K.notch_filter(x, g, axis))
    for i in range(shape[0]):
        assert torch.equal(got[i:i + 1], K.notch_filter(x[i:i + 1], g, axis))


@pytest.mark.gpu
def test_wide_plane_group_equals_one_subband_calls_on_the_card(cuda):
    """cH along x and cV along y of levels 1-7 of two padded 2048 x 66000
    planes (2, 2688, 66688), as filter_subband notches them: one launch
    for the 12 whose buffers fit shared memory, three each for 33344 and
    16672 along x (the long form, 521 on Rader's rows);
    each bit-equal to its one-subband call and within 1e-5 of its plain
    version."""
    rng = np.random.default_rng(66688)
    xs, gs, axes = [], [], []
    for lv in range(1, 8):
        for axis in (-1, -2):
            shape = (2, 2688 >> lv, 66688 >> lv)
            xs.append(torch.from_numpy(rng.standard_normal(shape).astype(
                np.float32)).to(cuda))
            gs.append(_notch(shape[axis]))
            axes.append(axis)
    K.reset_launch_counts()
    got = K.notch_filter_group(xs, gs, axes)
    assert K.LAUNCHES == {"notch": 1, "notch_long": 6}
    for y, x, g, a in zip(got, xs, gs, axes):
        assert torch.equal(y, K.notch_filter(x, g, a))
        ref = K.notch_filter_plain(x, g, a)
        assert _rel(y.cpu().numpy(), ref.cpu().numpy()) <= TOL


@pytest.mark.gpu
@pytest.mark.parametrize("H,W", [(2688, 2688), (2304, 2688)])
def test_group_equals_one_subband_calls_on_the_card(cuda, H, W):
    """cH along x and cV along y of levels 1-7 of a padded batch of 8 in
    one launch, each bit-equal to its own call: the arithmetic of a line
    pair depends on n alone, never on the group."""
    rng = np.random.default_rng(H)
    xs, gs, axes = [], [], []
    for lv in range(1, 8):
        for axis in (-1, -2):
            shape = (8, H >> lv, W >> lv)
            xs.append(torch.from_numpy(rng.standard_normal(shape).astype(
                np.float32)).to(cuda))
            gs.append(_notch(shape[axis]))
            axes.append(axis)
    K.reset_launch_counts()
    got = K.notch_filter_group(xs, gs, axes)
    assert K.LAUNCHES == {"notch": 1, "notch_long": 0}
    for y, x, g, a in zip(got, xs, gs, axes):
        assert torch.equal(y, K.notch_filter(x, g, a))
        ref = K.notch_filter_plain(x, g, a)
        assert _rel(y.cpu().numpy(), ref.cpu().numpy()) <= TOL


@pytest.mark.gpu
def test_filter_coefficient_calls_no_torch_fft_on_the_card(cuda,
                                                           monkeypatch):
    def refused(*a, **k):
        raise AssertionError("torch.fft ran on the card")

    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (4, 84, 168)).astype(np.float32)).to(cuda)
    for name in ("rfft", "irfft", "fft", "ifft"):
        monkeypatch.setattr(torch.fft, name, refused)
    K.reset_launch_counts()
    for axis in (-1, -2):
        y = P.filter_coefficient(x, 0.3, axis=axis)
        assert y.shape == x.shape and bool(torch.isfinite(y).all())
    assert K.LAUNCHES == {"notch": 2, "notch_long": 0}
    y = P.filter_subband(x, 40.0, 2, "db3", axes=(-1, -2))
    assert y.shape == x.shape and bool(torch.isfinite(y).all())
    assert K.LAUNCHES == {"notch": 3, "notch_long": 0}   # the four notches
    # the long form on both routes: 33344 (mixed, 3 launches), 65537
    # (chirp, 6)
    for n in (33344, 65537):
        for shape, axis in (((2, 4, n), -1), ((2, n, 4), -2)):
            xl = torch.from_numpy(np.random.default_rng(n).standard_normal(
                shape).astype(np.float32)).to(cuda)
            y = P.filter_coefficient(xl, 0.3, axis=axis)
            assert y.shape == xl.shape and bool(torch.isfinite(y).all())
    assert K.LAUNCHES == {"notch": 3, "notch_long": 18}
