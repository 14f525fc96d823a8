"""The port's NCC alignment (ops/ncc.py, stitch/align.py) against the JAX
package's, on JAX-CPU, with the same numpy-seeded inputs.

compute_mips equal; ncc_maps_batched within 1e-4 absolute (its f32 prefix
sums and FFT sum in another order than XLA's) at a small shape and at the
production MIP shape (12, 150, 1024) with search radius 20;
peak_and_widths and fuse_axis (host code, copied) equal on the same maps;
align_pairs_batched and align_pair displacements and widths equal, peaks
within 1e-4; compute_displacements on a 2 x 2 grid with known jitter:
candidates equal, reliabilities within 1e-4, and the placement the
reference's host code solves from them equal to the truth."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ipp_tpu.geometry.stacks import TileGrid as JGrid
from ipp_tpu.ops import ncc as JN
from ipp_tpu.stitch import align as JA
from ipp_tpu.stitch import place as JPL
from ipp_tpu_torch.geometry.stacks import TileGrid as PGrid
from ipp_tpu_torch.ops import ncc as PN
from ipp_tpu_torch.stitch import align as PA
from ipp_tpu_torch.stitch import place as PPL
from tests.synth import cut_tiles, make_phantom, write_tile_grid

CPU = torch.device("cpu")
OV = 40   # the pairs' nominal overlap (the search needs 25 + radius)


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("IPP_TPU_PLATFORM", "cpu")


def _pairs(rng, n, shape, shift, side):
    """n pairs of (D, V, H) volumes cut from one phantom, B displaced from
    A's nominal neighbour position (an overlap of OV) by `shift`
    (dv, dh, dd), plus 0..1 in y and x.  (The z search is clamped to 0
    below 25 planes of overlap depth, as in the reference.)"""
    D, V, H = shape
    vol = make_phantom(rng, (D + 8, 2 * V + 16, 2 * H + 16), smooth=8.0)
    a, b, truth = [], [], []
    for i in range(n):
        dv, dh, dd = shift[0] + i % 2, shift[1] + i % 2, shift[2]
        a.append(vol[2:2 + D, 4:4 + V, 4:4 + H])
        if side == "ns":
            y0, x0 = 4 + V - OV + dv, 4 + dh
        else:
            y0, x0 = 4 + dv, 4 + H - OV + dh
        b.append(vol[2 + dd:2 + dd + D, y0:y0 + V, x0:x0 + H])
        truth.append((dv, dh, dd))
    return np.stack(a), np.stack(b), truth


def test_compute_mips_equal(rng):
    v = rng.integers(0, 65535, (3, 7, 11, 13)).astype(np.float32)
    for got, ref in zip(PN.compute_mips(torch.from_numpy(v)),
                        JN.compute_mips(jnp.asarray(v))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("shape,du,dv", [
    ((3, 20, 33), 5, 7), ((2, 64, 40), 12, 3), ((12, 150, 1024), 20, 20)])
def test_ncc_maps_batched_within_1e4(rng, shape, du, dv):
    m1 = (rng.random(shape) * 3000 + 200).astype(np.float32)
    m2 = np.roll(m1, (2, -3), axis=(1, 2)) + \
        rng.normal(0, 50, shape).astype(np.float32)
    ref = np.asarray(JN.ncc_maps_batched(jnp.asarray(m1), jnp.asarray(m2),
                                         du, dv))
    got = PN.ncc_maps_batched(torch.from_numpy(m1), torch.from_numpy(m2),
                              du, dv).numpy()
    assert got.shape == ref.shape == (shape[0], 2 * du + 1, 2 * dv + 1)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)
    # the same peak on every map
    assert [int(np.argmax(g)) for g in got] == [int(np.argmax(r))
                                                for r in ref]


def test_ncc_map_single_pair(rng):
    m1 = rng.random((30, 40)).astype(np.float32)
    m2 = np.roll(m1, 1, axis=0)
    np.testing.assert_allclose(PN.ncc_map(m1, m2, 4, 4, device=CPU),
                               JN.ncc_map(jnp.asarray(m1), jnp.asarray(m2),
                                          4, 4), rtol=0, atol=1e-4)


@pytest.mark.parametrize("seed", range(4))
def test_peak_widths_and_fusion_equal(seed):
    """The host code is a copy: equal results on the same maps."""
    rng = np.random.default_rng(seed)
    params_j, params_p = JN.NCCParams(), PN.NCCParams()
    du, dv, wu, wv = 6, 5, 6, 5
    yy, xx = np.mgrid[-du - wu:du + wu + 1, -dv - wv:dv + wv + 1]
    cy, cx = rng.integers(-3, 4, 2)
    m = np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / rng.uniform(2, 30)) \
        * rng.uniform(0.2, 1) + rng.normal(0, 0.02, yy.shape)
    for inf_w in (None, 12):
        assert PN.peak_and_widths(m, du, dv, wu, wv, params_p, inf_w) == \
            JN.peak_and_widths(m, du, dv, wu, wv, params_j, inf_w)
    for args in [(2, 0.5, 4, 3, 0.6, 5), (2, 0.05, 4, 9, 0.6, 5),
                 (1, 0.7, 1, 1, 0.8, 3), (0, 0.0, 13, 0, 0.0, 13)]:
        assert PN.fuse_axis(*args, params_p, 13) == \
            JN.fuse_axis(*args, params_j, 13)


@pytest.mark.parametrize("side,shift", [("ns", (1, -2, 0)), ("we", (-1, 2, 0))])
def test_align_pairs_batched_displacements_equal(side, shift):
    rng = np.random.default_rng(11)
    a, b, truth = _pairs(rng, 4, (10, 48, 56), shift, side)
    got = PN.align_pairs_batched(a, b, side, OV, 6, 6, 3, device=CPU)
    ref = JN.align_pairs_batched(a, b, side, OV, 6, 6, 3)
    for g, r in zip(got, ref):
        assert g.coord == r.coord
        assert g.ncc_width == r.ncc_width
        np.testing.assert_allclose(g.ncc_peak, r.ncc_peak, rtol=0, atol=1e-4)
    # and the displacement is the truth (the nominal offset included)
    nom = 48 - OV if side == "ns" else 56 - OV
    for g, (dv, dh, dd) in zip(got, truth):
        want = (dv + nom, dh, dd) if side == "ns" else (dv, dh + nom, dd)
        assert g.coord == want


def test_align_pair_equal():
    rng = np.random.default_rng(12)
    a, b, _ = _pairs(rng, 1, (10, 48, 56), (1, 1, 0), "we")
    g = PN.align_pair(a[0], b[0], "we", OV, 6, 6, 3, device=CPU)
    r = JN.align_pair(a[0], b[0], "we", OV, 6, 6, 3)
    assert g.coord == r.coord and g.ncc_width == r.ncc_width
    np.testing.assert_allclose(g.ncc_peak, r.ncc_peak, rtol=0, atol=1e-4)


def test_mesh_raises():
    a = np.zeros((1, 4, 30, 30), np.float32)
    with pytest.raises(TypeError, match="Mesh"):
        PN.align_pairs_batched(a, a, "ns", 10, 2, 2, 1, mesh=object())


@pytest.fixture(scope="module")
def grid_dir(tmp_path_factory):
    rng = np.random.default_rng(5)
    root = tmp_path_factory.mktemp("grid")
    vol = make_phantom(rng, (8, 200, 200), smooth=5.0)
    tiles, truth = cut_tiles(vol, 2, 2, (120, 120), 48, jitter=2,
                             rng=np.random.default_rng(7))
    write_tile_grid(root, tiles, overlap_nominal_px=48,
                    voxel_um=(1.0, 1.0, 1.0))
    return root, truth


def test_compute_displacements_equal(grid_dir):
    root, truth = grid_dir
    gp = PGrid.from_directory(root, voxel_um=(1.0, 1.0, 1.0))
    gj = JGrid.from_directory(root, voxel_um=(1.0, 1.0, 1.0))
    kw = dict(overlap_v=48, overlap_h=48, displ_max_v=6, displ_max_h=6,
              displ_max_d=1, subvol_dim=4)
    got = PA.compute_displacements(gp, device=CPU, **kw)
    ref = JA.compute_displacements(gj, **kw)
    assert sorted(got) == sorted(ref) and len(got) == 4
    for key in ref:
        assert len(got[key]) == len(ref[key]) == 2   # two z subvolumes
        for g, r in zip(got[key], ref[key]):
            assert (g.displ, g.default_displ, g.ncc_width, g.delay) == \
                (r.displ, r.default_displ, r.ncc_width, r.delay)
            np.testing.assert_allclose(g.reliability, r.reliability,
                                       rtol=0, atol=1e-4)
            np.testing.assert_allclose(g.ncc_peak, r.ncc_peak, rtol=0,
                                       atol=1e-4)
    # the placement steps (host code, copied) recover the known jitter
    for grid, cands, pl in ((gp, got, PPL), (gj, ref, JPL)):
        pl.project_displacements(grid, cands, 48, 48)
        pl.threshold_displacements(grid, 0.65)
        pl.place_tiles_mst(grid)
        x0, y0, _ = truth[0][0]
        for r in range(2):
            for c in range(2):
                s = grid.stacks[r][c]
                x, y, _ = truth[r][c]
                assert (s.abs_h, s.abs_v, s.abs_d) == (x - x0, y - y0, 0)
