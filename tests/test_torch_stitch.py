"""The port's blend, merge and isotropic downsample (stitch/blend.py,
stitch/merge.py, ops/resample.py) against the JAX package's, on JAX-CPU,
with the same numpy-seeded tile grid placed at its known jitter.

distance_from_edge / cosine_blend_weight bit-equal (copied numpy);
PlaneBlender (cosine and max, batched and per plane) within 1 count on
u16; plan_isotropic_downsampling equal; isotropic_downsample_plane and
IsotropicAccumulator within 1e-5 of the max; merge_to_tif_series: the
same files and names, planes within 1 count, the downsample within 1e-4
of its max; downsampled_npz within 1e-4 of the max; a series half written
by one package resumes under the other; make_diag_stack equal."""

import os

import numpy as np
import pytest
import torch

from ipp_tpu.geometry.extent import VExtent as JExt
from ipp_tpu.geometry.stacks import TileGrid as JGrid
from ipp_tpu.io import tiff as tio
from ipp_tpu.ops import resample as JR
from ipp_tpu.stitch import blend as JB
from ipp_tpu.stitch import merge as JM
from ipp_tpu_torch.geometry.extent import VExtent as PExt
from ipp_tpu_torch.geometry.stacks import TileGrid as PGrid
from ipp_tpu_torch.ops import resample as PR
from ipp_tpu_torch.stitch import blend as PB
from ipp_tpu_torch.stitch import merge as PM
from tests.synth import cut_tiles, make_phantom, write_tile_grid

CPU = torch.device("cpu")
VOX = (0.41, 0.41, 0.8)


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("IPP_TPU_PLATFORM", "cpu")
    monkeypatch.setenv("IPP_TPU_PROGRESS", "off")


@pytest.fixture(scope="module")
def grids(tmp_path_factory):
    """A 2 x 3 grid of 9-plane u16 stacks placed at their true offsets,
    one stack 2 planes deeper (a z-staggered layout for the per-plane
    fallback); the JAX grid and the port's read from one placement XML."""
    root = tmp_path_factory.mktemp("tiles")
    rng = np.random.default_rng(3)
    vol = make_phantom(rng, (9, 160, 220), smooth=4.0)
    tiles, truth = cut_tiles(vol, 2, 3, (90, 90), 26, jitter=3,
                             rng=np.random.default_rng(4))
    tiles[1][2] = np.concatenate([tiles[1][2], tiles[1][2][:2]])
    grid = write_tile_grid(root, tiles, overlap_nominal_px=26, voxel_um=VOX)
    for r in range(2):
        for c in range(3):
            s = grid.stacks[r][c]
            s.abs_h, s.abs_v, _ = truth[r][c]
            s.abs_d = 1 if (r, c) == (1, 2) else 0
    xml = root / "placement.xml"
    grid.to_xml(xml)
    return JGrid.from_xml(xml), PGrid.from_xml(xml), root


def _ext(cls, e):
    return cls(e.x0, e.x1, e.y0, e.y1, e.z0, e.z1)


def _close(got, ref, count=1):
    assert got.dtype == ref.dtype and got.shape == ref.shape
    assert np.abs(got.astype(np.int64) - ref.astype(np.int64)).max() <= count


def test_blend_weights_bit_equal(grids):
    gj, gp, _ = grids
    ej = [s.extent for s in gj.flattened()]
    ep = [s.extent for s in gp.flattened()]
    vol_j, vol_p = gj.volume, gp.volume
    for i in range(len(ej)):
        inter_j = ej[i].intersection(vol_j)
        inter_p = ep[i].intersection(vol_p)
        others_j = [e.intersection(vol_j) for k, e in enumerate(ej) if k != i]
        others_p = [e.intersection(vol_p) for k, e in enumerate(ep) if k != i]
        w_j = JB.cosine_blend_weight(inter_j, ej[i], others_j)
        w_p = PB.cosine_blend_weight(inter_p, ep[i], others_p)
        assert w_p.dtype == w_j.dtype and np.array_equal(w_p, w_j)
        for k in range(len(ej)):
            if k != i and ej[i].intersects(ej[k]):
                iv_j = ej[i].intersection(ej[k])
                iv_p = ep[i].intersection(ep[k])
                assert np.array_equal(
                    PB.distance_from_edge(iv_p, ep[i], ep[k]),
                    JB.distance_from_edge(iv_j, ej[i], ej[k]))


@pytest.mark.parametrize("cosine", [True, False])
@pytest.mark.parametrize("dtype", [np.uint16, np.float32])
def test_plane_blender_within_one_count(grids, cosine, dtype):
    gj, gp, _ = grids
    sj, sp = gj.flattened(), gp.flattened()
    bj = JB.PlaneBlender([s.extent for s in sj], cosine=cosine)
    bp = PB.PlaneBlender([s.extent for s in sp], cosine=cosine, device=CPU)
    v = gj.volume
    batch = JExt(v.x0, v.x1, v.y0, v.y1, 2, 6)
    ref = bj.blend_planes(batch, lambda i, e: sj[i].imread(e), dtype=dtype)
    got = bp.blend_planes(_ext(PExt, batch), lambda i, e: sp[i].imread(e),
                          dtype=dtype)
    fin = bp.blend_planes_async(_ext(PExt, batch),
                                lambda i, e: sp[i].imread(e), dtype=dtype)()
    if dtype == np.uint16:
        _close(got, ref)
    else:
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=1e-5 * float(ref.max()))
    np.testing.assert_array_equal(fin, got)
    plane = JExt(v.x0, v.x1, v.y0, v.y1, 3, 4)
    one = bp.blend_plane(_ext(PExt, plane), lambda i, e: sp[i].imread(e),
                         dtype=dtype)
    np.testing.assert_array_equal(one, got[1])
    ref1 = bj.blend_plane(plane, lambda i, e: sj[i].imread(e), dtype=dtype)
    assert one.dtype == ref1.dtype and one.shape == ref1.shape
    # the z-staggered layout is refused by the batched path in both
    stag = JExt(v.x0, v.x1, v.y0, v.y1, 0, 4)
    assert bp.weights_for_batch(_ext(PExt, stag)) is None
    assert bj.weights_for_batch(stag) is None


@pytest.mark.parametrize("shape,vox,target", [
    ((100, 200), (0.41, 0.41), 4.0), ((301, 97), (1.8, 0.62), 10.0),
    ((64, 64), (2.0, 2.0), 2.0)])
def test_plan_isotropic_downsampling_equal(shape, vox, target):
    assert PR.plan_isotropic_downsampling(shape, vox, target) == \
        JR.plan_isotropic_downsampling(shape, vox, target)


@pytest.mark.parametrize("shape,vox,target", [
    ((100, 200), (0.41, 0.41), 4.0), ((301, 97), (1.8, 0.62), 10.0)])
def test_isotropic_downsample_plane_within_1e5(rng, shape, vox, target):
    img = rng.integers(0, 40000, shape).astype(np.uint16)
    t, m = JR.plan_isotropic_downsampling(shape, vox, target)
    ref = np.asarray(JR.isotropic_downsample_plane(img, t, m))
    got = PR.isotropic_downsample_plane(img, t, m, device=CPU).numpy()
    assert got.shape == ref.shape == tuple(t)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * ref.max())


@pytest.mark.parametrize("alternating", [True, False])
def test_isotropic_accumulator_within_1e5(rng, alternating):
    kw = dict(plane_shape=(90, 120), voxel_zyx=(0.5, 0.41, 0.41),
              target_voxel=2.5, alternating=alternating)
    aj = JR.IsotropicAccumulator(**kw)
    ap = PR.IsotropicAccumulator(**kw, device=CPU)
    for z in range(13):
        p = (rng.integers(0, 30000, (90, 120)) if z != 4
             else np.full((90, 120), 7)).astype(np.uint16)
        rj, rp = aj.add(p), ap.add(p)
        assert (rj is None) == (rp is None)
    aj.flush(), ap.flush()
    vj, vp = aj.volume(), ap.volume()
    assert vp.shape == vj.shape and vp.dtype == vj.dtype
    np.testing.assert_allclose(vp, vj, rtol=0, atol=1e-5 * vj.max())


def _merge(mod, grid, out, **kw):
    return mod.merge_to_tif_series(grid, out, cosine_blending=True,
                                   target_voxel_um=2.0, io_threads=2, **kw)


@pytest.fixture(scope="module")
def merged(grids, tmp_path_factory):
    gj, gp, _ = grids
    root = tmp_path_factory.mktemp("merged")
    out_j, ds_j = _merge(JM, gj, root / "jax")
    out_p, ds_p = _merge(PM, gp, root / "port", plane_batch=4, device=CPU)
    return root, (out_j, ds_j), (out_p, ds_p)


def test_merge_to_tif_series_within_one_count(merged, grids):
    _, (out_j, ds_j), (out_p, ds_p) = merged
    names = sorted(p.name for p in out_j.glob("*.tif"))
    assert names == sorted(p.name for p in out_p.glob("*.tif"))
    v = grids[0].volume
    assert len(names) == v.z1 - v.z0
    for n in names:
        _close(tio.imread(out_p / n), tio.imread(out_j / n))
    assert ds_p.shape == ds_j.shape and ds_p.dtype == ds_j.dtype
    np.testing.assert_allclose(ds_p, ds_j, rtol=0, atol=1e-4 * ds_j.max())


def test_downsampled_npz_within_1e4(merged, grids):
    root, (_, ds_j), _ = merged
    v = grids[0].volume
    full = (v.z1 - v.z0, v.y1 - v.y0, v.x1 - v.x0)
    args = ((VOX[2], VOX[0], VOX[1]), full, 2.0)
    JM.downsampled_npz(ds_j, root / "j.npz", *args)
    PM.downsampled_npz(ds_j, root / "p.npz", *args, device=CPU)
    a = np.load(root / "p.npz", allow_pickle=True)
    b = np.load(root / "j.npz", allow_pickle=True)
    assert a["I"].shape == b["I"].shape and a["I"].dtype == b["I"].dtype
    np.testing.assert_allclose(a["I"], b["I"], rtol=0,
                               atol=1e-4 * b["I"].max())
    for xa, xb in zip(a["xI"], b["xI"]):
        np.testing.assert_array_equal(xa, xb)


@pytest.mark.parametrize("first,second", [("jax", "port"), ("port", "jax")])
def test_half_written_series_resumes_under_the_other(merged, grids,
                                                     tmp_path, first,
                                                     second):
    """The planes one package wrote stay untouched; the other writes the
    missing ones, each within 1 count of the first package's."""
    root, (out_j, _), (out_p, _) = merged
    src = out_j if first == "jax" else out_p
    names = sorted(p.name for p in src.glob("*.tif"))
    out = tmp_path / "series"
    out.mkdir()
    for n in names[:5]:
        (out / n).write_bytes((src / n).read_bytes())
        os.utime(out / n, (1, 1))
    gj, gp, _ = grids
    if second == "jax":
        JM.merge_to_tif_series(gj, out, resume=True, io_threads=2)
    else:
        PM.merge_to_tif_series(gp, out, resume=True, io_threads=2,
                               plane_batch=4, device=CPU)
    assert sorted(p.name for p in out.glob("*.tif")) == names
    for n in names:
        if n in names[:5]:
            assert os.stat(out / n).st_mtime == 1
        _close(tio.imread(out / n), tio.imread(src / n))


def test_make_diag_stack_equal(grids, tmp_path):
    gj, gp, _ = grids
    JM.make_diag_stack(gj, tmp_path / "j", mipmap_level=1)
    PM.make_diag_stack(gp, tmp_path / "p", mipmap_level=1)
    names = sorted(p.name for p in (tmp_path / "j").glob("*.tif"))
    assert names == sorted(p.name for p in (tmp_path / "p").glob("*.tif"))
    for n in names:
        np.testing.assert_array_equal(tio.imread(tmp_path / "p" / n),
                                      tio.imread(tmp_path / "j" / n))


def test_merge_mesh_raises(grids, tmp_path):
    with pytest.raises(TypeError, match="Mesh"):
        PM.merge_to_tif_series(grids[1], tmp_path, mesh=object())
