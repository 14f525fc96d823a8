"""The port's pipelines on a device mesh against its single-device runs and
the JAX package's mesh runs.

The port's mesh is a list of CPU entries (`make_mesh(devices=["cpu"] *
n)`); the JAX twin runs on conftest's virtual CPU devices.  The
deconvolution CLI on a 4-entry mesh writes the single-device run's u16
planes byte for byte, and stays within 1e-3 of full scale of JAX's
`mesh=make_mesh(4)`; step 2's displacements, the merge and a whole
`process_channel` (preprocess, NCC, merge with its device
post-processing) on a 2-entry mesh equal the single-device port and JAX's
mesh run within their twins' tolerances; `pystripe_cli` and `tsv_tools`
with `parallel.mesh.default_mesh` returning a 2-entry mesh write the
single-device run's files byte for byte."""

import shutil
import warnings

import numpy as np
import pytest

from ipp_tpu.geometry.stacks import TileGrid as JGrid
from ipp_tpu.io import tiff as tio
from ipp_tpu.ops import deconv as dj
from ipp_tpu.ops.process import ProcessConfig as JCfg
from ipp_tpu.ops.psf import gaussian_psf
from ipp_tpu.parallel import mesh as mj
from ipp_tpu.pipeline import deconvolve as JD
from ipp_tpu.pipeline import process_images as JPI
from ipp_tpu.stitch import align as JA
from ipp_tpu.stitch import merge as JM
from ipp_tpu_torch.geometry.stacks import TileGrid as PGrid
from ipp_tpu_torch.ops.process import ProcessConfig as PCfg
from ipp_tpu_torch.parallel import mesh as mp
from ipp_tpu_torch.pipeline import deconvolve as PD
from ipp_tpu_torch.pipeline import process_images as PPI
from ipp_tpu_torch.pipeline import pystripe_cli as PS
from ipp_tpu_torch.pipeline import tsv_tools as PT
from ipp_tpu_torch.stitch import align as PA
from ipp_tpu_torch.stitch import merge as PM
from tests.synth import cut_tiles, make_phantom, write_tile_grid

CH = "Ex_488_Em_525"
VOX = (0.41, 0.41, 0.8)


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setattr(dj, "_RESOLVED_FFT", "xla")
    monkeypatch.setenv("IPP_TPU_PLATFORM", "cpu")
    monkeypatch.setenv("IPP_TPU_PROGRESS", "off")


def _mesh(n):
    return mp.make_mesh(devices=["cpu"] * n)


def _read(d, pattern="*.tif"):
    return {p.name: tio.imread(p) for p in sorted(d.glob(pattern))}


def _same_bytes(a_dir, b_dir):
    names = sorted(p.relative_to(b_dir) for p in b_dir.rglob("*.tif"))
    assert names
    assert sorted(p.relative_to(a_dir) for p in a_dir.rglob("*.tif")) == names
    for n in names:
        assert (a_dir / n).read_bytes() == (b_dir / n).read_bytes(), n


def _within(a, b, count):
    assert a.keys() == b.keys() and a
    for n in a:
        assert a[n].dtype == b[n].dtype and a[n].shape == b[n].shape
        diff = np.abs(a[n].astype(np.int64) - b[n].astype(np.int64)).max()
        assert diff <= count, (n, diff)


DECON_KW = dict(niter=2, max_block_elems=32 ** 3)


def _decon_series(src):
    """A (16, 40, 56) u16 bead series (six or more blocks at DECON_KW)."""
    from scipy.ndimage import gaussian_filter

    rng = np.random.default_rng(11)
    shape = (16, 40, 56)
    truth = np.full(shape, 100.0)
    idx = tuple(rng.integers(0, s, 40) for s in shape)
    truth[idx] += rng.uniform(20000, 40000, 40)
    vol = rng.poisson(gaussian_filter(truth, 1.2)).clip(0, 65535)
    src.mkdir()
    for z, plane in enumerate(vol.astype(np.uint16)):
        tio.imwrite(src / f"img_{z:06d}.tif", plane)
    return src


def test_deconvolve_volume_on_a_mesh(tmp_path):
    src = _decon_series(tmp_path / "in")
    psf = gaussian_psf((5, 5, 5), (1.0, 1.0, 1.0))
    kw = DECON_KW
    outs = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for name, mesh in (("single", None), ("mesh", _mesh(4))):
            outs[name] = tmp_path / name
            PD.deconvolve_volume(src, outs[name], psf, mesh=mesh, **kw)
        JD.deconvolve_volume(src, tmp_path / "jax", psf,
                             mesh=mj.make_mesh(4), **kw)
    man = PD.json.loads((outs["mesh"] / "blocks_manifest.json").read_text())
    assert man["n_blocks"] >= 6 and man["params"]["mesh"] == {"data": 4,
                                                              "z": 1}
    _same_bytes(outs["mesh"], outs["single"])
    _within(_read(outs["mesh"]), _read(tmp_path / "jax"), 1e-3 * 65535)
    # --batch-blocks: two blocks a device per batch, the same bricks
    PD.deconvolve_volume(src, tmp_path / "b8", psf, mesh=_mesh(4),
                         batch_blocks=8, **kw)
    _same_bytes(tmp_path / "b8", outs["single"])
    # one device, three blocks a batch: the same bricks again
    PD.deconvolve_volume(src, tmp_path / "b3", psf, batch_blocks=3, **kw)
    _same_bytes(tmp_path / "b3", outs["single"])


@pytest.mark.parametrize("entry", ["deconvolve_volume", "batch_filter"])
def test_an_explicit_device_takes_no_default_mesh(entry, tmp_path,
                                                  monkeypatch):
    """A caller who names the device runs on it alone, whatever
    `default_mesh()` would give; without one the default mesh is asked."""
    if entry == "deconvolve_volume":
        src = _decon_series(tmp_path / "in")
        psf = gaussian_psf((5, 5, 5), (1.0, 1.0, 1.0))

        def run(out, **kw):
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                PD.deconvolve_volume(src, out, psf, **DECON_KW, **kw)
    else:
        src = _tiles(tmp_path / "in")
        cfg = PCfg(sigma=(40.0, 40.0), wavelet="db9", bidirectional=True)

        def run(out, **kw):
            PS.batch_filter(src, out, cfg, batch_size=4, workers=2, **kw)
    run(tmp_path / "single", mesh=False)
    calls = _patch_default_mesh(monkeypatch)
    run(tmp_path / "pinned", device="cpu")
    assert not calls
    _same_bytes(tmp_path / "pinned", tmp_path / "single")
    run(tmp_path / "mesh")
    assert calls
    _same_bytes(tmp_path / "mesh", tmp_path / "single")


@pytest.fixture(scope="module")
def grid_xml(tmp_path_factory):
    """A 2 x 3 grid of 9-plane u16 stacks with known jitter, placed at
    its true offsets in a placement XML both packages read."""
    root = tmp_path_factory.mktemp("tiles")
    rng = np.random.default_rng(3)
    vol = make_phantom(rng, (9, 160, 220), smooth=4.0)
    tiles, truth = cut_tiles(vol, 2, 3, (90, 90), 26, jitter=3,
                             rng=np.random.default_rng(4))
    grid = write_tile_grid(root, tiles, overlap_nominal_px=26, voxel_um=VOX)
    nominal = root / "nominal.xml"
    grid.to_xml(nominal)
    for r in range(2):
        for c in range(3):
            s = grid.stacks[r][c]
            s.abs_h, s.abs_v, _ = truth[r][c]
    placed = root / "placed.xml"
    grid.to_xml(placed)
    return nominal, placed


def test_compute_displacements_on_a_mesh(grid_xml):
    nominal, _ = grid_xml
    kw = dict(overlap_v=26, overlap_h=26, displ_max_v=5, displ_max_h=5,
              displ_max_d=2, subvol_dim=4)
    single = PA.compute_displacements(PGrid.from_xml(nominal), **kw)
    mesh = PA.compute_displacements(PGrid.from_xml(nominal), mesh=_mesh(2),
                                    **kw)
    ref = JA.compute_displacements(JGrid.from_xml(nominal),
                                   mesh=mj.make_mesh(2), **kw)

    def same(got, want, atol):
        assert got.keys() == want.keys() and got
        for k in got:
            assert len(got[k]) == len(want[k])
            for a, b in zip(got[k], want[k]):
                assert tuple(a.displ) == tuple(b.displ), k
                assert tuple(a.ncc_width) == tuple(b.ncc_width), k
                np.testing.assert_allclose(a.reliability, b.reliability,
                                           atol=atol)

    # the maps of a split pair batch equal the whole batch's to rounding
    same(mesh, single, 1e-6)
    same(mesh, ref, 1e-4)


def test_merge_on_a_mesh(grid_xml, tmp_path):
    _, placed = grid_xml
    kw = dict(cosine_blending=True, target_voxel_um=2.0)
    _, ds_single = PM.merge_to_tif_series(PGrid.from_xml(placed),
                                          tmp_path / "single", **kw)
    _, ds_mesh = PM.merge_to_tif_series(PGrid.from_xml(placed),
                                        tmp_path / "mesh", mesh=_mesh(2),
                                        **kw)
    _, ds_jax = JM.merge_to_tif_series(JGrid.from_xml(placed),
                                       tmp_path / "jax",
                                       mesh=mj.make_mesh(2), **kw)
    _same_bytes(tmp_path / "mesh", tmp_path / "single")
    np.testing.assert_array_equal(ds_mesh, ds_single)
    _within(_read(tmp_path / "mesh"), _read(tmp_path / "jax"), 1)
    np.testing.assert_allclose(ds_mesh, ds_jax,
                               atol=1e-4 * float(np.abs(ds_jax).max()))


def test_process_channel_on_a_mesh(tmp_path):
    rng = np.random.default_rng(5)
    vol = make_phantom(rng, (6, 200, 200), smooth=6.0)
    stripes = 1.0 + 0.25 * np.sin(np.arange(200) / 3.0)[None, None, :]
    tiles, _ = cut_tiles(vol * stripes, 2, 2, (120, 120), 48, jitter=2,
                         rng=np.random.default_rng(7))
    raw = tmp_path / "raw" / CH
    raw.mkdir(parents=True)
    write_tile_grid(raw, tiles, overlap_nominal_px=48,
                    voxel_um=(0.41, 0.41, 0.2))
    cfg = dict(sigma=(24, 24), wavelet="db3", bidirectional=True)
    kw = dict(voxel_um=(0.41, 0.41, 0.2), tile_size=(120, 120),
              search_radius=6, subvol_dim=6, bleach_correction=True,
              convert_to_8bit=True, skip_inspection=True, io_workers=2)
    runs = {}
    for name, mesh in (("single", False), ("mesh", _mesh(2))):
        st = tmp_path / f"{name}_stitched"
        PPI.process_channel(raw, tmp_path / f"{name}_pre", st,
                            preprocess_cfg=PCfg(**cfg), mesh=mesh or None,
                            **kw)
        runs[name] = st
    JPI.process_channel(raw, tmp_path / "jax_pre", tmp_path / "jax_stitched",
                        preprocess_cfg=JCfg(**cfg), mesh=mj.make_mesh(2),
                        **kw)
    _same_bytes(tmp_path / "mesh_pre", tmp_path / "single_pre")
    # one plane a device against the single device's batches of four:
    # the merge's destripe runs its FFTs over other batch shapes
    _within(_read(runs["mesh"]), _read(runs["single"]), 1)
    _within(_read(runs["mesh"]), _read(tmp_path / "jax_stitched"), 1)


def _patch_default_mesh(monkeypatch):
    """default_mesh returns a 2-entry CPU mesh; returns its call list."""
    calls = []

    def two():
        calls.append(1)
        return _mesh(2), 1

    monkeypatch.setattr(mp, "default_mesh", two)
    return calls


def _tiles(root):
    rng = np.random.default_rng(21)
    for name, (h, w), n in (("A", (64, 96), 5), ("B", (48, 96), 3)):
        d = root / name
        d.mkdir(parents=True)
        for z in range(n):
            yy, xx = np.mgrid[:h, :w]
            img = (1800 + 700 * np.sin(yy / 9.0)) \
                * (1 + 0.1 * rng.standard_normal((1, w)))
            tio.imwrite(d / f"{z:06d}.tif",
                        np.clip(img, 0, 65535).astype(np.uint16))
    return root


def test_pystripe_cli_on_a_mesh(tmp_path, monkeypatch):
    src = _tiles(tmp_path / "in")
    argv = ["-i", str(src), "--sigma1", "40", "--sigma2", "40", "--wavelet",
            "db9", "--bidirectional", "--batch-size", "4", "--workers", "2"]
    assert PS.main(argv + ["-o", str(tmp_path / "single")]) == 0
    calls = _patch_default_mesh(monkeypatch)
    assert PS.main(argv + ["-o", str(tmp_path / "mesh")]) == 0
    assert calls
    _same_bytes(tmp_path / "mesh", tmp_path / "single")


@pytest.mark.parametrize("sub", ["convert", "simple"])
def test_tsv_tools_on_a_mesh(sub, tmp_path, monkeypatch):
    from tests.test_torch_tsv_tools import CASES

    build, argv, _tol = CASES[sub]
    src = tmp_path / "src"
    src.mkdir()
    build(src)
    outs, calls = {}, []
    for name in ("single", "mesh"):
        if name == "mesh":
            calls = _patch_default_mesh(monkeypatch)
        work = tmp_path / name
        shutil.copytree(src, work / "src")
        assert PT.main([a.format(src=work / "src", out=work / "out")
                        for a in argv]) == 0
        outs[name] = work / "out"
    assert calls
    _same_bytes(outs["mesh"], outs["single"])
