"""The port's deconvolution CLI against the JAX package's.

The JAX twin runs its single-device branch (`mesh=False`: conftest's eight
virtual CPU devices would otherwise route it to the mesh).  Output planes
must agree within 1e-3 of full scale, the envelope of BASELINE.md:34-36."""

import json
import warnings

import numpy as np
import pytest
import torch

from ipp_tpu.io import tiff as tio
from ipp_tpu.ops import deconv as dj
from ipp_tpu.ops.psf import make_psf
from ipp_tpu.pipeline import deconvolve as J
from ipp_tpu_torch.ops.matmul_fft import in_kernel_domain
from ipp_tpu_torch.pipeline import deconvolve as P
from ipp_tpu_torch.utils.transfer import HostArray, upload

VOL = (40, 48, 200)      # both planners: one block by default, 18 at 0.2 Mvox
PSF_SHAPE = (13, 9, 9)   # the CLI's default optics


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setattr(dj, "_RESOLVED_FFT", "xla")
    monkeypatch.setenv("IPP_TPU_PLATFORM", "cpu")
    monkeypatch.setenv("IPP_TPU_PROGRESS", "off")


@pytest.fixture(scope="module")
def psf():
    p, _, _ = make_psf(dxy=406.0, dz=800.0)
    return np.transpose(p, (2, 1, 0))


def _write_series(d, shape):
    """Blurred, Poisson-noised beads as a z-plane u16 TIFF series."""
    from scipy.ndimage import gaussian_filter

    rng = np.random.default_rng(11)
    truth = np.full(shape, 100.0)
    idx = tuple(rng.integers(0, s, 60) for s in shape)
    truth[idx] += rng.uniform(20000, 40000, 60)
    vol = rng.poisson(gaussian_filter(truth, (2.5, 1.2, 1.2))).clip(0, 65535)
    for z, plane in enumerate(vol.astype(np.uint16)):
        tio.imwrite(d / f"img_{z:06d}.tif", plane)
    return d


@pytest.fixture(scope="module")
def series(tmp_path_factory):
    return _write_series(tmp_path_factory.mktemp("series"), VOL)


def _read(d):
    return np.stack([tio.imread(p) for p in sorted(d.glob("img_*.tif"))])


def _plans(mod, vol, psf_shape, budget, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        plans, halo, planned = mod.autosplit(vol, psf_shape, budget,
                                             strict_accuracy=True, **kw)
    return [p.core for p in plans], halo


def test_parser_has_the_jax_flags_and_defaults():
    def surface(parser):
        return {a.dest: (tuple(a.option_strings), a.default, a.nargs,
                         a.type, tuple(a.choices or ()), a.required,
                         type(a).__name__)
                for a in parser._actions}

    assert surface(P.build_parser()) == surface(J.build_parser())


@pytest.mark.parametrize("vol,psf_shape,inside", [
    ((512, 1024, 1024), (13, 9, 9), True), ((300, 700, 900), (9, 9, 9), True),
    ((512, 2048, 2048), (13, 9, 9), True), ((200, 512, 512), (9, 9, 9), True),
    # no 256-multiple z candidate for a thin volume: the torch.fft route
    ((64, 512, 512), (9, 9, 9), False),
])
def test_autosplit_on_cuda_prefers_kernel_domain_blocks(vol, psf_shape,
                                                        inside):
    plans, halo, planned = P.autosplit(vol, psf_shape, strict_accuracy=True,
                                       kernel_domain=True)
    P._check_block_coverage(plans, vol)
    assert halo == tuple(max((p // 2) * 4, 8) for p in psf_shape)
    work = P._fft_shape_for_backend(P.fft_work_shape(plans, halo, planned))
    assert in_kernel_domain(work) is inside, work
    cores = [hi - lo for lo, hi in plans[0].core]
    assert all(c >= 2 * h for c, h in zip(cores, halo))


def test_autosplit_halo_ladder_and_strict_gate():
    budget = int(0.2 * 2 ** 20)
    with pytest.warns(UserWarning, match="3x the PSF"):
        _, halo, _ = P.autosplit(VOL, PSF_SHAPE, budget, strict_accuracy=True)
    assert halo == (18, 12, 12)
    tight = int(0.15 * 2 ** 20)
    with pytest.raises(ValueError, match="strict accuracy"):
        P.autosplit(VOL, PSF_SHAPE, tight, strict_accuracy=True)
    with pytest.warns(UserWarning, match="2x the PSF"):
        plans, halo, _ = P.autosplit(VOL, PSF_SHAPE, tight)
    assert halo == (12, 8, 8)
    P._check_block_coverage(plans, VOL)


def test_upload_and_quantise_keep_u16_exact():
    block = np.array([[[0, 1, 32767, 32768, 65534, 65535]]], np.uint16)
    x = upload(block, torch.device("cpu"))
    assert x.dtype == torch.int32
    np.testing.assert_array_equal(x.numpy(), block.astype(np.int32))
    np.testing.assert_array_equal(np.asarray(HostArray(x)), block)
    dec = torch.linspace(3.0, 9.0, 4 * 4 * 4).reshape(4, 4, 4)
    q, mm = P._finish(P._crop(dec, (1, 1, 1), (4, 4, 4)))
    codes = np.asarray(HostArray(q))
    assert codes.dtype == np.uint16
    core = dec[1:3, 1:3, 1:3].numpy()
    lo, hi = core.min(), core.max()
    ref = np.clip(np.rint((core - lo) * np.float32(65535.0 / (hi - lo))),
                  0, 65535)
    np.testing.assert_array_equal(codes, ref.astype(np.uint16))
    assert mm.tolist() == [float(lo), float(hi)]


def test_cli_matches_the_jax_twin(series, psf, tmp_path):
    assert _plans(P, VOL, psf.shape, 160 * 2 ** 20) == \
        _plans(J, VOL, psf.shape, 160 * 2 ** 20)
    out_p, out_j = tmp_path / "port", tmp_path / "jax"
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert P.main(["-i", str(series), "-o", str(out_p), "--niter", "4"]) == 0
        J.deconvolve_volume(series, out_j, psf, niter=4, mesh=False)
    a, b = _read(out_p), _read(out_j)
    assert a.shape == b.shape == VOL and a.dtype == np.uint16
    diff = np.abs(a.astype(np.int64) - b.astype(np.int64)).max()
    assert diff <= 1e-3 * 65535, diff
    man = json.loads((out_p / "blocks_manifest.json").read_text())
    assert man["n_blocks"] == 1 and "finished" in man


def test_port_resumes_a_jax_brick_cache(series, psf, tmp_path):
    budget = 0.2
    plans = _plans(P, VOL, psf.shape, int(budget * 2 ** 20))
    assert plans == _plans(J, VOL, psf.shape, int(budget * 2 ** 20))
    n = len(plans[0])
    assert n > 2
    mixed, full = tmp_path / "mixed", tmp_path / "full"
    args = ["--niter", "3", "--max-block-mvox", str(budget)]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        J.deconvolve_volume(series, mixed, psf, niter=3, mesh=False,
                            max_block_elems=int(budget * 2 ** 20),
                            start_block=n // 2)
        jax_bricks = {p.name: p.read_bytes()
                      for p in (mixed / "bricks").glob("*.npy")}
        assert len(jax_bricks) == n - n // 2
        assert not list(mixed.glob("img_*.tif"))  # waits for every brick
        P.main(["-i", str(series), "-o", str(mixed), "--resume", *args])
        P.main(["-i", str(series), "-o", str(full), *args])
    for name, data in jax_bricks.items():  # resumed, not recomputed
        assert (mixed / "bricks" / name).read_bytes() == data
    a, b = _read(mixed), _read(full)
    assert a.shape == VOL
    diff = np.abs(a.astype(np.int64) - b.astype(np.int64)).max()
    assert diff <= 1e-3 * 65535, diff


def test_destripe_sigma_matches_the_jax_twin(series, psf, tmp_path):
    """--destripe-sigma: each block's xz slices z-destriped (db9), f32
    bricks; output within 1e-3 of full scale of the JAX CLI's."""
    out_p, out_j = tmp_path / "port", tmp_path / "jax"
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert P.main(["-i", str(series), "-o", str(out_p), "--niter", "3",
                       "--destripe-sigma", "1.0"]) == 0
        J.deconvolve_volume(series, out_j, psf, niter=3, mesh=False,
                            destripe_sigma=1.0)
    a, b = _read(out_p), _read(out_j)
    assert a.shape == b.shape == VOL and a.dtype == np.uint16
    diff = np.abs(a.astype(np.int64) - b.astype(np.int64)).max()
    assert diff <= 1e-3 * 65535, diff
    man = json.loads((out_p / "blocks_manifest.json").read_text())
    assert man["quant"] == {} and man["params"]["destripe_sigma"] == 1.0
    assert np.load(out_p / "bricks" / "block_00000.npy").dtype == np.float32


def test_adaptive_psf_matches_the_jax_twin(psf, tmp_path):
    """--adaptive-psf: per-block blind-Wiener RL from the optics PSF;
    output within 1e-3 of full scale of the JAX CLI's.  The PSF estimate
    depends on the whole padded block, so the volume is one whose work
    shape both planners agree on (the JAX planner's TPU cost model keeps
    a 256-wide x axis where the port's takes the tight 224 for VOL).
    Three iterations: blind PSF re-estimation grows f32 rounding ~10x per
    iteration (see tests/test_torch_rl_variants.py)."""
    shape = VOL[:2] + (232,)
    (tmp_path / "series").mkdir()
    series = _write_series(tmp_path / "series", shape)
    work = []
    for mod in (P, J):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            plans, halo, planned = mod.autosplit(shape, psf.shape,
                                                 strict_accuracy=True)
        work.append(mod.fft_work_shape(plans, halo, planned))
    assert work[0] == work[1]
    out_p, out_j = tmp_path / "port", tmp_path / "jax"
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert P.main(["-i", str(series), "-o", str(out_p), "--niter", "3",
                       "--adaptive-psf"]) == 0
        J.deconvolve_volume(series, out_j, psf, niter=3, mesh=False,
                            adaptive_psf=True)
    a, b = _read(out_p), _read(out_j)
    assert a.shape == b.shape == shape and a.dtype == np.uint16
    diff = np.abs(a.astype(np.int64) - b.astype(np.int64)).max()
    assert diff <= 1e-3 * 65535, diff
    plain = tmp_path / "plain"
    assert P.main(["-i", str(series), "-o", str(plain), "--niter", "3"]) == 0
    assert not np.array_equal(a, _read(plain))   # the Wiener path ran


@pytest.mark.parametrize("flag", [["--adaptive-psf"]])
def test_unported_flags_fail_loudly(flag, psf, tmp_path):
    """--adaptive-psf is ported; with an explicit mesh it fails loudly,
    with the reference's guard."""
    args = P.build_parser().parse_args(
        ["-i", str(tmp_path), "-o", str(tmp_path / "o"), *flag])
    with pytest.raises(ValueError, match="mesh"):
        P.deconvolve_volume(args.input, args.output, psf, mesh=object(),
                            adaptive_psf=args.adaptive_psf)


def test_a_mesh_fails_loudly(psf, tmp_path):
    """A mesh that is not a parallel.mesh.Mesh is refused, never run on
    one device."""
    with pytest.raises(TypeError, match="Mesh"):
        P.deconvolve_volume(tmp_path, tmp_path / "o", psf, mesh=object())


def test_without_cuda_or_cpu_setting_the_cli_raises(monkeypatch, series,
                                                     tmp_path):
    monkeypatch.delenv("IPP_TPU_PLATFORM")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="IPP_TPU_PLATFORM=cpu"):
        P.main(["-i", str(series), "-o", str(tmp_path / "o")])
    assert not (tmp_path / "o").exists()


def test_dry_run_writes_nothing(series, tmp_path, capsys):
    out = tmp_path / "o"
    assert P.main(["-i", str(series), "-o", str(out), "--dry-run"]) == 0
    assert "DRY RUN" in capsys.readouterr().out
    assert not list(out.glob("img_*.tif"))
