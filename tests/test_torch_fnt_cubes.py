"""The port's FNT-cube CLI against the JAX package's.

Two small u16 cubes (24^3: PSF-blurred beads, numpy seed 5) through both
CLIs' `main` with the same flags; the JAX twin runs its XLA-FFT route on
the CPU.  Output cubes must keep the input shape and dtype and agree
within 1e-3 of the largest output value (and at least one count: both
round to integers after f32 RL with sums in another order).  The parser
must equal the JAX parser."""

import numpy as np
import pytest
from scipy.ndimage import convolve as ndi_convolve

from ipp_tpu.io.nrrd import read_nrrd, write_nrrd
from ipp_tpu.ops import deconv as dj
from ipp_tpu.ops.psf import gaussian_psf
from ipp_tpu.pipeline import fnt_cubes as J
from ipp_tpu_torch.pipeline import fnt_cubes as P

SHAPE = (24, 24, 24)


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setattr(dj, "_RESOLVED_FFT", "xla")
    monkeypatch.setenv("IPP_TPU_PLATFORM", "cpu")
    monkeypatch.setenv("IPP_TPU_PROGRESS", "off")


@pytest.fixture(scope="module")
def cubes(tmp_path_factory):
    rng = np.random.default_rng(5)
    d = tmp_path_factory.mktemp("cubes")
    (d / "sub").mkdir()
    psf = gaussian_psf((7, 5, 5), (2.0, 1.0, 1.0))
    for i, name in enumerate(["cube_000.nrrd", "sub/cube_001.nrrd"]):
        truth = np.full(SHAPE, 200.0, np.float32)
        idx = tuple(rng.integers(2, s - 2, 30) for s in SHAPE)
        truth[idx] += rng.uniform(2000, 6000, 30)
        vol = ndi_convolve(truth, psf, mode="wrap")
        vol *= 1 + 0.2 * (rng.random((1, SHAPE[1], 1)) < 0.2)  # stripes
        write_nrrd(d / name, np.clip(vol + i * 50, 0, 65535).astype(
            np.uint16), extra_header={"space": "left-posterior-superior"})
    np.save(d.parent / "psf.npy", gaussian_psf((5, 5, 5), (1.2, 1.0, 1.0)))
    return d


def _outputs(d):
    return [read_nrrd(p) for p in sorted(d.rglob("*.nrrd"))]


def test_parser_has_the_jax_flags_and_defaults():
    def surface(parser):
        return {a.dest: (tuple(a.option_strings), a.default, a.nargs,
                         a.type, tuple(a.choices or ()), a.required,
                         type(a).__name__, a.help == "==SUPPRESS==")
                for a in parser._actions}

    assert surface(P.build_parser()) == surface(J.build_parser())


CASES = {
    "plain": ["--niter", "4"],
    "axial_destripe": ["--niter", "4", "--destripe"],
    "gaussian_cadence": ["--niter", "5", "-g", "0.8", "-dgi", "2"],
    "auto_background_contrast": ["--niter", "3", "-b", "auto", "-cef", "2"],
    "doubled_psf": ["--niter", "3", "--doubled_psf"],
    "psf_file": ["--niter", "3", "--psf-file", "PSF"],
    "destripe_only": ["--no-deconvolution", "--destripe-sigma", "2"],
}


@pytest.mark.parametrize("case", list(CASES))
def test_cli_matches_the_jax_twin(case, cubes, tmp_path):
    args = [str(cubes.parent / "psf.npy") if a == "PSF" else a
            for a in CASES[case]]
    out_p, out_j = tmp_path / "port", tmp_path / "jax"
    assert P.main(["-i", str(cubes), "-o", str(out_p), *args]) == 0
    assert J.main(["-i", str(cubes), "-o", str(out_j), *args]) == 0
    got, ref = _outputs(out_p), _outputs(out_j)
    assert len(got) == len(ref) == 2
    for (a, ha), (b, hb) in zip(got, ref):
        assert a.shape == b.shape == SHAPE and a.dtype == np.uint16
        assert ha == hb
        diff = np.abs(a.astype(np.int64) - b.astype(np.int64)).max()
        assert diff <= max(1, 1e-3 * b.max()), (case, diff)


def test_resume_skips_written_cubes(cubes, tmp_path):
    out = tmp_path / "out"
    assert P.main(["-i", str(cubes), "-o", str(out), "--niter", "2"]) == 0
    kept, redo = sorted(out.rglob("*.nrrd"))
    want = read_nrrd(redo)[0]
    redo.unlink()
    kept.write_bytes(b"NRRD0004\n")   # a resumed run must not touch it
    n = P.process_cubes(cubes, out, niter=2, resume=True)
    assert n == 1
    assert kept.read_bytes() == b"NRRD0004\n"
    np.testing.assert_array_equal(read_nrrd(redo)[0], want)
