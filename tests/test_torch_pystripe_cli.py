"""The port's pystripe CLI against the JAX package's on one small tree.

Both CLIs destripe the same numpy-seeded tile tree (two stacks of two
shapes, a tail batch, a uniform tile) with process_images' stage-1
settings; the output trees must hold the same files, the counters must
agree, and every output tile must be within 1 count of the JAX one.  Also:
resume, single-image mode, the parser (dests, defaults, option strings),
the port's batch handle through the shared executor, and `--lightsheet`
against the JAX CLI."""

import numpy as np
import pytest
import torch

from ipp_tpu.io import tiff as tio
from ipp_tpu.parallel.executor import run_tile_pipeline
from ipp_tpu.pipeline import pystripe_cli as J
from ipp_tpu_torch.ops.process import ProcessConfig, process_batch_fn
from ipp_tpu_torch.pipeline import pystripe_cli as P

STAGE1 = ["--sigma1", "40", "--sigma2", "40", "--wavelet", "db9",
          "--padding-mode", "reflect", "--bidirectional", "--dark", "100",
          "--batch-size", "2", "--workers", "2"]


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("IPP_TPU_PLATFORM", "cpu")
    monkeypatch.setenv("IPP_TPU_PROGRESS", "off")


def _tile(rng, h, w):
    yy, xx = np.mgrid[:h, :w]
    base = 1800 + 700 * np.sin(yy / 9.0) + 400 * np.cos(xx / 14.0)
    img = base * (1 + 0.2 * rng.standard_normal((h, 1))) \
        * (1 + 0.1 * rng.standard_normal((1, w)))
    return np.clip(img + rng.normal(0, 25, (h, w)), 0, 65535).astype(np.uint16)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """stack A: 3 tiles 64 x 96 (one batch of 2 and a tail of 1) and a
    uniform tile; stack B: 2 tiles 48 x 96."""
    rng = np.random.default_rng(21)
    root = tmp_path_factory.mktemp("tiles")
    for name, (h, w), n in (("A", (64, 96), 3), ("B", (48, 96), 2)):
        d = root / name
        d.mkdir()
        for z in range(n):
            tio.imwrite(d / f"{z:06d}.tif", _tile(rng, h, w))
    tio.imwrite(root / "A" / "000003.tif", np.full((64, 96), 500, np.uint16))
    return root


def _files(d):
    return sorted(str(p.relative_to(d)) for p in d.rglob("*.tif"))


def test_parser_equals_the_jax_parser():
    def surface(parser):
        return {a.dest: (tuple(a.option_strings), a.default, a.nargs, a.type,
                         tuple(a.choices or ()), a.required,
                         type(a).__name__)
                for a in parser._actions}

    assert surface(P.build_parser()) == surface(J.build_parser())


def test_cli_matches_the_jax_cli(tree, tmp_path):
    out_p, out_j = tmp_path / "port", tmp_path / "jax"
    assert P.main(["-i", str(tree), "-o", str(out_p), *STAGE1]) == 0
    assert J.main(["-i", str(tree), "-o", str(out_j), *STAGE1]) == 0
    assert _files(out_p) == _files(out_j) == _files(tree)
    for rel in _files(out_j):
        a, b = tio.imread(out_p / rel), tio.imread(out_j / rel)
        assert a.dtype == b.dtype == np.uint16 and a.shape == b.shape
        assert np.abs(a.astype(np.int64) - b.astype(np.int64)).max() <= 1, rel
    assert not tio.imread(out_p / "A" / "000003.tif").any()  # uniform


def test_counters_and_resume_match_the_jax_cli(tree, tmp_path):
    kw = dict(sigma=(40, 40), wavelet="db3", padding_mode="reflect")
    first = {}
    for name, mod in (("port", P), ("jax", J)):
        out = tmp_path / name
        first[name] = mod.batch_filter(tree, out, mod.ProcessConfig(**kw),
                                       batch_size=2, workers=2)
    assert first["port"] == first["jax"] == {"done": 6, "skipped": 0,
                                             "failed": 0}
    (tmp_path / "port" / "B" / "000001.tif").unlink()
    again = P.batch_filter(tree, tmp_path / "port", P.ProcessConfig(**kw),
                           batch_size=2, workers=2, resume=True)
    assert again == {"done": 1, "skipped": 5, "failed": 0}
    a = tio.imread(tmp_path / "port" / "B" / "000001.tif")
    b = tio.imread(tmp_path / "jax" / "B" / "000001.tif")
    assert np.abs(a.astype(np.int64) - b.astype(np.int64)).max() <= 1


def test_single_image_mode(tree, tmp_path):
    src = tree / "B" / "000000.tif"
    out_p, out_j = tmp_path / "p.tif", tmp_path / "j.tif"
    assert P.main(["-i", str(src), "-o", str(out_p), *STAGE1]) == 0
    assert J.main(["-i", str(src), "-o", str(out_j), *STAGE1]) == 0
    a, b = tio.imread(out_p), tio.imread(out_j)
    assert np.abs(a.astype(np.int64) - b.astype(np.int64)).max() <= 1


def test_batch_handle_goes_through_the_shared_executor(tree, tmp_path):
    cfg = ProcessConfig(sigma=(40, 40), wavelet="db9", dark=100.0)
    tasks = P.collect_tasks(tree / "B", tmp_path / "o")
    run = process_batch_fn(cfg, torch.device("cpu"))
    counters = run_tile_pipeline(tasks, run, batch_size=2, reader_threads=1)
    assert counters == {"done": 2, "skipped": 0, "failed": 0}
    ref = np.asarray(run(np.stack([tio.imread(t.input_path)
                                   for t in tasks])))
    for t, r in zip(tasks, ref):
        np.testing.assert_array_equal(tio.imread(t.output_path), r)


def test_lightsheet_fails_loudly(tree, tmp_path):
    """(Named when `--lightsheet` raised.)  The flag runs the ported
    lightsheet stage now: the same files as the JAX CLI, every tile within
    1 count."""
    flags = ["--lightsheet", "--artifact-length", "40",
             "--background-window-size", "40", "--batch-size", "2",
             "--workers", "2"]
    out_p, out_j = tmp_path / "port", tmp_path / "jax"
    assert P.main(["-i", str(tree), "-o", str(out_p), *flags]) == 0
    assert J.main(["-i", str(tree), "-o", str(out_j), *flags]) == 0
    assert _files(out_p) == _files(out_j) == _files(tree)
    for rel in _files(out_j):
        a, b = tio.imread(out_p / rel), tio.imread(out_j / rel)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.abs(a.astype(np.int64) - b.astype(np.int64)).max() <= 1
