"""The port's Dragonfly scanner stitch (stitch/scan.py with the copied
pipeline/scan_stitch.py) against the JAX package's.

A synthetic X / X_Y / Z tree (tests/synth.write_dragonfly_tree: 2 x 2
substack columns, two piezo substacks each, known jitter) through
`scan_stitch.main` of both packages: the same offsets JSON (links and
offsets equal, NCC scores within 1e-5), the same
placed positions (equal to the truth up to 1 px, as the JAX package's own
test holds them), byte-equal blended planes; a run with the per-stack
creep estimate (`--estimate-creep`, the drift NCC) gives the same
positions; a run from the offsets JSON reproduces them.  The all-shifts
NCC maps of a plane sweep batch agree within 1e-4."""

import json

import numpy as np
import pytest

from ipp_tpu.pipeline import scan_stitch as J
from ipp_tpu.stitch.scan import Scanner as JScanner
from ipp_tpu_torch.pipeline import scan_stitch as P
from ipp_tpu_torch.stitch.scan import Scanner as PScanner
from tests.synth import write_dragonfly_tree

BASE = ["--voxel-size", "1,1,1", "--z-step", "12", "--piezo-distance",
        "16", "--x-slop", "5", "--y-slop", "5", "--z-slop", "4", "--dark",
        "100", "--threshold", "0.5", "--rounds", "1", "--n-io-cores", "2",
        "--compression", "0"]


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("IPP_TPU_PLATFORM", "cpu")


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("dragonfly") / "tree"
    truth, _vol = write_dragonfly_tree(root, np.random.default_rng(5),
                                       n_y=2)
    return root, truth


def _run(main, root, out, extra=()):
    out.mkdir(parents=True, exist_ok=True)
    rc = main(["--input", str(root), *BASE,
               "--output-pattern", str(out / "planes" / "img_%04d.tif"),
               "--stacks", str(out / "stacks.json"), *extra])
    assert rc == 0
    return {tuple(d["key"]): (d["x0"], d["y0"], d["z0"])
            for d in json.loads((out / "stacks.json").read_text())}


def _same_planes(a_dir, b_dir):
    names = sorted(p.name for p in b_dir.glob("*.tif"))
    assert names and sorted(p.name for p in a_dir.glob("*.tif")) == names
    for n in names:
        assert (a_dir / n).read_bytes() == (b_dir / n).read_bytes(), n


@pytest.mark.parametrize("creep", [False, True])
def test_scan_stitch_same_positions_offsets_and_planes(tree, tmp_path,
                                                       creep):
    root, truth = tree
    extra = ["--estimate-creep"] if creep else []
    placed, out = {}, {}
    for name, main in (("port", P.main), ("jax", J.main)):
        out[name] = tmp_path / name
        placed[name] = _run(main, root, out[name], extra + [
            "--stack-offset-output", str(out[name] / "offsets.json")])
    assert placed["port"] == placed["jax"]
    assert set(placed["port"]) == set(truth)
    t0, p0 = np.array(truth[(0, 0, 0)]), np.array(placed["port"][(0, 0, 0)])
    for k, t in truth.items():
        err = np.abs(np.array(placed["port"][k]) - p0 - (np.array(t) - t0))
        assert np.all(err <= 1), (k, err)
    links = {name: json.loads((out[name] / "offsets.json").read_text())
             ["links"] for name in out}
    assert [(d["k0"], d["k1"], d["coord"]) for d in links["port"]] == \
        [(d["k0"], d["k1"], d["coord"]) for d in links["jax"]]
    np.testing.assert_allclose([d["score"] for d in links["port"]],
                               [d["score"] for d in links["jax"]], atol=1e-5)
    _same_planes(out["port"] / "planes", out["jax"] / "planes")


def test_offsets_json_reuse(tree, tmp_path):
    """The JAX package's offsets JSON drives the port's placement."""
    root, _truth = tree
    ja = tmp_path / "jax"
    placed = _run(J.main, root, ja, ["--stack-offset-output",
                                     str(ja / "offsets.json")])
    pa = tmp_path / "port"
    again = _run(P.main, root, pa, ["--stack-offset-input",
                                    str(ja / "offsets.json")])
    assert again == placed
    _same_planes(pa / "planes", ja / "planes")


def test_plane_sweep_maps_within_1e4():
    rng = np.random.default_rng(3)
    a = rng.random((5, 40, 36)).astype(np.float32) * 1000
    b = np.roll(a, (2, -3), axis=(1, 2)) + rng.random((5, 40, 36)) * 50
    got = PScanner._maps(a, b.astype(np.float32), 6, 7)
    want = JScanner._maps_bucketed(a, b.astype(np.float32), 6, 7)
    assert got.shape == want.shape == (5, 13, 15)
    np.testing.assert_allclose(got, want, atol=1e-4)
