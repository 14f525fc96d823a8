"""The port on two processes over torch.distributed (gloo): the twin of
tests/test_distributed.py.

Two OS processes (tests/_torch_distributed_child.py), a localhost
coordinator, each with {2, 4} CPU mesh entries: a global mesh of 4 or 8
entries across the process boundary.  Each child places its rows with
device_put_global / process_slice and runs the sharded RL batch, the
destripe batch, the NCC maps with their all-gather, z-sharded RL whose
halos cross the process boundary, and the z-slab merge.  The parent
reassembles the ranks' rows: they equal a one-process port run, and the
JAX package's single-process results within the twin tolerances.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_children(tmp_path, local_devices):
    coord = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ, IPP_TPU_PLATFORM="cpu", IPP_TPU_PROGRESS="off",
               IPP_TPU_TEST_LOCAL_DEVICES=str(local_devices),
               PYTHONPATH=os.pathsep.join(
                   [str(REPO)] + [p for p in os.environ.get(
                       "PYTHONPATH", "").split(os.pathsep) if p]))
    procs, outs = [], []
    for rank in range(2):
        outs.append(tmp_path / f"rank{rank}.npz")
        procs.append(subprocess.Popen(
            [sys.executable,
             str(REPO / "tests" / "_torch_distributed_child.py"),
             "--rank", str(rank), "--nprocs", "2", "--coordinator", coord,
             "--out", str(outs[-1])],
            env=env, cwd=tmp_path, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE))
    msgs = []
    for p in procs:
        try:
            _, se = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("distributed child timed out")
        msgs.append(se.decode(errors="replace")[-3000:])
    assert all(p.returncode == 0 for p in procs), msgs
    return [np.load(o) for o in outs]


@pytest.mark.parametrize("local_devices", [2, 4])
def test_two_process_torch_distributed(tmp_path, local_devices, monkeypatch):
    monkeypatch.setenv("IPP_TPU_PLATFORM", "cpu")
    monkeypatch.setenv("IPP_TPU_PROGRESS", "off")
    d0, d1 = _run_children(tmp_path, local_devices)
    n_dev = 2 * local_devices
    cpu = torch.device("cpu")
    # the ranks cover the batches between them, disjointly, in order
    assert d0["lo"] == 0 and d0["hi"] == d1["lo"] == n_dev // 2
    assert d1["hi"] == n_dev
    assert d0["total"] == d1["total"]
    assert d0["stripe_total"] == d1["stripe_total"]

    import jax.numpy as jnp

    from ipp_tpu.ops import deconv as dj
    from ipp_tpu.ops.destripe import filter_streaks as fs_j
    from ipp_tpu.ops.ncc import ncc_maps_batched
    from ipp_tpu.ops.psf import gaussian_psf
    from ipp_tpu_torch.ops import deconv as dp
    from ipp_tpu_torch.ops.destripe import filter_streaks as fs_p
    from ipp_tpu_torch.ops.ncc import _ncc_maps_sharded

    monkeypatch.setattr(dj, "_RESOLVED_FFT", "xla")
    rng = np.random.default_rng(0)
    psf = np.asarray(gaussian_psf((5, 5, 5), (1.0, 1.0, 1.0)))

    # --- RL batch ----------------------------------------------------------
    vols = rng.random((n_dev, 16, 16, 16)).astype(np.float32) * 100
    kw = dict(niter=4, fft_shape=(20, 20, 20), edge_taper=False)
    got = np.concatenate([d0["decon"], d1["decon"]])
    one = dp.richardson_lucy_batched(vols, psf, device=cpu, **kw).numpy()
    assert np.abs(got - one).max() <= 1e-6 * np.abs(one).max()
    np.testing.assert_allclose(got.astype(np.float64).sum(), d0["total"],
                               rtol=1e-6)
    ref = np.asarray(dj.richardson_lucy_batched(jnp.asarray(vols),
                                                jnp.asarray(psf), **kw))
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-3)

    # --- destripe batch: two tiles a device --------------------------------
    tiles = rng.integers(0, 40000, (2 * n_dev, 128, 128)).astype(np.uint16)
    got = np.concatenate([d0["destripe"], d1["destripe"]])
    assert d0["t_hi"] == d1["t_lo"] == n_dev
    one = np.concatenate([fs_p(torch.from_numpy(
        tiles[i:i + 2].astype(np.int32)), sigma=(32, 32),
        wavelet="db4").numpy() for i in range(0, 2 * n_dev, 2)])
    np.testing.assert_array_equal(got, one.astype(np.uint16))
    assert int(got.astype(np.int64).sum()) == d0["stripe_total"]
    ref = np.asarray(fs_j(tiles, sigma=(32, 32), wavelet="db4"))
    assert np.abs(got.astype(np.int64) - ref.astype(np.int64)).max() <= 1

    # --- NCC maps, all-gathered on both ranks ------------------------------
    mips_a = rng.random((n_dev, 48, 40)).astype(np.float32)
    mips_b = np.roll(mips_a, (2, -1), axis=(1, 2)) \
        + rng.normal(0, 0.01, (n_dev, 48, 40)).astype(np.float32)
    one = _ncc_maps_sharded(mips_a, mips_b, 5, 5, None, device=cpu)
    ref = np.asarray(ncc_maps_batched(jnp.asarray(mips_a),
                                      jnp.asarray(mips_b), 5, 5), np.float64)
    for d in (d0, d1):
        np.testing.assert_allclose(d["ncc_maps"], one, atol=1e-6)
        np.testing.assert_allclose(d["ncc_maps"], ref, atol=1e-5)

    # --- z-sharded RL, halos across the process boundary -------------------
    from ipp_tpu_torch.parallel.mesh import make_mesh

    Z = n_dev * 6
    volz = rng.random((Z, 24, 24)).astype(np.float32) * 100
    assert d0["zrl_lo"] == 0 and d0["zrl_hi"] == d1["zrl_lo"] == Z // 2
    got = np.concatenate([d0["zrl"], d1["zrl"]])
    one = dp.richardson_lucy_sharded_z(
        volz, psf, make_mesh(n_dev, z_parallel=n_dev,
                             devices=["cpu"] * n_dev), niter=3).numpy()
    np.testing.assert_array_equal(got, one)
    from ipp_tpu.parallel.mesh import make_mesh as jmesh

    ref = np.asarray(dj.richardson_lucy_sharded_z(
        jnp.asarray(volz), jnp.asarray(psf), jmesh(n_dev, z_parallel=n_dev),
        niter=3))
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-3)

    # --- z-slab merge: the two slabs make the one-process series -----------
    from ipp_tpu.io import tiff as tio
    from ipp_tpu_torch.geometry.stacks import TileGrid
    from ipp_tpu_torch.stitch.merge import merge_to_tif_series

    merged = sorted((tmp_path / "merged").glob("img_*.tif"))
    assert len(merged) == 6
    merge_to_tif_series(TileGrid.from_directory(tmp_path / "raw"),
                        tmp_path / "one", cosine_blending=True, device=cpu)
    for p in merged:
        assert p.read_bytes() == (tmp_path / "one" / p.name).read_bytes()
    assert tio.imread(merged[0]).dtype == np.uint16
