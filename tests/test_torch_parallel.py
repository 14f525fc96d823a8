"""The port's mesh, halo and distributed layers against the JAX package's.

The JAX side runs on conftest's eight virtual CPU devices; the port's
mesh is an explicit list of CPU entries (`make_mesh(devices=["cpu"] *
n)`), PyTorch's counterpart of virtual devices.  Mesh shapes equal JAX's
for 1-8 devices; the halo exchange carries real neighbour planes (the
identity and z-mean filter of tests/test_parallel.py, port against JAX);
z-sharded RL equals JAX's and the slab-by-slab decomposition; a sharded
RL batch equals the unsharded call; the sharded NCC maps (padded to a
"data" multiple) equal JAX's; the distributed helpers degrade to one
process."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh
from jax.sharding import NamedSharding, PartitionSpec as JP
from scipy.ndimage import convolve as ndi_convolve, gaussian_filter

from ipp_tpu.ops import deconv as dj
from ipp_tpu.ops import ncc as nj
from ipp_tpu.ops.psf import gaussian_psf
from ipp_tpu.parallel import halo as hj
from ipp_tpu.parallel import mesh as mj
from ipp_tpu_torch.ops import deconv as dp
from ipp_tpu_torch.ops import ncc as np_
from ipp_tpu_torch.parallel import distributed as dist_p
from ipp_tpu_torch.parallel import halo as hp
from ipp_tpu_torch.parallel import mesh as mp

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setattr(dj, "_RESOLVED_FFT", "xla")
    monkeypatch.setenv("IPP_TPU_PLATFORM", "cpu")


def _cpu_mesh(n, z=1):
    return mp.make_mesh(n, z_parallel=z, devices=["cpu"] * 8)


@pytest.mark.parametrize("n", range(1, 9))
def test_make_mesh_shapes_equal_jax(n):
    for z in (d for d in range(1, n + 1) if n % d == 0):
        got = _cpu_mesh(n, z)
        assert got.shape == dict(mj.make_mesh(n, z_parallel=z).shape)
        assert got.size == n and all(d == CPU for d in got.devices.flat)


def test_make_mesh_refuses_what_jax_refuses():
    with pytest.raises(AssertionError):
        mj.make_mesh(6, z_parallel=4)
    with pytest.raises(ValueError, match="z_parallel"):
        _cpu_mesh(6, 4)
    with pytest.raises(ValueError, match="devices"):
        mp.make_mesh(9, devices=["cpu"] * 8)


def test_default_mesh_on_the_cpu():
    assert mp.default_mesh() == (None, 4)


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_a_cuda_mesh_raises_without_a_card():
    with pytest.raises(RuntimeError, match="CUDA"):
        mp.make_mesh(devices=["cuda:0", "cuda:0"])
    with pytest.raises(RuntimeError, match="CUDA"):
        mp.make_mesh()


def test_placements_split_and_gather(rng):
    mesh = _cpu_mesh(6, 2)
    x = torch.from_numpy(rng.random((6, 4, 3), dtype=np.float32))
    for place, n in ((mp.data_sharding(mesh, 3), 3),
                     (mp.block_sharding(mesh, 3), 6),
                     (mp.z_sharding(mesh, 3), 2)):
        sh = mp.put(x, place)
        assert len(sh.shards) == n
        assert torch.equal(mp.gather(sh), x)
    with pytest.raises(ValueError, match="split"):
        mp.put(x[:5], mp.data_sharding(mesh, 3))


def _jax_zmap(fn, vol, n, halo):
    mesh = JMesh(np.array(jax.devices()[:n]), ("z",))
    with mesh:
        sharded = jax.device_put(jnp.asarray(vol),
                                 NamedSharding(mesh, JP("z", None, None)))
        return np.asarray(jax.jit(hj.sharded_map_blocks_z(fn, mesh,
                                                          halo))(sharded))


def _zmean(halo, cat, stack, mean, pad):
    def fn(ext):
        k = 2 * halo + 1
        m = mean(stack([ext[i:ext.shape[0] - (k - 1 - i)]
                        for i in range(k)]))
        return pad(m)
    return fn


def test_halo_exchange_equals_jax(rng):
    vol = rng.standard_normal((16, 8, 8)).astype(np.float32)
    halo, n = 2, 4
    mesh = _cpu_mesh(n, n)
    ident = hp.sharded_map_blocks_z(lambda b: b, mesh, halo)(vol)
    np.testing.assert_array_equal(ident.numpy(), vol)
    # the extended slabs: real neighbour planes inside, replicated edges
    ext = hp.exchange_halos_z(mp.put(vol, mp.z_sharding(mesh, 3)), halo)
    assert [tuple(e.shape) for e in ext] == [(8, 8, 8)] * n
    np.testing.assert_array_equal(ext[1][:halo].numpy(), vol[2:4])
    np.testing.assert_array_equal(ext[1][-halo:].numpy(), vol[8:10])
    np.testing.assert_array_equal(ext[0][:halo].numpy(),
                                  np.repeat(vol[:1], halo, 0))
    np.testing.assert_array_equal(ext[-1][-halo:].numpy(),
                                  np.repeat(vol[-1:], halo, 0))
    fn_t = _zmean(halo, torch.cat, torch.stack, lambda s: s.mean(0),
                  lambda m: torch.nn.functional.pad(m, (0, 0, 0, 0, halo,
                                                        halo)))
    fn_j = _zmean(halo, jnp.concatenate, jnp.stack,
                  lambda s: jnp.mean(s, axis=0),
                  lambda m: jnp.pad(m, ((halo, halo), (0, 0), (0, 0))))
    got = hp.sharded_map_blocks_z(fn_t, mesh, halo)(torch.from_numpy(vol))
    ref = _jax_zmap(fn_j, vol, n, halo)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)
    k = 2 * halo + 1
    full = np.stack([vol[i:16 - (k - 1 - i)] for i in range(k)]).mean(0)
    np.testing.assert_allclose(got.numpy()[halo:16 - halo], full, atol=1e-5)


def _blurred(rng, shape=(16, 32, 32)):
    truth = gaussian_filter(
        (rng.random(shape) > 0.98).astype(np.float32) * 1000, 0.8)
    psf = gaussian_psf((5, 5, 5), (1.0, 1.0, 1.0))
    return ndi_convolve(truth, psf, mode="constant").astype(np.float32), psf


def test_sharded_z_rl_equals_jax_and_the_slabs(rng):
    blurred, psf = _blurred(rng)
    halo, n = 2, 4
    got = dp.richardson_lucy_sharded_z(blurred, psf, _cpu_mesh(n, n),
                                       niter=4, halo=halo).numpy()
    jmesh = JMesh(np.array(jax.devices()[:n]), ("z",))
    ref = np.asarray(dj.richardson_lucy_sharded_z(
        jax.device_put(jnp.asarray(blurred),
                       NamedSharding(jmesh, JP("z", None, None))),
        jnp.asarray(psf), jmesh, niter=4, halo=halo))
    np.testing.assert_allclose(got, ref, rtol=2e-3, atol=2e-1)
    # the same overlap-discard decomposition, slab by slab on one device
    serial = np.zeros_like(blurred)
    step = blurred.shape[0] // n
    fshape = dp.fft_shape_for((step + 2 * halo,) + blurred.shape[1:],
                              psf.shape, CPU)
    for i in range(n):
        z0, z1 = i * step, (i + 1) * step
        idx = np.clip(np.arange(z0 - halo, z1 + halo), 0, 15)
        dec = dp.richardson_lucy_batched(blurred[idx][None], psf, niter=4,
                                         fft_shape=fshape, device=CPU)
        serial[z0:z1] = dec[0, halo:halo + step].numpy()
    assert np.abs(got - serial).max() <= 1e-5 * np.abs(serial).max()


@pytest.mark.parametrize("n,z", [(4, 1), (6, 2)])
def test_sharded_rl_batch_equals_the_unsharded_call(rng, n, z):
    mesh = _cpu_mesh(n, z)
    psf = gaussian_psf((3, 3, 3), (1.0, 1.0, 1.0))
    vols = rng.random((n // z * 2, 8, 16, 16)).astype(np.float32) * 100
    kw = dict(niter=2, fft_shape=(8, 16, 16), edge_taper=False)
    local = dp.richardson_lucy_batched(vols, psf, device=CPU, **kw)
    sharded = dp.richardson_lucy_batched(
        torch.from_numpy(vols), psf, sharding=mp.block_sharding(mesh, 4),
        **kw)
    tol = 1e-6 * float(local.abs().max())
    assert float((sharded - local).abs().max()) <= tol
    ref = np.asarray(dj.richardson_lucy_batched(jnp.asarray(vols),
                                                jnp.asarray(psf), **kw))
    np.testing.assert_allclose(sharded.numpy(), ref, rtol=2e-5, atol=2e-3)


def test_sharded_ncc_maps_pad_and_equal_jax(rng):
    ma = rng.random((5, 32, 24)).astype(np.float32)
    mb = np.roll(ma, 1, axis=1) + rng.normal(0, 0.01, ma.shape).astype(
        np.float32)
    got = np_._ncc_maps_sharded(ma, mb, 4, 4, _cpu_mesh(6, 2))
    ref = nj._ncc_maps_sharded(ma, mb, 4, 4, mj.make_mesh(6, z_parallel=2))
    assert got.shape == ref.shape == (5, 9, 9)
    np.testing.assert_allclose(got, ref, atol=1e-5)
    # the single-device chain (a different FFT batch: equal to rounding)
    single = np_._ncc_maps_sharded(ma, mb, 4, 4, None, device=CPU)
    np.testing.assert_allclose(got, single, atol=1e-6)


def test_distributed_helpers_single_process():
    assert dist_p.initialize() is False
    assert not dist_p.is_multihost()
    mesh = dist_p.global_mesh(z_parallel=2, local_devices=["cpu"] * 8)
    assert mesh.shape == {"data": 4, "z": 2}
    assert dist_p.process_slice(10) == (0, 10)
    arr = np.arange(32, dtype=np.float32).reshape(8, 4)
    sh = dist_p.device_put_global(
        arr, mp.data_sharding(dist_p.global_mesh(local_devices=["cpu"] * 8),
                              2))
    np.testing.assert_array_equal(mp.gather(sh).numpy(), arr)
    t = torch.arange(6.0)
    assert dist_p.all_gather(t) is t


@pytest.mark.parametrize("env,multi,want", [
    ({}, True, [0, 1, 2, 3]),                       # one process a node
    ({"LOCAL_RANK": "2"}, True, [2]),                # one process a card
    ({"LOCAL_RANK": "0", "LOCAL_WORLD_SIZE": "1"}, True, [0, 1, 2, 3]),
    ({"LOCAL_RANK": "2"}, False, [0, 1, 2, 3]),      # no group joined
])
def test_process_devices_follow_the_launch_layout(monkeypatch, env, multi,
                                                  want):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(dist_p, "is_multihost", lambda: multi)
    for k in ("LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert dist_p.process_devices() == [torch.device("cuda", i)
                                        for i in want]


def test_process_devices_refuse_a_rank_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(dist_p, "is_multihost", lambda: True)
    monkeypatch.setenv("LOCAL_RANK", "2")
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    with pytest.raises(RuntimeError, match="LOCAL_RANK 2"):
        dist_p.process_devices()
