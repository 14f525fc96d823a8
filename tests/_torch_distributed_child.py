"""Child process of the port's two-process torch.distributed test.

Each process owns IPP_TPU_TEST_LOCAL_DEVICES CPU mesh entries, joins the
gloo process group through `ipp_tpu_torch.parallel.distributed.initialize`,
builds the global mesh, places its rows of globally identical data with
device_put_global / process_slice, and runs: a sharded RL batch, a
destripe batch, the sharded NCC maps (all-gathered), z-sharded RL whose
halos cross the process boundary, and the z-slab merge.  Its local rows
and the globally reduced sums go to --out; the parent reassembles the
ranks' rows and holds them to one-process runs.
"""

import argparse
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch

LOCAL = int(os.environ.get("IPP_TPU_TEST_LOCAL_DEVICES", "2"))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--nprocs", type=int, required=True)
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    torch.set_num_threads(2)

    from ipp_tpu_torch.ops.deconv import (richardson_lucy_batched,
                                          richardson_lucy_sharded_z)
    from ipp_tpu_torch.ops.destripe import filter_streaks
    from ipp_tpu_torch.ops.ncc import _ncc_maps_sharded
    from ipp_tpu_torch.ops.psf import gaussian_psf
    from ipp_tpu_torch.parallel import distributed as D
    from ipp_tpu_torch.parallel.mesh import (data_sharding, map_shards,
                                             z_sharding)

    assert D.initialize(coordinator_address=args.coordinator,
                        num_processes=args.nprocs, process_id=args.rank)
    assert D.backend() == "gloo" and D.process_count() == args.nprocs
    local = ["cpu"] * LOCAL
    mesh = D.global_mesh(local_devices=local)
    n_dev = mesh.size
    assert n_dev == LOCAL * args.nprocs
    rng = np.random.default_rng(0)  # the same logical data everywhere

    def rows(sh):
        return torch.cat([t.cpu() for t in sh.local_tensors()]).numpy()

    # --- RL: a batch of blocks over "data" --------------------------------
    vols = rng.random((n_dev, 16, 16, 16)).astype(np.float32) * 100
    psf = gaussian_psf((5, 5, 5), (1.0, 1.0, 1.0))
    lo, hi = D.process_slice(n_dev)
    g_vols = D.device_put_global(vols[lo:hi], data_sharding(mesh, 4))
    assert g_vols.shape == vols.shape
    dec = richardson_lucy_batched(g_vols, psf, niter=4,
                                  fft_shape=(20, 20, 20), edge_taper=False)
    total = float(D.all_gather(torch.tensor(
        [float(rows(dec).astype(np.float64).sum())])).sum())

    # --- destripe: a tile batch over "data", two tiles a device -----------
    tiles = rng.integers(0, 40000, (2 * n_dev, 128, 128)).astype(np.uint16)
    t_lo, t_hi = D.process_slice(2 * n_dev)
    g_tiles = D.device_put_global(
        torch.from_numpy(tiles[t_lo:t_hi].astype(np.int32)),
        data_sharding(mesh, 3))
    des = map_shards(lambda t: filter_streaks(t, sigma=(32, 32),
                                              wavelet="db4"), g_tiles)
    des_rows = rows(des).astype(np.uint16)
    stripe_total = int(D.all_gather(torch.tensor(
        [int(des_rows.astype(np.int64).sum())])).sum())

    # --- NCC maps: process_slice rows, all-gathered -----------------------
    mips_a = rng.random((n_dev, 48, 40)).astype(np.float32)
    mips_b = np.roll(mips_a, (2, -1), axis=(1, 2)) \
        + rng.normal(0, 0.01, (n_dev, 48, 40)).astype(np.float32)
    maps = _ncc_maps_sharded(mips_a, mips_b, 5, 5, mesh)

    # --- z-sharded RL: halos across the process boundary -------------------
    mesh_z = D.global_mesh(z_parallel=n_dev, local_devices=local)
    Z = n_dev * 6
    volz = rng.random((Z, 24, 24)).astype(np.float32) * 100
    z_lo, z_hi = D.process_slice(Z)
    g_volz = D.device_put_global(volz[z_lo:z_hi], z_sharding(mesh_z, 3))
    outz = richardson_lucy_sharded_z(g_volz, psf, mesh_z, niter=3)

    # --- stitch step 6: each process merges its own z slab -----------------
    from ipp_tpu_torch.geometry.stacks import TileGrid
    from ipp_tpu_torch.stitch.merge import merge_to_tif_series
    from tests.synth import cut_tiles, make_phantom, write_tile_grid

    shared = Path(args.out).parent
    raw = shared / "raw"
    if args.rank == 0:
        vol_m = make_phantom(np.random.default_rng(1), (6, 120, 120),
                             smooth=6.0)
        tiles_m, _ = cut_tiles(vol_m, 2, 2, (80, 80), 40, jitter=2,
                               rng=np.random.default_rng(1))
        raw.mkdir(parents=True, exist_ok=True)
        write_tile_grid(raw, tiles_m, overlap_nominal_px=40)
        (shared / "raw_ready").write_text("ok")
    else:
        for _ in range(600):
            if (shared / "raw_ready").exists():
                break
            time.sleep(0.1)
    merge_to_tif_series(TileGrid.from_directory(raw), shared / "merged",
                        cosine_blending=True)

    np.savez(args.out, decon=rows(dec), lo=lo, hi=hi, total=total,
             destripe=des_rows, t_lo=t_lo, t_hi=t_hi,
             stripe_total=stripe_total, ncc_maps=maps, zrl=rows(outz),
             zrl_lo=z_lo, zrl_hi=z_hi)
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
