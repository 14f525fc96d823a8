#!/usr/bin/env python3
"""The port's multi-GPU paths across several cards, each against one card.

    python3 scripts/mesh_bench.py

Needs two or more CUDA cards (exits 1 with fewer).  Builds the kernels,
then:

1. the deconvolution CLI on chip_smoke.py's phase-4 series (512 x 1024 x
   1024 u16 beads, the optics PSF, 10 iterations) in turns: one card, the
   mesh of every card, the mesh, one card.  Walls, the speed-up per card,
   the mesh's planes against one card's (max |diff|) and their K1-K4
   launch counts (equal);
2. richardson_lucy_sharded_z over a z mesh of every card (240-plane slabs
   of 248 x 248, a (256, 256, 256) work shape on the v2 walk) against the
   same slabs run one by one on card 0: max |diff| / max, warm times,
   launch counts (equal);
3. one process per card over NCCL (chip_smoke.mesh_processes): the NCC
   maps with their all-gather and z-sharded RL with halos across the
   processes, against one process on every card.

Every time is printed beside the card's name and power limit
(nvidia-smi); details go to chiprun_out/mesh_bench.json.  Exits non-zero
when a check fails.
"""

from __future__ import annotations

import json
import shutil
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def deconvolution_turns(torch, mesh, psf, work: Path, record, errors):
    import numpy as np

    from ipp_tpu_torch.ops import cuda_fft as cf
    from ipp_tpu_torch.pipeline import deconvolve as pdc

    src = work / "input"
    t0 = time.perf_counter()
    cs.make_series(torch, torch.device("cuda", 0), psf, src)
    cs.say(f"  series {cs.VOL_SHAPE} written in "
           f"{time.perf_counter() - t0:.1f} s")
    outs, counts, walls = {}, {}, {"one": [], "mesh": []}
    for i, kind in enumerate(("one", "mesh", "mesh", "one")):
        out = work / f"out_{i}"
        keep = kind not in outs   # the first run of each kind is compared
        cf.reset_launch_counts()
        wall, _ = cs.timed_cli(
            torch, mesh if kind == "mesh" else None, pdc.main,
            ["-i", str(src), "-o", str(out), "--niter", str(cs.NITER)],
            work / "unused" if keep else out)
        walls[kind].append(wall)
        if keep:
            outs[kind], counts[kind] = out, dict(cf.LAUNCHES)
    n_planes, diff, missing = cs.planes_max_diff(outs["mesh"], outs["one"],
                                                 "img_*.tif")
    one, on_mesh = float(np.mean(walls["one"])), float(np.mean(walls["mesh"]))
    n = mesh.size
    rec = record["deconvolve"] = dict(
        walls_s=walls, speedup=one / on_mesh,
        speedup_per_card=one / on_mesh / n, planes=n_planes, max_diff=diff,
        launches_equal=counts["one"] == counts["mesh"],
        launches=counts["mesh"])
    cs.say(f"  deconvolution CLI in turns: one card {walls['one']} s, mesh of "
           f"{n} {walls['mesh']} s: x{rec['speedup']:.2f}, "
           f"{rec['speedup_per_card']:.2f} per card ({cs.card_line()}); "
           f"{n_planes} planes, max |diff| {diff}; launches equal: "
           f"{rec['launches_equal']}")
    if missing or diff > 1 or not rec["launches_equal"]:
        errors.append(f"deconvolution: diff {diff}, missing {missing[:3]}, "
                      f"launches {counts}")
    shutil.rmtree(work, ignore_errors=True)


def sharded_z(torch, devices, record, errors):
    import numpy as np

    from ipp_tpu_torch.ops import cuda_fft as cf
    from ipp_tpu_torch.ops.deconv import (fft_shape_for,
                                          richardson_lucy_batched,
                                          richardson_lucy_sharded_z)
    from ipp_tpu_torch.ops.psf import gaussian_psf
    from ipp_tpu_torch.parallel.mesh import make_mesh

    n = len(devices)
    step, H, W = 240, 248, 248
    vol = (np.random.default_rng(11).random((step * n, H, W))
           * 1000).astype(np.float32)
    psf = gaussian_psf(*cs.MESH_PSF).astype(np.float32)
    psf = psf / psf.sum()
    halo = cs.MESH_PSF[0][0] // 2
    fshape = fft_shape_for((step + 2 * halo, H, W), psf.shape, None)
    zmesh = make_mesh(n, z_parallel=n, devices=devices)
    dev = torch.device(devices[0])

    def sharded():
        return richardson_lucy_sharded_z(vol, psf, zmesh, niter=cs.NITER)

    def serial():
        ref = torch.empty(vol.shape, device=dev)
        for i in range(n):
            z0, z1 = i * step, (i + 1) * step
            idx = np.clip(np.arange(z0 - halo, z1 + halo), 0, len(vol) - 1)
            ref[z0:z1] = richardson_lucy_batched(
                torch.from_numpy(vol[idx]).to(dev)[None], psf,
                niter=cs.NITER, fft_shape=fshape, edge_taper=True,
                device=dev)[0, halo:halo + step]
        return ref

    times, counts, outs = {}, {}, {}
    for name, fn in (("sharded", sharded), ("serial", serial),
                     ("sharded", sharded), ("serial", serial)):
        cf.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.setdefault(name, []).append(time.perf_counter() - t0)
        counts[name], outs[name] = dict(cf.LAUNCHES), out
    err = float((outs["sharded"].to(dev) - outs["serial"]).abs().max()
                / outs["serial"].abs().max())
    record["sharded_z"] = dict(shape=list(vol.shape), work_shape=fshape,
                               times_s=times, err_of_max=err,
                               launches_equal=counts["sharded"]
                               == counts["serial"])
    cs.say(f"  richardson_lucy_sharded_z {vol.shape} over {devices}, slabs "
           f"at {fshape}: {times['sharded']} s; one by one on {dev} "
           f"{times['serial']} s ({cs.card_line()}); max |diff| / max "
           f"{err:.2e}; launches equal: {counts['sharded'] == counts['serial']}")
    if not err <= 1e-5 or counts["sharded"] != counts["serial"]:
        errors.append(f"sharded_z: {err}, {counts}")


def main() -> int:
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        cs.say("FAIL: needs two or more CUDA cards")
        return 1
    from ipp_tpu_torch.ops._build import build_info, load_library
    from ipp_tpu_torch.ops.psf import make_psf
    from ipp_tpu_torch.parallel.mesh import make_mesh

    n = torch.cuda.device_count()
    devices = [f"cuda:{i}" for i in range(n)]
    cs.say(f"cards: {n} x {cs.card_line()}")
    load_library()
    cs.say(f"  built in {build_info()['seconds']:.1f} s")
    psf_xyz, _, _ = make_psf(dxy=406.0, dz=800.0)
    record, errors = {"cards": n, "card": cs.card_line()}, []
    work = ROOT / "build" / "mesh_bench"
    shutil.rmtree(work, ignore_errors=True)
    deconvolution_turns(torch, make_mesh(), psf_xyz.transpose(2, 1, 0),
                        work, record, errors)
    sharded_z(torch, devices, record, errors)
    record["processes"], errs = cs.mesh_processes(torch, devices,
                                                  work / "processes")
    cs.say(f"  ({cs.card_line()})")
    errors += errs
    shutil.rmtree(work, ignore_errors=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "mesh_bench.json").write_text(json.dumps(record, indent=1,
                                                    default=str))
    if errors:
        cs.say("FAIL: " + "; ".join(errors))
        return 1
    cs.say(json.dumps({"ok": True, "cards": n}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
