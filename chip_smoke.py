#!/usr/bin/env python3
"""Chip smoke test of ipp_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Phases:
1. build the CUDA kernels from ipp_tpu_torch/csrc with nvcc;
2. each kernel against its plain PyTorch version on the card, at the work
   shapes (256,256,256), (512,512,512), one with 768 axes, and the CLI's
   block shape; max |kernel - plain| / max |plain| must be <= 1e-5 (both
   f32); kernel and plain times by CUDA events after a warm call;
3. richardson_lucy on one (512,512,512) block (16-voxel halo, 9^3
   gaussian PSF, 10 iterations): the kernel walk against the torch.fft
   route, inner region within rtol=2e-3, atol=2e-1, and exact launch
   counts (K1 = 2n+1, K2 = 2n, K3 = 6n+2, K4 = 2n);
4. the deconvolution CLI end to end on a synthetic 512 x 1024 x 1024 u16
   TIFF series (PSF-blurred, Poisson-noised beads from a numpy seed,
   written by a minimal baseline TIFF writer here and read back through
   the port's TiffDirVolume): every block in the kernel domain and routed
   through the kernels, 512 u16 output planes, beads sharper than in the
   input, manifest complete.

The script exits non-zero when there is no CUDA device, when the port is
not beside it, or when any phase fails.  On success its last two lines
are the kernels' JSON record and {"ok": true, "device": {...}}.  Details
go to chiprun_out/chip_smoke.json; scratch data to build/chip_smoke/
(removed at the end).
"""

from __future__ import annotations

import json
import shutil
import struct
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
KERNELS = {
    "rdft_y_fwd": ("K1", "ipp_tpu/ops/pallas_fft.py:579"),
    "rdft_y_inv": ("K2", "ipp_tpu/ops/pallas_fft.py:604"),
    "radix2_stage": ("K3", "ipp_tpu/ops/pallas_fft.py:437"),
    "radix2_stage_inv_otf": ("K4", "ipp_tpu/ops/pallas_fft.py:208"),
}
SOURCE = "ipp_tpu_torch/csrc/fft_walk.cu"
NITER = 10
VOL_SHAPE = (512, 1024, 1024)  # the phase-4 series, z planes x y x x
N_BEADS = 4000


def say(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as exc:
        return f"nvidia-smi unavailable ({exc})"


def time_ms(torch, fn, reps: int = 5) -> float:
    """Mean ms per call over `reps` calls after one warm call."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


# -- phase 2 -----------------------------------------------------------------

def kernel_cases(torch, plan, rng, dev):
    """(kernel, variant, kernel_fn, plain_fn) for every variant on the
    walk, at this plan's work shape."""
    import numpy as np

    from ipp_tpu_torch.ops import cuda_fft as cf

    nz, ny, nx = plan.shape
    kp = plan.kp

    def t(*shape, lo=0.0, hi=1.0):
        a = rng.random(shape, dtype=np.float32) * (hi - lo) + lo
        return torch.from_numpy(a).to(dev)

    x, den, mul = t(nz, ny, nx), t(nz, ny, nx, lo=0.5), t(nz, ny, nx)
    sr, si = t(kp, nz, nx, lo=-1), t(kp, nz, nx, lo=-1)
    or_, oi = t(kp * nz, nx, lo=-1), t(kp * nz, nx, lo=-1)
    fz, iz = plan._z[True], plan._z[False]
    fx, ix = plan._x[True], plan._x[False]
    r2, i2 = sr.view(-1, nx), si.view(-1, nx)
    return [
        ("rdft_y_fwd", "plain", lambda: cf.rdft_y_fwd(x, plan._rfwd),
         lambda: cf.rdft_y_fwd_plain(x, plan._rfwd)),
        ("rdft_y_fwd", "ratio", lambda: cf.rdft_y_fwd(x, plan._rfwd, den),
         lambda: cf.rdft_y_fwd_plain(x, plan._rfwd, den)),
        ("rdft_y_inv", "plain", lambda: cf.rdft_y_inv(sr, si, plan._rinv),
         lambda: cf.rdft_y_inv_plain(sr, si, plan._rinv)),
        ("rdft_y_inv", "mul", lambda: cf.rdft_y_inv(sr, si, plan._rinv, mul),
         lambda: cf.rdft_y_inv_plain(sr, si, plan._rinv, mul)),
        ("radix2_stage", "fwd_z", lambda: cf.radix2_stage(sr, si, *fz, True, 1),
         lambda: cf.radix2_stage_plain(sr, si, *fz, True, 1)),
        ("radix2_stage", "fwd_x", lambda: cf.radix2_stage(r2, i2, *fx, True, -1),
         lambda: cf.radix2_stage_plain(r2, i2, *fx, True, -1)),
        ("radix2_stage", "inv_z", lambda: cf.radix2_stage(sr, si, *iz, False, 1),
         lambda: cf.radix2_stage_plain(sr, si, *iz, False, 1)),
        ("radix2_stage_inv_otf", "otf",
         lambda: cf.radix2_stage_inv_otf(r2, i2, or_, oi, *ix, False),
         lambda: cf.radix2_stage_inv_otf_plain(r2, i2, or_, oi, *ix, False)),
        ("radix2_stage_inv_otf", "conj",
         lambda: cf.radix2_stage_inv_otf(r2, i2, or_, oi, *ix, True),
         lambda: cf.radix2_stage_inv_otf_plain(r2, i2, or_, oi, *ix, True)),
    ]


def phase_kernels(torch, dev, shapes, record):
    import numpy as np

    from ipp_tpu_torch.ops.matmul_fft import MatmulFFT3

    rng = np.random.default_rng(2)
    rows, bad = [], []
    for shape in shapes:
        plan = MatmulFFT3(shape, dev)
        for name, variant, kfn, pfn in kernel_cases(torch, plan, rng, dev):
            got, ref = kfn(), pfn()
            torch.cuda.synchronize()
            got = got if isinstance(got, tuple) else (got,)
            ref = ref if isinstance(ref, tuple) else (ref,)
            abs_err = max(float((g - r).abs().max()) for g, r in zip(got, ref))
            scale = max(float(r.abs().max()) for r in ref)
            rel = abs_err / max(scale, 1e-30)
            reps = 3 if np.prod(shape) > 2 ** 27 else 5
            ms, plain_ms = time_ms(torch, kfn, reps), time_ms(torch, pfn, reps)
            row = dict(kernel=name, variant=variant, shape=list(shape),
                       max_abs_err=abs_err, rel_err=rel, ms=ms,
                       plain_ms=plain_ms)
            rows.append(row)
            say(f"  {KERNELS[name][0]} {name:<22s} {variant:<6s} "
                f"{str(shape):<18s} rel {rel:.2e} abs {abs_err:.2e}  "
                f"kernel {ms:9.3f} ms  plain {plain_ms:9.3f} ms")
            if not rel <= 1e-5:
                bad.append(f"{name}/{variant} at {shape}: rel {rel:.3e}")
            del got, ref
        del plan
        torch.cuda.empty_cache()
    record["kernels"] = rows
    if bad:
        raise AssertionError("kernel != plain: " + "; ".join(bad))


# -- phase 3 -----------------------------------------------------------------

def phase_rl_block(torch, dev, record):
    import numpy as np

    from ipp_tpu_torch.ops import cuda_fft as cf
    from ipp_tpu_torch.ops.deconv import richardson_lucy
    from ipp_tpu_torch.ops.psf import gaussian_psf

    shape, halo = (512, 512, 512), 16
    rng = np.random.default_rng(0)
    vol = torch.from_numpy(rng.random(shape, dtype=np.float32) * 1000).to(dev)
    psf = torch.from_numpy(gaussian_psf((9, 9, 9), (2.0, 2.0, 2.0))).to(dev)

    def run(route):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = richardson_lucy(vol, psf, niter=NITER, fft_shape=shape,
                              route=route)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    cf.reset_launch_counts()
    walk, t_walk0 = run(None)
    counts = dict(cf.LAUNCHES)
    want = {"rdft_y_fwd": 2 * NITER + 1, "rdft_y_inv": 2 * NITER,
            "radix2_stage": 6 * NITER + 2, "radix2_stage_inv_otf": 2 * NITER}
    fft, t_fft0 = run("fft")
    _, t_walk = run(None)
    _, t_fft = run("fft")
    inner = (slice(halo, -halo),) * 3
    a, b = walk[inner], fft[inner]
    excess = float(((a - b).abs() - (0.2 + 2e-3 * b.abs())).max())
    rel = float((a - b).abs().max() / b.abs().max())
    core = float(np.prod([s - 2 * halo for s in shape]))
    record["rl_block"] = dict(
        shape=list(shape), halo=halo, niter=NITER, launches=counts,
        walk_s=t_walk, fft_s=t_fft, walk_first_s=t_walk0,
        fft_first_s=t_fft0, walk_core_mvox_s=core / t_walk / 1e6,
        fft_core_mvox_s=core / t_fft / 1e6, max_rel_diff=rel,
        tol_excess=excess)
    say(f"  launches {counts}")
    say(f"  walk {t_walk:.3f} s/block ({core / t_walk / 1e6:.1f} core Mvox/s)"
        f", torch.fft {t_fft:.3f} s/block ({core / t_fft / 1e6:.1f}); "
        f"max |walk-fft|/max|fft| {rel:.2e}, tolerance excess {excess:.3e}")
    if counts != want:
        raise AssertionError(f"launch counts {counts} != {want}")
    if not excess <= 0:
        raise AssertionError("walk vs torch.fft outside rtol=2e-3, atol=2e-1")
    if not bool(torch.isfinite(walk).all()):
        raise AssertionError("non-finite RL output")


# -- phase 4 -----------------------------------------------------------------

def bead_widths(vol, beads, r=8):
    """Equivalent width (area / peak above the local floor) of each bead's
    x profile; smaller is sharper."""
    import numpy as np

    widths = []
    for z, y, x in beads:
        p = vol[z, y, x - r:x + r + 1].astype(np.float64)
        p = p - min(p[0], p[-1])
        peak = p[r]
        if peak > 0:
            widths.append(np.clip(p, 0, None).sum() / peak)
    return np.asarray(widths)


def write_u16_tiff(path: Path, plane) -> None:
    """One uncompressed, single-strip, little-endian baseline TIFF of a
    2-D u16 plane."""
    h, w = plane.shape
    n_tags = 10
    data_off = 8 + 2 + 12 * n_tags + 4
    tags = [(256, 4, w), (257, 4, h), (258, 3, 16), (259, 3, 1),
            (262, 3, 1), (273, 4, data_off), (277, 3, 1), (278, 4, h),
            (279, 4, h * w * 2), (339, 3, 1)]
    ifd = struct.pack("<H", n_tags) + b"".join(
        struct.pack("<HHII", tag, typ, 1, val) for tag, typ, val in tags)
    with open(path, "wb") as f:
        f.write(b"II" + struct.pack("<HI", 42, 8) + ifd
                + struct.pack("<I", 0))
        f.write(plane.astype("<u2", copy=False).tobytes())


def make_series(torch, dev, psf_zyx, out_dir, seed=7):
    """Synthetic bead phantom, blurred by the PSF with torch.fft on the
    card, Poisson-noised, written as z-plane u16 TIFFs."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    shape = VOL_SHAPE
    rng = np.random.default_rng(seed)
    beads = np.stack([rng.integers(32, s - 32, N_BEADS) for s in shape], 1)
    truth = torch.full(shape, 100.0, device=dev)
    amp = torch.from_numpy(rng.uniform(20000, 40000, N_BEADS).astype(np.float32))
    idx = torch.from_numpy(beads).to(dev)
    truth[idx[:, 0], idx[:, 1], idx[:, 2]] += amp.to(dev)
    psf = torch.from_numpy(np.ascontiguousarray(psf_zyx, np.float32)).to(dev)
    pad = torch.zeros(shape, device=dev)
    pad[tuple(slice(0, s) for s in psf.shape)] = psf
    pad = torch.roll(pad, tuple(-(s // 2) for s in psf.shape), (0, 1, 2))
    spec = torch.fft.rfftn(truth)
    del truth
    spec *= torch.fft.rfftn(pad)
    del pad
    blurred = torch.fft.irfftn(spec, s=shape).clamp_(min=0)
    del spec
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    noisy = torch.poisson(blurred, generator=gen).clamp_(0, 65535)
    del blurred
    host = noisy.to(torch.int32).cpu().numpy().astype(np.uint16)
    del noisy
    out_dir.mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(8) as pool:
        futs = [pool.submit(write_u16_tiff, out_dir / f"img_{z:06d}.tif",
                            host[z]) for z in range(shape[0])]
        for f in futs:
            f.result()
    return host, beads


def phase_cli(torch, dev, psf_zyx, record):
    import numpy as np

    from ipp_tpu_torch.ops import cuda_fft as cf
    from ipp_tpu_torch.ops.matmul_fft import in_kernel_domain
    from ipp_tpu_torch.pipeline import deconvolve as pdc

    work = ROOT / "build" / "chip_smoke"
    shutil.rmtree(work, ignore_errors=True)
    src, dst = work / "input", work / "output"
    t0 = time.perf_counter()
    host, beads = make_series(torch, dev, psf_zyx, src)
    t_data = time.perf_counter() - t0
    vol_shape = host.shape
    plans, halo, planned = pdc.autosplit(vol_shape, psf_zyx.shape,
                                         strict_accuracy=True,
                                         kernel_domain=True)
    fft_shape = pdc._fft_shape_for_backend(
        pdc.fft_work_shape(plans, halo, planned))
    nb = len(plans)
    say(f"  input {vol_shape} u16 written in {t_data:.1f} s; plan: {nb} "
        f"blocks, halo {halo}, work shape {fft_shape}")
    if not in_kernel_domain(fft_shape):
        raise AssertionError(f"work shape {fft_shape} outside kernel domain")
    torch.cuda.reset_peak_memory_stats()
    cf.reset_launch_counts()
    t0 = time.perf_counter()
    rc = pdc.main(["-i", str(src), "-o", str(dst), "--niter", str(NITER)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(cf.LAUNCHES)
    vox = float(np.prod(vol_shape))
    record["cli"] = dict(
        vol_shape=list(vol_shape), n_blocks=nb, halo=list(halo),
        work_shape=list(fft_shape), wall_s=wall, data_s=t_data,
        core_mvox_s=vox / wall / 1e6, launches=counts,
        peak_mem_bytes=torch.cuda.max_memory_allocated())
    say(f"  CLI rc {rc}: {nb} blocks in {wall:.1f} s, "
        f"{vox / wall / 1e6:.2f} core Mvox/s; launches {counts}")
    want = {"rdft_y_fwd": nb * (2 * NITER + 1), "rdft_y_inv": nb * 2 * NITER,
            "radix2_stage": nb * (6 * NITER + 2),
            "radix2_stage_inv_otf": nb * 2 * NITER}
    if rc != 0 or counts != want:
        raise AssertionError(f"not every block ran the kernel walk: "
                             f"{counts} != {want}")
    outs = sorted(dst.glob("img_*.tif"))
    if len(outs) != vol_shape[0]:
        raise AssertionError(f"{len(outs)} output planes, want {vol_shape[0]}")
    man = json.loads((dst / "blocks_manifest.json").read_text())
    if (man.get("n_blocks") != nb or len(man.get("quant", {})) != nb
            or "finished" not in man):
        raise AssertionError("manifest incomplete")
    out = pdc.TiffDirVolume(dst).read_block(
        tuple((0, s) for s in vol_shape))
    if out.dtype != np.uint16 or out.shape != vol_shape:
        raise AssertionError(f"output {out.dtype} {out.shape}")
    w_in = float(np.median(bead_widths(host, beads)))
    w_out = float(np.median(bead_widths(out, beads)))
    record["cli"].update(bead_width_in=w_in, bead_width_out=w_out)
    say(f"  bead equivalent width (x, voxels, median of {len(beads)}): "
        f"input {w_in:.3f}, output {w_out:.3f}")
    if not w_out < w_in:
        raise AssertionError("beads are not sharper than in the input")
    shutil.rmtree(work, ignore_errors=True)


# -- main ---------------------------------------------------------------------

def main() -> int:
    try:
        import torch
    except ImportError:
        say("FAIL: torch is not installed")
        return 1
    if not torch.cuda.is_available():
        say("FAIL: no CUDA device (torch.cuda.is_available() is false)")
        return 1
    if not (ROOT / "ipp_tpu_torch" / "__init__.py").exists():
        say(f"FAIL: the ipp_tpu_torch package is not beside {__file__}")
        return 1
    sys.path.insert(0, str(ROOT))
    import ipp_tpu_torch  # noqa: F401
    from ipp_tpu_torch.ops import cuda_fft as cf
    from ipp_tpu_torch.ops._build import build_info, load_library
    from ipp_tpu_torch.ops.psf import make_psf

    say(f"card: {card_line()}")
    dev = torch.device("cuda", 0)
    say(f"torch {torch.__version__} cuda {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    record, failed = {"card": card_line()}, []

    def phase(num, title, fn, *a):
        say(f"phase {num}: {title}")
        t0 = time.perf_counter()
        try:
            fn(*a)
            say(f"phase {num}: ok in {time.perf_counter() - t0:.1f} s")
        except Exception:  # noqa: BLE001 — report every phase, then fail
            traceback.print_exc(file=sys.stdout)
            say(f"phase {num}: FAILED after {time.perf_counter() - t0:.1f} s")
            failed.append(num)
        record.setdefault("phase_s", {})[num] = time.perf_counter() - t0

    def build():
        load_library()
        info = build_info()
        say(f"  built {info['path']} in {info['seconds']:.1f} s")
        for line in info["ptxas"].splitlines():
            if "registers" in line or "spill" in line:
                say(f"  {line.strip()}")
        record["build"] = info

    phase(1, "build the CUDA kernels", build)
    if 1 in failed:
        return 1
    psf_xyz, _, _ = make_psf(dxy=406.0, dz=800.0)
    psf = psf_xyz.transpose(2, 1, 0)
    from ipp_tpu_torch.pipeline import deconvolve as pdc

    plans, halo, planned = pdc.autosplit(VOL_SHAPE, psf.shape,
                                         strict_accuracy=True,
                                         kernel_domain=True)
    cli_shape = pdc._fft_shape_for_backend(
        pdc.fft_work_shape(plans, halo, planned))
    shapes = [(256, 256, 256), (512, 512, 512), (768, 256, 768)]
    if tuple(cli_shape) not in shapes:
        shapes.append(tuple(cli_shape))
    phase(2, f"kernels vs plain at {shapes}", phase_kernels, torch, dev,
          shapes, record)
    phase(3, "richardson_lucy (512,512,512): walk vs torch.fft",
          phase_rl_block, torch, dev, record)
    phase(4, f"CLI on a {VOL_SHAPE} u16 series", phase_cli, torch, dev, psf,
          record)
    record["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    say(f"torch.cuda.max_memory_allocated {record['max_memory_allocated']}")
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(record, indent=1,
                                                        default=str))
    if "jax" in sys.modules:
        say("FAIL: jax was imported")
        failed.append("jax")
    if failed:
        say(f"FAIL: phases {failed}")
        return 1
    main_shape = list(cli_shape)
    kernels = []
    for name, (tag, replaces) in KERNELS.items():
        rows = [r for r in record["kernels"] if r["kernel"] == name]
        at = [r for r in rows if r["shape"] == main_shape][0]
        kernels.append(dict(
            name=f"{tag} {name}", route="cuda", source=SOURCE,
            replaces=replaces, launches=record["cli"]["launches"][name],
            max_abs_err=max(r["max_abs_err"] for r in rows),
            ms=at["ms"], plain_ms=at["plain_ms"]))
    if any(k["launches"] == 0 for k in kernels):
        say("FAIL: a kernel of the path was never launched")
        return 1
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
