"""Volume deconvolution CLI on one GPU or a device mesh (port of
ipp_tpu/pipeline/deconvolve.py: BlockPlan, autosplit, _check_block_coverage,
fft_work_shape, TiffDirVolume, _uniform_shape, _fft_shape_for_backend,
_pad_symmetric_safe, read_block_uniform, _block_stats, deconvolve_volume
with its single-device and data-parallel branches, build_parser and
main).

Blocks are overlap-save: the FFT work shape equals the halo-padded block
shape, circular wraparound lands in the discarded halo (4x the PSF
half-extent).  Per block, on the device: u16 upload, optional gaussian
prefilter, dark subtraction, Richardson-Lucy (with `--adaptive-psf` the
blind-Wiener RL, `richardson_lucy_wiener`, each block from the given
PSF, as the reference), crop to the core and u16
quantisation with the block's range (with `--destripe-sigma`: the
z-destripe of each xz slice through `filter_streaks`, db9, and f32
bricks, as the reference); then the brick cache (manifest written before
the brick) and plane-streamed reassembly.  With more than one CUDA
device (or an explicit mesh) blocks go in batches of `--batch-blocks`
(default: one per device) split over the mesh's devices, each running the
same per-block chain from its own thread (the reference's LsDeconv
per-GPU block work, LsDeconv.m:644-706); bricks drain in block order.
Bricks and `blocks_manifest.json` keep the reference's format, so either
package can `--resume` a run of the other.

The block planner ranks candidates by padded voxels per core voxel of the
volume; on CUDA, shapes outside the kernel walk's domain rank after those
inside it.  (The reference's `_block_cost` table is a TPU calibration and
is not used.)
"""

from __future__ import annotations

import json
import math
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..io import tiff as tio
from ..ops.fftutil import next_fast_len
from ..ops.matmul_fft import in_kernel_domain
from ..utils.device import resolve_device
from ..utils.lagged import OneInFlight
from ..utils.log import Logger
from ..utils.progress import ProgressReporter
from ..utils.transfer import HostArray, upload

__all__ = ["BlockPlan", "autosplit", "deconvolve_volume", "build_parser",
           "main"]

MAX_BLOCK_ELEMS = 1290 ** 3  # reference limit (LsDeconv.m:312-315)
MAX_BLOCK_DIM = 1281


@dataclass
class BlockPlan:
    """One block: core extent [z0:z1, y0:y1, x0:x1] plus halo sizes."""

    index: int
    core: Tuple[Tuple[int, int], Tuple[int, int], Tuple[int, int]]
    halo: Tuple[int, int, int]

    def padded_bounds(self, vol_shape) -> List[Tuple[int, int]]:
        out = []
        for (lo, hi), h, n in zip(self.core, self.halo, vol_shape):
            out.append((max(0, lo - h), min(n, hi + h)))
        return out


def _axis_candidates(n: int, h: int, max_dim: int) -> List[int]:
    """Padded-size candidates for one axis: multiples of 128 up to the
    axis' whole extent, the minimal whole-axis size, and a coarse sub-128
    grid for small volumes/budgets."""
    whole = -(-(n + 2 * h) // 8) * 8
    top = min(max(whole + 127, 128), max_dim)
    cands = {min(whole, max_dim)}
    for p in range(128, top + 1, 128):
        if p - 2 * h >= 8:
            cands.add(p)
    for p in range(16, min(whole, 128), 16):
        if p - 2 * h >= 4:
            cands.add(p)
    return sorted(cands)


def autosplit(vol_shape: Tuple[int, int, int], psf_shape: Tuple[int, int, int],
              max_block_elems: int = 160 * 2 ** 20,
              strict_accuracy: bool = False, kernel_domain: bool = False):
    """Split a volume into overlap-save blocks; returns (plans, halo,
    planned_padded_shape).

    Reference role: autosplit + split_stack (LsDeconv.m:308-385).  The
    halo ladder and strict gate are the reference's; the cost is the
    total padded voxels of the tiling.  With `kernel_domain` (the CUDA
    device), shapes the kernel walk takes rank before all others."""
    max_block_elems = min(max_block_elems, MAX_BLOCK_ELEMS)

    def search(halo):
        cands = [_axis_candidates(n, h, MAX_BLOCK_DIM)
                 for n, h in zip(vol_shape, halo)]
        best, best_cost = None, None
        for pz in cands[0]:
            for py in cands[1]:
                for px in cands[2]:
                    if pz * py * px > max_block_elems:
                        continue
                    padded = (pz, py, px)
                    cores = [max(1, p - 2 * h)
                             for p, h in zip(padded, halo)]
                    nblocks = int(np.prod(
                        [math.ceil(n / c) for n, c in zip(vol_shape, cores)]))
                    cost = (kernel_domain and not in_kernel_domain(padded),
                            nblocks * pz * py * px)
                    if best_cost is None or cost < best_cost:
                        best, best_cost = padded, cost
        return best

    # halo ladder: prefer 4x the PSF half-extent (wrap error < 1e-4); under
    # tight block budgets step down toward the reference's psf/2 minimum
    best = halo = fallback = None
    chosen_m = 4
    for m in (4, 3, 2, 1):
        halo_m = tuple(max((p // 2) * m, 8 if m >= 4 else 1, 1)
                       for p in psf_shape)
        cand = search(halo_m)
        if cand is None:
            continue
        cores_ok = all(max(1, p - 2 * h) >= 2 * h
                       for p, h in zip(cand, halo_m))
        if cores_ok or m == 1:
            best, halo, chosen_m = cand, halo_m, m
            break
        if fallback is None:
            fallback = (cand, halo_m, m)  # feasible but core-starved
    if best is None and fallback is not None:
        best, halo, chosen_m = fallback
    if best is None:  # budget smaller than any candidate: minimal split
        halo = tuple(max(p // 2, 1) for p in psf_shape)
        best = tuple(min(16, -(-n // 8) * 8) for n in vol_shape)
        chosen_m = 1
    if chosen_m < 4:
        msg = (
            f"decon block budget forced the overlap-save halo down to "
            f"{chosen_m}x the PSF half-extent ({halo}); wraparound error "
            f"in core voxels grows beyond the <1e-4 NRMSE of the 4x halo. "
            f"Raise --max-block-mvox to restore the full halo.")
        # strict gate: a halo of <=2x the PSF half-extent measures >=2e-3
        # core NRMSE, beyond the 1e-3 output tolerance
        if strict_accuracy and chosen_m <= 2:
            raise ValueError(
                msg + " (strict accuracy mode: refusing to run beyond the "
                "1e-3 NRMSE budget; pass --no-strict-accuracy to override)")
        import warnings

        warnings.warn(msg, stacklevel=2)
    cores = [max(1, p - 2 * h) for p, h in zip(best, halo)]
    plans = []
    idx = 0
    for iz in range(math.ceil(vol_shape[0] / cores[0])):
        for iy in range(math.ceil(vol_shape[1] / cores[1])):
            for ix in range(math.ceil(vol_shape[2] / cores[2])):
                core = []
                for ax, i in zip(range(3), (iz, iy, ix)):
                    lo = i * cores[ax]
                    hi = min((i + 1) * cores[ax], vol_shape[ax])
                    core.append((lo, hi))
                if all(hi > lo for lo, hi in core):
                    plans.append(BlockPlan(idx, tuple(core), halo))
                    idx += 1
    _check_block_coverage(plans, vol_shape)
    return plans, halo, tuple(best)


def _check_block_coverage(plans: List[BlockPlan], vol_shape) -> None:
    """Block cores must tile the volume exactly (the reference's
    check_block_coverage_planes, LsDeconv.m:421), checked per axis as
    interval chains."""
    per_axis = [sorted({p.core[ax] for p in plans}) for ax in range(3)]
    for ax, ivs in enumerate(per_axis):
        pos = 0
        for lo, hi in ivs:
            if lo != pos or hi <= lo:
                raise AssertionError(
                    f"decon block plan leaves axis {ax} uncovered or "
                    f"overlapped at {pos} (next core [{lo}, {hi}))")
            pos = hi
        if pos != vol_shape[ax]:
            raise AssertionError(
                f"decon block plan covers axis {ax} to {pos} of "
                f"{vol_shape[ax]}")
    expected = int(np.prod([len(ivs) for ivs in per_axis]))
    unique = {p.core for p in plans}
    if len(plans) != expected or len(unique) != expected:
        raise AssertionError(
            f"decon block plan grid is ragged: {len(plans)} blocks "
            f"({len(unique)} unique) for a "
            f"{'x'.join(str(len(i)) for i in per_axis)} core grid")


def fft_work_shape(plans: List[BlockPlan], halo,
                   planned=None) -> Tuple[int, int, int]:
    """Overlap-save FFT shape: the tight uniform padded block shape, except
    that a planned 256-multiple axis is kept when the volume is smaller
    (it keeps the axis inside the kernel walk's domain)."""
    tight = _uniform_shape(plans, halo)
    if planned is None:
        return tight
    return tuple(p if (p % 256 == 0 and p > t) else t
                 for p, t in zip(planned, tight))


class TiffDirVolume:
    """z-indexed TIFF directory as a random-access (D, H, W) volume
    (reference load_bl_tif.cpp role)."""

    def __init__(self, directory: Path):
        self.dir = Path(directory)
        self.paths = sorted(p for p in self.dir.iterdir()
                            if p.suffix.lower() in (".tif", ".tiff"))
        if not self.paths:
            raise FileNotFoundError(f"no TIFFs in {directory}")
        first = tio.imread(self.paths[0])
        self.plane_shape = first.shape
        self.dtype = first.dtype
        self._cache = {0: first}

    @property
    def shape(self):
        return (len(self.paths),) + tuple(self.plane_shape)

    def read_block(self, bounds) -> np.ndarray:
        (z0, z1), (y0, y1), (x0, x1) = bounds
        from .. import native

        # keep the native dtype: uploading u16 halves the host->device
        # traffic; the device converts to f32
        block = native.read_block(self.paths[z0:z1], y0, y1, x0, x1,
                                  dtype=self.dtype)
        if block is not None:
            return block
        out = np.empty((z1 - z0, y1 - y0, x1 - x0), self.dtype)
        for i, z in enumerate(range(z0, z1)):
            plane = self._cache.get(z)
            if plane is None:
                plane = tio.imread(self.paths[z])
            out[i] = plane[y0:y1, x0:x1]
        return out


def _uniform_shape(plans: List[BlockPlan], halo) -> Tuple[int, int, int]:
    """One padded shape all blocks share (core max + 2*halo per axis,
    rounded to multiples of 8).  This is the overlap-save FFT shape."""
    return tuple(
        -(-(max(hi - lo for p in plans for (lo, hi) in [p.core[a]])
            + 2 * halo[a]) // 8) * 8
        for a in range(3))


def _fft_shape_for_backend(uni):
    """The uniform block shape where the v2 walk takes it, inside its
    domain (any such size works; wraparound lands in the halo); otherwise
    2,3,5,7-smooth sizes for torch.fft, as the reference's XLA backend
    (deconvolve.py:349-359).  One rule on every device."""
    if in_kernel_domain(uni):
        return tuple(uni)
    return tuple(next_fast_len(int(u)) for u in uni)


def _pad_symmetric_safe(a: np.ndarray, pads) -> np.ndarray:
    """np.pad(mode='symmetric') in rounds: numpy caps each round's pad at
    the current size, so halos wider than a thin edge block mirror-tile."""
    pads = [list(p) for p in pads]
    while True:
        cur = [(min(p[0], a.shape[i]), min(p[1], a.shape[i]))
               for i, p in enumerate(pads)]
        if all(c == (0, 0) for c in cur):
            return a
        a = np.pad(a, cur, mode="symmetric")
        for p, c in zip(pads, cur):
            p[0] -= c[0]
            p[1] -= c[1]


def read_block_uniform(vol, plan: BlockPlan, uni_shape) -> np.ndarray:
    """Read a plan's halo-padded block and symmetric-pad it to the uniform
    shape (the reference's symmetric edge pad, LsDeconv.m:877-898); the
    core always lands at offset `halo`."""
    bounds = plan.padded_bounds(vol.shape)
    block = vol.read_block(bounds)
    pads = []
    for (lo, hi), h, (b0, b1), u in zip(plan.core, plan.halo, bounds,
                                        uni_shape):
        pre = h - (lo - b0)
        pads.append((pre, u - pre - (b1 - b0)))
    if any(p != (0, 0) for p in pads):
        block = _pad_symmetric_safe(block, pads)
    return block


def _block_stats(core: np.ndarray, clip_percentile: float):
    """Per-block rescale percentiles (reference deconvolved_stats,
    LsDeconv.m:1300-1304): [100-clipval, clipval]."""
    lb, ub = np.percentile(core, [100.0 - clip_percentile, clip_percentile])
    return float(lb), float(ub)


def _crop(dec: torch.Tensor, halo, uni_shape) -> torch.Tensor:
    """The uniform max core of a block (the halo never leaves the device)."""
    return dec[tuple(slice(h, h + (u - 2 * h))
                     for h, u in zip(halo, uni_shape))]


def _finish(core: torch.Tensor):
    """Quantise a core to u16 with its range (halves the transfer and the
    brick IO); returns (u16 codes, as int32 on the device, [qmin, qmax])."""
    qmin, qmax = torch.min(core), torch.max(core)
    s = 65535.0 / torch.clamp(qmax - qmin, min=1e-30)
    q = torch.clamp(torch.round((core - qmin) * s), 0, 65535).to(torch.int32)
    return q, torch.stack([qmin, qmax])


def _block_chain(block: np.ndarray, dev: torch.device, psf_t, *,
                 gaussian_sigma, dark, adaptive_psf, niter, lam,
                 stop_criterion, regularize_interval, fft_shape, classic_rl,
                 halo, uni, destripe_sigma, core_size):
    """One uniform block through the device chain on `dev`: upload,
    prefilter, dark, RL (or the blind-Wiener RL), crop to the core and
    u16 quantisation (with `destripe_sigma`: the z-destripe and f32).
    Returns the `HostArray` handles (codes, [qmin, qmax]) or (f32 core,
    None)."""
    from ..ops.deconv import gauss3d, richardson_lucy, richardson_lucy_wiener
    from ..ops.destripe import filter_streaks

    if block.dtype != np.uint16:  # any other type as f32
        block = np.asarray(block, np.float32)
    x = upload(block, dev).to(torch.float32)
    if gaussian_sigma is not None:
        x = gauss3d(x, gaussian_sigma)
    if dark > 0:
        x = torch.clamp(x - dark, min=0.0)
    if adaptive_psf:
        dec, _ = richardson_lucy_wiener(
            x, psf_t, niter=niter, lam=lam,
            regularize_interval=regularize_interval, fft_shape=fft_shape)
    else:
        dec = richardson_lucy(
            x, psf_t, niter=niter, lam=lam, stop_criterion=stop_criterion,
            regularize_interval=regularize_interval, fft_shape=fft_shape,
            classic=classic_rl)
    core = _crop(dec, halo, uni)
    if destripe_sigma:
        # z-destripe each xz slice of the block's own core (reference
        # filter_subband_3d_z.m), before the range is final: f32 goes
        # back, no quantisation
        sz = core_size
        core = filter_streaks(
            core[:sz[0], :sz[1], :sz[2]].permute(1, 0, 2),
            sigma=(destripe_sigma, destripe_sigma),
            wavelet="db9").permute(1, 0, 2)
        return HostArray(core.contiguous()), None
    q, mm = _finish(core)
    return HostArray(q), HostArray(mm)


def deconvolve_volume(
    input_dir,
    output_dir,
    psf: np.ndarray,
    niter: int = 10,
    lam: float = 0.0,
    stop_criterion: float = 0.0,
    regularize_interval: int = 0,
    gaussian_sigma: Optional[Tuple[float, float, float]] = None,
    dark: float = 0.0,
    destripe_sigma: Optional[float] = None,
    out_dtype=np.uint16,
    amplification: float = 1.0,
    clip_percentile: float = 99.999,
    batch_blocks: Optional[int] = None,
    max_block_elems: int = 160 * 2 ** 20,
    resume: bool = False,
    classic_rl: bool = True,
    mesh=None,
    strict_accuracy: bool = True,
    adaptive_psf: bool = False,
    cache_dir=None,
    start_block: int = 0,
    dry_run: bool = False,
    log: Optional[Logger] = None,
    device=None,
) -> Path:
    """End-to-end volume deconvolution (the LsDeconv CLI semantics).

    A mesh (`parallel.mesh.Mesh`; when neither `mesh` nor `device` is
    given, that of `parallel.mesh.default_mesh()`, every card when there
    are several; mesh=False for none) runs data-parallel batches of
    `batch_blocks` blocks (default and minimum: one per "data" entry,
    rounded to a multiple of it; a "z" axis folds into "data"), each
    device running the single-block chain on its share from its own
    thread.  Without one, the blocks run on `device` (else the resolved
    one), in batches of `batch_blocks` (default 1).  `adaptive_psf` runs
    on one device and refuses an explicit mesh (ValueError), as the
    reference."""
    from ..parallel import mesh as _mesh

    if mesh is not None and mesh is not False:
        if adaptive_psf:  # the reference's guard (deconvolve.py:460-463)
            raise ValueError(
                "adaptive_psf runs the per-block blind-Wiener path and "
                "cannot combine with an explicit multi-device mesh; pass "
                "mesh=None")
        _mesh.check_mesh(mesh)
    dev = resolve_device(device)
    if mesh is None and device is None and not adaptive_psf:
        mesh = _mesh.default_mesh()[0]   # every card when there are several
    use_mesh = isinstance(mesh, _mesh.Mesh) and mesh.size > 1
    if use_mesh:
        if mesh.shape["z"] > 1:
            # blocks are autosplit to fit one device: the pipeline is pure
            # data parallelism, so a "z" axis folds into "data" (intra-
            # block z splitting is ops.deconv.richardson_lucy_sharded_z)
            mesh = _mesh.make_mesh(devices=list(mesh.devices.flat))
        dev = mesh.devices[0, 0]
    log = log or Logger()
    vol = TiffDirVolume(input_dir)
    output_dir = Path(output_dir)
    brick_dir = (Path(cache_dir) if cache_dir is not None
                 else output_dir / "bricks")
    brick_dir.mkdir(parents=True, exist_ok=True)
    output_dir.mkdir(parents=True, exist_ok=True)
    plans, halo, planned = autosplit(vol.shape, psf.shape, max_block_elems,
                                     strict_accuracy=strict_accuracy,
                                     kernel_domain=dev.type == "cuda")
    if dry_run:
        log.info(f"DRY RUN: volume {vol.shape}, {len(plans)} blocks, "
                 f"halo {halo}, work shape {planned}")
        for p_ in plans:
            log.info(f"  block {p_.index:05d}: core {p_.core}")
        return output_dir
    log.info(f"volume {vol.shape} -> {len(plans)} blocks, halo {halo}, "
             + (f"mesh {mesh.shape}" if use_mesh
                else f"single device ({dev})"))

    manifest_path = output_dir / "blocks_manifest.json"
    stats = {"min": float("inf"), "max": float("-inf")}
    quant = {}  # brick index -> [qmin, qmax] of its u16 codes
    if (resume or start_block > 0) and manifest_path.exists():
        # earlier blocks came from a previous run: their stats/quant
        # entries must survive this run's manifest writes
        old = json.loads(manifest_path.read_text())
        stats = old.get("stats", stats)
        quant = old.get("quant", quant)

    prog = ProgressReporter(len(plans), desc="decon blocks")
    psf_t = torch.from_numpy(np.array(psf, np.float32)).to(dev)
    todo = [p_ for p_ in plans
            if p_.index >= max(0, start_block)
            and not (resume and
                     (brick_dir / f"block_{p_.index:05d}.npy").exists())]
    for _ in range(len(plans) - len(todo)):
        prog.step()

    manifest_lock = threading.Lock()   # the drains run on host workers

    def save_core(plan: BlockPlan, core: np.ndarray, qrange):
        if qrange is not None:
            qmin, qmax = float(qrange[0]), float(qrange[1])
            lb, ub = np.percentile(core, [100.0 - clip_percentile,
                                          clip_percentile])
            s = (qmax - qmin) / 65535.0
            lb, ub = lb * s + qmin, ub * s + qmin
        else:  # the z-destripe path keeps f32 bricks, as the reference
            lb, ub = _block_stats(core, clip_percentile)
        with manifest_lock:
            if qrange is not None:
                quant[str(plan.index)] = [qmin, qmax]
            stats["min"] = min(stats["min"], float(lb))
            stats["max"] = max(stats["max"], float(ub))
            # manifest BEFORE brick: a crash between the two leaves a
            # quant entry without a brick (redone on --resume); the other
            # order would leave u16 codes that resume reads as intensities
            manifest_path.write_text(json.dumps(
                {"stats": stats, "quant": quant, "n_blocks": len(plans),
                 "vol_shape": vol.shape}))
        np.save(brick_dir / f"block_{plan.index:05d}.npy",
                core.astype(np.uint16 if qrange is not None
                            else np.float32))
        with manifest_lock:
            prog.step()

    uni = fft_work_shape(plans, halo, planned)
    fft_shape = _fft_shape_for_backend(uni)
    chain = dict(gaussian_sigma=gaussian_sigma, dark=dark,
                 adaptive_psf=adaptive_psf, niter=niter, lam=lam,
                 stop_criterion=stop_criterion,
                 regularize_interval=regularize_interval,
                 fft_shape=fft_shape, classic_rl=classic_rl, halo=halo,
                 uni=uni, destripe_sigma=destripe_sigma)

    def core_size(plan):
        return [hi - lo for lo, hi in plan.core]

    def drain(item):
        plan, core, qrange = item
        sz = core_size(plan)
        core = np.asarray(core)[:sz[0], :sz[1], :sz[2]]
        save_core(plan, core,
                  None if qrange is None else np.asarray(qrange).tolist())

    if todo:
        # batches over the devices (one device is a one-entry mesh): read
        # a batch ahead, dispatch each device's share from its own thread,
        # copy back a batch behind, and drain (host percentile, brick
        # write) each device's blocks on a host worker of their own
        from ..utils.memory import ram_gate

        devices = ([mesh.devices[i, 0] for i in range(mesh.shape["data"])]
                   if use_mesh else [dev])
        n_data = len(devices)
        psf_dev = [psf_t.to(d) for d in devices]
        batch = batch_blocks or n_data
        batch = max(n_data, (batch // n_data) * n_data)
        share = batch // n_data   # blocks a device takes from a batch
        groups = [todo[i:i + batch] for i in range(0, len(todo), batch)]
        block_pool = ThreadPoolExecutor(max_workers=min(8, max(2, n_data)))
        group_pool = ThreadPoolExecutor(max_workers=1)
        drain_pool = ThreadPoolExecutor(max_workers=n_data)
        draining = []   # the drains of the batch before

        def read_group(group):
            # explicit RAM admission before staging a batch of blocks
            # (the reference's free_ram_is_not_enough poll)
            ram_gate(2 * n_data * 4 * int(np.prod(uni)))
            return list(block_pool.map(
                lambda p_: read_block_uniform(vol, p_, uni), group))

        def run_share(k, group, blocks):
            # device k's blocks of the batch, in block order; a short tail
            # batch leaves the last devices fewer (or no) blocks
            return [(plan,) + _block_chain(blocks[b], devices[k], psf_dev[k],
                                           core_size=core_size(plan), **chain)
                    for b, plan in enumerate(group)
                    if b // share == k]

        def drain_batch(items):
            # one batch drains at a time: host RAM holds at most two
            # batches of cores, and a failed drain fails the run here
            for f in draining:
                f.result()
            draining[:] = [drain_pool.submit(drain, it) for it in items]

        lag = OneInFlight()  # batch gi's fetch overlaps batch gi+1's RL
        try:
            next_fut = group_pool.submit(read_group, groups[0])
            for gi, group in enumerate(groups):
                blocks = next_fut.result()
                if gi + 1 < len(groups):
                    next_fut = group_pool.submit(read_group, groups[gi + 1])
                n_busy = -(-len(group) // share)
                items = [it for res in _mesh.run_on_devices(
                    run_share, [(devices[k], (k, group, blocks))
                                for k in range(n_busy)]) for it in res]
                prev = lag.put(items, *[h for it in items for h in it[1:]
                                        if h is not None])
                if prev is not None:
                    drain_batch(prev)
            for items in lag.flush():
                drain_batch(items)
            drain_batch([])
        finally:
            group_pool.shutdown(wait=True)
            block_pool.shutdown(wait=True)
            drain_pool.shutdown(wait=True)

    # streamed reassembly: one output plane in RAM at a time, bricks
    # memory-mapped; global percentile rescale (reference postprocess_save,
    # LsDeconv.m:950-1180)
    missing = [p_.index for p_ in plans
               if not (brick_dir / f"block_{p_.index:05d}.npy").exists()]
    if missing:
        log.warn(f"{len(missing)} brick(s) missing (e.g. block "
                 f"{missing[0]:05d}); skipping reassembly — re-run with "
                 "--resume once all blocks are done")
        return output_dir
    log.info(f"reassembling, global stats {stats}")
    info = np.iinfo(out_dtype)
    deconvmin, deconvmax = stats["min"], stats["max"]
    scale = info.max * amplification / max(deconvmax - deconvmin, 1e-30)

    with ThreadPoolExecutor(max_workers=4) as write_pool:
        z_splits = sorted({p.core[0] for p in plans})
        for (z0, z1) in z_splits:
            zplans = [p for p in plans if p.core[0] == (z0, z1)]
            bricks = {p.index: np.load(brick_dir / f"block_{p.index:05d}.npy",
                                       mmap_mode="r") for p in zplans}
            pending = []
            for i, z in enumerate(range(z0, z1)):
                plane = np.zeros(vol.shape[1:], np.float32)
                for p in zplans:
                    (_, _), (y0, y1), (x0, x1) = p.core
                    part = bricks[p.index][i]
                    qr = quant.get(str(p.index))
                    if qr is not None:  # dequantize u16 brick
                        part = (part.astype(np.float32)
                                * ((qr[1] - qr[0]) / 65535.0) + qr[0])
                    elif part.dtype == np.uint16:
                        raise RuntimeError(
                            f"brick {p.index} is u16 but has no quant range "
                            f"in the manifest — stale/corrupt brick cache; "
                            f"delete {brick_dir} and re-run")
                    plane[y0:y1, x0:x1] = part
                plane = np.clip((plane - deconvmin) * scale,
                                0, info.max).astype(out_dtype)
                pending.append(write_pool.submit(
                    tio.imwrite, output_dir / f"img_{z:06d}.tif", plane))
            for f in pending:
                f.result()

    quant = {k: quant[k] for k in sorted(quant, key=int)}   # block order
    manifest_path.write_text(json.dumps({
        "stats": stats, "quant": quant,
        "n_blocks": len(plans), "vol_shape": vol.shape,
        "params": {
            "niter": niter, "lambda": lam, "stop_criterion": stop_criterion,
            "regularize_interval": regularize_interval,
            "gaussian_sigma": gaussian_sigma, "dark": dark,
            "destripe_sigma": destripe_sigma,
            "out_dtype": str(np.dtype(out_dtype)),
            "amplification": amplification,
            "clip_percentile": clip_percentile,
            "classic_rl": classic_rl,
            "psf_shape": list(psf.shape), "halo": list(halo),
            "mesh": dict(mesh.shape) if use_mesh else None,
        },
        "deconvmin": deconvmin, "deconvmax": deconvmax, "scale": scale,
        "finished": time.strftime("%Y-%m-%d %H:%M:%S"),
    }, indent=1))
    log.info(f"deconvolved series written to {output_dir}")
    return output_dir


def build_parser():
    """CLI with exactly the reference's flag set (ipp_tpu/pipeline/
    deconvolve.py build_parser)."""
    import argparse

    p = argparse.ArgumentParser(
        description="Richardson-Lucy volume deconvolution "
                    "(LsDeconvolveMultiGPU equivalent, PyTorch/CUDA port)")
    p.add_argument("--input", "-i", required=True, type=Path,
                   help="directory of z-plane TIFFs")
    p.add_argument("--output", "-o", required=True, type=Path)
    p.add_argument("--dxy", type=float, default=406.0,
                   help="xy voxel size in nm")
    p.add_argument("--dz", type=float, default=800.0, help="z step in nm")
    p.add_argument("--na", type=float, default=0.4)
    p.add_argument("--rf", type=float, default=1.45,
                   help="refractive index")
    p.add_argument("--lambda-ex", type=float, default=488.0)
    p.add_argument("--lambda-em", type=float, default=525.0)
    p.add_argument("--fcyl", type=float, default=80000.0)
    p.add_argument("--slitwidth", type=float, default=12000.0)
    p.add_argument("--niter", "-n", type=int, default=10)
    p.add_argument("--lambda", dest="lam", type=float, default=0.0)
    p.add_argument("--stop-criterion", type=float, default=0.0)
    p.add_argument("--regularize-interval", type=int, default=0)
    p.add_argument("--gaussian-sigma", type=float, nargs=3, default=None,
                   metavar=("Z", "Y", "X"))
    p.add_argument("--dark", type=float, default=0.0)
    p.add_argument("--destripe-sigma", type=float, default=0.0,
                   help="z-destripe sigma of each block's xz slices "
                        "(db9); 0 turns it off")
    p.add_argument("--bit-depth", type=int, default=16, choices=[8, 16])
    p.add_argument("--amplification", type=float, default=1.0)
    p.add_argument("--clip-percentile", type=float, default=99.999)
    p.add_argument("--max-block-mvox", type=float, default=160.0)
    p.add_argument("--reference-scheme", action="store_true",
                   help="use the reference's bl-as-y RL variant")
    p.add_argument("--fft-precision", default=None,
                   choices=["highest", "high", "default"],
                   help="accepted for compatibility; the CUDA kernels "
                        "always multiply in full f32")
    p.add_argument("--batch-blocks", type=int, default=None,
                   help="blocks per batch, rounded to a multiple of the "
                        "device count (default: one per device)")
    p.add_argument("--adaptive-psf", action="store_true",
                   help="blind Wiener PSF re-estimation per iteration "
                        "(reference deconFFT_Wiener)")
    p.add_argument("--cache-drive", "--cache-dir", type=Path, default=None,
                   help="brick cache location (default OUTPUT/bricks)")
    p.add_argument("--start-block", type=int, default=0,
                   help="skip blocks below this index (reference "
                        "starting_block)")
    p.add_argument("--dry-run", action="store_true",
                   help="print the block plan and exit")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--no-strict-accuracy", action="store_true",
                   help="proceed (with a warning) when the block budget "
                        "forces the overlap-save halo to <=2x the PSF "
                        "half-extent, where core NRMSE exceeds the 1e-3 "
                        "spec; by default that configuration is an error")
    return p


def main(argv=None) -> int:
    from ..ops.psf import make_psf

    args = build_parser().parse_args(argv)
    resolve_device()   # no card and no IPP_TPU_PLATFORM=cpu: fail here
    log = Logger()
    psf_xyz, fwhm_xy, fwhm_z = make_psf(
        dxy=args.dxy, dz=args.dz, NA=args.na, n=args.rf,
        lambda_ex=args.lambda_ex, lambda_em=args.lambda_em,
        fcyl=args.fcyl, slitwidth=args.slitwidth)
    psf = np.transpose(psf_xyz, (2, 1, 0))  # -> (z, y, x)
    log.info(f"PSF {psf.shape}, FWHM xy {fwhm_xy:.0f} nm z {fwhm_z:.0f} nm")
    deconvolve_volume(
        args.input, args.output, psf, niter=args.niter, lam=args.lam,
        stop_criterion=args.stop_criterion,
        regularize_interval=args.regularize_interval,
        gaussian_sigma=tuple(args.gaussian_sigma) if args.gaussian_sigma else None,
        dark=args.dark,
        destripe_sigma=args.destripe_sigma or None,
        out_dtype=np.uint8 if args.bit_depth == 8 else np.uint16,
        amplification=args.amplification,
        clip_percentile=args.clip_percentile,
        max_block_elems=int(args.max_block_mvox * 2 ** 20),
        batch_blocks=args.batch_blocks,
        resume=args.resume,
        classic_rl=not args.reference_scheme,
        strict_accuracy=not args.no_strict_accuracy,
        adaptive_psf=args.adaptive_psf,
        cache_dir=args.cache_drive,
        start_block=args.start_block,
        dry_run=args.dry_run,
        log=log)
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
