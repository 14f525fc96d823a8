"""Batch destriping CLI on the GPU(s) — the pystripe equivalent (port of
ipp_tpu/pipeline/pystripe_cli.py: collect_tasks, batch_filter,
build_parser, _resolve_compression and main).

Destripe/flat/dark/8-bit a directory tree of tiles into a mirrored output
tree, with resume and robust IO.  The host side is the port's copy of the
reference's streaming executor (`parallel.executor.run_tile_pipeline`: reader
threads, batching by shape, one batch in flight, writer threads); each
batch goes through the port's `process_batch_fn` (upload, the device
chain with the DWT through the CUDA kernel K5, a `HostArray` handle back).
Same flags and defaults as the reference CLI.

Usage: python -m ipp_tpu_torch.pipeline.pystripe_cli --input DIR
          [--output DIR] --sigma1 250 --sigma2 250 [...]

With a device mesh (by default `parallel.mesh.default_mesh`: every
CUDA device when more than one is visible) each tile batch splits over
the mesh's devices, each destriping its tiles from its own thread (the
reference's per-GPU queue, pystripe/core.py:2021-2037).
"""

from __future__ import annotations

import argparse
import struct
import sys
from pathlib import Path
from typing import List, Optional

import numpy as np

from ..io import tiff as tio
from ..io.imgcodec import CodecError
from ..io.png import png_shape
from ..io.tiff import TiffError
from ..io.tiffcodec import tiff_shape
from ..ops.process import (ProcessConfig, _out_meta, is_uniform_2d,
                           needs_host_stats, process_batch_fn, process_img)
from ..parallel.executor import TileTask, run_tile_pipeline
from ..utils.device import resolve_device
from ..utils.log import Logger

__all__ = ["batch_filter", "main"]

SUPPORTED_EXTENSIONS = (".tif", ".tiff", ".raw", ".png")


def collect_tasks(input_dir: Path, output_dir: Path,
                  extensions=SUPPORTED_EXTENSIONS,
                  z_step: Optional[float] = None) -> List[TileTask]:
    """Mirror the input tree into output, one task per image
    (reference glob in batch_filter, pystripe/core.py:1997-2019).

    With z_step (microns) the scan switches to DCIMG mode (reference
    :1997-2012): every *.dcimg expands to one task per frame, named
    z{start + i*z_step_tenths:08.1f}.tif where start is the file's name
    as a z position in tenths of a micron (process_dc_images,
    pystripe/core.py:1649-1684)."""
    tasks = []
    if z_step is not None:
        from ..io.dcimg import DCIMGFile

        step_tenths = z_step * 10.0
        for p in sorted(input_dir.rglob("*.dcimg")):
            try:
                start = int(p.name.split(".")[0])
            except ValueError:
                print(f"skipping {p}: name is not a z position")
                continue
            n_frames = DCIMGFile(p).shape[0]
            out_dir = (output_dir / p.relative_to(input_dir)).parent
            for i in range(n_frames):
                out = out_dir / f"z{start + i * step_tenths:08.1f}.tif"
                tasks.append(TileTask(p, out, frame=i))
        return tasks
    for p in sorted(input_dir.rglob("*")):
        if p.suffix.lower() in extensions and p.is_file():
            rel = p.relative_to(input_dir)
            out = (output_dir / rel).with_suffix(".tif")
            tasks.append(TileTask(p, out))
    return tasks


def batch_filter(input_dir: Path, output_dir: Path, cfg: ProcessConfig,
                 batch_size: int = 8, resume: bool = False,
                 compression: Optional[str] = None,
                 workers: int = 8, z_step: Optional[float] = None,
                 read_timeout: Optional[float] = 300.0,
                 read_sandbox: str = "thread", device=None,
                 mesh=None) -> dict:
    """Destripe a whole directory tree (reference batch_filter,
    pystripe/core.py:1806-2050).

    `mesh`: a `parallel.mesh.Mesh` whose entries (z folded into "data")
    each destripe their share of every tile batch; when neither `mesh`
    nor `device` is given, `parallel.mesh.default_mesh()`'s; False none.
    Without one the work runs on `device` (else the resolved device), a
    one-entry mesh.  The batch size rounds to a multiple of the device
    count, and a short batch pads to it with its last tile (the extra
    rows are dropped)."""
    from ..parallel import mesh as _mesh
    from ..utils.transfer import HostArrays

    tasks = collect_tasks(Path(input_dir), Path(output_dir), z_step=z_step)
    if not tasks:
        raise FileNotFoundError(f"no images under {input_dir}")
    if mesh is None and device is None:
        mesh = _mesh.default_mesh()[0]
    mesh = _mesh.check_mesh(mesh or None)
    devices = (list(mesh.devices.flat) if mesh is not None
               else [resolve_device(device)])
    n_dev = len(devices)
    dev = devices[0]
    per_plane = needs_host_stats(cfg)
    batch_size = max(batch_size, n_dev) // n_dev * n_dev
    # one batch callable per device
    runs = [] if per_plane else [process_batch_fn(cfg, d) for d in devices]

    def _device_run(stacked: np.ndarray):
        """Run the batch on the device(s); returns the `HostArrays`
        handle so the executor's lagged fetch overlaps this batch's
        download with the next batch's upload and chain."""
        if per_plane:
            # unresolved bleach clips are per-plane otsu statistics —
            # stacking would make them batch-global
            return np.stack([process_img(p, cfg, device=dev)
                             for p in stacked])
        # tail batches and mixed-uniform subsets pad to batch_size, as in
        # the reference: every device runs batch_size / n_dev tiles in
        # every batch (a tile's result then never depends on where in the
        # run it falls)
        n = stacked.shape[0]
        if n < batch_size:
            stacked = np.concatenate(
                [stacked, np.repeat(stacked[-1:], batch_size - n, 0)])
        step = batch_size // n_dev
        parts = _mesh.run_on_devices(
            lambda i: runs[i](stacked[i * step:(i + 1) * step]),
            [(d, (i,)) for i, d in enumerate(devices)])
        return HostArrays(parts, n)

    def proc_batch(batch: np.ndarray):
        # the device path handles whole batches; uniform tiles short-circuit
        # to zeros host-side (reference is_uniform_2d, pystripe/core.py:1241)
        uniform = [i for i, b in enumerate(batch) if is_uniform_2d(b)]
        if not uniform:  # common case: whole batch stays on device
            return _device_run(batch)
        work = [i for i in range(len(batch)) if i not in uniform]
        results = {}
        if work:
            processed = np.asarray(_device_run(
                np.stack([batch[i] for i in work])))
            for i, o in zip(work, processed):
                results[i] = o
        for i in uniform:
            tile, dt = _out_meta(batch[i].shape, cfg, batch[i].dtype)
            results[i] = np.zeros(tile, dt)
        return np.stack([results[i] for i in range(len(batch))])

    # cheap header probe (the first IFD or IHDR alone) so the executor
    # can RAM-size its reader pool and shape dummy tiles up front
    probes = {".tif": tiff_shape, ".tiff": tiff_shape, ".png": png_shape}
    expected_shape = None
    for t in tasks[:4]:
        probe = probes.get(t.input_path.suffix.lower())
        if probe is None:
            continue
        try:
            expected_shape = probe(t.input_path)
            break
        except (OSError, struct.error, TiffError, CodecError):
            continue        # a corrupt first file: no hint from it

    return run_tile_pipeline(tasks, proc_batch,
                             expected_shape=expected_shape,
                             batch_size=batch_size, resume=resume,
                             compression=compression,
                             reader_threads=workers,
                             read_timeout=read_timeout,
                             read_sandbox=read_sandbox,
                             progress_desc="destripe")


def build_parser() -> argparse.ArgumentParser:
    """The reference CLI's flags and defaults, unchanged."""
    p = argparse.ArgumentParser(
        description="Batch destriping (pystripe-compatible flags, "
                    "PyTorch/CUDA port)")
    p.add_argument("--input", "-i", required=True, type=Path)
    p.add_argument("--output", "-o", type=Path, default=None)
    p.add_argument("--sigma1", "-s1", type=float, default=0,
                   help="foreground destripe sigma")
    p.add_argument("--sigma2", "-s2", type=float, default=0,
                   help="background destripe sigma")
    p.add_argument("--level", "-l", type=int, default=0)
    p.add_argument("--wavelet", "-w", type=str, default="db3",
                   help="mother wavelet (reference CLI default db3, "
                        "pystripe/core.py:2075; filter_streaks' own "
                        "default is db9)")
    p.add_argument("--crossover", "-x", type=float, default=10)
    p.add_argument("--threshold", "-t", type=float, default=None)
    p.add_argument("--padding-mode", "--padding_mode", dest="padding_mode",
                   type=str, default="reflect",
                   help="destripe pad mode (reference CLI default "
                        "'reflect', pystripe/core.py:2079)")
    p.add_argument("--bidirectional", "-dr", action="store_true")
    p.add_argument("--dark", "-d", type=float, default=0)
    p.add_argument("--flat", "-f", type=Path, default=None)
    p.add_argument("--gaussian", action="store_true",
                   help="2D gaussian denoise before destriping")
    p.add_argument("--lightsheet", action="store_true")
    p.add_argument("--artifact-length", type=int, default=150)
    p.add_argument("--background-window-size", type=int, default=200,
                   help="background estimation window (lightsheet mode)")
    p.add_argument("--percentile", type=float, default=0.25,
                   help="background percentile (lightsheet mode)")
    p.add_argument("--lightsheet-vs-background", type=float, default=2.0)
    # the reference spells these with underscores AND inverts them via
    # argparse store_false bugs (pystripe/core.py:2116-2122); the
    # spellings are accepted, the inversion is not replicated
    p.add_argument("--convert-to-16bit", "--convert_to_16bit",
                   dest="convert_to_16bit", action="store_true")
    p.add_argument("--convert-to-8bit", "--convert_to_8bit",
                   dest="convert_to_8bit", action="store_true")
    p.add_argument("--bit-shift", "--bit_shift_to_right", "-bsh",
                   dest="bit_shift", type=int, default=8)
    p.add_argument("--down-sample", "--down_sample", "-ds",
                   dest="down_sample", type=int, nargs="+", default=None,
                   help="1 int (both axes, the reference form) or 2 ints")
    p.add_argument("--new-size", type=int, nargs=2, default=None)
    p.add_argument("--size_x", "-sx", type=int, default=None,
                   help="new x size (reference spelling; pairs with "
                        "--size_y)")
    p.add_argument("--size_y", "-sy", type=int, default=None)
    p.add_argument("--rotate", "-r", type=int, default=0,
                   choices=[0, 90, 180, 270])
    p.add_argument("--flip-upside-down", "--flip_upside_down", "-flup",
                   dest="flip_upside_down", action="store_true")
    p.add_argument("--zstep", "-z", type=float, default=None,
                   help="z-step in micron; switches the scan to DCIMG "
                        "mode (one output plane per frame, z-position "
                        "names — reference process_dc_images)")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--workers", "-n", type=int, default=8)
    p.add_argument("--read-sandbox", choices=["thread", "process"],
                   default="thread",
                   help="'process' decodes in kill-able worker processes "
                        "(respawned on timeout) — the reference's 1-task "
                        "ProcessPoolExecutor sandbox "
                        "(pystripe/core.py:1710-1755)")
    p.add_argument("--chunks", type=int, default=None,
                   help="accepted for reference-CLI compatibility; the "
                        "device batcher sizes its own dispatch batches")
    p.add_argument("--compression", type=str, default=None,
                   help="None | zlib | zlib:N")
    p.add_argument("--compression_method", "-cm", type=str, default=None,
                   help="reference spelling: ADOBE_DEFLATE/ZLIB/"
                        "DEFLATE map to zlib; None disables")
    p.add_argument("--compression_level", "-cl", type=int, default=1)
    p.add_argument("--resume", "--continue", dest="resume",
                   action="store_true")
    return p


def _resolve_compression(args) -> Optional[str]:
    """Fold --compression / --compression_method+--compression_level into
    the TIFF writer's 'zlib:N' form (reference compression tuple,
    pystripe/core.py:2092-2095)."""
    if args.compression_method is not None:
        method = args.compression_method.upper()
        if method in ("NONE", "RAW"):
            return None
        if method in ("ADOBE_DEFLATE", "ZLIB", "DEFLATE", "ZSTD", "LZW"):
            if method in ("ZSTD", "LZW"):
                print(f"compression {method} not supported by the native "
                      f"TIFF writer; using zlib (deflate)")
            level = max(1, min(9, args.compression_level))
            return f"zlib:{level}"
        raise ValueError(f"unsupported compression method {method!r}")
    return args.compression


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    log = Logger()
    flat = None
    if args.flat is not None:
        flat = tio.imread(args.flat).astype(np.float32)
        flat /= flat.max()
    down_sample = None
    if args.down_sample:
        ds = list(args.down_sample)
        if len(ds) == 1:  # the reference's single-factor form
            ds = [ds[0], ds[0]]
        down_sample = (ds[0], ds[1])
    new_size = tuple(args.new_size) if args.new_size else None
    if new_size is None and args.size_x is not None and args.size_y is not None:
        new_size = (args.size_y, args.size_x)  # reference order (:2140)
    cfg = ProcessConfig(
        flat=flat,
        gaussian_filter_2d=args.gaussian,
        down_sample=down_sample,
        new_size=new_size,
        sigma=(args.sigma1, args.sigma2),
        level=args.level, wavelet=args.wavelet, crossover=args.crossover,
        threshold=args.threshold, padding_mode=args.padding_mode,
        bidirectional=args.bidirectional,
        dark=args.dark, lightsheet=args.lightsheet,
        artifact_length=args.artifact_length,
        background_window_size=args.background_window_size,
        percentile=args.percentile,
        lightsheet_vs_background=args.lightsheet_vs_background,
        rotate=args.rotate, flip_upside_down=args.flip_upside_down,
        convert_to_16bit=args.convert_to_16bit,
        convert_to_8bit=args.convert_to_8bit,
        bit_shift_to_right=args.bit_shift)
    compression = _resolve_compression(args)
    if args.input.is_file():
        # single-image mode (reference main, pystripe/core.py:2150-2161)
        if args.input.suffix.lower() not in SUPPORTED_EXTENSIONS:
            log.error(f"unsupported input file {args.input}")
            return 1
        out = args.output or args.input.parent / (
            args.input.stem + "_destriped" + args.input.suffix)
        img = tio.imread(args.input)
        result = np.asarray(process_img(img[None], cfg))[0]
        Path(out).parent.mkdir(parents=True, exist_ok=True)
        tio.imwrite(out, result, compression=compression)
        log.info(f"destriped {args.input} -> {out}")
        return 0
    out = args.output or args.input.parent / (args.input.name + "_destriped")
    log.info(f"destriping {args.input} -> {out}")
    counters = batch_filter(args.input, out, cfg, batch_size=args.batch_size,
                            resume=args.resume, compression=compression,
                            workers=args.workers, z_step=args.zstep,
                            read_sandbox=args.read_sandbox)
    log.info(f"done: {counters}")
    return 1 if counters["failed"] else 0


if __name__ == "__main__":
    sys.exit(main())
