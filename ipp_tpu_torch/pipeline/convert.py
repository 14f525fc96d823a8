"""Parallel converter CLI on one device — the top-level convert.py
equivalent (port of ipp_tpu/pipeline/convert.py: convert, the exports,
build_parser and main; same flags and defaults).

(reference convert.py:23-404: IMS/TIFF dir -> preprocessed TIFF series
with optional 8-bit/destripe/resize, then TeraFly / Imaris / FNT-cube /
MP4 exports — the reference shells out to MPI paraconverter, wine
ImarisConvertiv, fnt-slice2cube and ffmpeg; here every export is native:
io.terafly, io.ims, io.bdv, tif_series_to_fnt (nrrd cubes the
fnt_cube_processor tooling rglobs), and tif_series_to_movie through the
port's Motion-JPEG AVI writer, io/avi.py.)

Device work: the tile chain of each batch of planes (`process_batch_fn`;
under `--destripe` the DWT through the CUDA kernel K5), the in-plane
ladder of the isotropic downsample, the 16/8-bit conversion of its
chunks and the final z resize of the npz.  Each batch's download overlaps
the next batch's read and upload (`OneInFlight` over `HostArray`
handles).  `--movie` encodes on the host: `.avi` (and any suffix but
`.mp4`) with the port's own Motion-JPEG writer; `.mp4` with OpenCV,
imported in that branch alone, which raises an ImportError naming cv2
without it.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..io import tiff as tio
from ..io.ims import ImarisReader, tif_series_to_imaris
from ..io.terafly import tif_series_to_terafly
from ..ops.process import (ProcessConfig, is_uniform_2d, needs_host_stats,
                           process_batch_fn, process_img)
from ..ops.resample import IsotropicAccumulator
from ..utils.device import resolve_device
from ..utils.lagged import OneInFlight
from ..utils.log import Logger
from ..utils.progress import ProgressReporter
from ..utils.transfer import HostArray

__all__ = ["convert", "main", "tif_series_to_fnt", "tif_series_to_movie"]

# device batch size for the converter's plane stream
_BATCH = 8


def tif_series_to_fnt(tif_dir: Path, out_dir: Path, cube: int = 128,
                      voxel_um=(1.0, 1.0, 1.0),
                      log: Optional[Logger] = None) -> Path:
    """Cut a z-plane TIFF series into FNT .nrrd cubes (the fnt-slice2cube
    role, reference convert.py:168-193).  Cubes land in
    out/Zzzzz/Yyyyy_Xxxxx.nrrd; the FNT tooling (and our
    pipeline.fnt_cubes) discovers cubes by rglob('*.nrrd'), so the layout
    only needs to be deterministic.  One z slab is in RAM at a time."""
    from ..io.nrrd import write_nrrd

    log = log or Logger()
    tif_dir = Path(tif_dir)
    out_dir = Path(out_dir)
    paths = sorted(p for p in tif_dir.iterdir()
                   if p.suffix.lower() in (".tif", ".tiff"))
    if not paths:
        raise FileNotFoundError(f"no TIFFs in {tif_dir}")
    first = tio.imread(paths[0])
    h, w = first.shape
    nz = len(paths)
    vz, vy, vx = voxel_um
    n_cubes = 0
    for zi, z0 in enumerate(range(0, nz, cube)):
        slab = np.stack([tio.imread(p) for p in paths[z0:z0 + cube]])
        for yi, y0 in enumerate(range(0, h, cube)):
            for xi, x0 in enumerate(range(0, w, cube)):
                blk = slab[:, y0:y0 + cube, x0:x0 + cube]
                p = out_dir / f"Z{zi:04d}" / f"Y{yi:04d}_X{xi:04d}.nrrd"
                p.parent.mkdir(parents=True, exist_ok=True)
                write_nrrd(p, blk, extra_header={
                    "spacings": f"{vz} {vy} {vx}",
                    "ipp_origin": f"{z0} {y0} {x0}"})
                n_cubes += 1
    log.info(f"{n_cubes} FNT cubes written to {out_dir}")
    return out_dir


def tif_series_to_movie(tif_dir: Path, movie_path: Path, fps: int = 60,
                        start: Optional[int] = None,
                        end: Optional[int] = None,
                        frame_repeat: int = 1,
                        log: Optional[Logger] = None) -> Path:
    """Render a TIFF series to a video file (the ffmpeg leg of the
    reference, convert.py:231-247).  Non-8-bit planes are contrast-scaled
    by 0.1/99.9 percentiles sampled from a few planes spread across the
    series.  `.mp4` goes through OpenCV's mp4v writer (`_open_mp4`); every
    other suffix is written as a Motion-JPEG AVI at quality 95 by the
    port's own writer (io/avi.py), as OpenCV's MJPG writer does."""
    log = log or Logger()
    tif_dir = Path(tif_dir)
    movie_path = Path(movie_path)
    paths = sorted(p for p in tif_dir.iterdir()
                   if p.suffix.lower() in (".tif", ".tiff"))[start:end]
    if not paths:
        raise FileNotFoundError(f"no TIFFs in {tif_dir}")
    first = tio.imread(paths[0])
    h, w = first.shape[:2]
    # contrast window computed unconditionally (a mixed-dtype series
    # would otherwise hit an unbound lo/hi below), from planes spread
    # across the series rather than the first frame only
    sample_idx = sorted({0, len(paths) // 2, len(paths) - 1})
    sample = np.concatenate([
        tio.imread(paths[i]).astype(np.float32).ravel()
        for i in sample_idx])
    lo, hi = np.percentile(sample, [0.1, 99.9])
    hi = max(hi, lo + 1)
    movie_path.parent.mkdir(parents=True, exist_ok=True)
    if movie_path.suffix.lower() == ".mp4":
        vw = _open_mp4(movie_path, fps, w, h)
    else:
        from ..io.avi import MjpegWriter

        vw = MjpegWriter(movie_path, w, h, fps, quality=95)
    try:
        for p in paths:
            img = tio.imread(p)
            if img.dtype != np.uint8:
                img = np.clip((img.astype(np.float32) - lo)
                              * (255.0 / (hi - lo)), 0, 255).astype(np.uint8)
            vw.write(img, repeat=max(1, frame_repeat))
    finally:
        vw.close()
    log.info(f"{len(paths)} frames -> {movie_path}")
    return movie_path


def _open_mp4(path: Path, fps: int, w: int, h: int) -> "_Mp4Writer":
    """OpenCV's mp4v writer, the one place the port imports cv2: an
    MPEG-4 encoder is not part of the port (ROADMAP queue 1 item 20)."""
    try:
        import cv2
    except ImportError:
        raise ImportError(
            f"writing {path.name} (.mp4) needs OpenCV (cv2), which is not "
            f"installed; write an .avi (Motion-JPEG) instead") from None
    vw = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), fps,
                         (w, h))
    if not vw.isOpened():
        raise RuntimeError(f"cv2.VideoWriter cannot open {path} (codec "
                           f"missing?); try an .avi extension (MJPG)")
    return _Mp4Writer(cv2, vw)


class _Mp4Writer:
    def __init__(self, cv2, vw):
        self.cv2, self.vw = cv2, vw

    def write(self, img: np.ndarray, repeat: int = 1) -> None:
        if img.ndim == 2:
            img = self.cv2.cvtColor(img, self.cv2.COLOR_GRAY2BGR)
        for _ in range(repeat):
            self.vw.write(img)

    def close(self) -> None:
        self.vw.release()


def _open_source(src: Path, channel: int = 0):
    """Return (reader(z)->plane, nz) for any supported volume source —
    the generic-source half of the reference teraconverter
    (TeraStitcher utils/volumeconverter: 2D TIFF series, 3D TIFF,
    TeraFly hierarchies, raw series, plus our .ims/.h5 formats):

    - ``.ims`` Imaris HDF5
    - ``.xml``/``.h5`` BigDataViewer
    - single multi-page ``.tif`` (tiff3D)
    - TeraFly root (contains RES(...) level dirs)
    - directory of 2D ``.tif`` planes
    - directory of ``.raw`` planes (pystripe raw format)
    """
    suffix = src.suffix.lower()
    if suffix == ".ims":
        r = ImarisReader(src, channel=channel)
        return (lambda z: r[z]), r.shape[0]
    if suffix in (".xml", ".h5"):
        from ..io.bdv import BDVReader

        r = BDVReader(src)
        return (lambda z: r[z]), len(r)
    if suffix in (".tif", ".tiff") and src.is_file():
        vol = tio.read_tiff_stack(src)
        return (lambda z: vol[z]), vol.shape[0]
    if not src.is_dir():
        raise ValueError(
            f"unsupported source {src}: expected .ims/.xml/.h5/.tif file, "
            f"a TeraFly root, or a directory of .tif/.raw planes")
    if list(src.glob("RES(*)")):
        from ..io.terafly import TeraFlyVolume

        r = TeraFlyVolume(src)
        return (lambda z: r[z]), len(r)
    paths = sorted(p for p in src.iterdir()
                   if p.suffix.lower() in (".tif", ".tiff"))
    if paths:
        return (lambda z: tio.imread(paths[z])), len(paths)
    raws = sorted(p for p in src.iterdir() if p.suffix.lower() == ".raw")
    if raws:
        from ..io.raw import raw_imread

        return (lambda z: raw_imread(raws[z])), len(raws)
    # generic 2D plane series (png/jp2/jpeg/bmp/pnm — the opencv2D /
    # bioformats2D optional-plugin role, io/generic2d.py)
    from ..io.generic2d import GENERIC_2D_SUFFIXES, imread_generic

    gens = sorted(p for p in src.iterdir()
                  if p.suffix.lower() in GENERIC_2D_SUFFIXES)
    if gens:
        return (lambda z: imread_generic(gens[z])), len(gens)
    raise FileNotFoundError(f"no TIFF/raw/generic-2D planes in {src}")


def convert(
    source: Path,
    destination: Path,
    cfg: Optional[ProcessConfig] = None,
    voxel_um=(1.0, 1.0, 1.0),
    to_terafly: bool = False,
    to_imaris: bool = False,
    to_bdv: bool = False,
    to_precomputed: bool = False,
    to_fnt: Optional[Path] = None,
    to_movie: Optional[Path] = None,
    fnt_cube: int = 128,
    movie_fps: int = 60,
    movie_start: int = 0,
    movie_end: Optional[int] = None,
    movie_frame_duration: int = 1,
    save_images: bool = True,
    halve: str = "mean",
    block_format: str = "tiff2d",
    resume: bool = False,
    channel: int = 0,
    read_timeout: Optional[float] = None,
    target_voxel_um: Optional[float] = None,
    downsample_path: Optional[Path] = None,
    alternating_downsampling: bool = False,
    downsample_dtype: str = "float32",
    compression: Optional[str] = None,
    log: Optional[Logger] = None,
    device=None,
) -> Path:
    """Convert `source` to a TIFF series under `destination` on `device`
    (else the resolved device), with the optional downsample and exports
    (reference convert.py:23-404)."""
    log = log or Logger()
    dev = resolve_device(device)
    if not save_images and (to_terafly or to_imaris or to_bdv
                            or to_precomputed or to_fnt or to_movie):
        # every export reads the written series back; honor the
        # reference's "downsample only" contract only when nothing else
        # needs the planes (convert.py:397)
        log.warning("--no-save-images ignored: an export needs the "
                    "full-res series")
        save_images = True
    reader, nz = _open_source(Path(source), channel=channel)
    if read_timeout and read_timeout > 0:
        # hung/corrupt plane reads become zero planes after the deadline
        # (reference convert.py --timeout, :386-390).  Each read runs on
        # its own DAEMON thread: a genuinely hung read is simply
        # abandoned — it can neither poison later reads nor block
        # interpreter exit (the reference kills a whole worker process
        # for the same reason, pystripe/core.py:1730-1755)
        import threading as _threading

        _state = {"meta": None}
        _raw_reader = reader

        def reader(z, _rr=_raw_reader):
            box = {}
            done = _threading.Event()

            def run():
                try:
                    box["v"] = _rr(z)
                except BaseException as exc:  # noqa: BLE001
                    box["e"] = exc
                done.set()

            _threading.Thread(target=run, daemon=True).start()
            if done.wait(read_timeout) and "v" in box:
                plane = box["v"]
                _state["meta"] = (plane.shape, plane.dtype)
                return plane
            if _state["meta"] is None:
                if "e" in box:
                    raise box["e"]
                raise TimeoutError(f"plane {z} read timed out with no "
                                   "prior plane to infer shape/dtype from")
            log.warn(f"plane {z} read "
                     f"{'failed' if 'e' in box else 'timed out'}; zeros")
            return np.zeros(*_state["meta"])
    tif_dir = Path(destination)
    tif_dir.mkdir(parents=True, exist_ok=True)
    # streamed isotropic downsample + npz during conversion (the reference
    # converter's --voxel-size-target/--downsample-path surface,
    # convert.py:122-130 driving parallel_image_processor's z_stack +
    # tail).  Per-chunk downsampled TIFFs land in downsample_path in
    # downsample_dtype; the npz stacks the SAME converted planes.
    acc = None
    npz_path = None
    ds_dir = None
    src_hw = proc_hw = None
    if target_voxel_um is not None:
        ds_dir = Path(downsample_path) if downsample_path else (
            tif_dir.parent /
            f"{tif_dir.name}_downsampled_{target_voxel_um:.1f}um")
        ds_dir.mkdir(parents=True, exist_ok=True)
        npz_path = ds_dir.parent / (
            f"{tif_dir.name}_zyx{target_voxel_um:.1f}um.npz")

    def _emit_ds_chunk(reduced: np.ndarray, idx: int):
        """Convert a reduced chunk plane to downsample_dtype and write it
        (reference :421-431: uint16 via convert_to_16bit_fun, uint8 via
        convert_to_8bit_fun unless the planes already are uint8)."""
        from ..ops.intensity import convert_to_16bit, convert_to_8bit

        out_p = ds_dir / f"img_{idx:06d}.tif"
        if downsample_dtype in ("uint16", "u2"):
            reduced = np.asarray(HostArray(convert_to_16bit(
                torch.as_tensor(reduced, device=dev))))
        elif downsample_dtype in ("uint8", "u1"):
            if plane_dtype == np.uint8:
                reduced = reduced.astype(np.uint8)
            else:
                reduced = np.asarray(HostArray(convert_to_8bit(
                    torch.as_tensor(reduced, device=dev), 8)))
        tio.imwrite(out_p, reduced, compression=compression)
        return reduced

    # unresolved bleach clips are a per-PLANE multi-Otsu statistic —
    # batching would make them batch-global, so such cfgs take the
    # per-plane host path
    batchable = cfg is not None and not needs_host_stats(cfg)
    run_batch = process_batch_fn(cfg, dev) if batchable else None
    plane_dtype = None
    ds_chunks = []
    ds_voxel = None
    chunk_len = 1
    plane0 = None
    if target_voxel_um is not None:
        # downsample geometry derived UP FRONT from the TRUE source shape
        # (the reference computes the target before processing,
        # parallel_image_processor.py:158-168; probing the already-written
        # plane on resume would feed source==processed into the
        # fun-induced voxel correction — ADVICE r3)
        raw0 = np.asarray(reader(0))
        src_hw = raw0.shape
        out0 = tif_dir / "img_000000.tif"
        if resume and out0.exists():
            plane0 = tio.imread(out0)
        elif cfg is None:
            plane0 = raw0
        elif not batchable or is_uniform_2d(raw0):
            plane0 = process_img(raw0, cfg, device=dev)
        else:
            # plane 0 through the batched chain the stream below uses
            plane0 = np.asarray(run_batch(raw0[None]))[0]
        proc_hw = plane0.shape
        plane_dtype = plane0.dtype
        vz, vy, vx = voxel_um
        rotated = cfg is not None and cfg.rotate in (90, 270)
        # fun-induced voxel change, rotation-aware (reference
        # calculate_down_sampling_target, :158-168)
        if rotated:
            vy2 = vy * src_hw[0] / proc_hw[1]
            vx2 = vx * src_hw[1] / proc_hw[0]
            vy2, vx2 = vx2, vy2
        else:
            vy2 = vy * src_hw[0] / proc_hw[0]
            vx2 = vx * src_hw[1] / proc_hw[1]
        ds_voxel = (vz, vy2, vx2)
        acc = IsotropicAccumulator(
            proc_hw, ds_voxel, target_voxel_um,
            alternating=alternating_downsampling, device=dev)
        chunk_len = acc.chunk_len

    def _chunk_done(ci: int) -> bool:
        """Resume: a downsample chunk can be skipped when its reduced TIFF
        and ALL member planes already exist (reference skips such chunks,
        parallel_image_processor.py:281-290)."""
        if not (ds_dir / f"img_{ci:06d}.tif").exists():
            return False
        return all((tif_dir / f"img_{zz:06d}.tif").exists()
                   for zz in range(ci * chunk_len,
                                   min(nz, (ci + 1) * chunk_len)))

    prog = ProgressReporter(nz, desc="convert")

    # Device batching + one-batch-in-flight lagged fetch: planes process
    # in batches of BATCH through one device chain (the chain takes
    # leading batch dims), and batch k's device->host stream overlaps
    # batch k+1's read/upload/dispatch — the device-side shape of the
    # reference's per-plane process pool (parallel_image_processor.py:
    # 660-678).  Plane writes and acc.add stay in strict z order.
    BATCH = _BATCH
    lag = OneInFlight()
    raw_batch = []  # [(z, out_path, raw_plane)]

    def _finish_plane(outp, plane, write):
        nonlocal proc_hw
        plane = np.asarray(plane)
        if proc_hw is None:
            proc_hw = plane.shape
        if write:
            tio.imwrite(outp, plane, compression=compression)
        if target_voxel_um is not None:
            reduced = acc.add(plane)
            if reduced is not None:
                ds_chunks.append(_emit_ds_chunk(reduced, len(ds_chunks)))
        prog.step()

    def _drain(item):
        tasks, out, n = item
        arr = np.asarray(out)[:n]
        for (zz, outp), pl in zip(tasks, arr):
            _finish_plane(outp, pl, write=save_images)

    def _flush_raw():
        if not raw_batch:
            return
        tasks = [(zz, outp) for zz, outp, _ in raw_batch]
        stacked = np.stack([r for _, _, r in raw_batch])
        raw_batch.clear()
        out = run_batch(stacked)
        done = lag.put((tasks, out, stacked.shape[0]), out)
        if done is not None:
            _drain(done)

    def _emit_host(outp, plane, write):
        """A plane that bypasses the device (resume read, plane0,
        uniform short-circuit): keep z order by flushing device work."""
        _flush_raw()
        for item in lag.flush():
            _drain(item)
        _finish_plane(outp, plane, write)

    # one completeness verdict per chunk, decided at its first plane —
    # re-stating every member file for every z is O(chunk_len^2), and a
    # chunk completed by THIS run's writes mid-chunk must not flip to
    # "skip" while the accumulator already holds its early planes
    chunk_state: dict = {}

    for z in range(nz):
        out = tif_dir / f"img_{z:06d}.tif"
        if resume and target_voxel_um is not None:
            ci = z // chunk_len
            done = chunk_state.get(ci)
            if done is None:
                done = chunk_state[ci] = _chunk_done(ci)
            if done:
                _flush_raw()
                for item in lag.flush():
                    _drain(item)
                if ci >= len(ds_chunks):
                    # read the existing reduced chunk back for the npz
                    ds_chunks.append(tio.imread(ds_dir / f"img_{ci:06d}.tif"))
                prog.step()
                continue
        if resume and out.exists():
            if target_voxel_um is None:
                prog.step()
                continue
            # downsampling still needs the written plane's content
            _emit_host(out, plane0 if (z == 0 and plane0 is not None)
                       else tio.imread(out), write=False)
            continue
        if z == 0 and plane0 is not None:
            _emit_host(out, plane0, write=save_images)
            continue
        raw = np.asarray(reader(z))
        if src_hw is None:
            src_hw = raw.shape
        if not batchable or is_uniform_2d(raw):
            # uniform tiles short-circuit on the host (the per-plane
            # semantics of process_img, reference pystripe/core.py:1241);
            # per-plane-stat cfgs (bleach otsu) also stay per-plane
            _emit_host(out, process_img(raw, cfg, device=dev)
                       if cfg is not None else raw, write=save_images)
            continue
        if raw_batch and (raw_batch[0][2].shape != raw.shape
                          or raw_batch[0][2].dtype != raw.dtype):
            _flush_raw()  # heterogeneous series: never stack mixed planes
        raw_batch.append((z, out, raw))
        if len(raw_batch) >= BATCH:
            _flush_raw()
    _flush_raw()
    for item in lag.flush():
        _drain(item)
    prog.close()
    if acc is not None:
        reduced = acc.flush()
        if reduced is not None:
            ds_chunks.append(_emit_ds_chunk(reduced, len(ds_chunks)))
        if ds_chunks and not (resume and npz_path.exists()):
            from ..stitch.merge import downsampled_npz

            downsampled_npz(np.stack(ds_chunks).astype(np.float32),
                            npz_path, ds_voxel, (nz,) + tuple(proc_hw),
                            target_voxel_um, device=dev)
            log.info(f"downsampled npz: {npz_path}")
    def _dest(flag, default):
        """True -> derived default; a str/Path -> explicit target
        (reference --teraFly/--imaris take explicit paths)."""
        return Path(flag) if isinstance(flag, (str, Path)) else default

    if to_terafly:
        log.info("building TeraFly pyramid ...")
        tif_series_to_terafly(
            tif_dir,
            _dest(to_terafly, tif_dir.parent / (tif_dir.name + "_terafly")),
            voxel_um=voxel_um, halve=halve, block_format=block_format)
    if to_imaris:
        log.info("writing Imaris file ...")
        tif_series_to_imaris(
            tif_dir,
            _dest(to_imaris, tif_dir.parent / (tif_dir.name + ".ims")),
            voxel_um=voxel_um)
    if to_bdv:
        from ..io.bdv import tif_series_to_bdv

        log.info("writing BigDataViewer file ...")
        tif_series_to_bdv(tif_dir, tif_dir.parent / (tif_dir.name + "_bdv.xml"),
                          voxel_um=voxel_um, halve=halve)
    if to_precomputed:
        from .tsv_tools import series_to_precomputed

        log.info("writing neuroglancer precomputed ...")
        series_to_precomputed(
            tif_dir, tif_dir.parent / (tif_dir.name + "_precomputed"),
            voxel_nm=tuple(v * 1000.0 for v in voxel_um), halve=halve)
    if to_fnt:
        log.info("cutting FNT cubes ...")
        tif_series_to_fnt(tif_dir, Path(to_fnt), cube=fnt_cube,
                          voxel_um=voxel_um, log=log)
    if to_movie:
        log.info("rendering movie ...")
        tif_series_to_movie(tif_dir, Path(to_movie), fps=movie_fps,
                            start=movie_start or None, end=movie_end,
                            frame_repeat=movie_frame_duration, log=log)
    return tif_dir


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="convert IMS/TIFF volumes "
                                            "(convert.py equivalent)")
    p.add_argument("--input", "-i", required=True, type=Path)
    p.add_argument("--output", "-o", "--tif", "-t", required=True,
                   type=Path, help="TIFF series output (reference --tif)")
    p.add_argument("--voxel-size-x", "-dx", type=float, default=None,
                   help="reference per-axis voxel flags; override --voxel")
    p.add_argument("--voxel-size-y", "-dy", type=float, default=None)
    p.add_argument("--voxel-size-z", "-dz", type=float, default=None)
    p.add_argument("--nthreads", "-n", type=int, default=None,
                   help="accepted for reference-CLI compatibility")
    p.add_argument("--convert-to-8bit", action="store_true")
    p.add_argument("--convert-to-16bit", action="store_true")
    p.add_argument("--bit-shift", "-b", type=int, default=8)
    p.add_argument("--dark", "-d", type=float, default=0.0)
    p.add_argument("--sigma1", type=float, default=0.0)
    p.add_argument("--sigma2", type=float, default=0.0)
    p.add_argument("--wavelet", default="db9")
    p.add_argument("--destripe", action="store_true",
                   help="destripe at the reference converter's fixed "
                        "sigma (250, 250) (convert.py:78-80)")
    p.add_argument("--downsample-x", "-dsx", type=int, default=0,
                   help="2D pre-downsample factor for x (reference -dsx)")
    p.add_argument("--downsample-y", "-dsy", type=int, default=0)
    p.add_argument("--downsample-method", "-dsm", default="mean",
                   choices=["min", "max", "mean", "median"])
    p.add_argument("--background-subtraction", action="store_true",
                   help="lightsheet local-percentile cleaning per plane")
    p.add_argument("--bleach-correction", action="store_true")
    p.add_argument("--bleach-correction-period", type=float, default=2000,
                   help="inverse low-pass frequency (reference default "
                        "2000; try the camera tile size)")
    p.add_argument("--bleach-correction-clip-min", type=float, default=20)
    p.add_argument("--bleach-correction-clip-max", type=float, default=255)
    p.add_argument("--compression-method", "-zm", default="ADOBE_DEFLATE")
    p.add_argument("--compression-level", "-zl", type=int, default=1,
                   help="0 disables compression (reference default 1)")
    p.add_argument("--new-size", type=int, nargs=2, default=None)
    p.add_argument("--new-size-x", "-nsx", type=int, default=0,
                   help="reference per-axis resize spelling; both "
                        "-nsx and -nsy are required together "
                        "(convert.py:54-57)")
    p.add_argument("--new-size-y", "-nsy", type=int, default=0)
    p.add_argument("--voxel", type=float, nargs=3, default=(1.0, 1.0, 1.0),
                   metavar=("Z", "Y", "X"))
    p.add_argument("--terafly", "--teraFly", "-f", nargs="?", const=True,
                   default=False, metavar="DIR",
                   help="TeraFly pyramid; optional explicit output dir "
                        "(reference --teraFly PATH)")
    p.add_argument("--imaris", nargs="?", const=True, default=False,
                   metavar="FILE",
                   help="Imaris .ims; optional explicit output file")
    p.add_argument("--bdv", action="store_true",
                   help="also write a BigDataViewer XML+HDF5 pair")
    p.add_argument("--precomputed", action="store_true",
                   help="also write a neuroglancer precomputed volume")
    p.add_argument("--halve", choices=["mean", "max"], default="mean",
                   help="pyramid pooling (reference teraconverter --halve)")
    p.add_argument("--block-format", choices=["tiff2d", "vaa3draw"],
                   default="tiff2d",
                   help="TeraFly block layout: 2D TIFF series or Vaa3D "
                        "raw stacks (reference mergeTilesVaa3DRaw, "
                        "StackStitcher.h:338)")
    p.add_argument("--fnt", "-fnt", type=Path, default=None,
                   help="cut FNT .nrrd cubes into this directory")
    p.add_argument("--fnt-cube", type=int, default=128)
    p.add_argument("--movie", "-m", type=Path, default=None,
                   help="render the series to this .mp4/.avi")
    p.add_argument("--movie-fps", type=int, default=60)
    p.add_argument("--movie-start", type=int, default=0,
                   help="first frame index (reference convert.py:372)")
    p.add_argument("--movie-end", type=int, default=None,
                   help="one past the last frame index")
    p.add_argument("--movie-frame-duration", type=int, default=1,
                   help="times each plane repeats in the movie.  The "
                        "reference default is 5, but its input-side "
                        "'-r 60' makes ffmpeg ignore the concat "
                        "durations entirely (convert.py:239-241), so its "
                        "effective duration is 1 frame — our default "
                        "matches that effective behavior")
    p.add_argument("--channel", "-c", type=int, default=0,
                   help="IMS channel to convert")
    p.add_argument("--rotation", "-r", type=int, default=0,
                   choices=[0, 90, 180, 270])
    p.add_argument("--flip-upside-down", "--flip_upside_down",
                   action="store_true")
    p.add_argument("--gaussian", "-g", action="store_true")
    p.add_argument("--padding-mode", "--padding_mode", "-w",
                   default="reflect")
    p.add_argument("--timeout", type=float, default=None,
                   help="per-plane read timeout (s); failed reads "
                        "become zero planes")
    p.add_argument("--rename", action="store_true",
                   help="accepted for reference compatibility (outputs "
                        "are always renumbered img_%%06d)")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--voxel-size-target", "-dt", type=float, default=None,
                   help="isotropic downsample target (um) -> per-chunk "
                        "downsampled TIFFs + atlas-registration npz "
                        "(reference convert.py -dt)")
    p.add_argument("--downsample-path", "-dsp", type=Path, default=None)
    p.add_argument("--downsample-dtype", "-dsdt", default="float32",
                   choices=["float32", "uint16", "uint8"])
    p.add_argument("--alternating-downsampling", action="store_true",
                   help="alternating max/mean xy rungs; default all-mean "
                        "(the reference converter's effective default, "
                        "convert.py:129)")
    p.add_argument("--save-images", default=True,
                   action=argparse.BooleanOptionalAction,
                   help="--no-save-images skips the full-res TIFF "
                        "series and only produces the -dt downsample/npz "
                        "(reference convert.py:397)")
    # accepted for reference compatibility: RAM admission is internal
    # (utils/memory.py) and there is one device stream, not a GPU pool
    p.add_argument("--needed-memory", type=int, default=1,
                   help="no-op (reference per-thread GB gate, "
                        "convert.py:395)")
    p.add_argument("--threads-per-gpu", type=int, default=1,
                   help="no-op (reference GPU batching knob, "
                        "convert.py:400)")
    return p


def main(argv=None) -> int:
    p = build_parser()
    args = p.parse_args(argv)
    if bool(args.new_size_x) != bool(args.new_size_y):
        p.error("both --new-size-x and --new-size-y are needed "
                "(reference convert.py:54-57)")
    if args.new_size_x and args.new_size_y:
        args.new_size = [args.new_size_y, args.new_size_x]
    cfg = None
    sigma = (args.sigma1, args.sigma2)
    if args.destripe and sigma == (0.0, 0.0):
        sigma = (250.0, 250.0)   # the reference's fixed de_striping_sigma
    down_sample = None
    if args.downsample_x > 0 or args.downsample_y > 0:
        down_sample = (args.downsample_y or 1, args.downsample_x or 1)
    if (args.convert_to_8bit or args.convert_to_16bit or args.dark
            or any(sigma) or args.new_size or args.rotation
            or args.flip_upside_down or args.gaussian or down_sample
            or args.background_subtraction or args.bleach_correction):
        cfg = ProcessConfig(
            sigma=sigma, wavelet=args.wavelet,
            padding_mode=args.padding_mode,
            dark=args.dark, convert_to_8bit=args.convert_to_8bit,
            convert_to_16bit=args.convert_to_16bit,
            bit_shift_to_right=args.bit_shift,
            gaussian_filter_2d=args.gaussian,
            down_sample=down_sample,
            down_sample_method=args.downsample_method,
            lightsheet=args.background_subtraction,
            bidirectional=True,
            bleach_correction_frequency=(
                1.0 / args.bleach_correction_period
                if args.bleach_correction else None),
            bleach_correction_clip_min=(
                args.bleach_correction_clip_min
                if args.bleach_correction else None),
            bleach_correction_clip_max=(
                args.bleach_correction_clip_max
                if args.bleach_correction else None),
            rotate=args.rotation, flip_upside_down=args.flip_upside_down,
            new_size=tuple(args.new_size) if args.new_size else None)
    voxel = tuple(args.voxel)
    if (args.voxel_size_x is not None or args.voxel_size_y is not None
            or args.voxel_size_z is not None):
        voxel = (args.voxel_size_z if args.voxel_size_z is not None else voxel[0],
                 args.voxel_size_y if args.voxel_size_y is not None else voxel[1],
                 args.voxel_size_x if args.voxel_size_x is not None else voxel[2])
    args.voxel = voxel
    compression = None
    if args.compression_level > 0:
        from .pystripe_cli import _resolve_compression

        compression = _resolve_compression(argparse.Namespace(
            compression_method=args.compression_method,
            compression_level=args.compression_level, compression=None))
    convert(args.input, args.output, cfg, voxel_um=tuple(args.voxel),
            to_terafly=args.terafly, to_imaris=args.imaris,
            to_bdv=args.bdv, to_precomputed=args.precomputed,
            to_fnt=args.fnt, to_movie=args.movie, fnt_cube=args.fnt_cube,
            movie_fps=args.movie_fps, movie_start=args.movie_start,
            movie_end=args.movie_end,
            movie_frame_duration=args.movie_frame_duration,
            save_images=args.save_images, halve=args.halve,
            block_format=args.block_format, resume=args.resume,
            channel=args.channel, read_timeout=args.timeout,
            target_voxel_um=args.voxel_size_target,
            downsample_path=args.downsample_path,
            alternating_downsampling=args.alternating_downsampling,
            downsample_dtype=args.downsample_dtype,
            compression=compression)
    return 0


if __name__ == "__main__":
    sys.exit(main())


def convert_deconvolved(input_dir: Path, output_dir: Path,
                        magnification: str = "6x",
                        log: Optional[Logger] = None) -> Path:
    """Rescale a 15x-deconvolved 2D series to the 6x or 12x grid
    (reference supplements/convert_deconvolved.py: batch_filter with
    new_size = shape * 0.42 / {1, 0.5} and 8-bit output)."""
    log = log or Logger()
    input_dir = Path(input_dir)
    paths = sorted(p for p in input_dir.iterdir()
                   if p.suffix.lower() in (".tif", ".tiff"))
    if not paths:
        raise FileNotFoundError(f"no TIFFs in {input_dir}")
    shape = tio.imread(paths[0]).shape
    factor = {"6x": 0.42 / 1.0, "12x": 0.42 / 0.5}[magnification]
    new_size = (int(round(shape[0] * factor)), int(round(shape[1] * factor)))
    cfg = ProcessConfig(convert_to_8bit=True, new_size=new_size)
    return convert(input_dir, output_dir, cfg, log=log)
