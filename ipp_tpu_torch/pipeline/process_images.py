"""End-to-end stitching orchestrator on one GPU — the process_images.py
equivalent (port of ipp_tpu/pipeline/process_images.py: build_parser,
process_channel, _merge_stage, mip_calibrate, stitch_test, main and their
helpers; same flags, on-disk layout and resume behaviour).

Usage: python -m ipp_tpu_torch.pipeline.process_images --input DIR
          [--stitched DIR] [--objective 15x] [...]

Re-design of the reference CLI (process_images.py:1062-1726): per channel,
  1. inspect tiles / substitute dummies for missing files (:160-193),
  2. preprocess tiles (destripe/dark/flat -> cache dir; batch_filter),
  3. steps 1-5: import grid, pairwise NCC displacements over z-subvolumes,
     project, threshold, MST placement (replaces the TeraStitcher binaries
     and the Parastitcher MPI wrapper),
  4. step 6: blended merge to a 2D TIFF series + isotropic downsample ->
     npz for atlas registration (replaces TSV + parallel_image_processor),
  5. optional channel alignment + RGB composite (align_channels module) and
     export conversions (ipp_tpu.io exports).

Microscope presets (objective -> voxel size / tile size) and the
channel-color table mirror process_images.py:52-64.

Device work (stage-1 destripe with the DWT through the CUDA kernel K5,
lightsheet correction, NCC maps, blend and merge post-processing, the
isotropic downsample, the channel alignment's ECC of `--rgb-composite`)
runs on one device, the merge blending 4 planes per device chain (the
reference's single-device policy); with more than one CUDA device (or an
explicit mesh) the preprocess, the NCC maps of step 2 and the merge of
step 6 with its post-processing split over the mesh's devices, one plane a
device in the merge (the role of the reference's MPI Parastitcher
fan-out, process_images.py:542-548).
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..geometry.stacks import TileGrid
from ..io import tiff as tio
from ..ops.process import ProcessConfig
from ..stitch.align import compute_displacements
from ..stitch.merge import downsampled_npz, merge_to_tif_series
from ..stitch.place import (place_tiles_mst, project_displacements,
                            threshold_displacements)
from ..utils.device import resolve_device
from ..utils.log import Logger
from ..utils.progress import StageTimer
from .pystripe_cli import _resolve_compression, batch_filter

__all__ = ["ALL_CHANNELS", "get_voxel_sizes", "process_channel", "main"]

# (channel folder name, rgb color) — reference process_images.py:52-58
ALL_CHANNELS: List[Tuple[str, str]] = [
    ("Ex_488_Em_525", "b"), ("Ex_561_Em_600", "g"), ("Ex_647_Em_690", "r"),
    ("Ex_642_Em_690", "r"), ("Ex_488_Em_1", "b"), ("Ex_561_Em_1", "g"),
    ("Ex_642_Em_1", "r"), ("Ex_488_Ch0", "b"), ("Ex_561_Ch1", "g"),
    ("Ex_642_Ch2", "r"), ("Ex_488_Em_2", "b"), ("Ex_561_Em_2", "g"),
    ("Ex_642_Em_2", "r"), ("Ex_642_Em_680", "r"),
]

# objective -> ((tile_y, tile_x), voxel_xy) — reference process_images.py:59-64
OBJECTIVES = {
    "4x": ((1600, 2000), 1.809),
    "8x": ((2000, 2000), 0.82),
    "9x": ((2000, 2000), 0.72),
    "10x": ((2000, 2000), 0.62),
    "15x": ((2000, 2000), 0.41),
    "40x": ((2048, 2048), 0.14),
}

# tiff/raw native + the generic 2D plugin surface (io/generic2d.py,
# the reference's optional opencv2D/bioformats2D input plugins)
from ..io.generic2d import PLANE_SUFFIXES as SUPPORTED_EXTENSIONS  # noqa: E402


def get_voxel_sizes(objective: str, channel_path: Path
                    ) -> Tuple[float, float, float, Tuple[int, int]]:
    """Voxel sizes from the objective preset + z-step from tenths-of-um
    filenames (reference get_voxel_sizes, process_images.py:89-148)."""
    if objective not in OBJECTIVES:
        raise ValueError(f"unsupported objective {objective!r}")
    tile_size, voxel_xy = OBJECTIVES[objective]
    voxel_z = None
    for x_folder in sorted(p for p in channel_path.iterdir() if p.is_dir()):
        for y_folder in sorted(p for p in x_folder.iterdir() if p.is_dir()):
            files = sorted(f for f in y_folder.iterdir()
                           if f.suffix.lower() in SUPPORTED_EXTENSIONS)
            if len(files) > 1:
                try:
                    voxel_z = (int(files[1].stem) - int(files[0].stem)) / 10.0
                    break
                except ValueError:
                    continue
        if voxel_z is not None:
            break
    if voxel_z is None:
        voxel_z = 1.0
    return voxel_xy, voxel_xy, voxel_z, tile_size


def inspect_for_missing_tiles(channel_path: Path, log: Logger) -> int:
    """Write dummy (zero) images for missing z planes so every stack has a
    complete series (reference inspect_for_missing_tiles_get_files_list,
    process_images.py:160-193)."""
    n_fixed = 0
    stacks = []
    for x_folder in sorted(p for p in channel_path.iterdir() if p.is_dir()):
        for y_folder in sorted(p for p in x_folder.iterdir() if p.is_dir()):
            files = sorted(f for f in y_folder.iterdir()
                           if f.suffix.lower() in SUPPORTED_EXTENSIONS)
            stacks.append((y_folder, files))
    if not stacks:
        return 0
    max_count = max(len(f) for _, f in stacks)
    template = None
    for y_folder, files in stacks:
        if len(files) == max_count and template is None:
            template = files
    names = [f.name for f in template]
    shape = None
    for y_folder, files in stacks:
        have = {f.name for f in files}
        for name in names:
            if name not in have:
                if shape is None:
                    shape = tio.imread(template[0]).shape
                log.warn(f"missing tile replaced with zeros: {y_folder / name}")
                tio.imwrite(y_folder / name,
                            np.zeros(shape, np.uint16))
                n_fixed += 1
    return n_fixed


def process_channel(
    channel_path: Path,
    preprocessed_path: Path,
    stitched_path: Path,
    voxel_um: Tuple[float, float, float],
    tile_size: Tuple[int, int],
    preprocess_cfg: Optional[ProcessConfig],
    overlap_fraction: float = 0.1,
    search_radius: int = 25,
    subvol_dim: int = 100,
    reliability_threshold: float = 0.65,
    cosine_blending: bool = True,
    target_voxel_um: Optional[float] = None,
    convert_to_8bit: bool = False,
    bit_shift: Optional[int] = 8,
    dark: float = 0.0,
    auto_params: bool = False,
    bleach_correction: bool = False,
    background_subtraction: bool = False,
    rotation: int = 0,
    placement_from: Optional[Path] = None,
    compression: Optional[str] = None,
    read_timeout: Optional[float] = None,
    read_sandbox: str = "thread",
    skip_inspection: bool = False,
    io_workers: int = 8,
    resume: bool = False,
    mesh=None,
    log: Optional[Logger] = None,
    device=None,
) -> Path:
    """Full single-channel pipeline (reference process_channel,
    process_images.py:334-786).

    With an explicit `mesh`, or with more than one CUDA device and
    neither `mesh` nor `device` given (`parallel.mesh.default_mesh`), the
    preprocess, step 2 (NCC) and step 6 (merge) split over the mesh's
    devices -- the role of the reference's MPI Parastitcher fan-out
    (process_images.py:542-548); otherwise every step runs on `device`
    (else the resolved one)."""
    from ..parallel import mesh as _mesh

    _mesh.check_mesh(mesh)
    log = log or Logger()
    timer = StageTimer()
    plane_batch = 1
    if mesh is None:
        mesh, plane_batch = (_mesh.default_mesh() if device is None
                             else (None, 4))
    use_mesh = mesh is not None and mesh.size > 1
    mesh = mesh if use_mesh else None
    dev = mesh.devices[0, 0] if use_mesh else resolve_device(device)
    if use_mesh:
        log.info(f"device mesh for steps 1, 2 and 6: {mesh.shape}")
    else:
        log.info(f"steps 1-6 on one device ({dev})")

    timer.start("inspect")
    if not skip_inspection:
        inspect_for_missing_tiles(channel_path, log)

    source_for_stitch = channel_path
    if preprocess_cfg is not None:
        timer.start("preprocess")
        log.info(f"preprocessing {channel_path} -> {preprocessed_path}")
        counters = batch_filter(channel_path, preprocessed_path,
                                preprocess_cfg, resume=resume,
                                workers=io_workers,
                                read_timeout=(300.0 if read_timeout is None
                                              else read_timeout),
                                read_sandbox=read_sandbox, device=dev,
                                mesh=mesh or False)
        # (--timeout 0 disables the read sandbox: executor treats
        # non-positive as no timeout)
        log.info(f"preprocess counters: {counters}")
        source_for_stitch = preprocessed_path

    if placement_from is not None:
        # reuse another (reference) channel's step-5 placement for this
        # channel's tiles (reference
        # --stitch_based_on_reference_channel_alignment,
        # process_images.py:1293-1308,1643-1648): same acquisition ->
        # same stage grid, so its solved offsets transfer verbatim
        timer.start("import")
        grid = TileGrid.from_xml(placement_from,
                                 alt_stack_dir=str(source_for_stitch))
        xml_path = (stitched_path.parent /
                    f"{channel_path.name}_placement.xml")
        stitched_path.mkdir(parents=True, exist_ok=True)
        grid.to_xml(xml_path)
        log.info(f"placement reused from {placement_from} -> {xml_path}")
        return _merge_stage(
            grid, channel_path, stitched_path, timer, log,
            cosine_blending=cosine_blending,
            target_voxel_um=target_voxel_um, voxel_um=voxel_um,
            tile_size=tile_size, convert_to_8bit=convert_to_8bit,
            bit_shift=bit_shift, dark=dark, auto_params=auto_params,
            bleach_correction=bleach_correction,
            background_subtraction=background_subtraction,
            rotation=rotation, compression=compression, resume=resume,
            plane_batch=plane_batch, dev=dev, mesh=mesh)

    timer.start("import")
    grid = TileGrid.from_directory(source_for_stitch,
                                   voxel_um=(voxel_um[1], voxel_um[0],
                                             voxel_um[2]))
    th, tw = grid.flattened()[0].plane_shape
    overlap_v = max(1, int(round(th * overlap_fraction)))
    overlap_h = max(1, int(round(tw * overlap_fraction)))
    # nominal grid uses stage positions; overlap from stage step.  A step
    # that implies a non-positive (or full-tile) overlap means the voxel
    # size / objective flag doesn't match the directory names — warn and
    # fall back to the nominal fraction instead of slicing empty overlaps
    def _first_adjacent(dr, dc):
        # first present adjacent pair in the given direction (sparse
        # grids can miss corner stacks)
        for r in range(grid.n_rows - dr):
            for c in range(grid.n_cols - dc):
                a, b = grid.stacks[r][c], grid.stacks[r + dr][c + dc]
                if a is not None and b is not None:
                    return a, b
        return None

    pair_h = _first_adjacent(0, 1)
    if pair_h is not None:
        oh = tw - (pair_h[1].abs_h - pair_h[0].abs_h)
        if 0 < oh < tw:
            overlap_h = oh
        else:
            log.warn(f"stage-step x overlap {oh} px implausible (check "
                     "--objective / voxel size); using "
                     f"{overlap_fraction:.0%} of tile width")
    pair_v = _first_adjacent(1, 0)
    if pair_v is not None:
        ov = th - (pair_v[1].abs_v - pair_v[0].abs_v)
        if 0 < ov < th:
            overlap_v = ov
        else:
            log.warn(f"stage-step y overlap {ov} px implausible (check "
                     "--objective / voxel size); using "
                     f"{overlap_fraction:.0%} of tile height")
    log.info(f"grid {grid.n_rows}x{grid.n_cols}, tile {th}x{tw}, "
             f"overlap v={overlap_v} h={overlap_h}")

    timer.start("align (step 2)")
    cands = compute_displacements(
        grid, overlap_v=overlap_v, overlap_h=overlap_h,
        displ_max_v=search_radius, displ_max_h=search_radius,
        displ_max_d=min(search_radius, max(1, grid.flattened()[0].depth // 8)),
        subvol_dim=subvol_dim, mesh=mesh, device=dev)

    timer.start("project/threshold/place (3-5)")
    project_displacements(grid, cands, overlap_v, overlap_h)
    threshold_displacements(grid, reliability_threshold)
    place_tiles_mst(grid)
    xml_path = stitched_path.parent / f"{channel_path.name}_placement.xml"
    stitched_path.mkdir(parents=True, exist_ok=True)
    grid.to_xml(xml_path)
    log.info(f"placement written to {xml_path}")

    return _merge_stage(
        grid, channel_path, stitched_path, timer, log,
        cosine_blending=cosine_blending, target_voxel_um=target_voxel_um,
        voxel_um=voxel_um, tile_size=tile_size,
        convert_to_8bit=convert_to_8bit, bit_shift=bit_shift, dark=dark,
        auto_params=auto_params, bleach_correction=bleach_correction,
        background_subtraction=background_subtraction,
        rotation=rotation, compression=compression, resume=resume,
        plane_batch=plane_batch, dev=dev, mesh=mesh)


def _merge_stage(
    grid, channel_path, stitched_path, timer, log, *, cosine_blending,
    target_voxel_um, voxel_um, tile_size, convert_to_8bit, bit_shift,
    dark, auto_params, bleach_correction, background_subtraction,
    rotation, compression, resume, plane_batch, dev, mesh,
) -> Path:
    """Steps after placement: parameter estimation, merge (step 6) and
    the downsampled npz — shared by the computed-placement path and the
    reused-reference-placement path."""
    cmin = cmed = cmax = None
    if auto_params or bleach_correction:
        # sample the 25/50/75% merged planes to estimate dark + bit shift
        # (reference estimate_img_related_params, process_images.py:594-655;
        # the reference runs it whenever 8-bit conversion OR bleach
        # correction is requested, :599)
        timer.start("estimate params")
        from ..ops.stats import estimate_image_params
        from ..stitch.blend import PlaneBlender
        from ..geometry.extent import VExtent

        stacks_fl = grid.flattened()
        blender = PlaneBlender([s.extent for s in stacks_fl],
                               cosine=cosine_blending, device=dev)
        bbox = grid.volume
        depth = bbox.z1 - bbox.z0
        samples = []
        for frac in (0.25, 0.5, 0.75):
            z = bbox.z0 + min(depth - 1, int(depth * frac))
            ext = VExtent(bbox.x0, bbox.x1, bbox.y0, bbox.y1, z, z + 1)
            samples.append(blender.blend_plane(
                ext, lambda i, e: stacks_fl[i].imread(e), dtype=np.uint16))
        est_dark, est_shift, cmin, cmed, cmax = estimate_image_params(samples)
        log.info(f"auto params: dark={est_dark}, bit_shift={est_shift}, "
                 f"clips=({cmin}, {cmed}, {cmax})")
        dark = dark or float(est_dark)
        bit_shift = est_shift if bit_shift is None else bit_shift

    timer.start("merge (step 6)")
    post_fn = None
    post_fn_device = None
    if bleach_correction or background_subtraction:
        # the reference's merge-stage process_img (process_images.py:
        # 696-727): with bleach correction, dual-band destriping at
        # sigma = 2*min(tile) with coif15, bidirectional, threshold =
        # clip_med, dark = expm1(clip_min) — evening out per-tile
        # brightness/bleaching seams (its bleach_correction_frequency is
        # always None there, :634 commented out — so no Butterworth
        # flat); with background subtraction, the lightsheet local-
        # percentile cleaning runs on the merged plane
        # ("lightsheet": need_lightsheet_cleaning, :720)
        from ..ops.process import ProcessConfig as PC, _chain
        from ..ops.process import process_img as pimg

        flat_stacks = grid.flattened()
        if flat_stacks:
            t0 = flat_stacks[0].extent
            sig = int(min(t0.y1 - t0.y0, t0.x1 - t0.x0))
        else:
            sig = int(min(tile_size))
        if not bleach_correction:
            sig = 0
        merge_cfg = PC(
            sigma=(2 * sig, 2 * sig), wavelet="coif15", bidirectional=True,
            threshold=cmed, bleach_correction_clip_min=cmin,
            bleach_correction_clip_med=cmed, bleach_correction_clip_max=cmax,
            dark=dark, lightsheet=background_subtraction, percentile=0.25,
            convert_to_8bit=convert_to_8bit,
            bit_shift_to_right=(bit_shift if bit_shift is not None else 8),
            d_type="uint16")

        def post_fn(plane):
            return np.asarray(pimg(
                np.clip(plane, 0, 65535).astype(np.uint16), merge_cfg,
                device=dev))

        # the same pipeline on the device, batched: the merge's batched
        # blend runs it on the canvas before the fetch (the process_img
        # role of the reference's merge workers,
        # parallel_image_processor.py:334-384, here without the float
        # canvas ever leaving the device); the clip then truncates to u16,
        # as the reference's astype does
        u16 = np.dtype(np.uint16)

        def post_fn_device(x):
            out = _chain(torch.clamp(x, 0, 65535).to(torch.int32),
                         merge_cfg, u16)
            # the host path's is_uniform_2d -> zeros short-circuit
            # (pystripe/core.py:1231-1246), as a per-plane select
            uni = (x == x[:, :1, :1]).flatten(1).all(dim=1)
            return torch.where(uni[:, None, None],
                               torch.zeros((), dtype=out.dtype,
                                           device=out.device), out)
    elif convert_to_8bit or dark > 0:
        from ..ops.intensity import convert_to_8bit as to8, subtract_dark
        from ..utils.transfer import HostArray, upload

        def _dark_to8(x):
            if dark > 0:
                x = subtract_dark(x, dark)
            if convert_to_8bit:
                x = to8(x, bit_shift if bit_shift is not None else 8)
            return x

        def post_fn(plane):
            x = upload(np.clip(plane, 0, 65535).astype(np.uint16), dev)
            return np.asarray(HostArray(_dark_to8(x)))

        def post_fn_device(x):
            return _dark_to8(torch.clamp(x, 0, 65535).to(torch.int32))

    out_dir, ds_vol = merge_to_tif_series(
        grid, stitched_path, cosine_blending=cosine_blending,
        post_fn=post_fn, post_fn_device=post_fn_device,
        dtype=np.uint8 if convert_to_8bit else np.uint16,
        target_voxel_um=target_voxel_um, resume=resume, rotation=rotation,
        compression=compression, mesh=mesh, plane_batch=plane_batch,
        device=dev)

    if target_voxel_um is not None and ds_vol is not None:
        timer.start("downsample npz")
        bbox = grid.volume
        vox_zyx = (voxel_um[2], voxel_um[1], voxel_um[0])
        shape_yx = (bbox.y1 - bbox.y0, bbox.x1 - bbox.x0)
        if rotation in (90, 270):
            # the npz follows the written (rotated) plane orientation
            # (reference calculate_down_sampling_target axis swap,
            # parallel_image_processor.py:161-164)
            vox_zyx = (vox_zyx[0], vox_zyx[2], vox_zyx[1])
            shape_yx = shape_yx[::-1]
        npz = downsampled_npz(
            ds_vol, stitched_path.parent /
            f"{channel_path.name}_zyx{target_voxel_um:.1f}um.npz",
            vox_zyx, (bbox.z1 - bbox.z0,) + shape_yx,
            target_voxel_um, device=dev)
        log.info(f"downsampled npz: {npz}")

    log(timer.report())
    return out_dir


def mip_calibrate(input_dir: Path, channels: List[str], out_dir: Path,
                  log: Logger) -> int:
    """MIP-first calibration (the reference's interactive workflow,
    README.md:146-160 + its MIP folders): max-project every tile stack
    into a 1-plane dataset with the same hierarchy — stitching it runs in
    seconds, so alignment/threshold/bit-shift parameters can be dialled in
    before committing to the full volume.  Prints the multi-Otsu parameter
    estimates (dark, bit shift) per channel."""
    from ..ops.stats import estimate_image_params

    out_dir = Path(out_dir)
    for ch in channels:
        ch_in = input_dir / ch
        ch_out = out_dir / ch
        sample_mips = []
        n = 0
        for x_folder in sorted(p for p in ch_in.iterdir() if p.is_dir()):
            for y_folder in sorted(p for p in x_folder.iterdir()
                                   if p.is_dir()):
                files = sorted(f for f in y_folder.iterdir()
                               if f.suffix.lower() in SUPPORTED_EXTENSIONS)
                if not files:
                    continue
                mip = None
                for f in files:
                    img = tio.imread(f)
                    mip = img if mip is None else np.maximum(mip, img)
                dst = (ch_out / x_folder.name / y_folder.name / files[0].name)
                dst.parent.mkdir(parents=True, exist_ok=True)
                tio.imwrite(dst, mip)
                if len(sample_mips) < 3:
                    sample_mips.append(mip)
                n += 1
        if not n:
            log.warn(f"{ch}: no stacks found")
            continue
        params = estimate_image_params(sample_mips)
        log.info(f"{ch}: {n} MIP tiles -> {ch_out}")
        log.info(f"{ch}: suggested params from MIP samples: {params}")
    log.info(
        "calibrate on the MIP dataset (e.g. process_images -i "
        f"{out_dir} --auto-params), then re-run on the full data "
        "with the dialled-in flags")
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="TPU-native whole-brain stitching pipeline "
                    "(process_images equivalent; PyTorch/CUDA port)")
    p.add_argument("--input", "-i", required=True, type=Path,
                   help="raw data dir containing channel folders")
    p.add_argument("--preprocessed", "--tmptif", "-t", type=Path,
                   default=None,
                   help="cache dir for preprocessed tiles (reference "
                        "spelling --tmptif)")
    p.add_argument("--need_raw_png_to_tiff_conversion",
                   action=argparse.BooleanOptionalAction, default=True,
                   help="accepted for reference-script compatibility and "
                        "ignored: every pipeline stage decodes raw/png "
                        "natively (io/raw.py, io/generic2d.py), so no "
                        "pre-conversion pass exists to toggle")
    p.add_argument("--stitched", "-s", type=Path, default=None)
    p.add_argument("--objective", default="15x", choices=sorted(OBJECTIVES))
    p.add_argument("--channel", action="append", default=None,
                   help="channel folder name(s); default: auto-discover")
    p.add_argument("--sigma1", type=float, default=250.0)
    p.add_argument("--sigma2", type=float, default=250.0)
    p.add_argument("--wavelet", default="db9")
    p.add_argument("--padding-mode", "--padding_mode", default="reflect",
                   help="destripe pad mode; the reference's production "
                        "call hardwires 'reflect' (process_images.py:436; "
                        "the CLI-level default there is 'wrap', "
                        "process_images.py:1671)")
    p.add_argument("--bidirectional", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="filter streaks in both directions (the "
                        "reference's production call passes True, "
                        "process_images.py:437)")
    p.add_argument("--dark", type=float, default=0.0)
    p.add_argument("--flat", type=Path, default=None,
                   help="flat-field image to divide tiles by "
                        "(reference process_images --flat)")
    p.add_argument("--lightsheet", action="store_true",
                   help="ClearMap-style lightsheet artifact correction "
                        "(reference --lightsheet)")
    p.add_argument("--lightsheet-vs-background", type=float, default=2.0)
    p.add_argument("--artifact-length", type=int, default=150)
    p.add_argument("--gaussian", "-g",
                   action=argparse.BooleanOptionalAction, default=True,
                   help="2D gaussian denoise before destriping "
                        "(reference default ON, process_images.py:1667)")
    p.add_argument("--de-stripe", "--de_stripe", dest="de_stripe",
                   action=argparse.BooleanOptionalAction, default=True,
                   help="--no-de-stripe zeroes the destripe sigmas "
                        "(reference --no-de_stripe)")
    p.add_argument("--skipconf", action="store_true",
                   help="accepted for reference-CLI compatibility "
                        "(this CLI never prompts)")
    p.add_argument("--enable-axis-correction", "--enable_axis_correction",
                   action="store_true",
                   help="accepted for reference-CLI compatibility (.ims "
                        "sources are read axis-correct natively)")
    p.add_argument("--no-preprocess", action="store_true")
    p.add_argument("--mip-calibrate", type=Path, default=None, metavar="DIR",
                   help="build a MIP dataset (1 max-projected plane per "
                        "stack) into DIR and print estimated parameters, "
                        "then exit — the reference's MIP-first calibration "
                        "workflow (README.md:146-160)")
    p.add_argument("--cosine-blending", "--cosine_blending",
                   dest="cosine_blending",
                   action=argparse.BooleanOptionalAction, default=False,
                   help="sin^2 distance blending; the reference default "
                        "is max blending (process_images.py:374,1346)")
    p.add_argument("--search-radius", type=int, default=25)
    p.add_argument("--subvol-dim", type=int, default=100)
    p.add_argument("--threshold", type=float, default=0.65,
                   help="displacement reliability threshold (step 4)")
    p.add_argument("--downsampled-voxel", "--voxel_size_target", "-dt",
                   type=float, default=None,
                   help="isotropic target voxel (um) for npz export "
                        "(reference short -dt, process_images.py:1704)")
    p.add_argument("--isotropic", action="store_true",
                   help="resize tiles in-plane during preprocessing so "
                        "voxels become isotropic (x = y = z)")
    p.add_argument("--timeout", type=float, default=None,
                   help="per-tile read timeout in seconds during "
                        "preprocessing (hung/corrupt reads become zero "
                        "tiles)")
    p.add_argument("--read-sandbox", choices=["thread", "process"],
                   default="thread",
                   help="'process' decodes tiles in kill-able worker "
                        "processes (respawned on timeout) for corrupt-"
                        "prone inputs — the reference's 1-task "
                        "ProcessPoolExecutor sandbox "
                        "(pystripe/core.py:1710-1755)")
    p.add_argument("--convert-to-8bit", "--convert_to_8bit",
                   action="store_true")
    p.add_argument("--bit-shift", type=int, default=None,
                   help="right bit shift for 8-bit conversion; default: "
                        "auto when --auto-params, else 8")
    p.add_argument("--compression", type=str, default=None,
                   help="output TIFF compression ('zlib:N' or None)")
    p.add_argument("--compression_method", "-cm", "-zm", type=str,
                   default=None,
                   help="reference-style method name (ADOBE_DEFLATE, ...; "
                        "reference short -zm, process_images.py:1697)")
    p.add_argument("--compression_level", "-cl", "-zl", type=int, default=1)
    p.add_argument("--background-subtraction", "--background_subtraction",
                   action="store_true",
                   help="lightsheet local-percentile background cleaning "
                        "on the merged planes (the reference's "
                        "postprocessing background subtraction)")
    p.add_argument("--background-subtraction-channels",
                   "--background_subtraction_channels", nargs="+",
                   default=[],
                   help="restrict background subtraction to these "
                        "channels (default: all when enabled)")
    p.add_argument("--reference-channel", "--reference_channel",
                   type=str, default="",
                   help="reference channel name (composite + "
                        "reference-based stitching)")
    p.add_argument("--stitch-on-reference-alignment",
                   "--stitch_based_on_reference_channel_alignment",
                   action="store_true",
                   help="apply the reference channel's placement to the "
                        "other channels (same-acquisition datasets)")
    p.add_argument("--noprogressbar", action="store_true",
                   help="silence progress bars")
    p.add_argument("--logprogress", action="store_true",
                   help="newline progress lines (for log files)")
    p.add_argument("--sparse-data", "--sparse_data", action="store_true",
                   help="accepted for reference compatibility; sparse "
                        "grids (missing stacks) are always tolerated")
    p.add_argument("--skip-inspection", "--skip_inspection",
                   action="store_true",
                   help="skip the missing-tile scan/dummy substitution")
    p.add_argument("--terafly-path", "--terafly_path", type=Path,
                   default=None,
                   help="TeraFly export destination (default: "
                        "STITCHED/<channel>_terafly)")
    p.add_argument("--terafly-channels", "--terafly_channels", "-f",
                   nargs="+", default=[],
                   help="restrict TeraFly export to these channels "
                        "(reference short -f, process_images.py:1651); "
                        "implies --terafly for the listed channels")
    p.add_argument("--nthreads", "-n", type=int, default=8,
                   help="host IO worker threads for preprocessing")
    p.add_argument("--rot90", action="store_true",
                   help="rotate stitched planes 90 degrees (the reference "
                        "rotates by default; here opt-in)")
    p.add_argument("--bleach-correction", "--bleach_correction",
                   action="store_true",
                   help="dual-band destripe the merged planes at "
                        "sigma=2*tile with auto-estimated clips (the "
                        "reference's merge-stage bleach correction)")
    p.add_argument("--bleach-correction-channels",
                   "--bleach_correction_channels", nargs="+", default=[],
                   help="restrict bleach correction to these channels "
                        "(default: all when enabled; reference "
                        "select_channels semantics)")
    p.add_argument("--auto-params", action="store_true",
                   help="estimate dark level and bit shift from sample "
                        "planes (multi-Otsu)")
    p.add_argument("--imaris", "-o", nargs="?", const=True, default=False,
                   help="export each stitched channel to .ims; with a "
                        "path value, write there (reference path form "
                        "--imaris/-o, process_images.py:1649)")
    p.add_argument("--terafly", action="store_true",
                   help="export each stitched channel to a TeraFly pyramid")
    p.add_argument("--rgb-composite", action="store_true",
                   help="align channels and write RGB composites")
    p.add_argument("--composite", type=str, default=None,
                   help="path for the composite RGB tif files; implies "
                        "--rgb-composite (reference flag, "
                        "process_images.py:1638-1640)")
    # GPU-scheduling knobs from the reference surface: accepted so
    # reference launch scripts run unchanged; meaningless on TPU
    p.add_argument("--exclude_gpus", nargs="+", default=[],
                   help="no-op on TPU (reference GPU-index exclusion, "
                        "process_images.py:1718)")
    p.add_argument("--vram_mem_fraction_gpu0", type=float, default=1.0,
                   help="no-op on TPU (reference GPU0 VRAM cap, "
                        "process_images.py:1720)")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--stitch-mip", "--stitch_mip", dest="stitch_mip",
                   action=argparse.BooleanOptionalAction, default=False,
                   help="stitch the <channel>_MIP folders (single-plane "
                        "max projections) instead of the full channels — "
                        "z search and the downsampled npz are skipped "
                        "(reference --stitch_mip, process_images.py:"
                        "1076-1082,562-564,728)")
    p.add_argument("--stitch-test", "--test", dest="stitch_test",
                   action="store_true",
                   help="stitch ONLY the middle slice at STAGE "
                        "coordinates (no alignment) and save it next to "
                        "the stitched output — a quick check of stage-"
                        "coordinate precision and the reference system "
                        "(terastitcher --test, TeraStitcher ui/CLI.cpp:87)")
    return p


def stitch_test(channel_path: Path, stitched_root: Path,
                voxel_um: Tuple[float, float, float],
                cosine_blending: bool = True,
                log: Optional[Logger] = None, device=None) -> Path:
    """TeraStitcher --test mode (ui/CLI.cpp:87, StackStitcher.h:265-275):
    blend the MIDDLE z slice of the whole volume at nominal stage
    coordinates — no displacement computation — so stage precision and
    the chosen reference system can be eyeballed before a full run.
    voxel_um is (vx, vy, vz) — process_channel's convention."""
    from ..geometry.extent import VExtent
    from ..stitch.merge import merge_to_tif_series

    log = log or Logger()
    grid = TileGrid.from_directory(
        channel_path, voxel_um=(voxel_um[1], voxel_um[0], voxel_um[2]))
    vol = grid.volume
    zmid = (vol.z0 + vol.z1) // 2
    out_dir = Path(stitched_root) / f"{channel_path.name}_test"
    merge_to_tif_series(
        grid, out_dir, cosine_blending=cosine_blending,
        tif_prefix="test_middle_slice",
        volume=VExtent(vol.x0, vol.x1, vol.y0, vol.y1, zmid, zmid + 1),
        device=device)
    out = out_dir / "test_middle_slice_000000.tif"
    log.info(f"stage-coordinate middle slice (z={zmid}) -> {out}")
    return out


def preprocess_cfg_from_args(args, flat, new_tile):
    """The per-channel preprocess ProcessConfig exactly as main() builds
    it — shared with pipeline.warmup so the primed destripe executable
    traces the same computation as the production run."""
    if args.no_preprocess:
        return None
    sig = ((args.sigma1, args.sigma2) if args.de_stripe else (0.0, 0.0))
    return ProcessConfig(
        sigma=sig, wavelet=args.wavelet,
        padding_mode=args.padding_mode,
        bidirectional=args.bidirectional,
        dark=args.dark, flat=flat,
        gaussian_filter_2d=args.gaussian,
        lightsheet=args.lightsheet,
        artifact_length=args.artifact_length,
        lightsheet_vs_background=args.lightsheet_vs_background,
        new_size=new_tile)


def resolve_channels(args) -> List[str]:
    """Channel list for a parsed args namespace, with the stitch_mip
    adjustments main() applies (subvol_dim=1, no npz) — shared with
    pipeline.warmup so the enumerated programs match the run.  Mutates
    args exactly as main() does."""
    if args.stitch_mip:
        channels = args.channel or [
            c + "_MIP" for c, _ in ALL_CHANNELS
            if (args.input / (c + "_MIP")).is_dir()]
        args.subvol_dim = 1
        args.downsampled_voxel = None
        return channels
    return args.channel or discover_channels(args.input)


def discover_channels(input_dir: Path) -> List[str]:
    found = []
    names = {d.name for d in input_dir.iterdir() if d.is_dir()}
    for name, _color in ALL_CHANNELS:
        if name in names:
            found.append(name)
    if not found:
        # any dir with a two-level numeric hierarchy counts
        for d in sorted(input_dir.iterdir()):
            if d.is_dir() and any(sub.name.isdigit() for sub in d.iterdir()
                                  if sub.is_dir()):
                found.append(d.name)
    return found


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.noprogressbar or args.logprogress:
        import os as _os

        _os.environ["IPP_TPU_PROGRESS"] = (
            "off" if args.noprogressbar else "log")
    log = Logger(args.input / "ipp_tpu_log.txt"
                 if args.input.exists() else None)
    # stitch_mip stitches the <channel>_MIP folders (single-plane stacks;
    # z subvolumes and the atlas npz are meaningless there — reference
    # process_images.py:1076-1082, subvoldim=1 :564, target_voxel=None
    # :728); the shared helper applies those adjustments
    channels = resolve_channels(args)
    if not channels:
        log.error(f"no channels found under {args.input}")
        return 2
    stitched_root = args.stitched or args.input.parent / (
        args.input.name + "_stitched")
    preproc_root = args.preprocessed or args.input.parent / (
        args.input.name + "_preprocessed")
    log.info(f"channels: {channels}")
    if args.composite and not Path(args.composite).exists():
        # the reference requires the composite PARENT dir to exist up
        # front (process_images.py:1104-1107)
        log.error(f"composite path {args.composite} does not exist")
        return 2
    if args.mip_calibrate is not None:
        return mip_calibrate(args.input, channels, args.mip_calibrate, log)
    dev = resolve_device()
    if args.stitch_test:
        # exclusive of the full pipeline, as in the reference
        # (terastitcher CLI.cpp:709-711)
        for ch in channels:
            vx, vy, vz, _tile = get_voxel_sizes(args.objective,
                                                args.input / ch)
            stitch_test(args.input / ch, stitched_root, (vx, vy, vz),
                        cosine_blending=args.cosine_blending, log=log,
                        device=dev)
        return 0
    flat = None
    if args.flat is not None:
        from ..io import tiff as _tio

        flat = _tio.imread(args.flat).astype(np.float32)
        flat = flat / max(float(flat.mean()), 1e-6)
    bg_channels: List[str] = []
    if args.background_subtraction:
        # reference select_channels (process_images.py:1192-1207): an
        # explicit list restricts; unknown names are an error
        if args.background_subtraction_channels:
            for c in args.background_subtraction_channels:
                if c not in channels:
                    log.error(f"background subtraction channel {c} not "
                              f"among {channels}")
                    return 2
                bg_channels.append(c)
        else:
            bg_channels = list(channels)
    bleach_channels: List[str] = []
    if args.bleach_correction:
        if args.bleach_correction_channels:
            for c in args.bleach_correction_channels:
                if c not in channels:
                    log.error(f"bleach correction channel {c} not "
                              f"among {channels}")
                    return 2
                bleach_channels.append(c)
        else:
            bleach_channels = list(channels)
    for c in args.terafly_channels:
        if c not in channels:
            log.error(f"--terafly-channels entry {c} not among {channels}")
            return 2
    reference_channel = args.reference_channel or channels[0]
    if args.stitch_on_reference_alignment:
        if reference_channel not in channels:
            log.error(f"--reference-channel must be one of {channels}")
            return 2
        # reference channel first so its placement exists for the rest
        # (reference reorder_list, process_images.py:1293-1294)
        channels = ([reference_channel]
                    + [c for c in channels if c != reference_channel])
    from concurrent.futures import ThreadPoolExecutor

    export_pool = ThreadPoolExecutor(max_workers=1)  # one background slot,
    # like the reference's single background conversion process
    export_futs = []
    for ch in channels:
        ch_path = args.input / ch
        vx, vy, vz, tile_size = get_voxel_sizes(args.objective, ch_path)
        log.info(f"channel {ch}: voxel ({vx}, {vy}, {vz}) um")
        new_tile = None
        if args.isotropic and not (vx == vy == vz):
            if args.no_preprocess:
                log.error("--isotropic needs the preprocessing stage "
                          "(it resizes tiles in-plane); drop "
                          "--no-preprocess")
                return 2
            # resize tiles so in-plane voxels land on the z pitch
            # (reference need_up_sizing/need_down_sampling,
            # process_images.py:1163-1186 — it scales the preset
            # tile_size; the ACTUAL tile shape is used here so datasets
            # whose tiles differ from the preset resize correctly)
            sample = next(iter(sorted(
                (args.input / ch).glob("*/*/*.tif*"))), None)
            actual = (tio.imread(sample).shape if sample is not None
                      else tile_size)
            new_tile = (int(round(actual[0] * vy / vz)),
                        int(round(actual[1] * vx / vz)))
            log.info(f"isotropic resize: tile {tuple(actual)} -> "
                     f"{new_tile}, voxel xy -> {vz} um")
            vx = vy = vz
        cfg = preprocess_cfg_from_args(args, flat, new_tile)
        out_dir = process_channel(
            ch_path, preproc_root / ch, stitched_root / ch,
            (vx, vy, vz), tile_size, cfg,
            search_radius=args.search_radius, subvol_dim=args.subvol_dim,
            reliability_threshold=args.threshold,
            cosine_blending=args.cosine_blending,
            target_voxel_um=args.downsampled_voxel,
            convert_to_8bit=args.convert_to_8bit, bit_shift=args.bit_shift,
            dark=args.dark if args.no_preprocess else 0.0,
            auto_params=args.auto_params,
            bleach_correction=ch in bleach_channels,
            background_subtraction=ch in bg_channels,
            rotation=90 if args.rot90 else 0,
            compression=_resolve_compression(args),
            read_timeout=args.timeout,
            read_sandbox=args.read_sandbox,
            skip_inspection=args.skip_inspection,
            io_workers=args.nthreads,
            placement_from=(
                stitched_root / f"{reference_channel}_placement.xml"
                if args.stitch_on_reference_alignment
                and ch != reference_channel else None),
            resume=args.resume, log=log)
        # exports (reference: TeraFly via paraconverter, Imaris via wine
        # ImarisConvertiv — here native, process_images.py:751-783,1452-1471)
        # run on ONE background thread so they overlap the NEXT channel's
        # stitch, the reference's pipeline-overlap pattern (TeraFly
        # conversion as a background process while the next channel
        # stitches, process_images.py:751-783,1291-1293); exports are
        # host-only (pyramid build + HDF5 write), so they hide behind the
        # next channel's device work and IO
        def _exports(ch=ch, out_dir=out_dir, vox=(vz, vy, vx)):
            base = ch[:-4] if ch.endswith("_MIP") else ch
            color = dict(ALL_CHANNELS).get(base, "g")
            # a bare --terafly exports every channel; -f/--terafly_channels
            # implies TeraFly for just the listed channels (reference
            # process_images.py:1216 enables conversion iff the list is
            # non-empty)
            if (args.terafly or args.terafly_channels) and (
                    not args.terafly_channels or ch in args.terafly_channels):
                from ..io.terafly import tif_series_to_terafly

                tf_root = args.terafly_path or stitched_root
                log.info(f"TeraFly export for {ch} ...")
                tif_series_to_terafly(out_dir, tf_root / f"{ch}_terafly",
                                      voxel_um=vox)
            if args.imaris:
                from ..io.ims import tif_series_to_imaris

                # path form: one channel -> the given file; several ->
                # siblings named <channel>.ims next to it (reference
                # process_images.py:1121-1125)
                if isinstance(args.imaris, str):
                    tgt = Path(args.imaris)
                    ims_out = (tgt if len(channels) == 1
                               else tgt.parent / f"{ch}.ims")
                    ims_out.parent.mkdir(parents=True, exist_ok=True)
                else:
                    ims_out = stitched_root / f"{ch}.ims"
                log.info(f"Imaris export for {ch} ...")
                tif_series_to_imaris(
                    out_dir, ims_out, voxel_um=vox,
                    channel_color={"r": "Red", "g": "Green",
                                   "b": "Blue"}[color])

        if args.terafly or args.terafly_channels or args.imaris:
            export_futs.append(export_pool.submit(_exports))
    for f in export_futs:
        f.result()  # surface export errors before declaring success
    export_pool.shutdown(wait=True)
    if (args.rgb_composite or args.composite) and len(channels) >= 2:
        # channel alignment + composite (reference align_main +
        # merge_all_channels, process_images.py:860-1000,1393-1419)
        from .merge_channels import main as merge_main

        color_of = dict(ALL_CHANNELS)
        if args.composite:
            # the reference treats --composite as a PARENT directory and
            # appends "<input>_composite[_MIP]" (process_images.py:
            # 1100-1108; existence validated at startup above)
            composite_dir = Path(args.composite) / (
                args.input.name + "_composite"
                + ("_MIP" if args.stitch_mip else ""))
        else:
            composite_dir = stitched_root / "composite"
        argv2 = ["--output", str(composite_dir)]
        if not args.resume:
            argv2.append("--no-resume")
        used = set()
        for ch in channels:
            # --stitch-mip channels carry a "_MIP" suffix that the color
            # table doesn't know (reference keeps MIP color per base name)
            base = ch[:-4] if ch.endswith("_MIP") else ch
            c = color_of.get(base, "g")
            flag = {"r": "--red", "g": "--green", "b": "--blue"}[c]
            if flag in used:
                log.warn(f"skipping {ch}: color {c} already assigned")
                continue
            used.add(flag)
            argv2 += [flag, str(stitched_root / ch)]
        merge_main(argv2)
    log.info("all channels complete")
    return 0


if __name__ == "__main__":
    sys.exit(main())
