"""Channel merge CLI on one device (port of
ipp_tpu/pipeline/merge_channels.py; reference merge_channels.py:1-102,
wrapping process_images.merge_all_channels): align stitched channel
series and write RGB composites.  The ECC of the alignment and the 8-bit
conversion run on the device (`align_channels`); the central blocks, the
roll-pad moves and the composite planes stay on the host."""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

from ..io import tiff as tio
from ..utils.log import Logger
from .align_channels import align_volumes, write_composite_series

__all__ = ["main"]


def _load_central_block(tif_dir: Path, max_planes: int = 32) -> np.ndarray:
    paths = sorted(tif_dir.glob("*.tif"))
    n = len(paths)
    z0 = max(0, n // 2 - max_planes // 2)
    planes = [tio.imread(p) for p in paths[z0:z0 + max_planes]]
    return np.stack(planes).astype(np.float32)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="align channels and write RGB/CMYK composites "
                    "(reference merge_channels.py surface)")
    p.add_argument("--red", type=Path, default=None)
    p.add_argument("--green", type=Path, default=None)
    p.add_argument("--blue", type=Path, default=None)
    p.add_argument("--cyan", "-c", type=Path, default=None)
    p.add_argument("--magenta", "-m", type=Path, default=None)
    p.add_argument("--yellow", "-y", type=Path, default=None)
    p.add_argument("--black", "-k", type=Path, default=None)
    p.add_argument("--output", "--output_path", "-o", required=True,
                   type=Path)
    p.add_argument("--no-align", action="store_true")
    p.add_argument("--convert-to-8bit", "--convert_to_8bit",
                   action="store_true",
                   help="convert each channel to 8-bit before compositing")
    p.add_argument("--bit-shift", "--bit_shift", type=int, default=8,
                   help="right bit shift for the 8-bit conversion (0-8)")
    p.add_argument("--resume", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="skip composite planes that already exist "
                        "(reference merge_channels.py --resume, default "
                        "on there too)")
    p.add_argument("--num_processes", "-n", type=int, default=None,
                   help="accepted for reference compatibility; the "
                        "composite writer is single-process (host IO "
                        "threads are internal)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    log = Logger()

    channels = {}
    colors = {}
    for name, color in (("red", "r"), ("green", "g"), ("blue", "b"),
                        ("cyan", "c"), ("magenta", "m"), ("yellow", "y"),
                        ("black", "k")):
        path = getattr(args, name)
        if path is not None:
            channels[name] = path
            colors[name] = color
    if not channels:
        log.error("no channels given")
        return 2
    if {c for c in colors.values()} & set("cmyk") and \
            {c for c in colors.values()} & set("rgb"):
        log.error("cannot mix RGB and CMYK channels")
        return 2

    offsets = {}
    if not args.no_align and len(channels) > 1:
        ref_name = next(iter(channels))
        ref_block = _load_central_block(channels[ref_name])
        for name, path in channels.items():
            if name == ref_name:
                offsets[name] = (0, 0, 0)
                continue
            block = _load_central_block(path)
            hh = min(ref_block.shape[0], block.shape[0])
            hy = min(ref_block.shape[1], block.shape[1])
            hx = min(ref_block.shape[2], block.shape[2])
            _, off = align_volumes(ref_block[:hh, :hy, :hx],
                                   block[:hh, :hy, :hx])
            offsets[name] = off
            log.info(f"channel {name} offset {off}")
    shifts = ({ch: args.bit_shift for ch in channels}
              if args.convert_to_8bit else None)
    # preserve the input dtype unless converting (the reference keeps
    # images[0].dtype, process_images.py:881)
    first_dir = next(iter(channels.values()))
    first_tif = sorted(Path(first_dir).glob("*.tif"))
    dtype = (np.uint8 if args.convert_to_8bit else
             (tio.imread(first_tif[0]).dtype if first_tif else np.uint16))
    write_composite_series(channels, colors, args.output, offsets,
                           dtype=dtype, right_bit_shifts=shifts,
                           resume=args.resume)
    return 0


if __name__ == "__main__":
    sys.exit(main())
