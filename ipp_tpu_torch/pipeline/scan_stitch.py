"""Dragonfly scanner stitch CLI — the tsv/stitch.py equivalent.

The reference's scanner pipeline (/root/reference/tsv/stitch.py:16-193)
walks a three-level directory hierarchy produced by the "dragonfly"
microscope (X / X_Y / Z plane files, all coordinates in 10ths of microns,
piezo travels split into substacks — tsv/scan.py:221-268), aligns every
adjacent substack pair in x, y and z, writes/reads the pairwise offsets as
JSON, solves global stack positions, and emits the blended planes to an
``--output-pattern`` series.

This module reproduces that surface on the ipp_tpu Scanner
(stitch/scan.py): discovery is byte-compatible with the reference's walk
(same coordinate arithmetic, same piezo z-split, .raw-before-tiff plugin
choice), alignment runs through the batched all-shifts NCC engine with
drift-recentered rounds, and positions come from the score-weighted LS
solve.  Documented deviations: the offsets JSON schema is link-based (one
record per aligned pair, not the reference's per-direction z-lists —
load/dump round-trip with THIS tool only); ``--z-skip`` is accepted but
unused (the NCC engine scores whole overlap volumes at once instead of
sampling planes, so there is nothing to skip); ``--n-cores`` is accepted
but unused (alignment is device-batched, there is no CPU alignment pool);
``--loose-x`` is accepted but unused (the score-weighted LS solve already
places every stack individually, strictly looser than the reference's
per-Y x offsets, tsv/scan.py:794-798).
"""

from __future__ import annotations

import argparse
import json
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..geometry.extent import VExtent
from ..io import tiff as tio
from ..stitch.scan import ScanStack, Scanner
from ..utils.log import Logger

__all__ = ["discover_scan_stacks", "main"]


def discover_scan_stacks(
        root: Path,
        voxel_size: Tuple[float, float, float],
        z_stepper_distance: float = 297.0,
        piezo_distance: float = 300.0,
        log: Optional[Logger] = None,
) -> Dict[Tuple[int, int, int], ScanStack]:
    """Walk the dragonfly hierarchy into ScanStacks keyed by grid index.

    Mirrors the reference Scanner.__init__ walk (tsv/scan.py:221-268):
    level-1 folder names are X stage positions in 10ths of microns,
    level-2 names are ``X_Y``, plane files are named by their Z position in
    10ths of microns; a gap of >= ``piezo_distance`` microns starts a new
    substack whose base advances by ``z_stepper_distance``.  Nominal pixel
    positions divide by the voxel size exactly as the reference does.
    """
    xv, yv, zv = voxel_size
    log = log or Logger()
    by_coord: Dict[Tuple[int, int, float], List[Path]] = {}
    root = Path(root)
    for folder in sorted(root.iterdir()):
        if not folder.is_dir():
            continue
        try:
            x = int(float(folder.name) / xv / 10)
        except ValueError:
            continue
        for sub in sorted(folder.iterdir()):
            if not sub.is_dir():
                continue
            parts = sub.name.split("_")
            if len(parts) < 2:
                continue
            try:
                y = int(float(parts[1]) / yv / 10)
            except ValueError:
                continue
            img_paths = sorted(sub.glob("*.raw"))
            if not img_paths:
                img_paths = sorted(sub.glob("*.tif*"))
                if not img_paths:
                    continue
            # names are Z positions in 10ths of microns; a stray
            # non-numeric file (preview.tif, thumbs…) must not silently
            # discard the whole substack — skip it loudly and keep the
            # real planes (the reference would crash on the same input,
            # tsv/scan.py:254)
            path_and_z = []
            for p in img_paths:
                try:
                    path_and_z.append((int(p.name.rsplit(".", 1)[0]) / 10, p))
                except ValueError:
                    log.warn(f"{sub}: ignoring non-plane file {p.name} "
                             f"(name is not a Z position)")
            if not path_and_z:
                continue
            path_and_z.sort()
            z0 = path_and_z[0][0]
            zbase = z0
            current: List[Path] = []
            for z_um, p in path_and_z:
                if z_um - z0 >= piezo_distance:
                    by_coord[(x, y, zbase)] = current
                    current = []
                    zbase += z_stepper_distance
                    z0 = z_um
                current.append(p)
            by_coord[(x, y, zbase)] = current
    if not by_coord:
        raise ValueError(f"no dragonfly stacks found under {root}")
    xs = sorted({k[0] for k in by_coord})
    ys = sorted({k[1] for k in by_coord})
    zs = sorted({k[2] for k in by_coord})
    out: Dict[Tuple[int, int, int], ScanStack] = {}
    for (x, y, zb), paths in by_coord.items():
        key = (xs.index(x), ys.index(y), zs.index(zb))
        out[key] = ScanStack(paths=paths, x0=x, y0=y, z0=int(zb / zv))
    return out


def _dump_offsets(scanner: Scanner, fd) -> None:
    """Link-based offsets JSON (schema deviation documented above)."""
    json.dump({"links": [
        {"k0": list(k0), "k1": list(k1),
         "coord": [int(c) for c in coord],
         "score": float(scanner.scores.get((k0, k1), 0.0))}
        for (k0, k1), coord in sorted(scanner.alignments.items())
    ]}, fd, indent=2)


def _load_offsets(scanner: Scanner, fd) -> None:
    d = json.load(fd)
    scanner.alignments = {}
    scanner.scores = {}
    for link in d["links"]:
        key = (tuple(link["k0"]), tuple(link["k1"]))
        scanner.alignments[key] = tuple(int(c) for c in link["coord"])
        scanner.scores[key] = float(link["score"])


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    """Reference tsv/stitch.py:16-106 argument surface."""
    p = argparse.ArgumentParser(
        description="Align and blend dragonfly piezo-stack hierarchies")
    p.add_argument("--input", required=True,
                   help="root of the input stack tree")
    p.add_argument("--output-pattern", required=True,
                   help="output file-name pattern, e.g. /path/img_%%04d.tiff")
    p.add_argument("--voxel-size", default="1.8,1.8,2.0",
                   help="comma-separated x,y,z voxel size in microns")
    p.add_argument("--z-step", type=float, default=300.0,
                   help="microns per coarse z-stepper step")
    p.add_argument("--piezo-distance", type=float, default=300.0,
                   help="microns of piezo travel per substack")
    p.add_argument("--threshold", type=float, default=0.75,
                   help="minimum NCC score for a usable pair link")
    p.add_argument("--x-slop", type=int, default=30)
    p.add_argument("--y-slop", type=int, default=30)
    p.add_argument("--z-slop", type=int, default=6)
    p.add_argument("--z-skip", default="middle",
                   help="accepted for reference-CLI compatibility; the NCC "
                        "engine always scores the full overlap volume")
    p.add_argument("--dark", type=int, default=200,
                   help="values below this are background")
    p.add_argument("--min-support", type=int, default=5,
                   help="minimum number of same-direction links before an "
                        "unlinked adjacent pair is given their median "
                        "offset (the reference's composite-alignment "
                        "fallback)")
    p.add_argument("--n-cores", type=int, default=None,
                   help="accepted for reference-CLI compatibility; "
                        "alignment runs batched on the device, so there "
                        "is no CPU alignment pool to size")
    p.add_argument("--loose-x", action="store_true",
                   help="accepted for reference-CLI compatibility; the "
                        "LS solve already places every stack "
                        "individually (strictly looser than per-Y x "
                        "offsets)")
    p.add_argument("--rounds", type=int, default=2,
                   help="drift-recentered alignment rounds")
    p.add_argument("--estimate-creep", action="store_true",
                   help="estimate per-stack linear x/y creep before aligning "
                        "(reference ScanStack x_off_per_z/y_off_per_z)")
    p.add_argument("--n-io-cores", type=int, default=8)
    p.add_argument("--log-level", default="WARNING")
    p.add_argument("--compression", type=int, default=3,
                   help="zlib level 0 (none) to 9, as in the reference")
    p.add_argument("--stack-offset-output", default=None,
                   help="write the pairwise offsets JSON here")
    p.add_argument("--stack-offset-input", default=None,
                   help="reuse a previously written offsets JSON")
    p.add_argument("--stacks", default=None,
                   help="write the final stack placements JSON here")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> int:
    opts = parse_args(argv)
    log = Logger()
    if opts.log_level.upper() in ("WARNING", "ERROR", "CRITICAL"):
        log.info = lambda msg: None  # reference --log-level semantics
    voxel_size = tuple(float(v) for v in opts.voxel_size.split(","))
    stacks = discover_scan_stacks(
        Path(opts.input), voxel_size,
        z_stepper_distance=opts.z_step, piezo_distance=opts.piezo_distance,
        log=log)
    log.info(f"discovered {len(stacks)} substacks")
    scanner = Scanner(stacks, dark=float(opts.dark),
                      slop=(opts.y_slop, opts.x_slop, opts.z_slop),
                      min_support=opts.min_support, log=log)
    if opts.stack_offset_input:
        with open(opts.stack_offset_input) as fd:
            _load_offsets(scanner, fd)
    else:
        if opts.estimate_creep:
            scanner.estimate_stack_drifts()
        scanner.align_all_stacks(rounds=max(1, opts.rounds))
    if opts.stack_offset_output:
        with open(opts.stack_offset_output, "w") as fd:
            _dump_offsets(scanner, fd)
    # the reference drops links below --threshold before its global adjust
    # (tsv/scan.py accumulate_offsets / flat_adjust_stacks); low-score links
    # would otherwise pull the LS solve toward noise peaks
    drop = [k for k, s in scanner.scores.items() if s < opts.threshold]
    for k in drop:
        scanner.alignments.pop(k, None)
        scanner.scores.pop(k, None)
    if drop:
        log.info(f"dropped {len(drop)} links below threshold "
                 f"{opts.threshold}")
    scanner.apply_alignments()
    if opts.stacks:
        with open(opts.stacks, "w") as fd:
            json.dump([{"key": list(k),
                        "x0": s.x0, "y0": s.y0, "z0": s.z0,
                        "n_planes": len(s.paths),
                        "paths": [str(p) for p in s.paths]}
                       for k, s in sorted(scanner.stacks.items())], fd,
                      indent=2)
    vol = scanner.volume
    width, height = vol.x1, vol.y1
    level = max(0, min(9, opts.compression))
    compression = f"zlib:{level}" if level > 0 else None

    def write_one(z: int) -> None:
        plane = scanner.imread(
            VExtent(0, width, 0, height, z, z + 1), np.uint16)[0]
        out_path = Path(opts.output_pattern % z)
        # patterns may put the z index in a directory component — the
        # reference mkdirs per plane inside the z loop (tsv/stitch.py:184)
        out_path.parent.mkdir(parents=True, exist_ok=True)
        tio.write_tiff(out_path, plane, compression=compression)

    # blending reads are the heavy part and hold the GIL only in numpy;
    # thread the TIFF writes like the reference's n_io_cores pool
    with ThreadPoolExecutor(max_workers=max(1, opts.n_io_cores)) as ex:
        list(ex.map(write_one, range(vol.z0, vol.z1)))
    log.info(f"wrote {vol.z1 - vol.z0} planes to {opts.output_pattern}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
