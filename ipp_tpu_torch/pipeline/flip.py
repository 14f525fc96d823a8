"""Flip a TIFF series on x/y/z axes (reference flip_script.py:1-114).

Matches the reference surface: ``-x``/``-y`` flip each plane's columns/
rows, ``-z`` reverses the plane order (out-of-place: the output filename
list is reversed, flip_script.py:99-101; in-place: first/last planes are
swapped pairwise, :60-76).  Deviation (documented): the reference's
in-place mode ALWAYS performs the pairwise z swap even when ``-z`` was
not requested (its ``execute_pair`` branch ignores ``flip_z``,
flip_script.py:84-97); here the z swap happens only when ``flip_z`` is
set, and in-place x/y-only flips rewrite each file in place.
"""

from __future__ import annotations

import argparse
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional

import numpy as np

from ..io import tiff as tio
from ..utils.progress import ProgressReporter
from ..utils.tifstack import natural_sorted

__all__ = ["flip_series", "main"]


def flip_series(input_dir: Path, output_dir: Optional[Path] = None,
                flip_x: bool = False, flip_y: bool = False,
                flip_z: bool = False, workers: int = 8) -> int:
    """Flip a TIFF series; ``output_dir=None`` flips in place.  Returns
    the number of planes processed."""
    input_dir = Path(input_dir)
    in_place = (output_dir is None
                or Path(output_dir).resolve() == input_dir.resolve())
    if not in_place:
        output_dir = Path(output_dir)
        output_dir.mkdir(parents=True, exist_ok=True)
    paths = [Path(p) for p in natural_sorted(
        str(p) for p in input_dir.iterdir()
        if p.is_file() and p.suffix.lower() in (".tif", ".tiff"))]
    prog = ProgressReporter(len(paths), desc="flip")

    def flip_xy(img):
        if flip_y:
            img = img[::-1]
        if flip_x:
            img = img[:, ::-1]
        return np.ascontiguousarray(img)

    def one(src: Path, dest: Path):
        tio.imwrite(dest, flip_xy(tio.imread(src)))
        prog.step()

    def swap(pair):
        a, b = pair
        if a == b:
            one(a, b)
            return
        img_a, img_b = tio.imread(a), tio.imread(b)
        tio.imwrite(b, flip_xy(img_a))
        tio.imwrite(a, flip_xy(img_b))
        prog.step()
        prog.step()

    with ThreadPoolExecutor(workers) as pool:
        if in_place and flip_z:
            n = len(paths)
            list(pool.map(swap, [(paths[i], paths[n - 1 - i])
                                 for i in range((n + 1) // 2)]))
        else:
            dests = paths if in_place else [output_dir / p.name
                                            for p in paths]
            if flip_z and not in_place:
                dests = dests[::-1]
            list(pool.map(one, paths, dests))
    prog.close()
    return len(paths)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="flip TIFF series")
    p.add_argument("--input", "-i", required=True, type=Path)
    p.add_argument("--output", "-o", type=Path, default=None,
                   help="defaults to flipping in place")
    p.add_argument("--flip-x", "--x", "-x", dest="flip_x",
                   action="store_true")
    p.add_argument("--flip-y", "--y", "-y", dest="flip_y",
                   action="store_true")
    p.add_argument("--flip-z", "--z", "-z", dest="flip_z",
                   action="store_true")
    p.add_argument("--workers", "--num_threads", "-n", type=int, default=8)
    return p


def main(argv=None) -> int:
    p = build_parser()
    args = p.parse_args(argv)
    if not (args.flip_x or args.flip_y or args.flip_z):
        p.error("no axis to flip over (pass -x, -y and/or -z)")
    flip_series(args.input, args.output, args.flip_x, args.flip_y,
                args.flip_z, args.workers)
    return 0


if __name__ == "__main__":
    sys.exit(main())
