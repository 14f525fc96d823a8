"""How far the port's zstd and LZMA TIFF reads scale over reader threads.

Writes `--planes` of chip_smoke phase 6's 2000 x 2000 u16 tiles with PIL
(zstd level 1 with predictor 2, LZMA preset 1: chip_smoke phase 18 (i)'s
files) and an uncompressed TIFF of each, then times, serially and on
`--threads` threads (best of `--reps`):

- `io.tiff.imread` of every plane (what the destripe CLI's readers call);
- `io.zstd.zstd_decode` of every zstd strip (the decoder alone);
- `_undo_predictor` of every strip (numpy's cumsum, predictor 2).

Run: `python scripts/tiff_read_threads.py [--planes 16] [--threads 8]`
(PIL needed to write the files; no card).  Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def best(fn, reps):
    out = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        out = min(out, time.perf_counter() - t0)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--planes", type=int, default=16)
    ap.add_argument("--threads", type=int, default=8)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)

    import chip_smoke as cs
    from ipp_tpu_torch.io import tiff as tio
    from ipp_tpu_torch.io.zstd import zstd_decode
    from PIL import Image, TiffImagePlugin

    work = Path(tempfile.mkdtemp(prefix="tiff_threads_",
                                 dir=ROOT / "build"))
    paths = {"zstd": [], "lzma": [], "raw": []}
    for k, z, tile in cs.codec_tiles(1, args.planes):
        for kind in ("zstd", "lzma"):
            info = TiffImagePlugin.ImageFileDirectory_v2()
            tag, level = cs.PIL_FAST[kind]
            info[tag] = level
            info.tagtype[tag] = 4
            if kind == "zstd":
                info[317] = 2
            p = work / f"{kind}_{z}.tif"
            Image.fromarray(tile).save(p, compression=kind, tiffinfo=info)
            paths[kind].append(p)
        p = work / f"raw_{z}.tif"
        tio.write_tiff(p, tile)
        paths["raw"].append(p)
    mb = args.planes * 2000 * 2000 * 2 / 1e6
    pool = ThreadPoolExecutor(args.threads)
    rec = {"planes": args.planes, "threads": args.threads,
           "cpus": len(os.sched_getaffinity(0)), "card": cs.card_line()}
    for kind, ps in paths.items():
        tio.imread(ps[0])
        serial = best(lambda: [tio.imread(p) for p in ps], args.reps)
        threaded = best(lambda: list(pool.map(tio.imread, ps)), args.reps)
        rec[f"imread_{kind}_mb_s"] = [mb / serial, mb / threaded]
    strips, sizes = [], []
    for p in paths["zstd"]:
        with open(p, "rb") as f:
            page = tio._page_from_tags(next(iter(tio._parse_ifds(
                f, "<", False))))
        b = p.read_bytes()
        rows = page.rows_per_strip
        for i, (o, c) in enumerate(zip(page.strip_offsets,
                                       page.strip_counts)):
            strips.append(b[o:o + c])
            sizes.append(min(rows, 2000 - i * rows) * 2000 * 2)

    def decode(chunk):
        return [zstd_decode(c, n) for c, n in chunk]

    jobs = list(zip(strips, sizes))
    parts = [jobs[i::args.threads] for i in range(args.threads)]
    serial = best(lambda: decode(jobs), args.reps)
    threaded = best(lambda: list(pool.map(decode, parts)), args.reps)
    rec["zstd_decode_mb_s"] = [mb / serial, mb / threaded]
    arrs = [np.frombuffer(zstd_decode(c, n), np.uint16).reshape(-1, 2000)
            for c, n in jobs]

    def undo(chunk):
        return [tio._undo_predictor(a.copy(), 2, 1) for a in chunk]

    aparts = [arrs[i::args.threads] for i in range(args.threads)]
    serial = best(lambda: undo(arrs), args.reps)
    threaded = best(lambda: list(pool.map(undo, aparts)), args.reps)
    rec["predictor_mb_s"] = [mb / serial, mb / threaded]
    pool.shutdown()
    for p in work.iterdir():
        p.unlink()
    work.rmdir()
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
