#!/usr/bin/env python3
"""Time fastio's share of two CLIs on one CUDA card, this tree against
another tree of the repository.

    python3 scripts/fastio_bench.py --root DIR [--runs N]
                                    [--only deconvolve|stitch]

The inputs are `chip_smoke.py`'s, made once by this tree's helpers: phase
4's series (512 u16 planes of 1024^2 with beads, `make_series`) for the
deconvolution CLI (`pipeline.deconvolve.main`, 10 iterations), and phase
12's tree (3 x 3 stacks of 32 u16 planes of 2000^2, `write_stitch_tree`)
for the stitch (`pipeline.process_images.main`, phase 12's flags).  Each
CLI runs in a process of its own, for this tree and for DIR's (an
unpacked `git archive` of an earlier commit: `mkdir -p build/parent &&
git archive <commit> | tar -x -C build/parent`), in turns (this, DIR, DIR,
this, this, DIR for 3 runs each), every run into an empty output
directory; the page cache holds the inputs (warm reads).  Before the timed
runs one process per tree builds its CUDA kernels (DIR takes this tree's
library where the kernel sources are the same bytes) and reports whether
its fastio builds (`native.available()`, `native.build_error()`), so no
build is timed.  Each run reports its wall, the stitch its `StageTimer`
seconds per stage; the outputs of every run are held to the first run's:
the decoded planes equal (a difference fails the bench), and whether the
files' bytes are equal too.  Prints the medians and spread of each tree,
the card's name and power limit; writes chiprun_out/fastio_bench.json.
"""

from __future__ import annotations

import json
import os
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (the smoke's input makers)


def arg(name, default=None):
    return sys.argv[sys.argv.index(name) + 1] if name in sys.argv else default


PARENT = Path(arg("--root")).resolve() if "--root" in sys.argv else None
RUNS = int(arg("--runs", "3"))
ONLY = arg("--only")

# A CLI run in a process of its own: argv kind, input, output, flags (JSON)
CHILD = r"""
import hashlib, json, sys, time
from pathlib import Path
import torch
from ipp_tpu_torch import native
from ipp_tpu_torch.io import tiff as tio

kind, src, out, flags = sys.argv[1], sys.argv[2], Path(sys.argv[3]), \
    json.loads(sys.argv[4])
rec = dict(fastio=native.available(), fastio_error=native.build_error())
if kind == "build":
    from ipp_tpu_torch.ops._build import load_library
    load_library()
    print(json.dumps(rec))
    sys.exit(0)
torch.zeros(1, device="cuda")
if kind == "deconvolve":
    from ipp_tpu_torch.pipeline import deconvolve as pdc
    t0 = time.perf_counter()
    rc = pdc.main(["-i", src, "-o", str(out), *flags])
    torch.cuda.synchronize()
    rec.update(rc=rc, wall_s=time.perf_counter() - t0)
    planes = sorted(out.glob("img_*.tif"))
else:
    from ipp_tpu_torch.pipeline import process_images as pim
    from ipp_tpu_torch.utils.progress import StageTimer
    timers = []

    class Recorded(StageTimer):
        def __init__(self):
            super().__init__()
            timers.append(self)

    pim.StageTimer = Recorded
    t0 = time.perf_counter()
    rc = pim.main(["--input", src, "--preprocessed", str(out) + "_pre",
                   "--stitched", str(out), *flags])
    torch.cuda.synchronize()
    rec.update(rc=rc, wall_s=time.perf_counter() - t0,
               stages=dict(timers[0].stages) if timers else {})
    planes = sorted(out.rglob("*.tif"))
arrays, files = hashlib.sha256(), hashlib.sha256()
for p in planes:
    arrays.update(tio.imread(p).tobytes())
    files.update(p.read_bytes())
rec.update(planes=len(planes), arrays_sha=arrays.hexdigest(),
           files_sha=files.hexdigest())
print(json.dumps(rec))
"""


def child(tree: Path, kind, src="", out="", flags=()):
    env = dict(os.environ, PYTHONPATH=str(tree))
    res = subprocess.run([sys.executable, "-c", CHILD, kind, str(src),
                          str(out), json.dumps(list(flags))], cwd=str(tree),
                         env=env, capture_output=True, text=True,
                         timeout=1800)
    if res.returncode != 0:
        raise RuntimeError(f"{kind} in {tree}: {res.stderr[-3000:]}")
    return json.loads(res.stdout.splitlines()[-1])


def share_kernels(parent: Path):
    """Copy this tree's built kernel library into DIR's build directory
    where DIR's kernel sources hash to the same name (the same bytes)."""
    for lib in (ROOT / "build" / "ipp_tpu_torch").glob(
            "libipp_tpu_torch_*.so"):
        dst = parent / "build" / "ipp_tpu_torch" / lib.name
        if not dst.exists():
            dst.parent.mkdir(parents=True, exist_ok=True)
            shutil.copy2(lib, dst)


def spread(v):
    return dict(median=statistics.median(v), min=min(v), max=max(v),
                runs=v)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device")
        return 1
    if PARENT is None or not (PARENT / "ipp_tpu_torch").is_dir():
        print("FAIL: --root DIR must hold another tree of the repository")
        return 1
    from ipp_tpu_torch.ops.psf import make_psf

    card = cs.card_line()
    print(f"card: {card}")
    dev = torch.device("cuda", 0)
    work = ROOT / "build" / "fastio_bench"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    trees = {"this": ROOT, "parent": PARENT}
    record = dict(card=card, runs=RUNS, trees={k: str(v) for k, v in
                                               trees.items()})
    for name in ("this", "parent"):   # builds, untimed
        t0 = time.perf_counter()
        info = child(trees[name], "build")
        record.setdefault("build", {})[name] = dict(
            info, seconds=time.perf_counter() - t0)
        print(f"{name}: fastio {'built' if info['fastio'] else 'not built'}"
              + ("" if info["fastio"] else
                 f" ({(info['fastio_error'] or '').splitlines()[-1][:200]})")
              + f"; kernels ready in {time.perf_counter() - t0:.1f} s")
        if name == "this":
            share_kernels(PARENT)
    jobs = []
    if ONLY in (None, "deconvolve"):
        psf_xyz, _, _ = make_psf(dxy=406.0, dz=800.0)
        t0 = time.perf_counter()
        cs.make_series(torch, dev, psf_xyz.transpose(2, 1, 0),
                       work / "series")
        print(f"phase 4's series written in {time.perf_counter() - t0:.1f} s")
        jobs.append(("deconvolve", work / "series",
                     ["--niter", str(cs.NITER)]))
    if ONLY in (None, "stitch"):
        t0 = time.perf_counter()
        cs.write_stitch_tree(torch, dev, work / "raw")
        print(f"phase 12's tree written in {time.perf_counter() - t0:.1f} s")
        jobs.append(("stitch", work / "raw", cs.STITCH_FLAGS))
    torch.cuda.empty_cache()
    order = (["this", "parent", "parent", "this"] * RUNS)[:2 * RUNS]
    failed = False
    for kind, src, flags in jobs:
        rows = []
        for i, name in enumerate(order):
            out = work / f"out_{kind}_{i}"
            row = dict(tree=name, **child(trees[name], kind, src, out,
                                          flags))
            shutil.rmtree(out, ignore_errors=True)
            shutil.rmtree(str(out) + "_pre", ignore_errors=True)
            rows.append(row)
            print(f"  {kind} {name}: rc {row['rc']}, {row['wall_s']:.2f} s, "
                  f"fastio {row['fastio']}"
                  + (", stages " + ", ".join(f"{k} {v:.2f}" for k, v in
                                             row["stages"].items())
                     if row.get("stages") else ""))
        first = rows[0]
        same_arrays = all(r["arrays_sha"] == first["arrays_sha"]
                          and r["planes"] == first["planes"] for r in rows)
        same_files = {name: len({r["files_sha"] for r in rows
                                 if r["tree"] == name}) == 1
                      for name in trees}
        same_files["across"] = len({r["files_sha"] for r in rows}) == 1
        summary = {name: spread([r["wall_s"] for r in rows
                                 if r["tree"] == name]) for name in trees}
        if kind == "stitch":
            for name in trees:
                stages = [r["stages"] for r in rows if r["tree"] == name]
                summary[name]["stages"] = {k: statistics.median(
                    s.get(k, 0.0) for s in stages) for k in stages[0]}
        record[kind] = dict(rows=rows, summary=summary,
                            arrays_equal=same_arrays, files_equal=same_files)
        ok = same_arrays and all(r["rc"] == 0 for r in rows)
        failed |= not ok
        t, p = summary["this"]["median"], summary["parent"]["median"]
        print(f"{kind}: this {t:.2f} s (min {summary['this']['min']:.2f}, "
              f"max {summary['this']['max']:.2f}), parent {p:.2f} s (min "
              f"{summary['parent']['min']:.2f}, max "
              f"{summary['parent']['max']:.2f}): {t / p:.3f}x; planes equal "
              f"{same_arrays} ({first['planes']}), files byte-equal "
              f"{same_files}")
        if kind == "stitch":
            print("  stage medians (s): " + "; ".join(
                f"{name} " + ", ".join(f"{k} {v:.2f}" for k, v in
                                       summary[name]["stages"].items())
                for name in trees))
    shutil.rmtree(work, ignore_errors=True)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "fastio_bench.json").write_text(json.dumps(record, indent=1))
    print(f"card: {cs.card_line()}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
