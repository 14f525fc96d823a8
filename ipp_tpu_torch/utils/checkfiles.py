"""Damaged-file scanner — the supplements/check_files.py equivalent.

Walks a dataset for tif/tiff/raw/png/nrrd files, attempts a bounded-time
decode of each on worker threads, reports (and optionally deletes) files
that fail (reference supplements/check_files.py:1-60 prints and unlinks).
The repaired-read path (io.tiff.read_tiff_partial) is deliberately NOT
used here: this tool's job is to find files that need re-acquisition.
"""

from __future__ import annotations

import queue as _queue
import re
import threading
import time
from pathlib import Path
from typing import List, Optional

from ..io import tiff as tio
from ..utils.log import Logger

__all__ = ["check_files", "main"]

_PATTERN = re.compile(r"\.(?:tiff?|raw|png|nrrd)$", re.IGNORECASE)


def _decode(path: Path):
    suffix = path.suffix.lower()
    if suffix == ".nrrd":
        from ..io.nrrd import read_nrrd

        read_nrrd(path)
    elif suffix == ".raw":
        from ..io.raw import raw_imread

        raw_imread(path)
    else:
        tio.read_tiff(path) if suffix in (".tif", ".tiff") else tio.imread(
            path, retries=1)


def check_files(source, delete: bool = False, timeout: float = 200.0,
                workers: int = 8, log: Optional[Logger] = None,
                return_unchecked: bool = False):
    """Return the list of undecodable files under `source` (recursively).

    delete=True unlinks them (the reference's behavior) so a re-acquisition
    or fill_blanks pass can replace them.

    With return_unchecked=True, returns (damaged, unchecked): `unchecked`
    are files that never got a worker before the overall deadline (stalled
    pool) — possibly healthy, NEVER deleted, and kept out of `damaged` so
    re-acquisition workflows don't act on unverified files."""
    log = log or Logger()
    source = Path(source)
    files = [p for p in source.rglob("*") if _PATTERN.search(p.name)]
    bad: List[Path] = []
    unchecked: List[Path] = []
    # DAEMON worker threads (not a ThreadPoolExecutor): permanently-hung
    # decodes (the NFS-stall scenario this tool exists for) can neither
    # pin pool workers past shutdown nor block interpreter exit via the
    # executor's atexit join.  The timeout measures DECODE time, not
    # queue wait: a clogged pool must not mark (and with delete=True
    # destroy) healthy files that never got a worker.
    started = {}
    finished = {}  # path -> exception or None
    events = {p: threading.Event() for p in files}
    work: "_queue.Queue[Optional[Path]]" = _queue.Queue()
    for p in files:
        work.put(p)

    def worker():
        while True:
            try:
                p = work.get_nowait()
            except _queue.Empty:
                return
            started[p] = time.monotonic()
            try:
                _decode(p)
                finished[p] = None
            except BaseException as exc:  # noqa: BLE001
                finished[p] = exc
            events[p].set()

    for _ in range(max(1, workers)):
        threading.Thread(target=worker, daemon=True).start()

    # Overall deadline: if every worker is wedged, queued files never
    # start and the per-file decode clock never begins — without a
    # global bound check_files would poll forever.  Budget = one
    # `timeout` per batch of `workers` files, plus one spare round.
    import math

    deadline = time.monotonic() + timeout * (
        math.ceil(len(files) / max(1, workers)) + 1)

    def mark_bad(p, why):
        log.info(f"damaged: {p} ({why})")
        bad.append(p)
        if delete:
            try:
                p.unlink()
            except OSError:
                pass

    for p in files:
        while True:
            if events[p].wait(timeout=min(timeout, 5.0)):
                exc = finished[p]
                if exc is not None:
                    mark_bad(p, f"{type(exc).__name__}: {exc}")
                break
            t0 = started.get(p)
            if t0 is not None and time.monotonic() - t0 > timeout:
                mark_bad(p, "decode timeout")
                break
            if t0 is None and time.monotonic() > deadline:
                # never started and the pool has been stalled past the
                # whole-run budget: report it (so the caller knows it
                # was NOT verified) but never delete — it may be fine.
                log.info(f"unchecked: {p} (worker pool stalled)")
                unchecked.append(p)
                break
            # not started yet (pool busy) or still within budget
    log.info(f"checked {len(files)} files, {len(bad)} damaged"
             + (f", {len(unchecked)} unchecked (pool stalled)"
                if unchecked else ""))
    if return_unchecked:
        return bad, unchecked
    return bad


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(
        description="find (and optionally delete) damaged image files")
    p.add_argument("source", type=Path)
    p.add_argument("--delete", action="store_true")
    p.add_argument("--timeout", type=float, default=200.0)
    p.add_argument("--workers", type=int, default=8)
    args = p.parse_args(argv)
    bad, unchecked = check_files(args.source, delete=args.delete,
                                 timeout=args.timeout, workers=args.workers,
                                 return_unchecked=True)
    return 1 if (bad or unchecked) else 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
