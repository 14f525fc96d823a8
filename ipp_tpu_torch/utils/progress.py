"""Progress reporting and timing.

Replaces the reference's tqdm-over-Queue progress plumbing
(pystripe/core.py:1774-1803 progress_manager; process_images.py:1046-1059
commands_progress_manger): single-process counters with rate/ETA, safe to
update from worker threads.
"""

from __future__ import annotations

import sys
import threading
import time
from typing import Optional

__all__ = ["ProgressReporter", "StageTimer"]


class ProgressReporter:
    """Carriage-return progress bar.  IPP_TPU_PROGRESS=off silences the
    bar entirely; IPP_TPU_PROGRESS=log switches to one newline-terminated
    line every ~10 s (the reference --noprogressbar / --logprogress pair,
    process_images.py argparse)."""

    def __init__(self, total: int, desc: str = "", unit: str = "it",
                 stream=None, min_interval: float = 0.5):
        import os

        mode = os.environ.get("IPP_TPU_PROGRESS", "bar").lower()
        self._mode = mode if mode in ("bar", "log", "off") else "bar"
        self.total = total
        self.desc = desc
        self.unit = unit
        self.count = 0
        self._lock = threading.Lock()
        self._start = time.time()
        self._last_print = 0.0
        self._stream = stream if stream is not None else sys.stderr
        self._min_interval = 10.0 if self._mode == "log" else min_interval

    def step(self, n: int = 1) -> None:
        with self._lock:
            self.count += n
            now = time.time()
            if (now - self._last_print >= self._min_interval
                    or self.count >= self.total):
                self._last_print = now
                self._print(now)

    def _print(self, now: float) -> None:
        elapsed = now - self._start
        rate = self.count / elapsed if elapsed > 0 else 0.0
        remaining = (self.total - self.count) / rate if rate > 0 else float("inf")
        pct = 100.0 * self.count / self.total if self.total else 100.0
        if self._mode == "off":
            return
        head, tail = ("\r", "") if self._mode == "bar" else ("", "\n")
        msg = (f"{head}{self.desc}: {self.count}/{self.total} ({pct:5.1f}%) "
               f"{rate:8.2f} {self.unit}/s ETA {remaining:6.0f}s{tail}")
        try:
            self._stream.write(msg)
            if self.count >= self.total and self._mode == "bar":
                self._stream.write("\n")
            self._stream.flush()
        except Exception:
            pass

    def close(self) -> None:
        with self._lock:
            self._print(time.time())


class StageTimer:
    """Per-stage wall-clock accounting (the reference logs tic/toc per phase,
    LsDeconv.m:650)."""

    def __init__(self):
        self.stages = {}
        self._current: Optional[str] = None
        self._t0 = 0.0

    def start(self, name: str) -> None:
        self.stop()
        self._current = name
        self._t0 = time.time()

    def stop(self) -> None:
        if self._current is not None:
            self.stages[self._current] = (
                self.stages.get(self._current, 0.0) + time.time() - self._t0)
            self._current = None

    def report(self) -> str:
        self.stop()
        total = sum(self.stages.values())
        lines = [f"  {k:<28s} {v:8.1f}s ({100 * v / total:4.1f}%)"
                 for k, v in sorted(self.stages.items(), key=lambda kv: -kv[1])]
        return "\n".join([f"stage timing (total {total:.1f}s):"] + lines)
