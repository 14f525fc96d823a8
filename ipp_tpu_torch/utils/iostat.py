"""Thread-safe per-stage time/byte accounting for pipeline runs.

Lets a benchmark (or a verbose pipeline run) decompose an end-to-end
wall-clock into host-decode / host-encode / device-upload / device-fetch
components measured INSIDE the production code paths, instead of
estimating them from side measurements.  The reference has no analog —
its per-stage numbers come from separate runs (LsDeconvolveMultiGPU/
README.md benchmarks); here the accounting rides along a real run.

Accumulated seconds are THREAD-seconds (reads/writes happen on thread
pools, so concurrent work sums to more than wall-clock); byte counts are
exact.  Overhead when disabled is a single module-attribute check.
"""

from __future__ import annotations

import threading
import time
from typing import Dict

ACTIVE = False
_lock = threading.Lock()
_acc: Dict[str, float] = {}


def enable() -> None:
    """Reset counters and start accounting."""
    global ACTIVE
    with _lock:
        _acc.clear()
        ACTIVE = True


def disable() -> Dict[str, float]:
    """Stop accounting and return {key_s: seconds, key_bytes: bytes}."""
    global ACTIVE
    with _lock:
        ACTIVE = False
        out = dict(_acc)
        _acc.clear()
        return out


def snapshot() -> Dict[str, float]:
    with _lock:
        return dict(_acc)


def add(key: str, seconds: float, nbytes: int = 0) -> None:
    """Accumulate a span; call sites guard on `iostat.ACTIVE` themselves
    so the disabled cost is one attribute load."""
    with _lock:
        _acc[key + "_s"] = _acc.get(key + "_s", 0.0) + seconds
        if nbytes:
            _acc[key + "_bytes"] = _acc.get(key + "_bytes", 0) + nbytes


class span:
    """Context manager form: `with iostat.span("device_fetch", nbytes): ...`
    (no-op when accounting is disabled)."""

    def __init__(self, key: str, nbytes: int = 0):
        self.key = key
        self.nbytes = nbytes

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if ACTIVE:
            add(self.key, time.perf_counter() - self.t0, self.nbytes)
        return False
