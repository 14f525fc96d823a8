"""Host-RAM admission control for streaming readers.

The reference gates work on available RAM in two places: each converter
worker polls `virtual_memory().available < needed` under a semaphore and
sleeps before taking the next plane (free_ram_is_not_enough,
parallel_image_processor.py:210-217), and the merge step sizes its
worker pool from a bytes-per-thread model against available RAM
(process_images.py:644-655).  The TPU build's single-controller loops
bound memory implicitly through bounded queues and one-batch-in-flight
pipelines; this module adds the same EXPLICIT gate for hosts where other
tenants eat the headroom mid-run.

No psutil dependency: /proc/meminfo's MemAvailable is authoritative on
Linux; other platforms fall back to psutil when present, else the gate
is a no-op (never a crash, never a deadlock).
"""
from __future__ import annotations

import os
import time
from typing import Optional

__all__ = ["available_ram_bytes", "ram_gate", "workers_for_ram"]

_WARNED = False


def _my_rss_bytes() -> int:
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    except Exception:  # noqa: BLE001
        return 0


def available_ram_bytes() -> Optional[int]:
    """Available (not merely free) host RAM in bytes, or None unknown.

    IPP_TPU_RAM_BUDGET_GB imposes a process budget: available is then
    min(real available, budget - this process's RSS) — the endurance
    drive uses it to make the admission gate bind under a constrained
    budget without another tenant (scripts/endurance.py)."""
    budget = os.environ.get("IPP_TPU_RAM_BUDGET_GB")
    cap = None
    if budget:
        cap = max(0, int(float(budget) * 2**30) - _my_rss_bytes())
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    avail = int(line.split()[1]) * 1024
                    return min(avail, cap) if cap is not None else avail
    except OSError:
        pass
    try:  # pragma: no cover — non-Linux fallback
        import psutil

        avail = int(psutil.virtual_memory().available)
        return min(avail, cap) if cap is not None else avail
    except Exception:  # noqa: BLE001
        return cap


def ram_gate(needed_bytes: float, poll_s: float = 0.5,
             timeout_s: float = 60.0) -> None:
    """Block while available RAM < needed_bytes (the reference's
    free_ram_is_not_enough sleep loop).  Bounded: after timeout_s the
    caller proceeds anyway — stalling forever would turn memory pressure
    into a hang, which the reference's 1 s-sleep poll also avoids by
    re-checking rather than blocking.  IPP_TPU_RAM_GATE=0 disables."""
    global _WARNED
    if os.environ.get("IPP_TPU_RAM_GATE", "1") == "0" or needed_bytes <= 0:
        return
    deadline = time.monotonic() + timeout_s
    while True:
        avail = available_ram_bytes()
        if avail is None or avail >= needed_bytes:
            return
        if time.monotonic() >= deadline:
            if not _WARNED:
                _WARNED = True
                print(f"ram_gate: proceeding under memory pressure "
                      f"(available {avail / 2**30:.1f} GiB < needed "
                      f"{needed_bytes / 2**30:.1f} GiB for {timeout_s:.0f}s)",
                      flush=True)
            return
        time.sleep(poll_s)


def workers_for_ram(bytes_per_worker: float, requested: int,
                    reserve_bytes: float = 2 * 2**30) -> int:
    """Cap a worker count by available RAM (the reference's
    merge_step_cores model, process_images.py:644-655): at least one
    worker, at most `requested`, sized against MemAvailable minus a
    reserve."""
    avail = available_ram_bytes()
    if avail is None or bytes_per_worker <= 0:
        return max(1, requested)
    fit = int((avail - reserve_bytes) // bytes_per_worker)
    return max(1, min(requested, fit))
