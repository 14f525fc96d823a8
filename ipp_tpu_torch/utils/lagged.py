"""One-slot lagged device->host fetch pipeline.

Every streaming loop in the pipelines (converter plane stream, tile
executor, decon block loop, merge plane batches, FNT cubes) wants the
same overlap: batch k's device->host copy streams back while batch k+1
reads/uploads/dispatches, so the two link directions of a remote
backend overlap instead of serializing.  The reference gets the same
effect from process pools (pystripe/core.py:1687-1771) and its GPU
semaphore workers (fnt_cube_processor.py:227-388); on a single
controller the primitive is `copy_to_host_async` plus holding exactly
one batch in flight.

Usage:
    lag = OneInFlight()                  # depth=0 serializes (A/B lever)
    ...
    done = lag.put(item, dev_array)      # kicks dev_array's async copy
    if done is not None:
        drain(done)                      # previous item, copy underway
    ...
    for item in lag.flush():
        drain(item)
"""
from __future__ import annotations

from typing import Any, List, Optional

__all__ = ["OneInFlight"]


class OneInFlight:
    """Holds up to `depth` items; `put` returns the displaced oldest
    item (or None), `flush` returns-and-clears the rest in order."""

    def __init__(self, depth: int = 1):
        self.depth = max(0, int(depth))
        self._slots: List[Any] = []

    def __len__(self) -> int:
        return len(self._slots)

    def put(self, item: Any, *handles: Any) -> Optional[Any]:
        """Kick copy_to_host_async on each handle (numpy results and
        backends without async copy are fine — the later np.asarray in
        the caller's drain is then the first and only fetch), enqueue
        `item`, and return the oldest item once more than `depth` are
        held."""
        for h in handles:
            try:
                h.copy_to_host_async()
            except Exception:  # noqa: BLE001 — np output / no async copy
                pass
        self._slots.append(item)
        if len(self._slots) > self.depth:
            return self._slots.pop(0)
        return None

    def flush(self) -> List[Any]:
        """Return all held items (oldest first) and empty the pipeline."""
        items, self._slots = self._slots, []
        return items
