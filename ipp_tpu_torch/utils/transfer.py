"""Host <-> device transfers of the port's pipelines.

Images keep their numpy dtype on the host.  On the device each numpy dtype
has one torch dtype (`device_dtype`); uint16, which torch has no general
arithmetic for, lives there as int32 (exact, and wide enough for the
chain's shifts and comparisons).  An int32 device image therefore stands
for a uint16 one, and int32 or uint32 host images are not taken.

- `upload`: a host array to the device.  u16 travels as its 16 bits (an
  int16 view, through pinned memory on CUDA) and widens on the device.
- `HostArray`: a device tensor on its way back to the host.
  `copy_to_host_async()` starts a non-blocking copy into pinned memory and
  records a CUDA event; `np.asarray(handle)` waits on that event only.
  This is the handle the one-batch-in-flight fetch
  (`utils.lagged.OneInFlight`, used by
  `parallel.executor.run_tile_pipeline`) expects of a device array.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

__all__ = ["device_dtype", "host_dtype", "upload", "HostArray",
           "HostArrays"]

_DEVICE = {
    np.dtype(np.bool_): torch.bool,
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.uint16): torch.int32,
    np.dtype(np.float16): torch.float16,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.int64): torch.int64,
}
_HOST = {v: k for k, v in _DEVICE.items()}


def device_dtype(dtype) -> torch.dtype:
    """The torch dtype a host image of numpy `dtype` has on the device."""
    dt = np.dtype(dtype)
    if dt == np.float64:   # the reference runs with 64-bit types off
        return torch.float32
    if dt not in _DEVICE:
        raise TypeError(f"images of dtype {dt} are not supported on the "
                        f"device (supported: {sorted(map(str, _DEVICE))})")
    return _DEVICE[dt]


def host_dtype(t: torch.Tensor) -> np.dtype:
    """The numpy dtype a device image of `t`'s dtype stands for."""
    if t.dtype not in _HOST:
        raise TypeError(f"no host image dtype for a {t.dtype} tensor")
    return _HOST[t.dtype]


def upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array -> device tensor of `device_dtype(a.dtype)`."""
    a = np.ascontiguousarray(a)
    dt = device_dtype(a.dtype)
    if a.dtype == np.uint16:
        t = torch.from_numpy(a.view(np.int16))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        return t.to(torch.int32).bitwise_and_(0xFFFF)
    t = torch.from_numpy(a)
    if device.type == "cuda":
        t = t.pin_memory().to(device, non_blocking=True)
    return t.to(dt)


class HostArray:
    """Device tensor `t` as a host numpy array of `host_dtype(t)`, fetched
    lazily: `copy_to_host_async` starts the copy, `np.asarray` waits for
    it.  The device tensor is released once its copy is queued (the
    caching allocator orders reuse on the stream)."""

    def __init__(self, t: torch.Tensor):
        self.dtype = host_dtype(t)
        self.shape = tuple(t.shape)
        self._dev: Optional[torch.Tensor] = t
        self._host: Optional[torch.Tensor] = None
        self._event = None

    def copy_to_host_async(self) -> None:
        if self._dev is None:
            return
        t = self._dev
        if self.dtype == np.uint16:   # back to 16 bits before the copy
            t = torch.where(t > 32767, t - 65536, t).to(torch.int16)
        if t.device.type == "cuda":
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(t.device))
        else:
            host = t
        self._host, self._dev = host, None

    def __array__(self, dtype=None, copy=None):
        self.copy_to_host_async()
        if self._event is not None:
            self._event.synchronize()
            self._event = None
        a = self._host.numpy()
        if self.dtype == np.uint16:
            a = a.view(np.uint16)
        return a if dtype is None else a.astype(dtype, copy=False)


class HostArrays:
    """Device tensors (one batch split over devices, in order) as one
    host array: their first `n` rows along dim 0 after concatenation."""

    def __init__(self, parts, n: Optional[int] = None):
        self._parts = [p if isinstance(p, HostArray) else HostArray(p)
                       for p in parts]
        self._n = n
        rows = sum(p.shape[0] for p in self._parts)
        self.shape = ((rows if n is None else min(n, rows)),) \
            + self._parts[0].shape[1:]

    def copy_to_host_async(self) -> None:
        for p in self._parts:
            p.copy_to_host_async()

    def __array__(self, dtype=None, copy=None):
        a = np.concatenate([np.asarray(p) for p in self._parts])[:self._n]
        return a if dtype is None else a.astype(dtype, copy=False)
