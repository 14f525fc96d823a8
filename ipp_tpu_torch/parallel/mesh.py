"""Device meshes and shard placement on CUDA devices (port of
ipp_tpu/parallel/mesh.py: make_mesh, default_mesh, data_sharding,
block_sharding).

A `Mesh` is a 2-D array of `torch.device` with axes ("data", "z"), like
the reference's jax.sharding.Mesh: tiles and blocks are data-parallel
over "data"; a large single block shards its z axis over "z".
`mesh.shape` is the dict {"data": n // z, "z": z}.  Each entry also
records the rank of the process that owns it (`parallel.distributed`
builds meshes across processes); a mesh made here is all this process's.

PyTorch has no virtual devices, so `make_mesh(devices=[...])` takes an
explicit list, which may name one device more than once: two shards on
one card, or a mesh of CPU entries for the tests (the counterpart of the
reference's `jax_num_cpu_devices`).

A `Placement` (the reference's NamedSharding) names, per leading
dimension of an array, the mesh axis that splits it ("data", "z" or
None).  `put` splits an array into its shards on their devices, a
`Sharded`; `gather` puts them back together in order; `map_shards` runs a
function on every shard on its own device, one dispatch thread per shard
when the devices are CUDA devices (kernels and torch ops release the GIL,
and a host sync in one shard does not hold up the others).
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.device import cpu_requested

__all__ = ["Mesh", "Placement", "Sharded", "make_mesh", "default_mesh",
           "data_sharding", "block_sharding", "z_sharding", "put", "gather",
           "map_shards", "run_on_devices", "check_mesh"]

AXES = ("data", "z")


def _canonical(device) -> torch.device:
    """`device` as a torch.device with its index; a CUDA device raises
    when no card (or not that card) is present."""
    d = torch.device(device)
    if d.type != "cuda":
        return d
    if not torch.cuda.is_available():
        raise RuntimeError(f"the mesh names {d}, but no CUDA device is "
                           f"available")
    index = torch.cuda.current_device() if d.index is None else d.index
    if index >= torch.cuda.device_count():
        raise RuntimeError(f"the mesh names cuda:{index}, but only "
                           f"{torch.cuda.device_count()} CUDA device(s) "
                           f"are visible")
    return torch.device("cuda", index)


class Mesh:
    """(data, z) grid of devices; `ranks` holds each entry's process."""

    axis_names = AXES

    def __init__(self, devices, ranks=None, rank: int = 0):
        grid = np.empty(np.shape(devices), dtype=object)
        for idx in np.ndindex(grid.shape):
            grid[idx] = devices[idx[0]][idx[1]]
        if grid.ndim != 2 or grid.size == 0:
            raise ValueError(f"a mesh is a non-empty 2-D device grid, got "
                             f"shape {grid.shape}")
        self.devices = grid
        self.ranks = (np.zeros(grid.shape, np.int64) if ranks is None
                      else np.asarray(ranks, np.int64).reshape(grid.shape))
        self.rank = int(rank)

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": int(self.devices.shape[0]),
                "z": int(self.devices.shape[1])}

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def is_local(self, key) -> bool:
        return int(self.ranks[key]) == self.rank

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, "
                f"{[str(d) for d in self.devices.flat]})")


def make_mesh(n_devices: Optional[int] = None, z_parallel: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """Mesh with axes ("data", "z") over the first `n_devices` of
    `devices` (default: every visible CUDA device, each once)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available for a mesh; "
                               "pass devices=[...] explicitly")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [_canonical(d) for d in devices]
    n = n_devices or len(devices)
    if n > len(devices):
        raise ValueError(f"asked for {n} devices, {len(devices)} given")
    if n % z_parallel:
        raise ValueError(f"{n} devices do not split into z_parallel="
                         f"{z_parallel}")
    devices = devices[:n]
    rows = n // z_parallel
    return Mesh([devices[r * z_parallel:(r + 1) * z_parallel]
                 for r in range(rows)])


def check_mesh(mesh, what: str = "mesh"):
    """`mesh` when it is None or a `Mesh`; anything else raises TypeError
    (a caller's mistake must not run on one device unnoticed)."""
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(f"{what} must be a parallel.mesh.Mesh or None, "
                        f"got {type(mesh).__name__}")
    return mesh


def default_mesh():
    """(mesh_or_None, plane_batch): the pipelines' shared policy, as the
    reference's -- a ("data", "z"=1) mesh over the CUDA devices when more
    than one is visible, else no mesh with a 4-plane dispatch batch.  On
    the CPU (IPP_TPU_PLATFORM=cpu, or no card) always (None, 4)."""
    if (not cpu_requested() and torch.cuda.is_available()
            and torch.cuda.device_count() > 1):
        return make_mesh(), 1
    return None, 4


@dataclass(frozen=True)
class Placement:
    """Which mesh axis splits each leading dimension of an array."""

    mesh: Mesh
    spec: Tuple[Optional[str], ...]

    def __post_init__(self):
        for s in self.spec:
            if s not in (None,) + AXES:
                raise ValueError(f"unknown mesh axis {s!r}")

    def keys(self) -> List[Tuple[int, int]]:
        """The mesh entries that hold a distinct shard, in order; an axis
        that splits no dimension is held by its first entry."""
        n_data, n_z = self.mesh.devices.shape
        rows = range(n_data) if "data" in self.spec else range(1)
        cols = range(n_z) if "z" in self.spec else range(1)
        return [(i, j) for i in rows for j in cols]

    def local_keys(self) -> List[Tuple[int, int]]:
        return [k for k in self.keys() if self.mesh.is_local(k)]

    def parts(self, dim: int) -> int:
        axis = self.spec[dim] if dim < len(self.spec) else None
        return 1 if axis is None else self.mesh.shape[axis]

    def block(self, key, dim: int) -> int:
        axis = self.spec[dim] if dim < len(self.spec) else None
        return 0 if axis is None else key[AXES.index(axis)]

    def slices(self, key, shape) -> Tuple[slice, ...]:
        """The slice of a global `shape` that entry `key` holds."""
        out = []
        for d, n in enumerate(shape):
            parts = self.parts(d)
            if n % parts:
                raise ValueError(f"dimension {d} of {tuple(shape)} does not "
                                 f"split into {parts} shards")
            b = self.block(key, d)
            out.append(slice(b * (n // parts), (b + 1) * (n // parts)))
        return tuple(out)


def data_sharding(mesh: Mesh, ndim: int) -> Placement:
    """Shard the leading (batch) axis over "data", replicate the rest."""
    return Placement(mesh, ("data",) + (None,) * (ndim - 1))


def block_sharding(mesh: Mesh, ndim: int) -> Placement:
    """Shard (batch, z, y, x): batch over "data", z over "z"."""
    return Placement(mesh, ("data", "z") + (None,) * (ndim - 2))


def z_sharding(mesh: Mesh, ndim: int) -> Placement:
    """Shard the leading (z) axis of a volume over "z"."""
    return Placement(mesh, ("z",) + (None,) * (ndim - 1))


@dataclass
class Sharded:
    """An array split by `placement`: `shards` maps each of this
    process's mesh entries to its piece, on that entry's device."""

    placement: Placement
    shape: Tuple[int, ...]
    shards: Dict[Tuple[int, int], torch.Tensor] = field(default_factory=dict)

    def local_keys(self) -> List[Tuple[int, int]]:
        return [k for k in self.placement.keys() if k in self.shards]

    def local_tensors(self) -> List[torch.Tensor]:
        return [self.shards[k] for k in self.local_keys()]


def _as_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(x))


def put(x, placement: Placement) -> Sharded:
    """Split a whole array (numpy or tensor) into this process's shards,
    each copied to its entry's device."""
    x = _as_tensor(x)
    shards = {}
    for key in placement.local_keys():
        piece = x[placement.slices(key, x.shape)]
        shards[key] = piece.to(placement.mesh.devices[key],
                               non_blocking=True).contiguous()
    return Sharded(placement, tuple(x.shape), shards)


def _assemble(placement: Placement, tensors: Dict, device) -> torch.Tensor:
    """Concatenate shards keyed by mesh entry into one tensor: within a
    data row along the z-split dimension, then the rows."""
    spec = placement.spec
    z_dim = spec.index("z") if "z" in spec else None
    d_dim = spec.index("data") if "data" in spec else None
    rows = {}
    for (i, j) in placement.keys():
        rows.setdefault(i, []).append(tensors[(i, j)].to(device))
    parts = [torch.cat(r, z_dim) if z_dim is not None else r[0]
             for _, r in sorted(rows.items())]
    return torch.cat(parts, d_dim) if d_dim is not None else parts[0]


def gather(sh: Sharded, device=None) -> torch.Tensor:
    """The whole array on `device` (default: the first shard's); every
    shard must be this process's (`distributed.all_gather` collects the
    others)."""
    missing = [k for k in sh.placement.keys() if k not in sh.shards]
    if missing:
        raise ValueError(f"shards {missing} live in other processes")
    if device is None:
        device = sh.shards[sh.placement.keys()[0]].device
    return _assemble(sh.placement, sh.shards, torch.device(device))


def run_on_devices(fn: Callable, items: Sequence[Tuple[torch.device, tuple]]
                   ) -> list:
    """[fn(*args) for (device, args) in items], each call under its
    device: one thread per item when any device is a CUDA device, else in
    order on this thread.  The first exception propagates (no retry)."""
    def one(device, args):
        if device.type == "cuda":
            with torch.cuda.device(device):
                return fn(*args)
        return fn(*args)

    if len(items) <= 1 or all(d.type != "cuda" for d, _ in items):
        return [one(d, a) for d, a in items]
    with ThreadPoolExecutor(max_workers=len(items)) as pool:
        futs = [pool.submit(one, d, a) for d, a in items]
        return [f.result() for f in futs]


def map_shards(fn: Callable[[torch.Tensor], torch.Tensor], sh: Sharded
               ) -> Sharded:
    """fn on every local shard on its own device; the results keep the
    placement, and their global shape scales each split dimension by its
    number of shards."""
    keys = sh.local_keys()
    outs = run_on_devices(fn, [(sh.shards[k].device, (sh.shards[k],))
                               for k in keys])
    first = outs[0]
    shape = tuple(n * sh.placement.parts(d)
                  for d, n in enumerate(first.shape))
    return Sharded(sh.placement, shape, dict(zip(keys, outs)))
