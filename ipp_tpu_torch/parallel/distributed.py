"""Multi-process wiring on torch.distributed (port of
ipp_tpu/parallel/distributed.py: initialize, is_multihost, global_mesh,
device_put_global, process_slice; and an all-gather, the counterpart of
jax.experimental.multihost_utils.process_allgather).

The reference scales across nodes with mpi4py master-worker wrappers
(TeraStitcher/pyscripts/Parastitcher.py:410-470) and shared-filesystem
claim files (LsDeconv.m:697-706).  Here every process runs the same
program: `initialize` joins the process group (NCCL when the processes
drive CUDA devices, gloo on the CPU), `global_mesh` lays every process's
local devices out in rank order, `device_put_global` places this
process's rows on its local entries, and `process_slice` says which of n
work items this process reads and writes.

Two layouts of processes and cards are supported:

- one process a card: a launcher sets LOCAL_RANK (torchrun does), and
  the process owns card LOCAL_RANK of those it sees; or it sees one card
  only (CUDA_VISIBLE_DEVICES);
- one process a node, owning every card it sees (no LOCAL_RANK).

Under NCCL each process binds its first card, and collectives and halo
transfers go through that card.  `global_mesh` refuses a mesh in which
two processes name the same card.
"""

from __future__ import annotations

import os
import socket
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..utils.device import cpu_requested
from .mesh import Mesh, Placement, Sharded, _as_tensor, make_mesh

__all__ = ["initialize", "is_multihost", "process_count", "process_index",
           "process_devices", "global_mesh", "device_put_global",
           "process_slice", "all_gather", "backend"]


def _active() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    return dist.get_world_size() if _active() else 1


def process_index() -> int:
    return dist.get_rank() if _active() else 0


def backend() -> Optional[str]:
    """The process group's backend ("nccl" or "gloo"), None without one."""
    return dist.get_backend() if _active() else None


# under NCCL: the card this process's collectives and halo transfers use
_BOUND: Optional[torch.device] = None


def process_devices() -> List[torch.device]:
    """This process's cards: with one process a card (LOCAL_RANK set by
    a launcher that starts several on the node), card LOCAL_RANK; else
    every visible card."""
    n = torch.cuda.device_count()
    rank = os.environ.get("LOCAL_RANK")
    if (rank is None or not is_multihost()
            or int(os.environ.get("LOCAL_WORLD_SIZE", 2)) == 1):
        return [torch.device("cuda", i) for i in range(n)]
    if not 0 <= int(rank) < n:
        raise RuntimeError(f"LOCAL_RANK {rank}, but this process sees {n} "
                           f"card(s): one process a card needs a card for "
                           f"each local rank")
    return [torch.device("cuda", int(rank))]


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> bool:
    """Join the process group from the arguments or the reference's
    environment names (JAX_COORDINATOR_ADDRESS, JAX_NUM_PROCESSES,
    JAX_PROCESS_ID).  The address is host:port (or a tcp:// URL) of rank
    0.  NCCL when CUDA devices are the work's (a card is present and the
    CPU was not asked for), each process bound to its first card
    (`process_devices`), else gloo.  A no-op for one process without an
    address; safe to call twice.  Returns True if more than one process
    is joined afterwards."""
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS")
    if num_processes is None and "JAX_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and "JAX_PROCESS_ID" in os.environ:
        process_id = int(os.environ["JAX_PROCESS_ID"])
    if _active():
        return dist.get_world_size() > 1
    if coordinator_address is None and num_processes in (None, 1):
        return False  # single-process run: nothing to join
    if coordinator_address is None:
        raise ValueError("several processes need a coordinator address")
    global _BOUND
    nccl = torch.cuda.is_available() and not cpu_requested()
    url = (coordinator_address if "://" in coordinator_address
           else f"tcp://{coordinator_address}")
    dist.init_process_group("nccl" if nccl else "gloo", init_method=url,
                            world_size=int(num_processes or 1),
                            rank=int(process_id or 0))
    if nccl:   # before the first collective, which builds the communicator
        _BOUND = process_devices()[0]
        torch.cuda.set_device(_BOUND)
    return dist.get_world_size() > 1


def is_multihost() -> bool:
    return process_count() > 1


def _card_id(d: torch.device) -> Optional[str]:
    """Host and UUID of a card (None for a CPU entry, or where this
    PyTorch reports no UUID)."""
    if d.type != "cuda":
        return None
    uuid = getattr(torch.cuda.get_device_properties(d), "uuid", None)
    return None if uuid is None else f"{socket.gethostname()}/{uuid}"


def global_mesh(z_parallel: int = 1,
                local_devices: Optional[Sequence] = None) -> Mesh:
    """("data", "z") mesh over every process's local devices in rank
    order.  `local_devices` defaults to this process's cards
    (`process_devices`); the CPU tests pass a list of CPU entries.  Two
    processes that name one card raise ValueError."""
    local = make_mesh(devices=(process_devices() if local_devices is None
                               else local_devices))
    local = [d for d in local.devices.flat]
    if not is_multihost():
        devices, ranks = local, [0] * len(local)
    else:
        per_rank: List[list] = [None] * process_count()
        dist.all_gather_object(per_rank, [(str(d), _card_id(d))
                                          for d in local])
        devices, ranks, owner = [], [], {}
        for r, entries in enumerate(per_rank):
            for name, card in entries:
                if card is not None and owner.setdefault(card, r) != r:
                    raise ValueError(
                        f"ranks {owner[card]} and {r} both hold card {name} "
                        f"({card}): run one process a node, or one a card "
                        f"(LOCAL_RANK, or CUDA_VISIBLE_DEVICES)")
            devices += (local if r == process_index()
                        else [torch.device(name) for name, _ in entries])
            ranks += [r] * len(entries)
    n = len(devices)
    if n % z_parallel:
        raise ValueError(f"{n} devices do not split into z_parallel="
                         f"{z_parallel}")
    rows = n // z_parallel
    grid = [devices[r * z_parallel:(r + 1) * z_parallel] for r in range(rows)]
    return Mesh(grid, np.asarray(ranks).reshape(rows, z_parallel),
                rank=process_index())


def device_put_global(array, placement: Placement) -> Sharded:
    """Place an array on a placement that may span processes.  One
    process: `array` is the whole array, split over the devices.  Several:
    `array` is this process's contiguous rows of the split dimension
    (`process_slice`), split over this process's entries in order."""
    from .mesh import put

    if not is_multihost():
        return put(array, placement)
    x = _as_tensor(array)
    keys = placement.local_keys()
    split = [d for d, s in enumerate(placement.spec) if s is not None]
    if len(split) != 1:
        raise ValueError("across processes a placement splits one "
                         "dimension")
    dim = split[0]
    parts = placement.parts(dim)
    n_local = len(keys)
    if x.shape[dim] % n_local:
        raise ValueError(f"{x.shape[dim]} local rows do not split over "
                         f"{n_local} local entries")
    step = x.shape[dim] // n_local
    shards = {}
    for i, key in enumerate(keys):
        piece = x.narrow(dim, i * step, step)
        shards[key] = piece.to(placement.mesh.devices[key]).contiguous()
    shape = list(x.shape)
    shape[dim] = step * parts
    return Sharded(placement, tuple(shape), shards)


def process_slice(n_items: int) -> Tuple[int, int]:
    """[start, stop) of the work items this process reads and writes
    (contiguous split, remainder to the first ranks): the role of
    Parastitcher's rank partitioning (:136-205)."""
    p = process_count()
    r = process_index()
    base, extra = divmod(n_items, p)
    start = r * base + min(r, extra)
    stop = start + base + (1 if r < extra else 0)
    return start, stop


def _comm_device() -> torch.device:
    """Where a collective's buffers live: the CPU under gloo; under NCCL
    the bound card (the current one for a group joined elsewhere)."""
    if backend() != "nccl":
        return torch.device("cpu")
    return _BOUND or torch.device("cuda", torch.cuda.current_device())


def all_gather(t: torch.Tensor) -> torch.Tensor:
    """Every process's `t` (equal shapes), concatenated along dim 0 in
    rank order, on `t`'s device; `t` itself without a process group (a
    one-rank group runs the collective)."""
    if not _active():
        return t
    dev = _comm_device()
    src = t.to(dev).contiguous()
    outs = [torch.empty_like(src) for _ in range(process_count())]
    dist.all_gather(outs, src)
    return torch.cat(outs).to(t.device)
