"""Halo exchange over the device mesh (port of ipp_tpu/parallel/halo.py:
exchange_halos_z, sharded_map_blocks_z).

The deconvolution block decomposition needs PSF-half halos of *real
neighbour data* (reference LsDeconv load_block symmetric/real padding,
LsDeconv.m:817-898).  When a volume's z axis is split over mesh axis "z",
each slab takes `halo` planes from each z neighbour; the two edge slabs
replicate their own boundary plane instead (as the reference's
ppermute-and-select does).  Within one process a halo is a copy onto the
receiving device (PyTorch orders a cross-device copy against both
devices' current streams); across processes it is a torch.distributed
send / receive of the boundary planes (`batch_isend_irecv`).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import torch
import torch.distributed as dist

from .mesh import Sharded, gather, put, run_on_devices, z_sharding

__all__ = ["exchange_halos_z", "sharded_map_blocks_z"]


def _remote_halos(sh: Sharded, halo: int, axis: int
                  ) -> Dict[Tuple[int, int], torch.Tensor]:
    """Receive the halos this process's slabs need from slabs of other
    processes, and send theirs: {(key, side): planes}, side -1 from the
    previous slab, +1 from the next."""
    from .distributed import _comm_device

    keys = sh.placement.keys()
    mesh = sh.placement.mesh
    pos = {k: n for n, k in enumerate(keys)}
    ops, recvs = [], {}
    dev = _comm_device()
    for key in sh.local_keys():
        slab = sh.shards[key]
        n = pos[key]
        for side, nb in ((-1, n - 1), (1, n + 1)):
            if not 0 <= nb < len(keys) or mesh.is_local(keys[nb]):
                continue
            peer = int(mesh.ranks[keys[nb]])
            mine = slab[:halo] if side < 0 else slab[slab.shape[axis] - halo:]
            ops.append(dist.P2POp(dist.isend, mine.to(dev).contiguous(),
                                  peer))
            buf = torch.empty((halo,) + tuple(slab.shape[1:]),
                              dtype=slab.dtype, device=dev)
            ops.append(dist.P2POp(dist.irecv, buf, peer))
            recvs[key, side] = buf
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return recvs


def exchange_halos_z(sh: Sharded, halo: int) -> List[torch.Tensor]:
    """This process's z slabs of `sh` (split along dim 0 over "z"), each
    extended with `halo` planes of real data from its z neighbours, on
    its own device, in z order; the first and last slab of the volume
    replicate their own boundary plane."""
    keys = sh.placement.keys()
    if any(sh.shards[k].shape[0] < halo for k in sh.local_keys()):
        raise ValueError(f"a z slab is thinner than the halo ({halo})")
    remote = _remote_halos(sh, halo, 0)
    out = []
    for key in sh.local_keys():
        slab = sh.shards[key]
        n = keys.index(key)
        parts = []
        for side, nb in ((-1, n - 1), (1, n + 1)):
            if not 0 <= nb < len(keys):   # a volume edge: replicate
                edge = slab[:1] if side < 0 else slab[-1:]
                planes = edge.expand((halo,) + tuple(slab.shape[1:]))
            elif (key, side) in remote:
                planes = remote[key, side]
            else:
                other = sh.shards[keys[nb]]
                planes = other[-halo:] if side < 0 else other[:halo]
            parts.append(planes.to(slab.device))
        out.append(torch.cat([parts[0], slab, parts[1]], 0))
    return out


def sharded_map_blocks_z(fn: Callable[[torch.Tensor], torch.Tensor], mesh,
                         halo: int, axis_name: str = "z"):
    """Wrap fn(block_with_halos) -> block into a z-sharded call: each
    slab, extended by exchanged halos, runs `fn` on its own device, and
    the halo planes are cropped from the result.

    fn sees (local_z + 2*halo, H, W) and returns the same shape.  The
    wrapper takes a whole volume (split over the mesh's "z" entries, the
    result gathered back on the volume's device, or the first slab's for
    a numpy volume) or a `Sharded` one (this process's slabs; the result
    is `Sharded` too)."""
    if axis_name != "z":
        raise ValueError("slabs split over the mesh's 'z' axis")

    def run(vol):
        sh = vol if isinstance(vol, Sharded) else put(
            vol, z_sharding(mesh, vol.ndim))
        ext = exchange_halos_z(sh, halo)

        def local(block):
            out = fn(block)
            return out[halo:out.shape[0] - halo]

        outs = run_on_devices(local, [(e.device, (e,)) for e in ext])
        res = Sharded(sh.placement, sh.shape, dict(zip(sh.local_keys(),
                                                       outs)))
        if isinstance(vol, Sharded):
            return res
        device = vol.device if isinstance(vol, torch.Tensor) else None
        return gather(res, device)

    return run
