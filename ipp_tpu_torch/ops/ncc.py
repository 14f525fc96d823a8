"""MIP-NCC pairwise tile alignment on one device (port of
ipp_tpu/ops/ncc.py: NCCParams, NCCResult, compute_mips, ncc_maps_batched,
ncc_map, peak_and_widths, fuse_axis, align_pair, align_pairs_batched).

The all-shifts NCC map of every MIP pair of a batch comes out of one chain
on the device, as in the reference (TeraStitcher's crossmips, compute_NCC,
compute_funcs.cu):

- cross terms for every shift at once by rFFT cross-correlation
  (torch.fft at 2,3,5,7-smooth sizes, the plain counterpart of the
  reference's jnp.fft),
- windowed sums and sums of squares per shift from 2D inclusive prefix sums
  (f32), read at the four window corners by separable row / column takes,
- the NCC of the overlap window with its means subtracted.

Peak, widths and the fusion of the two candidates per axis run on the host
in float64 (tiny data): the reference's code, unchanged.  MIPs of the
overlap volumes are taken on the host in their native dtype, as the
reference does; only the MIPs travel.  With a device mesh the pair batch
pads to a multiple of the mesh's "data" size and splits over its devices
(the reference's `_ncc_maps_sharded`, ncc.py:352-425, the role of
Parastitcher's rank-per-pair step 2); across processes each takes its
`process_slice` of the batch and the maps are all-gathered.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ..utils import iostat
from ..utils.device import resolve_device
from ..utils.transfer import HostArray, upload
from .fftutil import next_fast_len

__all__ = [
    "NCCParams",
    "NCCResult",
    "compute_mips",
    "ncc_maps_batched",
    "ncc_map",
    "peak_and_widths",
    "fuse_axis",
    "align_pair",
    "align_pairs_batched",
]

# reference defaults (PDAlgoMIPNCC.cpp:80-94, S_config.h)
S_NCC_WIDTH_MAX = 100
S_NCC_PEAK_MIN = 0.0


@dataclass
class NCCParams:
    """Mirror of NCC_parms_t (crossmips/CrossMIPs.h:58-86) with the
    PDAlgoMIPNCC defaults."""

    max_thr: float = 0.10
    width_thr: float = 0.80
    min_points: int = 3
    min_dim_ncc_src: int = 25
    min_dim_ncc_map: int = 3
    unr_ncc: float = S_NCC_PEAK_MIN
    inv_coord: int = 0

    def w_range(self, delay: int) -> int:
        return min(delay, S_NCC_WIDTH_MAX - 1)

    def inf_w(self, delays: Tuple[int, int, int]) -> int:
        return max(self.w_range(d) for d in delays) + 1


@dataclass
class NCCResult:
    """Mirror of NCC_descr_t (CrossMIPs.h:47-56): per-axis (V,H,D)
    displacement, NCC peak, and peak width."""

    coord: Tuple[int, int, int]
    ncc_peak: Tuple[float, float, float]
    ncc_width: Tuple[int, int, int]


# ---------------------------------------------------------------------------
# Device chain
# ---------------------------------------------------------------------------


def compute_mips(vol: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Three maximum-intensity projections of a (..., D, V, H) overlap
    volume (reference compute_3_MIPs, crossmips: MIP_xy (V,H), MIP_xz
    (V,D), MIP_yz (H,D))."""
    mip_xy = torch.amax(vol, dim=-3)
    mip_xz = torch.amax(vol, dim=-1).transpose(-1, -2)
    mip_yz = torch.amax(vol, dim=-2).transpose(-1, -2)
    return mip_xy, mip_xz, mip_yz


def _prefix2d(x: torch.Tensor) -> torch.Tensor:
    """Inclusive 2D prefix sum with a leading zero row and column."""
    p = torch.cumsum(torch.cumsum(x, dim=-1), dim=-2)
    return torch.nn.functional.pad(p, (1, 0, 1, 0))


def _corner_sums_sep(ii: torch.Tensor, r0, r1, c0, c1) -> torch.Tensor:
    """Rectangle sums [r0:r1, c0:c1) from an inclusive prefix sum, for
    separable row / column index vectors (rows a function of the first
    shift only, columns of the second): each corner is a row take then a
    column take, as the reference computes it."""
    def take2(rvec, cvec):
        return ii.index_select(-2, rvec).index_select(-1, cvec)

    return take2(r1, c1) - take2(r0, c1) - take2(r1, c0) + take2(r0, c0)


def ncc_maps_batched(m1: torch.Tensor, m2: torch.Tensor, du: int,
                     dv: int) -> torch.Tensor:
    """All-shifts NCC maps for batched MIP pairs.

    m1, m2: (B, U, V) float32 tensors.  Returns (B, 2*du+1, 2*dv+1) f32
    where out[b, du+u, dv+v] = NCC over the overlap of m1 shifted by
    (+u,+v) against m2 — the math of compute_NCC (compute_funcs.cu), all
    shifts at once."""
    if m1.dim() == 2:
        m1, m2 = m1[None], m2[None]
    m1, m2 = m1.float(), m2.float()
    B, U, V = m1.shape
    dev = m1.device
    # NCC is invariant to a per-image affine rescale: remove the global
    # mean and scale so the f32 sums do not cancel catastrophically
    m1 = m1 - m1.mean(dim=(-2, -1), keepdim=True)
    m2 = m2 - m2.mean(dim=(-2, -1), keepdim=True)
    m1 = m1 / torch.clamp(m1.std(dim=(-2, -1), keepdim=True, correction=0),
                          min=1e-30)
    m2 = m2 / torch.clamp(m2.std(dim=(-2, -1), keepdim=True, correction=0),
                          min=1e-30)

    # cross-correlation for every lag by rFFT at fast-composite sizes
    P = next_fast_len(U + du)
    Q = next_fast_len(V + dv)
    f1 = torch.fft.rfft2(m1, s=(P, Q))
    f2 = torch.fft.rfft2(m2, s=(P, Q))
    corr = torch.fft.irfft2(f1 * torch.conj(f2), s=(P, Q))
    # corr[u mod P, v mod Q] = sum_t m1[t+u] m2[t]
    uu = torch.arange(-du, du + 1, device=dev)
    vv = torch.arange(-dv, dv + 1, device=dev)
    cross = corr.index_select(-2, uu % P).index_select(-1, vv % Q)

    # windowed sums via integral images, read at separable corners
    ii1 = _prefix2d(m1)
    ii2 = _prefix2d(m2)
    ii1sq = _prefix2d(m1 * m1)
    ii2sq = _prefix2d(m2 * m2)
    zero = torch.zeros((), dtype=uu.dtype, device=dev)
    # m1 window rows [max(0,u), U+min(0,u)), cols [max(0,v), V+min(0,v))
    r0a, r1a = torch.maximum(zero, uu), U + torch.minimum(zero, uu)
    c0a, c1a = torch.maximum(zero, vv), V + torch.minimum(zero, vv)
    # m2 window: mirrored shift
    r0b, r1b = torch.maximum(zero, -uu), U + torch.minimum(zero, -uu)
    c0b, c1b = torch.maximum(zero, -vv), V + torch.minimum(zero, -vv)

    s1 = _corner_sums_sep(ii1, r0a, r1a, c0a, c1a)
    s2 = _corner_sums_sep(ii2, r0b, r1b, c0b, c1b)
    q1 = _corner_sums_sep(ii1sq, r0a, r1a, c0a, c1a)
    q2 = _corner_sums_sep(ii2sq, r0b, r1b, c0b, c1b)
    n = ((U - uu.abs())[:, None] * (V - vv.abs())[None, :]).float()

    num = cross - s1 * s2 / n
    var1 = torch.clamp(q1 - s1 * s1 / n, min=0.0)
    var2 = torch.clamp(q2 - s2 * s2 / n, min=0.0)
    den = torch.sqrt(var1 * var2)
    return torch.where(den > 1e-12, num / den, torch.zeros_like(num))


def ncc_map(m1, m2, du: int, dv: int, device=None) -> np.ndarray:
    """Single-pair convenience wrapper returning numpy float64; host arrays
    go to `device` (else the resolved device)."""
    dev = (m1.device if isinstance(m1, torch.Tensor)
           else resolve_device(device))
    a = torch.as_tensor(m1, dtype=torch.float32, device=dev)
    b = torch.as_tensor(m2, dtype=torch.float32, device=dev)
    out = ncc_maps_batched(a[None], b[None], du, dv)
    return np.asarray(HostArray(out[0]), dtype=np.float64)


# ---------------------------------------------------------------------------
# Host-side peak, width and fusion (numpy float64, tiny data)
# ---------------------------------------------------------------------------


def _width_1d(profile: np.ndarray, center: int, w_range: int, thr: float,
              min_points: int, inf_w: int) -> int:
    """Peak width along one direction of an NCC map cross-section
    (reference compute_NCC_width, compute_funcs.cu:1131-1253)."""

    def side_width(step: int) -> Tuple[bool, int]:
        w = 1
        while w <= w_range:
            idx = center + step * w
            if idx < 0 or idx >= len(profile) or profile[idx] <= thr:
                return True, w
            w += 1
        return False, w

    found_lo, w_lo = side_width(-1)
    if found_lo:
        found_hi, w_hi = side_width(+1)
        w = max(w_lo, w_hi) if found_hi else w_lo
        # the reference continues the walk from w_lo: total width is the walk
        # position when either side hits the threshold
        if found_hi:
            return max(w_lo, w_hi)
        # fall through to slope fallback for the high side only: the
        # reference merges both estimates; approximate with slope fallback
    # slope-projection fallback: find where the profile stops decreasing
    peak = profile[center]

    def slope_width(step: int) -> int:
        if center + step * min_points < 0 or center + step * min_points >= len(profile):
            return inf_w
        prev = profile[center + step * min_points]
        dist = min_points + 1
        while dist <= w_range:
            idx = center + step * dist
            if idx < 0 or idx >= len(profile):
                break
            if profile[idx] >= prev:
                break
            prev = profile[idx]
            dist += 1
        if dist < 2 * min_points:
            return inf_w
        if peak - prev <= 0:
            return inf_w
        return int(math.floor((dist - 1) * (peak - thr) / (peak - prev)))

    w_minus = slope_width(-1)
    w_plus = slope_width(+1)
    w = max(w_minus, w_plus)
    return min(w, inf_w - 1) if w < inf_w else inf_w


def peak_and_widths(ncc: np.ndarray, delay_u: int, delay_v: int,
                    w_range_u: int, w_range_v: int,
                    params: NCCParams,
                    inf_w: Optional[int] = None
                    ) -> Tuple[int, int, float, int, int]:
    """Find the map peak (search restricted to the central +-delay window of
    a wRange-extended map) and per-direction widths at that peak.

    ncc: ((2*(delay_u+w_range_u)+1), (2*(delay_v+w_range_v)+1)) map.
    Returns (du, dv, peak, width_u, width_v).

    inf_w is the link-global infinite width (reference
    PDAlgoMIPNCC.cpp:92: max over all three unclamped search radii + 1,
    one value shared by every map of the link); the align paths pass it,
    standalone callers get a per-map fallback."""
    eu = delay_u + w_range_u
    ev = delay_v + w_range_v
    if inf_w is None:
        inf_w = max(w_range_u, w_range_v) + 1
    # peak over the central search window (reference searches the original
    # (2*delay+1)^2 map first: libcrossmips.cpp:408-410)
    central = ncc[eu - delay_u: eu + delay_u + 1,
                  ev - delay_v: ev + delay_v + 1]
    ind = int(np.argmax(central))
    pu = ind // central.shape[1] - delay_u
    pv = ind % central.shape[1] - delay_v
    # one refinement pass over the extended neighborhood around the peak
    # (reference compute_Neighborhood iterates maxIter=2 times)
    lo_u = max(-eu, pu - w_range_u)
    hi_u = min(eu, pu + w_range_u)
    lo_v = max(-ev, pv - w_range_v)
    hi_v = min(ev, pv + w_range_v)
    nb = ncc[eu + lo_u: eu + hi_u + 1, ev + lo_v: ev + hi_v + 1]
    ind = int(np.argmax(nb))
    pu = lo_u + ind // nb.shape[1]
    pv = lo_v + ind % nb.shape[1]
    peak = float(ncc[eu + pu, ev + pv])
    thr = params.width_thr * peak

    if 2 * delay_v + 1 < params.min_dim_ncc_map or w_range_v < params.min_dim_ncc_map:
        width_v = inf_w
    else:
        row = ncc[eu + pu, :]
        width_v = _width_1d(row, ev + pv, w_range_v, thr, params.min_points, inf_w)
    if 2 * delay_u + 1 < params.min_dim_ncc_map or w_range_u < params.min_dim_ncc_map:
        width_u = inf_w
    else:
        col = ncc[:, ev + pv]
        width_u = _width_1d(col, eu + pu, w_range_u, thr, params.min_points, inf_w)
    return pu, pv, peak, width_u, width_v


def fuse_axis(d1: int, peak1: float, width1: int, d2: int, peak2: float,
              width2: int, params: NCCParams, inf_w: int
              ) -> Tuple[int, float, int]:
    """Fuse the two per-axis candidates (each axis appears in two NCC maps)
    (reference compute_NCC_alignment, compute_funcs.cu:1597-1680)."""
    if width1 == 1:
        width1 = inf_w
    if width2 == 1:
        width2 = inf_w
    ok1 = peak1 >= params.max_thr and width1 < inf_w
    ok2 = peak2 >= params.max_thr and width2 < inf_w
    if ok1 and ok2:
        if abs(d1 - d2) < min(width1, width2):
            coord = int(math.floor((peak1 * d1 + peak2 * d2) / (peak1 + peak2) + 0.5))
            peak = (peak1 * peak1 + peak2 * peak2) / (peak1 + peak2)
            return coord, peak, max(width1, width2)
        if peak1 / width1 > peak2 / width2:
            return d1, peak1, width1
        return d2, peak2, width2
    if ok1:
        return d1, peak1, width1
    if ok2:
        return d2, peak2, width2
    return params.inv_coord, params.unr_ncc, inf_w


def _ncc_maps_deferred(ma: np.ndarray, mb: np.ndarray, du: int, dv: int,
                       dev: torch.device):
    """Upload a batch of MIP pairs and queue their NCC maps on `dev` now;
    returns a zero-arg fetcher of the (B, 2du+1, 2dv+1) float64 maps whose
    device->host copy is already started, so several map kinds dispatch
    back to back and their round trips overlap (the reference's deferred
    fetch)."""
    with iostat.span("device_ncc", ma.nbytes + mb.nbytes):
        out = HostArray(ncc_maps_batched(upload(ma, dev), upload(mb, dev),
                                         du, dv))
        out.copy_to_host_async()

    def fetch():
        with iostat.span("device_ncc"):  # fetch wait
            return np.asarray(out, np.float64)
    return fetch


def _ncc_maps_sharded(ma: np.ndarray, mb: np.ndarray, du: int, dv: int,
                      mesh, defer: bool = False, device=None):
    """The (B, 2du+1, 2dv+1) float64 NCC maps of a MIP pair batch, the
    batch split over the mesh's "data" devices (padded to a multiple of
    them by repeating the last pair; the extra maps are dropped), each
    device's share dispatched from its own thread.  Without a mesh (or
    with one "data" entry) one chain on `device`, else on the mesh's
    first device.  With defer=True returns a zero-arg fetcher, the maps
    dispatched and their copies started (several processes: computed and
    all-gathered now, as collectives run in one order everywhere)."""
    from ..parallel import distributed
    from ..parallel.mesh import data_sharding, run_on_devices

    n_data = int(mesh.shape["data"]) if mesh is not None else 1
    if n_data <= 1:
        dev = (mesh.devices[0, 0] if mesh is not None
               else resolve_device(device))
        fetch = _ncc_maps_deferred(ma, mb, du, dv, dev)
        return fetch if defer else fetch()
    B = ma.shape[0]
    pad = (-B) % n_data
    if pad:
        ma = np.concatenate([ma, np.repeat(ma[-1:], pad, axis=0)])
        mb = np.concatenate([mb, np.repeat(mb[-1:], pad, axis=0)])
    place = data_sharding(mesh, 3)
    if distributed.is_multihost():
        lo, hi = distributed.process_slice(ma.shape[0])
        a = distributed.device_put_global(np.ascontiguousarray(ma[lo:hi]),
                                          place)
        b = distributed.device_put_global(np.ascontiguousarray(mb[lo:hi]),
                                          place)
        keys = a.local_keys()
        outs = run_on_devices(
            lambda x, y: ncc_maps_batched(x, y, du, dv).cpu(),
            [(a.shards[k].device, (a.shards[k], b.shards[k]))
             for k in keys])
        out = distributed.all_gather(torch.cat(outs)).numpy().astype(
            np.float64)[:B]
        return (lambda: out) if defer else out
    keys = place.keys()
    step = ma.shape[0] // n_data

    def one(i):
        dev = mesh.devices[keys[i]]
        rows = slice(i * step, (i + 1) * step)
        return _ncc_maps_deferred(ma[rows], mb[rows], du, dv, dev)

    fetches = run_on_devices(one, [(mesh.devices[k], (i,))
                                   for i, k in enumerate(keys)])

    def fetch():
        return np.concatenate([f() for f in fetches])[:B]
    return fetch if defer else fetch()


def align_pairs_batched(vols_a: np.ndarray, vols_b: np.ndarray, side: str,
                        overlap: int, delay_v: int, delay_h: int,
                        delay_d: int, params: Optional[NCCParams] = None,
                        mesh=None, _defer: bool = False, device=None):
    """Align a batch of same-shape pairs in three device chains in all.

    vols_a / vols_b: (P, D, V, H) host arrays.  The three NCC map kinds are
    each computed for every pair in one `ncc_maps_batched` call; the per-
    pair host loop does only the tiny peak / width / fusion math.  With a
    `mesh` the pair batch splits over its "data" devices
    (`_ncc_maps_sharded`).  With _defer=True returns the finalizer (the
    maps dispatched, their fetch started) instead of the results, so a
    caller can stack several pair groups.  Returns a list of NCCResult,
    one per pair."""
    from ..parallel.mesh import check_mesh

    check_mesh(mesh)
    dev = None if mesh is not None else resolve_device(device)
    params = params or NCCParams()
    assert vols_a.shape == vols_b.shape and vols_a.ndim == 4
    P, dimk, dimi, dimj = vols_a.shape
    nk = ni = nj = 0
    if side == "ns":
        ni = dimi - overlap
        a = vols_a[:, :, ni:, :]
        b = vols_b[:, :, : dimi - ni, :]
    elif side == "we":
        nj = dimj - overlap
        a = vols_a[:, :, :, nj:]
        b = vols_b[:, :, :, : dimj - nj]
    elif side == "tb":
        nk = dimk - overlap
        a = vols_a[:, nk:, :, :]
        b = vols_b[:, : dimk - nk, :, :]
    else:
        raise ValueError("side must be 'ns', 'we' or 'tb'")
    dimk_v, dimi_v, dimj_v = a.shape[1], a.shape[2], a.shape[3]
    # the link-global infinite width comes from the unclamped radii
    # (reference PDAlgoMIPNCC.cpp:87-92 computes INF_W before libcrossmips
    # clamps the delays against the overlap extents)
    inf_w = params.inf_w((delay_v, delay_h, delay_d))
    delay_v = min(delay_v, max(0, dimi_v - params.min_dim_ncc_src))
    delay_h = min(delay_h, max(0, dimj_v - params.min_dim_ncc_src))
    delay_d = min(delay_d, max(0, dimk_v - params.min_dim_ncc_src))
    wr_v = params.w_range(delay_v)
    wr_h = params.w_range(delay_h)
    wr_d = params.w_range(delay_d)

    # MIPs on the host in the native dtype (a max-reduce is memory-bound
    # either way and the volumes are in host RAM); only the small MIPs
    # are cast to f32 and uploaded
    def host_mips(v):
        return (np.max(v, axis=1).astype(np.float32, copy=False),
                np.ascontiguousarray(
                    np.swapaxes(np.max(v, axis=3), 1, 2),
                    dtype=np.float32),
                np.ascontiguousarray(
                    np.swapaxes(np.max(v, axis=2), 1, 2),
                    dtype=np.float32))

    mips_a = host_mips(a)
    mips_b = host_mips(b)
    fetch_xy = _ncc_maps_sharded(mips_a[0], mips_b[0], delay_v + wr_v,
                                 delay_h + wr_h, mesh, True, dev)
    fetch_xz = _ncc_maps_sharded(mips_a[1], mips_b[1], delay_v + wr_v,
                                 delay_d + wr_d, mesh, True, dev)
    fetch_yz = _ncc_maps_sharded(mips_a[2], mips_b[2], delay_h + wr_h,
                                 delay_d + wr_d, mesh, True, dev)

    def finalize():
        return _finalize_pairs(
            fetch_xy(), fetch_xz(), fetch_yz(), P, side, ni, nj, nk,
            delay_v, delay_h, delay_d, wr_v, wr_h, wr_d, inf_w, params)

    if _defer:
        return finalize
    return finalize()


def _finalize_pairs(ncc_xy, ncc_xz, ncc_yz, P, side, ni, nj, nk,
                    delay_v, delay_h, delay_d, wr_v, wr_h, wr_d, inf_w,
                    params):
    """Host-side peak/width/fusion over fetched NCC maps (tiny data)."""
    failed_xy = delay_v == 0 and delay_h == 0
    failed_xz = delay_v == 0 and delay_d == 0
    failed_yz = delay_h == 0 and delay_d == 0
    results = []
    for p_i in range(P):
        if failed_xy:
            dv1 = dh1 = 0
            pk_xy, wv1, wh1 = params.unr_ncc, inf_w, inf_w
        else:
            dv1, dh1, pk_xy, wv1, wh1 = peak_and_widths(
                ncc_xy[p_i], delay_v, delay_h, wr_v, wr_h, params,
                inf_w=inf_w)
        if failed_xz:
            dv2 = dd1 = 0
            pk_xz, wv2, wd1 = params.unr_ncc, inf_w, inf_w
        else:
            dv2, dd1, pk_xz, wv2, wd1 = peak_and_widths(
                ncc_xz[p_i], delay_v, delay_d, wr_v, wr_d, params,
                inf_w=inf_w)
        if failed_yz:
            dh2 = dd2 = 0
            pk_yz, wh2, wd2 = params.unr_ncc, inf_w, inf_w
        else:
            dh2, dd2, pk_yz, wh2, wd2 = peak_and_widths(
                ncc_yz[p_i], delay_h, delay_d, wr_h, wr_d, params,
                inf_w=inf_w)
        cv, pv, wv = fuse_axis(dv1, pk_xy, wv1, dv2, pk_xz, wv2, params, inf_w)
        ch, ph, wh = fuse_axis(dh1, pk_xy, wh1, dh2, pk_yz, wh2, params, inf_w)
        cd, pd, wd = fuse_axis(dd1, pk_xz, wd1, dd2, pk_yz, wd2, params, inf_w)
        if side == "ns":
            cv += ni
        elif side == "we":
            ch += nj
        else:
            cd += nk
        results.append(NCCResult(coord=(cv, ch, cd), ncc_peak=(pv, ph, pd),
                                 ncc_width=(wv, wh, wd)))
    return results


def align_pair(vol_a: np.ndarray, vol_b: np.ndarray, side: str,
               overlap: int, delay_v: int, delay_h: int, delay_d: int,
               params: Optional[NCCParams] = None,
               device=None) -> NCCResult:
    """Full pairwise alignment of two equal-shape (D, V, H) stacks
    (reference norm_cross_corr_mips, libcrossmips.cpp:101-516): the overlap
    volumes go to the device, their MIPs and maps are taken there.

    side: 'ns' (B is SOUTH of A), 'we' (B is EAST of A), or 'tb'
    (B is BELOW A in z).  Returns per-axis (V, H, D) coord / peak / width,
    where coord includes the nominal offset (coord[V] += dimV - overlap for
    'ns', analogs for the other sides)."""
    dev = resolve_device(device)
    params = params or NCCParams()
    assert vol_a.shape == vol_b.shape
    dimk, dimi, dimj = vol_a.shape
    nk = 0
    if side == "ns":
        ni, nj = dimi - overlap, 0
        a = vol_a[:, ni:, :]
        b = vol_b[:, : dimi - ni, :]
    elif side == "we":
        ni, nj = 0, dimj - overlap
        a = vol_a[:, :, nj:]
        b = vol_b[:, :, : dimj - nj]
    elif side == "tb":
        ni = nj = 0
        nk = dimk - overlap
        a = vol_a[nk:, :, :]
        b = vol_b[: dimk - nk, :, :]
    else:
        raise ValueError("side must be 'ns', 'we' or 'tb'")
    dimi_v, dimj_v = a.shape[1], a.shape[2]

    # clamp the search when the overlap is too small (libcrossmips.cpp:
    # 260-262); the link-global infinite width uses the unclamped radii
    dimk_v = a.shape[0]
    inf_w = params.inf_w((delay_v, delay_h, delay_d))
    delay_v = min(delay_v, max(0, dimi_v - params.min_dim_ncc_src))
    delay_h = min(delay_h, max(0, dimj_v - params.min_dim_ncc_src))
    delay_d = min(delay_d, max(0, dimk_v - params.min_dim_ncc_src))
    wr_v = params.w_range(delay_v)
    wr_h = params.w_range(delay_h)
    wr_d = params.w_range(delay_d)

    mips_a = compute_mips(upload(np.asarray(a, np.float32), dev))
    mips_b = compute_mips(upload(np.asarray(b, np.float32), dev))

    # extended maps: search window + wRange margin so width walks and the
    # refinement pass never leave the map
    def emap(ma, mb, d_u, d_v, w_u, w_v):
        out = ncc_maps_batched(ma[None], mb[None], d_u + w_u, d_v + w_v)
        return np.asarray(HostArray(out[0]), dtype=np.float64)

    ncc_xy = emap(mips_a[0], mips_b[0], delay_v, delay_h, wr_v, wr_h)
    ncc_xz = emap(mips_a[1], mips_b[1], delay_v, delay_d, wr_v, wr_d)
    ncc_yz = emap(mips_a[2], mips_b[2], delay_h, delay_d, wr_h, wr_d)
    return _finalize_pairs(
        ncc_xy[None], ncc_xz[None], ncc_yz[None], 1, side, ni, nj, nk,
        delay_v, delay_h, delay_d, wr_v, wr_h, wr_d, inf_w, params)[0]
