"""Tile tracer: ray tiles x candidate clusters, kernel K1 (counterpart of
mirres_restir_nerf_mesh_tpu/ops/tile_tracer.py).

Rays are grouped into tiles of R; per tile, a conservative interval slab
test of each direction octant's frustum against the cluster boxes selects
candidate clusters, sorted by entry t (two-level above HIER_MIN_C clusters).
A global work budget of ``queue_avg`` candidates per tile on average clips
crowded tiles; every cut extends the tile's ``dropped`` bound, and a ray
whose answer lies beyond it is reported ``uncertain``.  The kernel
(csrc/tile_trace.cu, wrapper ``queue_trace``) then walks each tile's first
``n_active`` candidates.  All prep runs in plain PyTorch and matches the
reference exactly: stable sorts stand in for ``lax.top_k`` and
``lax.sort_key_val`` (lower index first on ties).

``queue=False`` is the reference's dense (tile, k_cap) grid, its K2
``_kernel``: no work budget, so ``dropped`` comes from the k_cap cut alone,
and each tile walks its first ``counts`` candidates (kernel K2 of the same
source, wrapper ``grid_trace``).  The reference splits that grid into tile
chunks only to fit its scalar tables into the TPU's SMEM; one launch here.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from ..utils.profiling import count, count_sync, count_upload, span
from .bvh import HitResult
from .cluster_bvh import SC_GROUP, ClusterMesh, _finish, _intersect_dense, _occluded_dense
from .morton import morton3d

R_TILE = 512      # rays per tile (threads per block)
BIG = 1e30
HIER_MIN_C = 1536   # clusters above which candidate prep goes two-level
HIER_KEEP = 96      # superclusters expanded per tile
W_CHUNK = 49152     # the reference's queue chunk (its W_cap padding rule)

_VP = ctypes.c_void_p


def _smallest(x: torch.Tensor, k: int):
    """(values, indices) of the k smallest entries per row, ascending, lower
    index first on ties (lax.top_k of -x)."""
    vals, idx = torch.sort(x, dim=1, stable=True)
    return vals[:, :k], idx[:, :k]


def _tile_frustums(rot, rdt, tmt):
    """Per-tile conservative frustums: origin box, t ceiling, per-octant
    sign-clamped inverse-direction boxes, octant presence."""
    dev = rot.device
    live = tmt > 0.0
    o_lo = torch.where(live[..., None], rot, torch.inf).amin(dim=1)      # [T,3]
    o_hi = torch.where(live[..., None], rot, -torch.inf).amax(dim=1)
    o_lo = torch.where(torch.isfinite(o_lo), o_lo, 3e8)
    o_hi = torch.where(torch.isfinite(o_hi), o_hi, 3e8)
    t_hi = torch.where(live, tmt, 0.0).amax(dim=1)                        # [T]

    pos = rdt > 0
    oct_id = pos[..., 0].long() + 2 * pos[..., 1].long() + 4 * pos[..., 2].long()
    ar8 = torch.arange(8, device=dev)
    in_b = (oct_id[:, None, :] == ar8[None, :, None]) & live[:, None, :]  # [T,8,R]
    dexp = rdt.transpose(1, 2)                                            # [T,3,R]
    sel = in_b[:, :, None, :]                                             # [T,8,1,R]
    d_lo = torch.where(sel, dexp[:, None], torch.inf).amin(dim=-1)        # [T,8,3]
    d_hi = torch.where(sel, dexp[:, None], -torch.inf).amax(dim=-1)
    present = in_b.any(dim=-1)                                            # [T,8]

    bits = torch.stack([ar8 % 2, (ar8 // 2) % 2, ar8 // 4], dim=-1).bool()  # [8,3]
    eps = 1e-12
    d_lo = torch.where(bits[None], torch.clamp_min(d_lo, eps), torch.clamp_max(d_lo, -eps))
    d_hi = torch.where(bits[None], torch.clamp_min(d_hi, eps), torch.clamp_max(d_hi, -eps))
    return o_lo, o_hi, t_hi, 1.0 / d_hi, 1.0 / d_lo, present


def _frustum_hits(o_lo, o_hi, t_hi, i_lo, i_hi, present, bmin, bmax, t_min: float):
    """Interval slab test of per-tile octant frustums against boxes
    bmin/bmax [T or 1, W, 3] -> (hit [T,8,W], t0_lb [T,8,W])."""
    s_lo = (bmin - o_hi[:, None])[:, None]                                # [T,1,W,3]
    s_hi = (bmax - o_lo[:, None])[:, None]
    il = i_lo[:, :, None]                                                 # [T,8,1,3]
    ih = i_hi[:, :, None]
    p1, p2, p3, p4 = s_lo * il, s_lo * ih, s_hi * il, s_hi * ih
    p_lo = torch.minimum(torch.minimum(p1, p2), torch.minimum(p3, p4))
    p_hi = torch.maximum(torch.maximum(p1, p2), torch.maximum(p3, p4))
    t0_lb = p_lo.amax(dim=-1)
    t1_ub = p_hi.amin(dim=-1)
    hit = (
        present[..., None]
        & (t1_ub >= torch.clamp_min(t0_lb, t_min))
        & (t0_lb <= t_hi[:, None, None])
    )
    return hit, t0_lb


def _octant_candidates(cm: ClusterMesh, rot, rdt, tmt, t_min: float, k_flat: int):
    """Per-tile candidate clusters, entry-sorted:
    (cand [T,K], octs [T,K], counts [T], dropped [T], entries [T,K])."""
    T_ = rot.shape[0]
    C = cm.aabb_min.shape[0]
    dev = rot.device

    fr = _tile_frustums(rot, rdt, tmt)
    sc_dropped = torch.full((T_,), torch.inf, device=dev)
    if C > HIER_MIN_C and cm.sc_min.shape[0] >= 2:
        G = SC_GROUP
        SC = cm.sc_min.shape[0]
        hit_sc, t0_sc = _frustum_hits(*fr, cm.sc_min[None], cm.sc_max[None], t_min)
        entry_sc = torch.where(hit_sc, torch.clamp_min(t0_sc, 0.0), torch.inf).amin(dim=1)
        KS = min(HIER_KEEP, SC)
        ks_sel = min(KS + 1, SC)
        ent_sc, sidx = _smallest(entry_sc, ks_sel)
        if ks_sel > KS:
            sc_full = torch.isfinite(ent_sc[:, KS - 1])
            sc_dropped = torch.where(sc_full, ent_sc[:, ks_sel - 1], torch.inf)
        sidx = sidx[:, :KS]
        cb = cm.child_boxes[sidx].reshape(T_, KS, G, 6)
        bmin = cb[..., 0:3].reshape(T_, KS * G, 3)
        bmax = cb[..., 3:6].reshape(T_, KS * G, 3)
        cids = (sidx[:, :, None] * G + torch.arange(G, device=dev)[None, None, :]).reshape(T_, KS * G)
        valid_child = cids < C
        cids = torch.clamp_max(cids, C - 1)
        hit, t0_lb = _frustum_hits(*fr, bmin, bmax, t_min)
        hit = hit & valid_child[:, None, :]
        W = KS * G
    else:
        hit, t0_lb = _frustum_hits(*fr, cm.aabb_min[None], cm.aabb_max[None], t_min)
        cids = None
        W = C

    entry = torch.where(hit, torch.clamp_min(t0_lb, 0.0), torch.inf).amin(dim=1)  # [T,W]
    octmask = (hit.long() << torch.arange(8, device=dev)[None, :, None]).sum(dim=1)

    K = min(k_flat, W)
    k_sel = min(K + 1, W)
    ent_m, midx = _smallest(entry, k_sel)
    sel_w = midx[:, :K]
    octs = torch.gather(octmask, 1, sel_w)
    cand = sel_w if cids is None else torch.gather(cids, 1, sel_w)
    counts = torch.isfinite(ent_m[:, :K]).sum(dim=1)
    if k_sel > K:
        dropped = torch.where(counts == K, ent_m[:, k_sel - 1], torch.inf)
    else:
        dropped = torch.full((T_,), torch.inf, device=dev)
    dropped = torch.minimum(dropped, sc_dropped)
    last = torch.gather(cand, 1, torch.clamp(counts - 1, 0, K - 1)[:, None])
    cand = torch.where(torch.arange(K, device=dev)[None, :] < counts[:, None], cand, last)
    return cand, octs, counts, dropped, ent_m[:, :K]


def _cand_width(cm: ClusterMesh, k_flat: int) -> int:
    """K, the candidate-table width _octant_candidates returns."""
    C = cm.aabb_min.shape[0]
    if C > HIER_MIN_C and cm.sc_min.shape[0] >= 2:
        return min(k_flat, min(HIER_KEEP, cm.sc_min.shape[0]) * SC_GROUP)
    return min(k_flat, C)


def _octant_candidates_blocked(cm: ClusterMesh, rot, rdt, tmt, t_min: float, k_flat: int):
    """_octant_candidates over static tile blocks, skipping blocks whose rays
    are all dead (t_max <= 0): they get zero candidates.  Tiles are
    independent, so live blocks compute what the unblocked call would."""
    T_ = rot.shape[0]
    nb = next((b for b in (8, 4, 2) if T_ % b == 0 and T_ >= 2 * b), 1)
    if nb == 1:
        return _octant_candidates(cm, rot, rdt, tmt, t_min, k_flat)
    tb = T_ // nb
    K = _cand_width(cm, k_flat)
    dev = rot.device
    outs = []
    for b in range(nb):
        sl = slice(b * tb, (b + 1) * tb)
        count_sync("octant_blocks", tmt.is_cuda)
        if bool((tmt[sl] > 0.0).any()):
            outs.append(_octant_candidates(cm, rot[sl], rdt[sl], tmt[sl], t_min, k_flat))
        else:
            zk = torch.zeros((tb, K), dtype=torch.int64, device=dev)
            outs.append((zk, zk, torch.zeros((tb,), dtype=torch.int64, device=dev),
                         torch.full((tb,), torch.inf, device=dev),
                         torch.full((tb, K), torch.inf, device=dev)))
    return tuple(torch.cat(parts, dim=0) for parts in zip(*outs))


def _queue_budget(counts, dropped, entries, q_avg: int):
    """The reference's global work budget (_run_queue): the largest uniform
    per-tile cap whose total fits W_cap; cut tiles extend their dropped bound.
    Returns (n_active [T] candidates the kernel runs per tile, dropped [T])."""
    T_, K = entries.shape
    dev = counts.device
    W_cap = min(max(T_ * max(q_avg, 1), 16384), T_ * K)
    n_chunks = -(-W_cap // W_CHUNK) if W_cap > W_CHUNK else 1
    W_cap = n_chunks * min(W_CHUNK, W_cap) if n_chunks > 1 else W_cap

    counts_q = torch.clamp_min(counts, 1)
    caps = torch.arange(1, K + 1, device=dev)
    fits = torch.minimum(counts_q[:, None], caps[None, :]).sum(dim=0) <= W_cap
    any_fit = bool(fits.any())
    cap = int(fits.sum()) if any_fit else 1
    count_sync("queue_budget", fits.is_cuda, 2 if any_fit else 1)
    counts_adj = torch.clamp_max(counts_q, max(cap, 1))
    trunc = counts_adj < counts
    ent_at_cut = torch.gather(entries, 1, torch.clamp(counts_adj, 0, K - 1)[:, None])[:, 0]
    dropped = torch.where(trunc, torch.minimum(dropped, ent_at_cut), dropped)
    # a tile with no candidate keeps its (no-op) queue item but runs nothing
    n_active = torch.minimum(counts_adj, counts)
    return n_active, dropped


def queue_trace_plain(geom_cm, rays_cm, cand, octs, n_active, t_min: float, any_hit: bool,
                      stats: Optional[dict] = None):
    """Plain PyTorch version of the K1 kernel: for each tile, its first
    n_active candidates in order, with the kernel's culls, strict `<` and
    first-slot tie rule.  Returns out [T,5,R] rows (t, slot, u, v, cluster).
    stats, when given, accumulates the (ray, cluster) pairs that ran the
    triangle tests ('useful_pairs') and the (tile, candidate) items."""
    return _trace_plain(geom_cm, rays_cm, cand, octs, n_active, t_min, any_hit, stats)[0]


def _trace_plain(geom_cm, rays_cm, cand, octs, n_active, t_min: float, any_hit: bool,
                 stats: Optional[dict] = None):
    """queue_trace_plain -> (out [T,5,R], k [T,R] candidate position of each
    closest hit, 0 where none)."""
    T_, _, R = rays_cm.shape
    S = geom_cm.shape[2]
    dev = rays_cm.device
    out = torch.zeros((T_, 5, R), dtype=torch.float32, device=dev)
    out[:, 0] = BIG
    kpos = torch.zeros((T_, R), dtype=torch.int64, device=dev)
    tile_chunk = max(1, (1 << 24) // (S * R))   # tiles per pass: [t, S, R] temporaries
    ar_s = torch.arange(S, device=dev)[:, None]
    for c0 in range(0, T_, tile_chunk):
        c1 = min(c0 + tile_chunk, T_)
        ray = rays_cm[c0:c1]
        ox, oy, oz = ray[:, 0], ray[:, 1], ray[:, 2]
        dx, dy, dz = ray[:, 3], ray[:, 4], ray[:, 5]
        tmax = ray[:, 6]
        ix = 1.0 / torch.where(dx.abs() < 1e-12, 1e-12, dx)
        iy = 1.0 / torch.where(dy.abs() < 1e-12, 1e-12, dy)
        iz = 1.0 / torch.where(dz.abs() < 1e-12, 1e-12, dz)
        ray_oct = (dx > 0).long() + 2 * (dy > 0).long() + 4 * (dz > 0).long()
        best = out[c0:c1, 0].clone()
        slot = out[c0:c1, 1].clone()
        bu = out[c0:c1, 2].clone()
        bv = out[c0:c1, 3].clone()
        bcid = out[c0:c1, 4].clone()
        bk = kpos[c0:c1].clone()
        na = n_active[c0:c1]
        for k in range(int(na.max()) if na.numel() else 0):
            tiles = torch.nonzero(na > k)[:, 0]
            cid = cand[c0 + tiles, k].long()
            oct_k = octs[c0 + tiles, k].long()
            g = geom_cm[cid]                                       # [t,16,S]
            o_x, o_y, o_z = ox[tiles], oy[tiles], oz[tiles]
            d_x, d_y, d_z = dx[tiles], dy[tiles], dz[tiles]
            tm, b_t = tmax[tiles], best[tiles]
            oct_ok = ((oct_k[:, None] >> ray_oct[tiles]) & 1) == 1
            bn = g[:, 10:16, 0:1]                                  # [t,6,1]
            lox, hix = (bn[:, 0] - o_x) * ix[tiles], (bn[:, 3] - o_x) * ix[tiles]
            loy, hiy = (bn[:, 1] - o_y) * iy[tiles], (bn[:, 4] - o_y) * iy[tiles]
            loz, hiz = (bn[:, 2] - o_z) * iz[tiles], (bn[:, 5] - o_z) * iz[tiles]
            t0 = torch.maximum(torch.maximum(torch.minimum(lox, hix), torch.minimum(loy, hiy)),
                               torch.minimum(loz, hiz))
            t1 = torch.minimum(torch.minimum(torch.maximum(lox, hix), torch.maximum(loy, hiy)),
                               torch.maximum(loz, hiz))
            useful = (oct_ok & (t1 >= torch.clamp_min(t0, t_min)) & (t0 <= tm)
                      & (torch.clamp_min(t0, 0.0) < b_t))
            if any_hit:
                useful = useful & (b_t >= BIG)
            if stats is not None:
                stats["items"] = stats.get("items", 0) + int(tiles.numel())
                stats["useful_pairs"] = stats.get("useful_pairs", 0) + int(useful.sum())
            run = useful.any(dim=1)
            if not bool(run.any()):
                continue
            tiles, g, useful = tiles[run], g[run], useful[run]
            o_x, o_y, o_z = o_x[run][:, None], o_y[run][:, None], o_z[run][:, None]
            d_x, d_y, d_z = d_x[run][:, None], d_y[run][:, None], d_z[run][:, None]
            tm, b_t = tm[run][:, None], b_t[run]
            col = lambda i: g[:, i, :, None]  # noqa: E731  [t,S,1]
            v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z, prim = (col(i) for i in range(10))
            px = d_y * e2z - d_z * e2y
            py = d_z * e2x - d_x * e2z
            pz = d_x * e2y - d_y * e2x
            det = e1x * px + e1y * py + e1z * pz
            dinv = torch.where(det.abs() < 1e-12, 0.0, 1.0 / det)
            tx = o_x - v0x
            ty = o_y - v0y
            tz = o_z - v0z
            u = (tx * px + ty * py + tz * pz) * dinv
            qx = ty * e1z - tz * e1y
            qy = tz * e1x - tx * e1z
            qz = tx * e1y - ty * e1x
            v = (d_x * qx + d_y * qy + d_z * qz) * dinv
            th = (e2x * qx + e2y * qy + e2z * qz) * dinv
            ok = ((det.abs() > 1e-12) & (u >= 0) & (v >= 0) & (u + v <= 1) & (th > t_min)
                  & (th < tm) & (prim >= 0) & useful[:, None, :])        # [t,S,R]
            if any_hit:
                best[tiles] = torch.where(ok.any(dim=1), 0.0, b_t)
                continue
            th = torch.where(ok, th, BIG)
            s_best = th.argmin(dim=1)                              # first minimal slot
            t_best = torch.gather(th, 1, s_best[:, None])[:, 0]
            sel = ar_s[None] == s_best[:, None, :]
            u_best = torch.where(sel, u, -BIG).amax(dim=1)
            v_best = torch.where(sel, v, -BIG).amax(dim=1)
            better = t_best < b_t
            best[tiles] = torch.where(better, t_best, b_t)
            slot[tiles] = torch.where(better, s_best.float(), slot[tiles])
            bu[tiles] = torch.where(better, u_best, bu[tiles])
            bv[tiles] = torch.where(better, v_best, bv[tiles])
            bcid[tiles] = torch.where(better, cid[run].float()[:, None], bcid[tiles])
            bk[tiles] = torch.where(better, k, bk[tiles])
        out[c0:c1, 0], out[c0:c1, 1], out[c0:c1, 2] = best, slot, bu
        out[c0:c1, 3], out[c0:c1, 4] = bv, bcid
        kpos[c0:c1] = bk
    return out, kpos


def split_factor(n_tiles: int, n_sms: int) -> int:
    """Blocks the kernel gives each tile: enough for two per SM,
    ceil(2 SMs / T), clamped to 1..8."""
    return max(1, min(8, -(-2 * n_sms // max(n_tiles, 1))))


def queue_trace_split_plain(geom_cm, rays_cm, cand, octs, n_active, t_min: float,
                            any_hit: bool, split: int):
    """The kernel's split and combine rule in plain PyTorch: part p of
    `split` walks candidates k = p, p + split, ... of each tile against its
    own best only, and the parts combine by the smallest (t, k, slot), which
    is queue_trace_plain's answer (earlier candidate first on equal t; the
    slot is the cluster's first minimal one).  -> out [T,5,R]."""
    best = kbest = None
    for p in range(split):
        n_p = torch.clamp_min(n_active - p + split - 1, 0) // split
        out, kpos = _trace_plain(geom_cm, rays_cm, cand[:, p::split], octs[:, p::split], n_p,
                                 t_min, any_hit)
        kabs = p + kpos * split
        if best is None:
            best, kbest = out, kabs
            continue
        t_new, t_old = out[:, 0], best[:, 0]
        better = (t_new < t_old) | ((t_new == t_old) & (t_new < BIG) & (kabs < kbest))
        best = torch.where(better[:, None, :], out, best)
        kbest = torch.where(better, kabs, kbest)
    return best


@functools.lru_cache(maxsize=None)
def _kernel():
    """The bound C entry of csrc/tile_trace.cu, bound once."""
    from ..cuda_build import load

    fn = load("tile_trace").tile_trace_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [_VP, _VP, _VP, _VP, _VP, _VP, _VP, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int, _VP]
    return fn


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _int32(x: torch.Tensor) -> torch.Tensor:
    return x if x.dtype == torch.int32 and x.is_contiguous() else x.to(torch.int32).contiguous()


def _launch(what: str, geom_cm, rays_cm, cand, octs, n_run, t_min: float,
            any_hit: bool, split: Optional[int]) -> torch.Tensor:
    """Check the card's inputs and launch csrc/tile_trace.cu's kernel on each
    tile's first n_run candidates, each tile split over `split` blocks
    (None: split_factor of the card's SM count) -> out [T,5,R] (`what`
    names the caller in errors)."""
    from ..cuda_build import check, stream_ptr

    dev = geom_cm.device
    cand, octs, n_run = _int32(cand), _int32(octs), _int32(n_run)
    for name, x, dt in (("geom_cm", geom_cm, torch.float32), ("rays_cm", rays_cm, torch.float32)):
        if x.device != dev or x.dtype != dt or not x.is_contiguous():
            raise ValueError(f"{what}: {name} must be a contiguous {dt} tensor on {dev}")
    T_, rows, R = rays_cm.shape
    C, grows, S = geom_cm.shape
    if rows != 8 or grows != 16 or R > 1024 or R % 32 or S % 32 or cand.shape != octs.shape \
            or cand.shape[0] != T_:
        raise ValueError(f"{what}: expects rays [T,8,R<=1024], geom [C,16,S], cand/octs [T,K], "
                         "R and S multiples of 32")
    if cand.device != dev or n_run.device != dev:
        raise ValueError(f"{what}: candidate tables must lie on the card")
    if geom_cm.data_ptr() % 16:
        raise ValueError(f"{what}: geom_cm must start on a 16-byte boundary (cp.async)")
    out = torch.empty((T_, 5, R), dtype=torch.float32, device=dev)
    if not T_:
        return out
    if split is None:
        split = split_factor(T_, _sm_count(dev.index if dev.index is not None
                                           else torch.cuda.current_device()))
    if not 1 <= split <= 64:
        raise ValueError(f"{what}: split {split} outside 1..64")
    keys = torch.empty((T_, R) if split > 1 else (0,), dtype=torch.int64, device=dev)
    check(_kernel()(geom_cm.data_ptr(), rays_cm.data_ptr(), cand.data_ptr(), octs.data_ptr(),
                    n_run.data_ptr(), out.data_ptr(), keys.data_ptr(), T_, cand.shape[1], S, R,
                    split, t_min, int(any_hit), stream_ptr(dev)), what)
    return out


def queue_trace(geom_cm, rays_cm, cand, octs, n_active, t_min: float, any_hit: bool,
                split: Optional[int] = None):
    """Run each tile's first n_active candidates: the K1 kernel for tensors on
    the card (each tile over `split` blocks, None = from the SM count),
    queue_trace_plain for tensors on the CPU -> out [T,5,R]."""
    if not geom_cm.is_cuda:
        return queue_trace_plain(geom_cm, rays_cm, cand, octs, n_active, t_min, any_hit)
    out = _launch("queue_trace", geom_cm, rays_cm, cand, octs, n_active, t_min, any_hit, split)
    if rays_cm.shape[0]:
        count("launches.queue_trace")
    return out


def grid_trace(geom_cm, rays_cm, cand, octs, counts, t_min: float, any_hit: bool,
               split: Optional[int] = None):
    """Run each tile's first counts candidates, no work budget: the K2
    kernel for tensors on the card, queue_trace_plain (called with counts)
    for tensors on the CPU -> out [T,5,R]."""
    if not geom_cm.is_cuda:
        return queue_trace_plain(geom_cm, rays_cm, cand, octs, counts, t_min, any_hit)
    out = _launch("grid_trace", geom_cm, rays_cm, cand, octs, counts, t_min, any_hit, split)
    if rays_cm.shape[0]:
        count("launches.grid_trace")
    return out


class TileTraceOut(NamedTuple):
    hit: HitResult
    uncertain: torch.Tensor  # [N] bool: hit may lie in a dropped candidate


class TraceWork(NamedTuple):
    """Everything the kernel takes, plus what finishing the trace needs."""
    rays_cm: torch.Tensor             # [T,8,R] (o, d, t_max, pad), sorted order
    cand: torch.Tensor                # [T,K]
    octs: torch.Tensor                # [T,K]
    counts: torch.Tensor              # [T] candidates found
    n_active: torch.Tensor            # [T] candidates to run (= counts without the budget)
    dropped: torch.Tensor             # [T] exactness bound after the budget
    t_max: torch.Tensor               # [N] in sorted order
    inv_perm: Optional[torch.Tensor]  # [N] undoes the sort (None = unsorted)


def _t_max_array(t_max, N: int, device) -> torch.Tensor:
    count_upload("t_max", device, t_max)
    return torch.broadcast_to(torch.as_tensor(t_max, dtype=torch.float32, device=device), (N,))


def _sort_keys(cm: ClusterMesh, rays_o, rays_d, t_max_arr, sort_octants, sort_block: int):
    N = rays_o.shape[0]
    dev = rays_o.device
    oct_id = (rays_d[:, 0] > 0).long() + 2 * (rays_d[:, 1] > 0).long() + 4 * (rays_d[:, 2] > 0).long()
    dead = t_max_arr <= 0.0
    if sort_octants == "dir":
        cd = torch.clamp(((rays_d * 0.5 + 0.5) * 32.0).to(torch.int32), 0, 31)
        return torch.where(dead, 1 << 26, morton3d(cd))
    if sort_octants in ("morton", "morton_dir2"):
        lo = cm.aabb_min.amin(dim=0)
        hi = cm.aabb_max.amax(dim=0)
        cell = torch.clamp(((rays_o - lo) / torch.clamp_min(hi - lo, 1e-6) * 32.0).to(torch.int32), 0, 31)
        key = oct_id * (1 << 15) + morton3d(cell)
        if sort_octants == "morton_dir2":
            ad = rays_d.abs()
            axm = torch.argmax(ad, dim=1)
            major = torch.gather(ad, 1, axm[:, None])[:, 0]
            c1 = torch.gather(rays_d, 1, ((axm + 1) % 3)[:, None])[:, 0]
            c2 = torch.gather(rays_d, 1, ((axm + 2) % 3)[:, None])[:, 0]
            inv_m = 1.0 / torch.clamp_min(major, 1e-6)
            q1 = torch.clamp(((c1 * inv_m + 1.0) * 2.0).to(torch.int32), 0, 3).long()
            q2 = torch.clamp(((c2 * inv_m + 1.0) * 2.0).to(torch.int32), 0, 3).long()
            key = oct_id * (1 << 19) + (q1 * 4 + q2) * (1 << 15) + morton3d(cell)
        return torch.where(dead, 1 << 26, key)
    blk = torch.arange(N, device=dev) // sort_block
    return blk * 16 + torch.where(dead, 8, oct_id)


def prepare_trace(cm: ClusterMesh, rays_o, rays_d, t_min: float = 1e-4, t_max=1e10,
                  k_cap: int = 128, tile: int = R_TILE, sort_octants=False,
                  sort_block: int = 4096, queue: bool = True,
                  queue_avg: int = 64) -> TraceWork:
    """Sort, tile, select candidates and, with ``queue``, apply the work
    budget (without it every tile runs all its candidates)."""
    N = rays_o.shape[0]
    R = tile
    dev = rays_o.device
    rays_o = rays_o.to(torch.float32)
    rays_d = rays_d.to(torch.float32)
    t_max_arr = _t_max_array(t_max, N, dev)

    inv_perm = None
    if sort_octants and N > R:
        key = _sort_keys(cm, rays_o, rays_d, t_max_arr, sort_octants, sort_block)
        perm = torch.sort(key, stable=True).indices
        rays_o, rays_d, t_max_arr = rays_o[perm], rays_d[perm], t_max_arr[perm]
        inv_perm = torch.empty_like(perm)
        inv_perm[perm] = torch.arange(N, device=dev)

    pad = (-N) % R
    ro = torch.cat([rays_o, torch.zeros((pad, 3), device=dev)])
    rd = torch.cat([rays_d, torch.ones((pad, 3), device=dev)])
    tm = torch.cat([t_max_arr, torch.zeros((pad,), device=dev)])
    n_tiles = (N + pad) // R
    rot, rdt, tmt = ro.reshape(n_tiles, R, 3), rd.reshape(n_tiles, R, 3), tm.reshape(n_tiles, R)

    cand, octs, counts, dropped, entries = _octant_candidates_blocked(cm, rot, rdt, tmt, t_min, k_cap)
    if queue:
        n_active, dropped = _queue_budget(counts, dropped, entries, queue_avg)
    else:
        n_active = counts

    rays_cm = torch.zeros((n_tiles, 8, R), dtype=torch.float32, device=dev)
    rays_cm[:, 0:3] = rot.transpose(1, 2)
    rays_cm[:, 3:6] = rdt.transpose(1, 2)
    rays_cm[:, 6] = tmt
    return TraceWork(rays_cm=rays_cm, cand=cand, octs=octs, counts=counts, n_active=n_active,
                     dropped=dropped, t_max=t_max_arr, inv_perm=inv_perm)


def finish_trace(cm: ClusterMesh, work: TraceWork, out: torch.Tensor, any_hit: bool) -> TileTraceOut:
    """Kernel output [T,5,R] -> hits and the uncertain mask, in input order."""
    N = work.t_max.shape[0]
    R = work.rays_cm.shape[2]
    S = cm.prim.shape[1]
    dev = out.device
    t_max_arr = work.t_max
    best_t = out[:, 0].reshape(-1)[:N]
    found = best_t < BIG * 0.5
    if any_hit:
        hit = HitResult(
            t=torch.where(found, best_t, torch.inf),
            prim=torch.where(found, 0, -1),
            u=torch.zeros((N,), device=dev),
            v=torch.zeros((N,), device=dev),
            normal=torch.zeros((N, 3), device=dev),
        )
    else:
        best_slot = out[:, 1].reshape(-1)[:N].to(torch.int64)
        best_cid = out[:, 4].reshape(-1)[:N].to(torch.int64)
        u = out[:, 2].reshape(-1)[:N]
        v = out[:, 3].reshape(-1)[:N]
        best_t = torch.where(found, best_t, torch.inf)
        best_t = torch.where(best_t <= t_max_arr, best_t, torch.inf)
        best_lin = torch.clamp(best_cid * S + best_slot, 0, cm.soa.shape[1] - 1)
        hit = _finish(cm, best_lin, best_t, u, v, t_max_arr)

    per_ray_dropped = work.dropped.repeat_interleave(R)[:N]
    reach = torch.where(torch.isfinite(hit.t), hit.t, torch.clamp_max(t_max_arr, BIG))
    uncertain = torch.isfinite(per_ray_dropped) & (reach > per_ray_dropped)
    if work.inv_perm is not None:
        ip = work.inv_perm
        hit = HitResult(*(x[ip] for x in hit))
        uncertain = uncertain[ip]
    return TileTraceOut(hit=hit, uncertain=uncertain)


def tile_trace(cm: ClusterMesh, rays_o, rays_d, t_min: float = 1e-4, t_max=1e10,
               any_hit: bool = False, k_cap: int = 128, tile: int = R_TILE,
               sort_octants=False, sort_block: int = 4096, queue: bool = True,
               queue_avg: int = 64) -> TileTraceOut:
    """Trace via tile-coherent candidate streaming (S % 128 == 0 as in the
    reference's dispatch).  sort_octants: False, True/"block", "dir",
    "morton" or "morton_dir2" ray reorders; results come back unpermuted.
    queue: the work budget of queue_avg candidates per tile on average and
    K1; queue=False runs every tile's k_cap-cut candidates through K2."""
    with span("tile_prep"):
        work = prepare_trace(cm, rays_o, rays_d, t_min=t_min, t_max=t_max, k_cap=k_cap,
                             tile=tile, sort_octants=sort_octants, sort_block=sort_block,
                             queue=queue, queue_avg=queue_avg)
    with span("tile_kernel"):
        run = queue_trace if queue else grid_trace
        out = run(cm.geom_cm, work.rays_cm, work.cand, work.octs, work.n_active, t_min, any_hit)
    with span("tile_finish"):
        return finish_trace(cm, work, out, any_hit)


def _empty_trace(N: int, device) -> TileTraceOut:
    z = torch.zeros((N,), device=device)
    return TileTraceOut(
        hit=HitResult(t=z, prim=torch.zeros((N,), dtype=torch.int64, device=device),
                      u=z, v=z, normal=torch.zeros((N, 3), device=device)),
        uncertain=torch.zeros((N,), dtype=torch.bool, device=device),
    )


def _takes_dense(cm: ClusterMesh, dense_threshold: int) -> bool:
    """The dense pass's rule (the reference's): few padded slots, one
    cluster, or clusters the tile kernel does not take."""
    C, S = cm.prim.shape
    return C * S <= dense_threshold or C == 1 or S % 128 != 0


DENSE_SORT_MIN = 1 << 16   # rays below which the dense route keeps their order


def dense_order(cm: ClusterMesh, rays_o, rays_d, t_max, sort_octants, tile: int = R_TILE):
    """The dense route's ray order -> (rays_o, rays_d, t_max [N], perm or
    None): where sort_octants asks for it and N >= DENSE_SORT_MIN (and >
    tile), _sort_keys order, so that the kernel's warps hold neighbouring
    rays of one octant and cull triangle groups against a narrow bundle.
    Smaller batches keep their order: there the sort's own launches cost
    the host more than the kernel gains."""
    N = rays_o.shape[0]
    ro, rd = rays_o.to(torch.float32), rays_d.to(torch.float32)
    tm = _t_max_array(t_max, N, rays_o.device)
    if not sort_octants or N <= tile or N < DENSE_SORT_MIN:
        return ro, rd, tm, None
    perm = torch.sort(_sort_keys(cm, ro, rd, tm, sort_octants, 4096), stable=True).indices
    return ro[perm], rd[perm], tm[perm], perm


def _dense_pass(cm: ClusterMesh, rays_o, rays_d, t_min: float, t_max, sort_octants, tile: int,
                occluded: bool):
    """The dense route (closest hit, or the any-hit mask) in dense_order,
    the results back in input order."""
    ro, rd, tm, perm = dense_order(cm, rays_o, rays_d, t_max, sort_octants, tile)
    res = (_occluded_dense if occluded else _intersect_dense)(cm, ro, rd, t_min, tm)
    if perm is None:
        return res

    def unsort(x):
        out = torch.empty_like(x)
        out[perm] = x
        return out

    return unsort(res) if occluded else HitResult(*(unsort(x) for x in res))


def intersect_tiles_t(cm: ClusterMesh, rays_o, rays_d, t_min: float = 1e-4, t_max=1e10,
                      any_hit: bool = False, k_cap: int = 128, tile: int = R_TILE,
                      dense_threshold: int = 8192, sort_octants=False, queue: bool = True,
                      queue_avg: int = 64) -> TileTraceOut:
    """Dense pass for small meshes (exact -> uncertain all False), tile trace
    otherwise.  The dense pass finds the closest hit also for any_hit, so
    the HitResult is the reference's."""
    N = rays_o.shape[0]
    if N == 0:
        return _empty_trace(0, rays_o.device)
    if _takes_dense(cm, dense_threshold):
        hit = _dense_pass(cm, rays_o, rays_d, t_min, t_max, sort_octants, tile, False)
        return TileTraceOut(hit=hit, uncertain=torch.zeros((N,), dtype=torch.bool,
                                                           device=rays_o.device))
    return tile_trace(cm, rays_o, rays_d, t_min=t_min, t_max=t_max, any_hit=any_hit,
                      k_cap=k_cap, tile=tile, sort_octants=sort_octants, queue=queue,
                      queue_avg=queue_avg)


def intersect_tiles(cm: ClusterMesh, rays_o, rays_d, t_min: float = 1e-4, t_max=1e10,
                    any_hit: bool = False, k_cap: int = 128, tile: int = R_TILE,
                    dense_threshold: int = 8192, sort_octants=False, queue: bool = True,
                    queue_avg: int = 64) -> HitResult:
    """HitResult-contract wrapper of intersect_tiles_t."""
    return intersect_tiles_t(cm, rays_o, rays_d, t_min=t_min, t_max=t_max, any_hit=any_hit,
                             k_cap=k_cap, tile=tile, dense_threshold=dense_threshold,
                             sort_octants=sort_octants, queue=queue, queue_avg=queue_avg).hit


def occluded_tiles_t(cm: ClusterMesh, rays_o, rays_d, t_max, t_min: float = 1e-4,
                     k_cap: int = 128, tile: int = R_TILE, dense_threshold: int = 8192,
                     sort_octants=False, queue: bool = True,
                     queue_avg: int = 64) -> Tuple[torch.Tensor, torch.Tensor]:
    """(occluded [N] bool, uncertain [N] bool).  The dense pass runs its any
    hit, whose mask is the closest hit's prim >= 0."""
    N = rays_o.shape[0]
    if N and _takes_dense(cm, dense_threshold):
        occ = _dense_pass(cm, rays_o, rays_d, t_min, t_max, sort_octants, tile, True)
        return occ, torch.zeros((N,), dtype=torch.bool, device=rays_o.device)
    res = intersect_tiles_t(cm, rays_o, rays_d, t_min=t_min, t_max=t_max, any_hit=True,
                            k_cap=k_cap, tile=tile, dense_threshold=dense_threshold,
                            sort_octants=sort_octants, queue=queue, queue_avg=queue_avg)
    return res.hit.prim >= 0, res.uncertain


def occluded_tiles(cm: ClusterMesh, rays_o, rays_d, t_max, t_min: float = 1e-4,
                   k_cap: int = 128, tile: int = R_TILE, dense_threshold: int = 8192,
                   sort_octants=False, queue: bool = True, queue_avg: int = 64) -> torch.Tensor:
    return occluded_tiles_t(cm, rays_o, rays_d, t_max, t_min=t_min, k_cap=k_cap, tile=tile,
                            dense_threshold=dense_threshold, sort_octants=sort_octants,
                            queue=queue, queue_avg=queue_avg)[0]
