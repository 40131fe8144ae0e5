"""Triangle clusters and the cluster tracer (counterpart of
mirres_restir_nerf_mesh_tpu/ops/cluster_bvh.py).

Triangles are morton-sorted into clusters of S; each cluster keeps a
component-major geometry block ``geom_cm`` [16, S] that the tile tracer's
kernel stages in shared memory.  Superclusters of SC_GROUP morton-neighbour
clusters feed the two-level candidate prep of ops/tile_tracer.py.

``intersect_clusters`` / ``occluded_clusters`` (the ``cluster`` tracer
kind): a mesh of at most ``dense_threshold`` slots (or one cluster) takes
one dense pass, kernel K3 on the card (``dense_tracer.dense_hit``); a
larger one a slab test of every ray against every cluster box, the K
nearest entries picked by K argmin extractions, and K candidate rounds,
each one row gather of the cluster's packed triangles a ray (plain
PyTorch, as the reference's XLA).  Inexact by design: a hit beyond the K
candidates is missed.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.math import cross
from .bvh import HitResult
from .morton import morton3d

SC_GROUP = 8  # clusters per supercluster


class ClusterMesh(NamedTuple):
    aabb_min: torch.Tensor     # [C, 3]
    aabb_max: torch.Tensor     # [C, 3]
    packed: torch.Tensor       # [C, S, 10] (v0, e1, e2, prim as float)
    soa: torch.Tensor          # [10, C*S] component-major copy for dense passes
    prim: torch.Tensor         # [C, S] int64 original triangle id (-1 = padding)
    geom_cm: torch.Tensor      # [C, 16, S] rows 0-8 v0/e1/e2, 9 prim,
                               # 10-12 aabb_min, 13-15 aabb_max (broadcast)
    sc_min: torch.Tensor       # [SC, 3] union box of each supercluster
    sc_max: torch.Tensor       # [SC, 3]
    child_boxes: torch.Tensor  # [SC, SC_GROUP*6] packed child (min, max) rows


def build_clusters(vertices: torch.Tensor, triangles: torch.Tensor,
                   cluster_size: int = 128) -> ClusterMesh:
    """Morton-sort the triangles (stable, as jnp.argsort) into [C, S] clusters."""
    tri = triangles.to(torch.int64)
    v0, v1, v2 = vertices[tri[:, 0]], vertices[tri[:, 1]], vertices[tri[:, 2]]
    n = tri.shape[0]
    S = min(cluster_size, max(n, 1))
    dev = vertices.device

    tmin = torch.minimum(torch.minimum(v0, v1), v2)
    tmax = torch.maximum(torch.maximum(v0, v1), v2)
    centroid = (tmin + tmax) * 0.5
    scene_min = tmin.amin(dim=0)
    extent = torch.clamp_min(tmax.amax(dim=0) - scene_min, 1e-9)
    grid = torch.clamp(((centroid - scene_min) / extent * 1024.0).to(torch.int32), 0, 1023)
    order = torch.argsort(morton3d(grid), stable=True)

    pad = (-n) % S
    order_p = torch.cat([order, torch.full((pad,), -1, dtype=torch.int64, device=dev)])
    C = (n + pad) // S

    def take(x, fill):
        xp = torch.cat([x, torch.full((1,) + tuple(x.shape[1:]), fill, dtype=x.dtype, device=dev)])
        return xp[order_p].reshape(C, S, -1)

    v0c, v1c, v2c = take(v0, 0.0), take(v1, 0.0), take(v2, 0.0)
    prim = torch.where(order_p >= 0, order_p, -1).reshape(C, S)

    valid = (prim >= 0)[..., None]
    big = 1e30
    cmin = torch.where(valid, torch.minimum(torch.minimum(v0c, v1c), v2c), big).amin(dim=1)
    cmax = torch.where(valid, torch.maximum(torch.maximum(v0c, v1c), v2c), -big).amax(dim=1)
    packed = torch.cat([v0c, v1c - v0c, v2c - v0c, prim[..., None].to(torch.float32)], dim=-1)
    soa = packed.reshape(C * S, 10).T.contiguous()
    geom_cm = torch.cat(
        [
            packed.transpose(1, 2),
            cmin[:, :, None].expand(C, 3, S),
            cmax[:, :, None].expand(C, 3, S),
        ],
        dim=1,
    ).contiguous()

    G = SC_GROUP
    padc = (-C) % G
    mn = torch.cat([cmin, torch.full((padc, 3), big, device=dev)])
    mx = torch.cat([cmax, torch.full((padc, 3), -big, device=dev)])
    SCn = (C + padc) // G
    sc_min = mn.reshape(SCn, G, 3).amin(dim=1)
    sc_max = mx.reshape(SCn, G, 3).amax(dim=1)
    child_boxes = torch.cat([mn.reshape(SCn, G, 3), mx.reshape(SCn, G, 3)], dim=-1).reshape(SCn, G * 6)
    return ClusterMesh(
        aabb_min=cmin, aabb_max=cmax, packed=packed.contiguous(), soa=soa,
        prim=prim, geom_cm=geom_cm, sc_min=sc_min, sc_max=sc_max,
        child_boxes=child_boxes,
    )


def _finish(cm: ClusterMesh, best_lin, best_t, best_u, best_v, t_max_arr) -> HitResult:
    """Resolve linear slot -> prim id + geometric normal."""
    miss = ~torch.isfinite(best_t) | (best_t >= t_max_arr)
    lin = torch.clamp(best_lin.to(torch.int64), 0, cm.soa.shape[1] - 1)
    rows = cm.packed.reshape(-1, cm.packed.shape[-1])[lin]
    prim = rows[:, 9].to(torch.int64)
    nrm = cross(rows[:, 3:6], rows[:, 6:9])
    return HitResult(
        t=torch.where(miss, torch.inf, best_t),
        prim=torch.where(miss, -1, prim),
        u=best_u,
        v=best_v,
        normal=torch.where(miss[:, None], 0.0, nrm),
    )


def _intersect_dense(cm: ClusterMesh, rays_o, rays_d, t_min, t_max_arr) -> HitResult:
    """One dense pass over every triangle (small meshes), through the dense
    tracer on the SoA (kernel on the card, its plain version on the CPU)."""
    from .dense_tracer import dense_hit

    M = cm.soa.shape[1]
    best_t, best_lin, u, v = dense_hit(cm.soa, rays_o, rays_d, t_min=t_min)
    best_t = torch.where(best_t >= 1e29, torch.inf, best_t)
    best_t = torch.where(best_t <= t_max_arr, best_t, torch.inf)
    best_lin = torch.clamp(best_lin, 0, M - 1)
    return _finish(cm, best_lin, best_t, u, v, t_max_arr)


def _occluded_dense(cm: ClusterMesh, rays_o, rays_d, t_min, t_max_arr) -> torch.Tensor:
    """The dense pass's any hit: [N] bool, equal to ``_intersect_dense(...).prim
    >= 0`` (a hit t_min < t < t_max; the closest hit drops t >= 1e29, hence
    the cap)."""
    from .dense_tracer import dense_occluded

    return dense_occluded(cm.soa, rays_o, rays_d, torch.clamp_max(t_max_arr, 1e29), t_min=t_min)


def _slab_all(cm: ClusterMesh, rays_o, inv_d, t_lo, t_hi) -> torch.Tensor:
    """[N, C] entry t of every ray into every cluster box (inf: missed)."""
    lo = (cm.aabb_min[None] - rays_o[:, None]) * inv_d[:, None]
    hi = (cm.aabb_max[None] - rays_o[:, None]) * inv_d[:, None]
    t0 = torch.minimum(lo, hi).amax(dim=-1)
    t1 = torch.maximum(lo, hi).amin(dim=-1)
    hit = (t1 >= torch.clamp_min(t0, t_lo)) & (t0 <= t_hi[:, None])
    return torch.where(hit, torch.clamp_min(t0, 0.0), torch.inf)


def _mt_rows(rows: torch.Tensor, rays_o, rays_d, t_min):
    """Moeller-Trumbore where each ray has its own [S, 10] triangle rows ->
    (t [N, S], inf where missed; u; v): the dense tracer's arithmetic."""
    from .dense_tracer import _mt

    cols = (rays_o[:, 0:1], rays_o[:, 1:2], rays_o[:, 2:3],
            rays_d[:, 0:1], rays_d[:, 1:2], rays_d[:, 2:3])
    ok, t, u, v = _mt(rows.permute(2, 0, 1), *cols, t_min)
    return torch.where(ok, t, torch.inf)[0], u[0], v[0]


def intersect_clusters(cm: ClusterMesh, rays_o: torch.Tensor, rays_d: torch.Tensor,
                       t_min: float = 1e-4, t_max=1e10, any_hit: bool = False,
                       dense_threshold: int = 8192, max_candidates: int = 10) -> HitResult:
    """Closest-hit (or any-hit: the first hit found, then stop) trace."""
    N = rays_o.shape[0]
    C, S = cm.prim.shape
    dev = rays_o.device
    t_max_arr = torch.broadcast_to(torch.as_tensor(t_max, dtype=torch.float32, device=dev), (N,))
    if C * S <= dense_threshold or C == 1:
        return _intersect_dense(cm, rays_o, rays_d, t_min, t_max_arr)

    inv_d = 1.0 / torch.where(rays_d.abs() < 1e-12, 1e-12, rays_d)
    work = _slab_all(cm, rays_o, inv_d, t_min, t_max_arr)          # [N, C]
    # the K nearest clusters by entry t: K argmin extractions (first minimal
    # index, as jnp.argmin), each masking its pick
    K = min(max_candidates, C)
    col = torch.arange(C, device=dev)[None]
    cand_list, ent_list = [], []
    for _ in range(K):
        i = torch.argmin(work, dim=-1)
        cand_list.append(i)
        ent_list.append(torch.gather(work, 1, i[:, None])[:, 0])
        work = torch.where(col == i[:, None], torch.inf, work)
    cand = torch.stack(cand_list, dim=1)
    cand_entry = torch.stack(ent_list, dim=1)

    best_t = t_max_arr.clone()
    best_lin = torch.zeros((N,), dtype=torch.int64, device=dev)
    best_u = torch.zeros((N,), device=dev)
    best_v = torch.zeros((N,), device=dev)
    found = torch.zeros((N,), dtype=torch.bool, device=dev)
    done = torch.zeros((N,), dtype=torch.bool, device=dev)
    for k in range(K):
        cid = cand[:, k]
        ent = cand_entry[:, k]
        active = ~done & torch.isfinite(ent) & (ent <= best_t)
        rows = cm.packed[torch.where(active, cid, 0)]                # [N, S, 10]
        t, u, v = _mt_rows(rows, rays_o, rays_d, t_min)
        t = torch.where(active[:, None], t, torch.inf)
        i = torch.argmin(t, dim=-1, keepdim=True)
        tmin_ = torch.gather(t, 1, i)[:, 0]
        better = tmin_ < best_t
        best_lin = torch.where(better, cid * S + i[:, 0], best_lin)
        best_u = torch.where(better, torch.gather(u, 1, i)[:, 0], best_u)
        best_v = torch.where(better, torch.gather(v, 1, i)[:, 0], best_v)
        best_t = torch.where(better, tmin_, best_t)
        found = found | better
        if any_hit:
            done = done | found
        nxt = cand_entry[:, min(k + 1, K - 1)]
        done = done | ~torch.isfinite(nxt) | (nxt > best_t) | (k + 1 >= K)

    best_t = torch.where(found, best_t, torch.inf)
    return _finish(cm, best_lin, best_t, best_u, best_v, t_max_arr)


def occluded_clusters(cm: ClusterMesh, rays_o, rays_d, t_max, t_min: float = 1e-4,
                      max_candidates: int = 10, dense_threshold: int = 8192) -> torch.Tensor:
    """[N] bool: some hit closer than t_max among the candidates."""
    return intersect_clusters(cm, rays_o, rays_d, t_min=t_min, t_max=t_max, any_hit=True,
                              max_candidates=max_candidates,
                              dense_threshold=dense_threshold).prim >= 0
