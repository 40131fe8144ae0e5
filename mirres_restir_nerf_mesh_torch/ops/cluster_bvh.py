"""Triangle clusters for the tracers (counterpart of
mirres_restir_nerf_mesh_tpu/ops/cluster_bvh.py: ``ClusterMesh``,
``build_clusters``, ``_finish`` and the dense pass ``_intersect_dense``).

Triangles are morton-sorted into clusters of S; each cluster keeps a
component-major geometry block ``geom_cm`` [16, S] that the tile tracer's
kernel stages in shared memory.  Superclusters of SC_GROUP morton-neighbour
clusters feed the two-level candidate prep of ops/tile_tracer.py.
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
