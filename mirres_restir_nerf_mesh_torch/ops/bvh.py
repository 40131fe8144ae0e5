"""LBVH construction and ray-mesh traversal (counterpart of
mirres_restir_nerf_mesh_tpu/ops/bvh.py), and the hit record of every tracer.

A Karras (2012) hierarchy over the triangles' 30-bit Morton codes, built by
fixed-count loops of tensor ops (the reference's ``fori_loop``s: 22
doubling steps, 24 + 24 binary-search steps, ``max_depth`` bottom-up box
sweeps), so the tree equals the reference's bit for bit; then a lockstep
stack traversal of every ray (Moeller-Trumbore leaves, back faces hit).
Plain PyTorch on either device: the reference computes it in XLA, with no
Pallas kernel.  Node layout: internal nodes 0..n-2, leaves n-1..2n-2 (leaf
i holds sorted primitive i).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.math import cross
from .morton import morton3d

EXIT_TEST_EVERY = 8   # traversal steps between the host's looks at the live-ray count


class HitResult(NamedTuple):
    t: torch.Tensor        # [R] hit distance (inf if miss)
    prim: torch.Tensor     # [R] int64 original primitive id (-1 if miss)
    u: torch.Tensor        # [R] barycentric u
    v: torch.Tensor        # [R] barycentric v
    normal: torch.Tensor   # [R, 3] geometric normal (unnormalized cross)


class BVH(NamedTuple):
    node_min: torch.Tensor   # [2n-1, 3]
    node_max: torch.Tensor   # [2n-1, 3]
    left: torch.Tensor       # [n-1] int64 child (node id space)
    right: torch.Tensor      # [n-1]
    prim: torch.Tensor       # [n] int64 sorted primitive ids (leaf order)
    tri_v0: torch.Tensor     # [n, 3] triangle vertices in leaf order
    tri_e1: torch.Tensor     # [n, 3]
    tri_e2: torch.Tensor     # [n, 3]


def _bit_length(x: torch.Tensor) -> torch.Tensor:
    """Position of the highest set bit + 1 (0 for x == 0) of uint32 values
    held in int64."""
    out = torch.zeros_like(x)
    cur = x
    for shift in (16, 8, 4, 2, 1):
        hi = cur >> shift
        has = hi > 0
        out = out + torch.where(has, shift, 0)
        cur = torch.where(has, hi, cur)
    return torch.where(x == 0, 0, out + 1)


def _common_prefix(codes: torch.Tensor, i: torch.Tensor, j: torch.Tensor, n: int) -> torch.Tensor:
    """Karras delta(i, j): common-prefix length of the Morton codes, the
    index breaking ties of equal codes (+32), -1 where j is out of range."""
    j_ok = (j >= 0) & (j < n)
    jc = torch.clamp(j, 0, n - 1)
    x = codes[i] ^ codes[jc]
    xi = i ^ jc
    d = torch.where(x == 0, 32 + (32 - _bit_length(xi)), 32 - _bit_length(x))
    return torch.where(j_ok, d, -1)


def build_bvh(vertices: torch.Tensor, triangles: torch.Tensor, max_depth: int = 64) -> BVH:
    """vertices [V, 3] float32, triangles [n, 3] -> BVH on their device."""
    tri = triangles.to(torch.int64)
    v0, v1, v2 = vertices[tri[:, 0]], vertices[tri[:, 1]], vertices[tri[:, 2]]
    n = tri.shape[0]
    dev = vertices.device

    tmin = torch.minimum(torch.minimum(v0, v1), v2)
    tmax = torch.maximum(torch.maximum(v0, v1), v2)
    centroid = (tmin + tmax) * 0.5
    scene_min = tmin.amin(dim=0)
    extent = torch.clamp_min(tmax.amax(dim=0) - scene_min, 1e-9)
    unit = (centroid - scene_min) / extent
    grid = torch.clamp((unit * 1024.0).to(torch.int32), 0, 1023)
    codes = morton3d(grid)

    order = torch.argsort(codes, stable=True)   # jnp.argsort is stable: equal codes keep their order
    codes = codes[order]
    prim = order
    e1, e2 = v1 - v0, v2 - v0

    if n == 1:
        empty = torch.zeros((0,), dtype=torch.int64, device=dev)
        return BVH(tmin[:1], tmax[:1], empty, empty, prim, v0[order], e1[order], e2[order])

    i = torch.arange(n - 1, dtype=torch.int64, device=dev)

    # direction and range of each internal node
    d_next = _common_prefix(codes, i, i + 1, n)
    d_prev = _common_prefix(codes, i, i - 1, n)
    d = torch.where(d_next > d_prev, 1, -1)
    delta_min = _common_prefix(codes, i, i - d, n)

    lmax = torch.full((n - 1,), 2, dtype=torch.int64, device=dev)
    for _ in range(22):   # upper bound of the range length by doubling
        ok = _common_prefix(codes, i, i + lmax * d, n) > delta_min
        lmax = torch.where(ok, lmax * 2, lmax)

    length = torch.zeros((n - 1,), dtype=torch.int64, device=dev)
    t = lmax // 2
    for _ in range(24):   # binary search of the exact length
        ok = _common_prefix(codes, i, i + (length + t) * d, n) > delta_min
        length = torch.where(ok, length + t, length)
        t = torch.clamp_min(t // 2, 1)
    j = i + length * d

    delta_node = _common_prefix(codes, i, j, n)
    s = torch.zeros((n - 1,), dtype=torch.int64, device=dev)
    t2 = (length + 1) // 2
    for _ in range(24):   # split position
        ok = _common_prefix(codes, i, i + (s + t2) * d, n) > delta_node
        s = torch.where(ok & (s + t2 < length), s + t2, s)
        t2 = torch.clamp_min((t2 + 1) // 2, 1)
    gamma = i + s * d + torch.clamp_max(d, 0)

    lo = torch.minimum(i, j)
    hi = torch.maximum(i, j)
    left = torch.where(lo == gamma, gamma + (n - 1), gamma)
    right = torch.where(hi == gamma + 1, gamma + 1 + (n - 1), gamma + 1)

    # bottom-up boxes by fixed-depth sweeps
    node_min = torch.cat([torch.full((n - 1, 3), torch.inf, device=dev), tmin[prim]])
    node_max = torch.cat([torch.full((n - 1, 3), -torch.inf, device=dev), tmax[prim]])
    for _ in range(max_depth):
        node_min = torch.cat([torch.minimum(node_min[left], node_min[right]), node_min[n - 1:]])
        node_max = torch.cat([torch.maximum(node_max[left], node_max[right]), node_max[n - 1:]])

    return BVH(node_min=node_min, node_max=node_max, left=left, right=right, prim=prim,
               tri_v0=v0[prim], tri_e1=e1[prim], tri_e2=e2[prim])


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x + y + z in that order on every device (a reduction kernel may sum
    three terms in another, which moves a grazing hit's t by ulps)."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _tri_hit(bvh: BVH, leaf_id: torch.Tensor, rays_o, rays_d, t_min: float):
    """Moeller-Trumbore of each ray against the triangle of its leaf_id ->
    (t, inf where missed; u; v; unnormalized normal)."""
    v0, e1, e2 = bvh.tri_v0[leaf_id], bvh.tri_e1[leaf_id], bvh.tri_e2[leaf_id]
    pvec = cross(rays_d, e2)
    det = _dot(e1, pvec)
    inv_det = torch.where(det.abs() < 1e-12, 0.0, 1.0 / det)
    tvec = rays_o - v0
    u = _dot(tvec, pvec) * inv_det
    qvec = cross(tvec, e1)
    v = _dot(rays_d, qvec) * inv_det
    t = _dot(e2, qvec) * inv_det
    ok = (det.abs() > 1e-12) & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > t_min)
    return torch.where(ok, t, torch.inf), u, v, cross(e1, e2)


def _aabb_hit(bvh: BVH, node, o, idv, tmax_cur):
    """The slab test of the reference: t1 >= max(t0, 0) and t0 <= the ray's
    current best (t_min plays no part)."""
    lo = (bvh.node_min[node] - o) * idv
    hi = (bvh.node_max[node] - o) * idv
    t0 = torch.minimum(lo, hi).amax(dim=-1)
    t1 = torch.maximum(lo, hi).amin(dim=-1)
    return (t1 >= torch.clamp_min(t0, 0.0)) & (t0 <= tmax_cur)


def intersect_bvh(bvh: BVH, rays_o: torch.Tensor, rays_d: torch.Tensor, t_min: float = 1e-4,
                  t_max=1e10, any_hit: bool = False, stack_depth: int = 64) -> HitResult:
    """Closest-hit (or any-hit) traversal of R rays in lockstep: a
    [R, stack_depth] stack a ray, one node popped a step, the children whose
    box the ray enters pushed (left, then right), the stack pointer clamped
    to stack_depth - 1 as in the reference."""
    R = rays_o.shape[0]
    n = bvh.prim.shape[0]
    n_internal = n - 1
    dev = rays_o.device
    best_t = torch.broadcast_to(torch.as_tensor(t_max, dtype=torch.float32, device=dev), (R,))

    if n == 1:
        hit_t, u, v, nrm = _tri_hit(bvh, torch.zeros((R,), dtype=torch.int64, device=dev),
                                    rays_o, rays_d, t_min)
        hit = hit_t < best_t
        return HitResult(t=torch.where(hit, hit_t, torch.inf),
                         prim=torch.where(hit, bvh.prim[0], -1), u=u, v=v, normal=nrm)

    inv_d = 1.0 / torch.where(rays_d.abs() < 1e-12, 1e-12, rays_d)
    stack = torch.zeros((R, stack_depth), dtype=torch.int64, device=dev)
    sp = torch.ones((R,), dtype=torch.int64, device=dev)     # stack[:, 0] = 0, the root
    best_t = best_t.clone()
    best_prim = torch.full((R,), -1, dtype=torch.int64, device=dev)
    best_u = torch.zeros((R,), device=dev)
    best_v = torch.zeros((R,), device=dev)
    best_n = torch.zeros((R, 3), device=dev)
    done = torch.zeros((R,), dtype=torch.bool, device=dev)
    rows = torch.arange(R, device=dev)
    top = stack_depth - 1

    step = 0
    while True:
        active = (sp > 0) & ~done
        # a finished ray changes nothing in later steps, so the host may
        # look at the exit test only every few steps
        if step % EXIT_TEST_EVERY == 0 and not bool(active.any()):
            break
        step += 1
        spc = torch.clamp_min(sp - 1, 0)
        node = stack[rows, spc]
        sp_new = torch.where(active, spc, sp)

        is_leaf = node >= n_internal
        leaf_id = torch.clamp(node - n_internal, 0, n - 1)
        hit_t, u, v, nrm = _tri_hit(bvh, leaf_id, rays_o, rays_d, t_min)
        better = active & is_leaf & (hit_t < best_t)
        best_t = torch.where(better, hit_t, best_t)
        best_prim = torch.where(better, bvh.prim[leaf_id], best_prim)
        best_u = torch.where(better, u, best_u)
        best_v = torch.where(better, v, best_v)
        best_n = torch.where(better[:, None], nrm, best_n)
        if any_hit:
            done = done | better

        node_i = torch.clamp(node, 0, n_internal - 1)
        lchild, rchild = bvh.left[node_i], bvh.right[node_i]
        inner = active & ~is_leaf
        push_l = inner & _aabb_hit(bvh, lchild, rays_o, inv_d, best_t)
        push_r = inner & _aabb_hit(bvh, rchild, rays_o, inv_d, best_t)
        for push, child in ((push_l, lchild), (push_r, rchild)):
            idx = torch.clamp(torch.where(push, sp_new, top), 0, top)
            stack[rows, idx] = torch.where(push, child, stack[rows, idx])
            sp_new = sp_new + push.long()
        sp = torch.clamp_max(sp_new, top)

    miss = best_prim < 0
    return HitResult(t=torch.where(miss, torch.inf, best_t), prim=best_prim, u=best_u, v=best_v,
                     normal=best_n)


def occluded(bvh: BVH, rays_o: torch.Tensor, rays_d: torch.Tensor, t_max,
             t_min: float = 1e-4) -> torch.Tensor:
    """Shadow-ray query: True where some hit lies closer than t_max (a
    scalar or [R])."""
    return intersect_bvh(bvh, rays_o, rays_d, t_min=t_min, t_max=t_max, any_hit=True).prim >= 0
