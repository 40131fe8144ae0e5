"""Brute-force ray / triangle tests, the judge of the tracer's answers:
every sampled ray against every triangle of the mesh, in float64, by the
Moeller-Trumbore test (two-sided; a hit needs |det| > 1e-12, u >= 0,
v >= 0, u + v <= 1 and t_min < t < t_max)."""

from __future__ import annotations

import torch

TRI_CHUNK = 16384


def closest_t(verts: torch.Tensor, tris: torch.Tensor, rays_o: torch.Tensor,
              rays_d: torch.Tensor, t_min: float, t_max: torch.Tensor) -> torch.Tensor:
    """[K] distance of each ray's closest hit with t_min < t < t_max, inf
    where it hits nothing.  verts [V, 3], tris [F, 3], rays [K, 3],
    t_max [K]."""
    v = verts.to(torch.float64)
    t = tris.long()
    v0, v1, v2 = v[t[:, 0]], v[t[:, 1]], v[t[:, 2]]
    e1, e2 = v1 - v0, v2 - v0
    o = rays_o.to(torch.float64)[:, None, :]
    d = rays_d.to(torch.float64)[:, None, :]
    tmax = t_max.to(torch.float64)
    best = torch.full((rays_o.shape[0],), float("inf"), dtype=torch.float64,
                      device=rays_o.device)
    for s in range(0, t.shape[0], TRI_CHUNK):
        a0, a1, a2 = v0[None, s:s + TRI_CHUNK], e1[None, s:s + TRI_CHUNK], e2[None, s:s + TRI_CHUNK]
        p = torch.linalg.cross(d.expand(-1, a2.shape[1], -1), a2.expand(d.shape[0], -1, -1))
        det = torch.sum(a1 * p, dim=-1)
        ok_det = det.abs() > 1e-12
        inv = torch.where(ok_det, 1.0 / torch.where(ok_det, det, 1.0), 0.0)
        tv = o - a0
        u = torch.sum(tv * p, dim=-1) * inv
        qv = torch.linalg.cross(tv, a1.expand(d.shape[0], -1, -1))
        w = torch.sum(d * qv, dim=-1) * inv
        th = torch.sum(a2 * qv, dim=-1) * inv
        hit = ok_det & (u >= 0) & (w >= 0) & (u + w <= 1) & (th > t_min) & (th < tmax[:, None])
        cand = torch.where(hit, th, float("inf")).min(dim=1).values
        best = torch.minimum(best, cand)
    return best


def judge_hits(t_prog: torch.Tensor, prim_prog: torch.Tensor, t_ref: torch.Tensor) -> torch.Tensor:
    """[K] bool: the program's closest hit disagrees with the brute force
    (a hit against a miss, or distances apart by more than 1e-4 of the
    distance)."""
    hit_p = prim_prog >= 0
    hit_r = torch.isfinite(t_ref)
    tol = 1e-4 * torch.clamp_min(t_ref.abs(), 1.0)
    far = (t_prog.to(torch.float64) - t_ref).abs() > tol
    return (hit_p != hit_r) | (hit_p & hit_r & far)


def judge_occlusion(occ_prog: torch.Tensor, t_ref: torch.Tensor) -> torch.Tensor:
    """[K] bool: the program's occlusion disagrees with the brute force."""
    return occ_prog.bool() != torch.isfinite(t_ref)
