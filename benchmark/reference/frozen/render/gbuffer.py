"""G-buffer by ray casting (counterpart of mirres_restir_nerf_mesh_tpu/render/gbuffer.py).

Positions and normals are interpolated from the (offset) vertices with the
hit barycentrics, so gradients reach the vertices of the hit triangle;
silhouette gradients come from render/antialias.py.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.tracer import Tracer
from ..utils.math import cross, safe_normalize


def auto_normals(verts: torch.Tensor, tris: torch.Tensor) -> torch.Tensor:
    """Area-weighted vertex normals by scatter-add (+z for degenerate).  The
    sums run in face order on every device (``index_put`` with accumulate
    sorts the rows; ``index_add`` on the card adds by atomics, in an order
    that changes from call to call, and a vertex normal an ulp apart moves
    ReSTIR's picks between two renders of one state)."""
    t = tris.long()
    v0, v1, v2 = verts[t[:, 0]], verts[t[:, 1]], verts[t[:, 2]]
    fn = cross(v1 - v0, v2 - v0)
    vn = torch.zeros_like(verts)
    for k in range(3):
        vn = vn.index_put((t[:, k],), fn, accumulate=True)
    bad = torch.sum(vn * vn, dim=-1, keepdim=True) < 1e-20
    vn = torch.where(bad, torch.tensor([0.0, 0.0, 1.0], device=verts.device), vn)
    return safe_normalize(vn)


class GBuffer(NamedTuple):
    mask: torch.Tensor         # [N] bool hit
    position: torch.Tensor     # [N,3] world hit position
    normal: torch.Tensor       # [N,3] smooth shading normal
    face_normal: torch.Tensor  # [N,3] geometric normal
    depth: torch.Tensor        # [N]
    face_id: torch.Tensor      # [N] int64 (-1 miss)
    bary: torch.Tensor         # [N,3]
    view_dir: torch.Tensor     # [N,3] unit, camera toward surface
    tri_v0: torch.Tensor       # [N,3] hit triangle vertices (for antialias)
    tri_v1: torch.Tensor
    tri_v2: torch.Tensor


def raycast_gbuffer(verts: torch.Tensor, tris: torch.Tensor, tracer: Tracer,
                    rays_o: torch.Tensor, rays_d: torch.Tensor) -> GBuffer:
    """Cast primary rays; interpolate attributes differentiably from verts."""
    d = safe_normalize(rays_d)
    hit = tracer.intersect(rays_o, d)
    mask = hit.prim >= 0
    face = torch.where(mask, hit.prim, 0)
    t = tris.long()
    i0, i1, i2 = t[face, 0], t[face, 1], t[face, 2]
    w = torch.stack([1.0 - hit.u - hit.v, hit.u, hit.v], dim=-1)
    tv0, tv1, tv2 = verts[i0], verts[i1], verts[i2]
    pos = w[:, 0:1] * tv0 + w[:, 1:2] * tv1 + w[:, 2:3] * tv2
    vn = auto_normals(verts, tris)
    nrm = safe_normalize(w[:, 0:1] * vn[i0] + w[:, 1:2] * vn[i1] + w[:, 2:3] * vn[i2])
    fn = safe_normalize(cross(tv1 - tv0, tv2 - tv0))
    m3 = mask[:, None]
    return GBuffer(
        mask=mask, position=torch.where(m3, pos, 0.0), normal=torch.where(m3, nrm, 0.0),
        face_normal=torch.where(m3, fn, 0.0), depth=torch.where(mask, hit.t, 0.0),
        face_id=hit.prim, bary=w, view_dir=d, tri_v0=tv0, tri_v1=tv1, tri_v2=tv2,
    )


def prepare_shading_normal(view_dir, smooth_nrm, geom_nrm):
    """Two-sided flip toward the camera + bent-normal blend so the shading
    normal never faces away from the viewer."""
    view = -view_dir
    flip = torch.sum(view * geom_nrm, dim=-1, keepdim=True) < 0
    smooth = torch.where(flip, -smooth_nrm, smooth_nrm)
    NoV = torch.sum(view * smooth, dim=-1, keepdim=True)
    t = torch.clamp(NoV / 0.1, 0.0, 1.0)
    bent = safe_normalize(view * (1.0 - t) + smooth * t)
    return torch.where(NoV < 0.1, bent, smooth)
