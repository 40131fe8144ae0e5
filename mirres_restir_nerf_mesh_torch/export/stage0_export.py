"""Stage-0 mesh extraction: density field -> cleaned, decimated surface mesh
(counterpart of mirres_restir_nerf_mesh_tpu/export/stage0_export.py).

1. the density (or SDF) on a dense grid, in chunks on the device;
2. marching tetrahedra (native/meshops.cpp);
3. optional visibility culling: every training-view pixel ray goes through
   the port's tracer (ops/tracer.py: K1, or K3 for a small mesh) and a face
   no closest hit lands on is dropped (a z-buffer, so interior faces go);
4. small components removed, QEM decimation;
5. ``mesh_{cascade}.ply``; outer cascades (bound > 1) give shells without
   the faces inside the previous cascade's box.
"""

from __future__ import annotations

import os
from typing import Callable

import numpy as np
import torch

from ..data.rays import get_rays
from ..device import resolve_device
from ..ops.tracer import build_tracer
from .meshio import write_ply
from .meshops import clean_components, decimate, marching_tets


def query_density_grid(density_fn: Callable[[torch.Tensor], torch.Tensor], resolution: int,
                       bound: float, chunk: int = 262144, device="cuda") -> np.ndarray:
    """Dense [R, R, R] field over [-bound, bound]^3 (x slowest), density_fn
    called on chunks of points on ``device``."""
    dev = resolve_device(device)
    # numpy's linspace: torch.linspace rounds some lattice points an ulp apart
    ax = torch.as_tensor(np.linspace(-bound, bound, resolution, dtype=np.float32), device=dev)
    pts = torch.stack(torch.meshgrid(ax, ax, ax, indexing="ij"), dim=-1).reshape(-1, 3)
    out = np.empty((resolution ** 3,), np.float32)
    with torch.no_grad():
        for s in range(0, pts.shape[0], chunk):
            out[s: s + chunk] = density_fn(pts[s: s + chunk]).float().cpu().numpy()
    return out.reshape(resolution, resolution, resolution)


def mark_unseen_triangles(verts: np.ndarray, tris: np.ndarray, poses: np.ndarray,
                          intrinsics: np.ndarray, H: int, W: int, downscale: int = 1,
                          device="cuda") -> np.ndarray:
    """True for triangles that no training-view pixel ray hits first (one
    closest-hit launch a view)."""
    dev = resolve_device(device)
    Hs, Ws = max(H // downscale, 1), max(W // downscale, 1)
    intr = np.asarray(intrinsics, np.float32) / downscale
    tracer = build_tracer(torch.as_tensor(verts, device=dev),
                          torch.as_tensor(tris.astype(np.int32), device=dev))
    seen = torch.zeros((tris.shape[0],), dtype=torch.bool, device=dev)
    with torch.no_grad():
        for p in poses:
            r = get_rays(torch.as_tensor(np.asarray(p, np.float32), device=dev)[None], intr,
                         Hs, Ws)
            prim = tracer.intersect(r["rays_o"].contiguous(), r["rays_d"]).prim
            seen[prim[prim >= 0]] = True
    return ~seen.cpu().numpy()


def export_stage0_mesh(density_fn: Callable[[torch.Tensor], torch.Tensor], workspace: str, *,
                       bound: float = 1.0, cascade: int = 1, resolution: int = 512,
                       density_thresh: float = 10.0, decimate_target: float = 3e5,
                       clean_min_f: int = 8, clean_min_d: int = 5, sdf: bool = False,
                       dataset=None, visibility_culling: bool = False, env_reso: int = 256,
                       device="cuda"):
    """Extract and write mesh_{cas}.ply for each cascade -> [(verts, tris)]
    (the inner mesh first).  dataset: a FrameData (poses, intrinsics, H, W)
    for the visibility culling."""
    os.makedirs(workspace, exist_ok=True)
    meshes = []
    for cas in range(cascade):
        cas_bound = min(2.0 ** cas, bound)
        reso = resolution if cas == 0 else env_reso
        grid = query_density_grid(density_fn, reso, cas_bound, device=device)
        field, iso = (-grid, 0.0) if sdf else (grid, float(density_thresh))
        v, t = marching_tets(field, iso, origin=(-cas_bound,) * 3,
                             spacing=(2.0 * cas_bound / (reso - 1),) * 3)
        if len(t) == 0:
            continue
        if cas > 0 and meshes:
            inner_b = min(2.0 ** (cas - 1), bound)
            t = t[np.abs(v[t].mean(axis=1)).max(axis=-1) > inner_b]
        # an outer cascade can keep no face once the inner box's are cut (a
        # compact object): nothing to cull (the reference builds a tracer on
        # the empty mesh there and fails)
        if visibility_culling and dataset is not None and len(t):
            t = t[~mark_unseen_triangles(v, t, dataset.poses, dataset.intrinsics, dataset.H,
                                         dataset.W, device=device)]
        v, t = clean_components(v, t, clean_min_f, float(clean_min_d) / 100.0 * 2 * cas_bound)
        if decimate_target > 0 and t.shape[0] > decimate_target:
            v, t = decimate(v, t, int(decimate_target))
        write_ply(os.path.join(workspace, f"mesh_{cas}.ply"), v, t)
        meshes.append((v, t))
    return meshes
