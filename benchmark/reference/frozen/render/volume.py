"""Stage-0 volume renderer: march -> field -> composite (counterpart of
mirres_restir_nerf_mesh_tpu/render/volume.py ``render_rays``).

Train and eval share one pipeline; eval takes more samples a ray and
evaluates the field in chunks of ``field_chunk`` points.  With
``compact_points`` M (the train step's point budget), the field runs on the
first M valid samples in ray order only (the reference's cross-ray
compaction: a stable valid-first order, truncated in ray order), and the
results go back to their [N, K] slots; the rest weigh zero.  The three
parts run under the profiler ranges ``march``, ``field`` and ``composite``.
(The port's data-parallel ``shard`` is left out of this copy.)
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch.profiler import record_function

from ..models import nerf as nerf_model
from ..ops.marching import composite_rays, march_rays, near_far_from_aabb
from ..utils.compact import apply_in_chunks
from ..utils.math import safe_normalize


def field_points(N: int, K: int, compact_points: Optional[int] = None, sdf: bool = False) -> int:
    """Points the field evaluates for N rays of K samples: the stochastic
    encode's uniforms are drawn for this many."""
    if not sdf and compact_points is not None and compact_points < N * K:
        return compact_points
    return N * K


def render_rays(params: Dict[str, Any], occ: torch.Tensor, rays_o: torch.Tensor,
                rays_d: torch.Tensor, spec: nerf_model.NeRFSpec, aabb: torch.Tensor, *,
                K: int = 64, max_steps: int = 1024, dt_gamma: float = 0.0,
                min_near: float = 0.05, T_thresh: float = 1e-4,
                bg_color: Optional[torch.Tensor] = None, noise: Optional[torch.Tensor] = None,
                contract: bool = False, max_level=None, cos_anneal_ratio=1.0,
                cam_near_far: Optional[torch.Tensor] = None,
                stochastic_u: Optional[torch.Tensor] = None,
                compact_points: Optional[int] = None, field_chunk: Optional[int] = None,
                march_candidates: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """Render N rays -> image [N,3], depth [N], weights_sum [N], and the
    training extras (weights, xyzs, valid, sigmas; normal and sdf in sdf
    mode).  noise: [N] march perturbation uniforms; stochastic_u: [P, 3]
    one-corner encode uniforms for the P = ``field_points`` evaluated
    points (None: exact encode)."""
    nears, fars = near_far_from_aabb(rays_o, rays_d, aabb, min_near)
    if cam_near_far is not None:
        nears = torch.maximum(nears, cam_near_far[:, 0])
        fars = torch.minimum(fars, cam_near_far[:, 1])
    with torch.no_grad(), record_function("march"):
        m = march_rays(rays_o, rays_d, occ, nears, fars, bound=spec.bound, K=K,
                       max_steps=max_steps, dt_gamma=dt_gamma, noise=noise, contract=contract,
                       n_candidates=march_candidates)
    N, Kk = m.ts.shape
    pts = m.xyzs.reshape(-1, 3)
    dirs = safe_normalize(m.dirs[:, None, :].expand(N, Kk, 3)).reshape(-1, 3)
    results: Dict[str, torch.Tensor] = {}

    def chunked(fn, *arrays):
        if field_chunk is None:
            return fn(*arrays)
        return apply_in_chunks(fn, arrays, field_chunk)

    def field(p, d, *u):
        return nerf_model.forward(params, p, d, spec, max_level=max_level,
                                  stochastic_u=u[0] if u else None)

    def sdf_eval(p, d, dt):
        dres = nerf_model.density(params, p, spec, max_level=max_level)
        rgbs = nerf_model.color(params, dres["geo_feat"], d, spec)
        nrm = nerf_model.normal_autodiff(params, p, spec, max_level=max_level)
        alphas = nerf_model.neus_alpha(dres["sigma"], params["variance"], nrm, d, dt,
                                       cos_anneal_ratio=cos_anneal_ratio)
        return dres["sigma"], rgbs, nrm, alphas

    compact = compact_points is not None and compact_points < N * Kk
    su = () if stochastic_u is None else (stochastic_u,)
    alpha_mode = spec.sdf
    with record_function("field"):
        if spec.sdf:
            sdf, rgbs, raw_normal, alphas = chunked(sdf_eval, pts, dirs, m.dts.reshape(-1))
            sig_for_comp = alphas.reshape(N, Kk)
            results["normal"] = raw_normal.reshape(N, Kk, 3)
            results["sdf"] = sdf.reshape(N, Kk)
        elif compact:
            valid_flat = m.valid.reshape(-1)
            # stable valid-first order; its first M positions are unique,
            # the valid ones among them the first M valid samples in ray order
            idx = torch.sort((~valid_flat).to(torch.int8), stable=True).indices[:compact_points]
            sig_c, rgb_c = chunked(field, pts[idx], dirs[idx], *su)
            packed = torch.cat([sig_c[:, None].to(torch.float32), rgb_c.to(torch.float32)], dim=1)
            packed = torch.where(valid_flat[idx, None], packed, 0.0)
            # unique targets: a copy whose backward is a gather
            got = torch.zeros((N * Kk, 4), dtype=packed.dtype, device=packed.device)
            got = got.index_copy(0, idx, packed)
            sig_for_comp, rgbs = got[:, 0].reshape(N, Kk), got[:, 1:4]
        else:
            sigmas, rgbs = chunked(field, pts, dirs, *su)
            sig_for_comp = sigmas.reshape(N, Kk)
    with record_function("composite"):
        comp = composite_rays(sig_for_comp, rgbs.reshape(N, Kk, 3), m.ts, m.dts, m.valid,
                              T_thresh=T_thresh, alpha_mode=alpha_mode)
    bg = (torch.ones((1, 3), device=rays_o.device) if bg_color is None
          else torch.as_tensor(bg_color, dtype=torch.float32, device=rays_o.device).reshape(-1, 3))
    results.update(image=comp.image + (1.0 - comp.weights_sum)[:, None] * bg, depth=comp.depth,
                   weights=comp.weights, weights_sum=comp.weights_sum, xyzs=m.xyzs, valid=m.valid,
                   sigmas=sig_for_comp, num_points=m.valid.sum())
    return results

