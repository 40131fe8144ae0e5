"""Stage-0 volume renderer: march -> field -> composite (counterpart of
mirres_restir_nerf_mesh_tpu/render/volume.py ``render_rays``).

Train and eval share one pipeline; eval takes more samples a ray and
evaluates the field in chunks of ``field_chunk`` points.  With
``compact_points`` M (the train step's point budget), the field runs on the
first M valid samples in ray order only (the reference's cross-ray
compaction: a stable valid-first order, truncated in ray order), and the
results go back to their [N, K] slots; the rest weigh zero.  With a
``shard`` (data parallelism: these rays are one rank's contiguous rows of
the batch) the compaction is the whole batch's: each rank's count of valid
samples is gathered, and rank r keeps its valid samples whose index among
the batch's valid samples is below M, at the global slots offset_r + j
(the stochastic encode's uniforms are taken by that slot).  The three
parts run under the profiler ranges ``march``, ``field`` and ``composite``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from ..models import nerf as nerf_model
from ..ops.marching import MarchResult, composite_rays, march_rays, near_far_from_aabb
from ..parallel.mesh import Shard, all_gather_rows
from ..utils.compact import apply_in_chunks
from ..utils.math import safe_normalize
from ..utils.profiling import span


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
                march_candidates: Optional[int] = None,
                shard: Optional[Shard] = None) -> Dict[str, torch.Tensor]:
    """Render N rays -> image [N,3], depth [N], weights_sum [N], and the
    training extras (weights, xyzs, valid, sigmas; normal and sdf in sdf
    mode).  noise: [N] march perturbation uniforms; stochastic_u: [P, 3]
    one-corner encode uniforms for the P = ``field_points`` evaluated
    points (None: exact encode); with ``shard``, P counts the whole
    batch's points and the rays are the shard's rows."""
    m, pts, dirs = march_points(occ, rays_o, rays_d, spec, aabb, K=K, max_steps=max_steps,
                                dt_gamma=dt_gamma, min_near=min_near, noise=noise,
                                contract=contract, cam_near_far=cam_near_far,
                                march_candidates=march_candidates)
    N, Kk = m.ts.shape
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

    n_all = N if shard is None else shard.n
    compact = compact_points is not None and compact_points < n_all * Kk
    if shard is not None and stochastic_u is not None and not compact:
        stochastic_u = stochastic_u[shard.lo * Kk:shard.hi * Kk]
    su = () if stochastic_u is None else (stochastic_u,)
    alpha_mode = spec.sdf
    with span("field"):
        if spec.sdf:
            sdf, rgbs, raw_normal, alphas = chunked(sdf_eval, pts, dirs, m.dts.reshape(-1))
            sig_for_comp = alphas.reshape(N, Kk)
            results["normal"] = raw_normal.reshape(N, Kk, 3)
            results["sdf"] = sdf.reshape(N, Kk)
        elif compact:
            valid_flat = m.valid.reshape(-1)
            if shard is None:
                idx = compact_index(valid_flat, compact_points)
            else:
                idx, su = _global_compaction(valid_flat, compact_points, shard, stochastic_u)
            sig_c, rgb_c = chunked(field, pts[idx], dirs[idx], *su)
            sig_flat, rgbs = spread_field(sig_c, rgb_c, valid_flat, idx, N * Kk)
            sig_for_comp = sig_flat.reshape(N, Kk)
        else:
            sigmas, rgbs = chunked(field, pts, dirs, *su)
            sig_for_comp = sigmas.reshape(N, Kk)
    results.update(shade(m, sig_for_comp, rgbs, bg_color, T_thresh, alpha_mode),
                   xyzs=m.xyzs, valid=m.valid, sigmas=sig_for_comp, num_points=m.valid.sum())
    return results


def march_points(occ: torch.Tensor, rays_o: torch.Tensor, rays_d: torch.Tensor,
                 spec: nerf_model.NeRFSpec, aabb: torch.Tensor, *, K: int, max_steps: int,
                 dt_gamma: float, min_near: float, noise: Optional[torch.Tensor], contract: bool,
                 cam_near_far: Optional[torch.Tensor], march_candidates: Optional[int]):
    """``render_rays``' march (no gradient) -> (MarchResult, the samples'
    positions [N*K, 3] and unit directions [N*K, 3])."""
    nears, fars = near_far_from_aabb(rays_o, rays_d, aabb, min_near)
    if cam_near_far is not None:
        nears = torch.maximum(nears, cam_near_far[:, 0])
        fars = torch.minimum(fars, cam_near_far[:, 1])
    with torch.no_grad(), span("march"):
        m = march_rays(rays_o, rays_d, occ, nears, fars, bound=spec.bound, K=K,
                       max_steps=max_steps, dt_gamma=dt_gamma, noise=noise, contract=contract,
                       n_candidates=march_candidates)
    N, Kk = m.ts.shape
    pts = m.xyzs.reshape(-1, 3)
    dirs = safe_normalize(m.dirs[:, None, :].expand(N, Kk, 3)).reshape(-1, 3)
    return m, pts, dirs


def compact_index(valid_flat: torch.Tensor, M: int) -> torch.Tensor:
    """The first M positions of the stable valid-first order of the samples:
    unique, the valid ones among them the first M valid samples in ray
    order."""
    return torch.sort((~valid_flat).to(torch.int8), stable=True).indices[:M]


def spread_field(sig_c: torch.Tensor, rgb_c: torch.Tensor, valid_flat: torch.Tensor,
                 idx: torch.Tensor, n: int):
    """The compacted samples' sigma [M] and rgb [M, 3] back to their slots
    among n -> (sigma [n], rgb [n, 3]), zero where no valid sample lands."""
    packed = torch.cat([sig_c[:, None].to(torch.float32), rgb_c.to(torch.float32)], dim=1)
    packed = torch.where(valid_flat[idx, None], packed, 0.0)
    # unique targets: a copy whose backward is a gather
    got = torch.zeros((n, 4), dtype=packed.dtype, device=packed.device)
    got = got.index_copy(0, idx, packed)
    return got[:, 0], got[:, 1:4]


def shade(m: MarchResult, sig_for_comp: torch.Tensor, rgbs: torch.Tensor, bg_color,
          T_thresh: float, alpha_mode: bool) -> Dict[str, torch.Tensor]:
    """Composite the samples' sigma [N, K] and rgb [N*K, 3] over the
    background -> image, depth, weights, weights_sum."""
    N, Kk = m.ts.shape
    with span("composite"):
        comp = composite_rays(sig_for_comp, rgbs.reshape(N, Kk, 3), m.ts, m.dts, m.valid,
                              T_thresh=T_thresh, alpha_mode=alpha_mode)
    dev = m.ts.device
    bg = (torch.ones((1, 3), device=dev) if bg_color is None
          else torch.as_tensor(bg_color, dtype=torch.float32, device=dev).reshape(-1, 3))
    return {"image": comp.image + (1.0 - comp.weights_sum)[:, None] * bg, "depth": comp.depth,
            "weights": comp.weights, "weights_sum": comp.weights_sum}


def _global_compaction(valid_flat: torch.Tensor, M: int, shard: Shard,
                       stochastic_u: Optional[torch.Tensor]):
    """This rank's part of the batch's first M valid samples -> (its local
    sample indices, in order; the uniforms of their global slots, as a
    0- or 1-tuple)."""
    dp = shard.dp
    counts = all_gather_rows(valid_flat.sum().reshape(1), dp, [1] * dp.world).tolist()
    off = sum(counts[:dp.rank])
    keep = max(0, min(counts[dp.rank], M - off))
    idx = torch.nonzero(valid_flat)[:keep, 0]
    return idx, (() if stochastic_u is None else (stochastic_u[off:off + keep],))
