"""Silhouette antialiasing, forward (counterpart of
mirres_restir_nerf_mesh_tpu/render/antialias.py, the dr.antialias
equivalent).

For every horizontal and vertical pixel pair across a coverage boundary,
both rays are re-intersected with the hit pixel's triangle; the silhouette
crosses the segment between the pixel centers at s = w_hit[k] / (w_hit[k] -
w_miss[k]) (k: the miss point's most negative barycentric), and one pixel
of the pair blends toward the other: the hit pixel loses (1/2 - s) when
s < 1/2, the miss pixel gains (s - 1/2) when s > 1/2.  Only s carries vertex
gradients (scaled by ``boost``).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..utils.math import cross


def mt_bary(o, d, v0, v1, v2, eps: float = 1e-12):
    """Moeller-Trumbore barycentrics (u, v, ok) of rays against per-pixel
    triangles, all [N,3]."""
    e1 = v1 - v0
    e2 = v2 - v0
    p = cross(d, e2)
    det = torch.sum(e1 * p, dim=-1)
    small = det.abs() < eps
    inv = torch.where(small, 0.0, 1.0 / torch.where(small, 1.0, det))
    tvec = o - v0
    u = torch.sum(tvec * p, dim=-1) * inv
    v = torch.sum(d * cross(tvec, e1), dim=-1) * inv
    return u, v, det.abs() > eps


def _pair_blend(s, active, hit_is_a):
    """(blend_a, blend_b): fraction of the other pixel's value mixed in."""
    blend_hit = torch.where(active, torch.clamp(0.5 - s, 0.0, 0.5), 0.0)
    blend_miss = torch.where(active, torch.clamp(s - 0.5, 0.0, 0.5), 0.0)
    return (torch.where(hit_is_a, blend_hit, blend_miss),
            torch.where(hit_is_a, blend_miss, blend_hit))


def _crossing(o_a, d_a, o_b, d_b, v0, v1, v2, mask_a, mask_b, boost: float):
    """Crossing parameter for pixel pairs (A, B); triangles are the hit pixel's."""
    hit_is_a = mask_a
    active = torch.logical_xor(mask_a, mask_b)
    ha = hit_is_a[:, None]
    u_h, v_h, ok_h = mt_bary(torch.where(ha, o_a, o_b), torch.where(ha, d_a, d_b), v0, v1, v2)
    u_m, v_m, ok_m = mt_bary(torch.where(ha, o_b, o_a), torch.where(ha, d_b, d_a), v0, v1, v2)
    w_h = torch.stack([1.0 - u_h - v_h, u_h, v_h], dim=-1)
    w_m = torch.stack([1.0 - u_m - v_m, u_m, v_m], dim=-1)
    k = torch.argmin(w_m, dim=-1, keepdim=True).detach()
    wh_k = torch.gather(w_h, 1, k)[:, 0]
    wm_k = torch.gather(w_m, 1, k)[:, 0]
    denom = wh_k - wm_k
    dd = denom.detach()
    good = active & ok_h & ok_m & (dd > 1e-9) & (wh_k.detach() >= 0) & (wm_k.detach() <= 0)
    s = torch.clamp(wh_k / torch.where(dd > 1e-9, denom, 1.0), 0.0, 1.0)
    if boost != 1.0:
        s = s.detach() + boost * (s - s.detach())
    return s, good, hit_is_a


def antialias(buffers: Dict[str, torch.Tensor], mask: torch.Tensor,
              tri_verts: Tuple[torch.Tensor, torch.Tensor, torch.Tensor],
              rays_o: torch.Tensor, rays_d: torch.Tensor, H: int, W: int,
              boost: float = 1.0) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Returns (antialiased buffers {name: [HW, C]}, soft mask [HW] in [0,1])."""
    m2 = mask.reshape(H, W)
    o2, d2 = rays_o.reshape(H, W, -1), rays_d.reshape(H, W, -1)
    tv = [v.reshape(H, W, -1) for v in tri_verts]
    out = {n: b.reshape(H, W, -1) for n, b in buffers.items()}
    mask_f = mask.to(torch.float32).reshape(H, W, 1)

    for axis in (1, 0):  # horizontal pairs then vertical pairs
        if axis == 1:
            sl_a, sl_b = (slice(None), slice(0, W - 1)), (slice(None), slice(1, W))
        else:
            sl_a, sl_b = (slice(0, H - 1), slice(None)), (slice(1, H), slice(None))
        ma, mb = m2[sl_a].reshape(-1), m2[sl_b].reshape(-1)

        def pick(x2):
            return x2[sl_a].reshape(-1, x2.shape[-1]), x2[sl_b].reshape(-1, x2.shape[-1])

        oa, ob = pick(o2)
        da, db = pick(d2)
        tv_hit = [torch.where(ma[:, None], a, b) for a, b in (pick(t) for t in tv)]
        s, good, hit_a = _crossing(oa, da, ob, db, *tv_hit, ma, mb, boost)
        blend_a, blend_b = _pair_blend(s, good, hit_a)
        shape_pairs = m2[sl_a].shape

        def apply(x2):
            # accumulate both pairs' deltas: interior pixels belong to two pairs
            a, b = pick(x2)
            da_ = (blend_a[:, None] * (b - a)).reshape(shape_pairs + (x2.shape[-1],))
            db_ = (blend_b[:, None] * (a - b)).reshape(shape_pairs + (x2.shape[-1],))
            x2 = x2.clone()
            x2[sl_a] += da_
            x2[sl_b] += db_
            return x2

        out = {n: apply(x) for n, x in out.items()}
        mask_f = apply(mask_f)

    flat = {n: b.reshape(mask.shape[0], -1) for n, b in out.items()}
    return flat, torch.clamp(mask_f.reshape(-1), 0.0, 1.0)
