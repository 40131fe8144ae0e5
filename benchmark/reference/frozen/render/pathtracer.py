"""Wavefront path tracer over pixel batches (counterpart of
mirres_restir_nerf_mesh_tpu/render/pathtracer.py).

Gradient topology as the reference: direct shading is differentiable, the
indirect bounces are detached.  Random numbers come in pre-drawn, row per
lane, so a compacted call equals the full-width call on live lanes:

  direct u    [N, 8]          env (2), brdf sel (1), brdf d (2), brdf s (2), pick (1)
  indirect u  [N, 5 + 10*B]   spawn brdf sel, d, s (5); then per bounce
                              NEE env (2), material corner (3), brdf sel, d, s (5)
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..models import envlight
from ..ops.tracer import Tracer
from ..utils.math import safe_normalize
from . import brdf

DIRECT_U = 8
SPAWN_U = 5
BOUNCE_U = 10


def indirect_u_width(bounces: int) -> int:
    return SPAWN_U + BOUNCE_U * bounces


def _brdf_u(u: torch.Tensor):
    """(u_sel, u_d, u_s) from a [N,5] block."""
    return u[:, 0], u[:, 1:3], u[:, 3:5]


class LightSample(NamedTuple):
    """A resolved direct-light sample per pixel."""

    dir: torch.Tensor       # [N,3] world dir toward light
    distance: torch.Tensor  # [N] (>0 valid; envmap = large)
    Li: torch.Tensor        # [N,3] radiance * inv_pdf * visibility


def shade_direct(light: LightSample, mask, normal, view_dir, kd, roughness, metallic, env_bg):
    """Differentiable final shading -> (color, diff_light, spec_light)."""
    w_view = brdf.to_local(-view_dir, normal)
    w_light = brdf.to_local(light.dir, normal)
    alpha = brdf.alpha_from_roughness(roughness)
    spec_alb = brdf.spec_albedo_from(kd, metallic)
    p_diff, p_spec = brdf.lobe_probabilities(kd, metallic, torch.sum(-view_dir * normal, dim=-1))

    has_light = light.distance > 0
    dval = brdf.diffuse_light(w_view, w_light)[..., None] * light.Li
    dval = torch.where((has_light & (p_diff > 0))[:, None], dval, 0.0)
    sval = brdf.specular_eval(w_view, w_light, spec_alb, alpha) * light.Li
    sval = torch.where((has_light & (p_spec > 0))[:, None], sval, 0.0)

    color = kd * (1.0 - metallic[:, None]) * dval + sval
    color = torch.where(mask[:, None], color, env_bg)
    dval = torch.where(mask[:, None], dval, 0.0)
    sval = torch.where(mask[:, None], sval, 0.0)
    return color, dval, sval


def sample_direct_mis(position, normal, view_dir, mask, kd, roughness, metallic,
                      env_tex, env_dist, tracer: Tracer, u: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None) -> LightSample:
    """One-sample NEE + BRDF MIS direct-light sample per pixel; u [N, 8]
    (see the module docstring) or drawn from ``generator``."""
    N = position.shape[0]
    if u is None:
        u = torch.rand((N, DIRECT_U), generator=generator, device=position.device)
    rnd_env, brdf_u, u_pick = u[:, 0:2], _brdf_u(u[:, 2:7]), u[:, 7]

    alpha = brdf.alpha_from_roughness(roughness)
    w_view = brdf.to_local(-view_dir, normal)
    p_diff, p_spec = brdf.lobe_probabilities(kd, metallic, torch.sum(-view_dir * normal, dim=-1))

    # strategy A: envmap importance sample
    ldir, le, lpdf = envlight.sample_li(env_tex, env_dist, rnd_env)
    w_l = brdf.to_local(ldir, normal)
    bpdf_at_l = brdf.brdf_pdf(w_view, w_l, alpha, p_diff, p_spec)
    mis_l = lpdf / torch.clamp_min(lpdf + bpdf_at_l, 1e-12)
    ok_env = (lpdf > 1e-12) & (w_l[:, 2] > 1e-6)
    vis_l = ~tracer.occluded(position + normal * 1e-4, ldir,
                             torch.where(ok_env & mask, 1e9, 0.0), incoherent=True)
    Li_env = le * (mis_l * vis_l / torch.clamp_min(lpdf, 1e-12))[:, None]

    # strategy B: BRDF sample toward the env
    s = brdf.brdf_sample(w_view, kd, metallic, alpha, u=brdf_u)
    bdir = brdf.to_global(s.w_light_l, normal)
    lpdf_at_b = envlight.pdf_li(env_dist, bdir)
    mis_b = s.pdf / torch.clamp_min(s.pdf + lpdf_at_b, 1e-12)
    ok_brdf = s.valid
    vis_b = ~tracer.occluded(position + normal * 1e-4, bdir,
                             torch.where(ok_brdf & mask, 1e9, 0.0), incoherent=True)
    Li_brdf = envlight.eval_le(env_tex, bdir) * (mis_b * vis_b / torch.clamp_min(s.pdf, 1e-12))[:, None]

    # one of the two, with probability 1/2 each, doubled
    pick_env = u_pick < 0.5
    dirs = torch.where(pick_env[:, None], ldir, bdir)
    Li = torch.where(pick_env[:, None], Li_env, Li_brdf) * 2.0
    ok = torch.where(pick_env, ok_env, ok_brdf) & mask
    return LightSample(dir=dirs, distance=torch.where(ok, 1e9, 0.0),
                       Li=torch.where(ok[:, None], Li, 0.0))


class BounceState(NamedTuple):
    origin: torch.Tensor       # [N,3]
    direction: torch.Tensor    # [N,3]
    throughput: torch.Tensor   # [N,3]
    alive: torch.Tensor        # [N] bool
    specular: torch.Tensor     # [N] bool (last bounce was sharp specular)


def spawn_bounce(gb_mask, position, normal, view_dir, kd, roughness, metallic,
                 u: torch.Tensor) -> BounceState:
    """Continuation ray at the primary hit; u [N,5] brdf uniforms. No grad."""
    normal, position = normal.detach(), position.detach()
    kd, roughness, metallic = kd.detach(), roughness.detach(), metallic.detach()
    w_view = brdf.to_local(-view_dir, normal)
    s = brdf.brdf_sample(w_view, kd, metallic, brdf.alpha_from_roughness(roughness), u=_brdf_u(u))
    alive = gb_mask & s.valid
    return BounceState(origin=position + normal * 1e-4, direction=brdf.to_global(s.w_light_l, normal),
                       throughput=torch.where(alive[:, None], s.weight, 0.0), alive=alive,
                       specular=s.specular_bounce)


def face_corners(verts: torch.Tensor, tris: torch.Tensor) -> torch.Tensor:
    """[F, 9] per-face corner table (v0, v1, v2)."""
    t = tris.long()
    return torch.cat([verts[t[:, 0]], verts[t[:, 1]], verts[t[:, 2]]], dim=1)


def trace_bounce(state: BounceState, tracer: Tracer, vface_tab: torch.Tensor, material_fn,
                 env_tex, env_dist, u: torch.Tensor, extra_occ=None):
    """One indirect bounce: trace, NEE at the hit with MIS, escape adds env Le.
    vface_tab: face_corners(verts, tris); u [N, 10] (see the module
    docstring).  Returns (escape contribution, NEE contribution, next state,
    hit positions).  extra_occ: optional (origins, dirs, t_max) occlusion
    rays traced in the same launch as the NEE shadow rays, ahead of them;
    their visibility is then a fifth output."""
    hit = tracer.intersect(state.origin, state.direction,
                           t_max=torch.where(state.alive, 1e10, 0.0), incoherent=True)
    hit_mask = (hit.prim >= 0) & state.alive
    escape = state.alive & (hit.prim < 0)
    le_escape = envlight.eval_le(env_tex, state.direction)
    escape_contrib = torch.where(escape[:, None], state.throughput * le_escape, 0.0)

    vface = vface_tab[torch.where(hit_mask, hit.prim, 0)]
    w = torch.stack([1.0 - hit.u - hit.v, hit.u, hit.v], dim=-1)
    pos = w[:, 0:1] * vface[:, 0:3] + w[:, 1:2] * vface[:, 3:6] + w[:, 2:3] * vface[:, 6:9]
    nrm = safe_normalize(hit.normal)
    nrm = torch.where(torch.sum(nrm * state.direction, dim=-1, keepdim=True) > 0, -nrm, nrm)
    pos, nrm = pos.detach(), nrm.detach()

    # material re-query at the hit: one-corner stochastic hash lookup
    mat = material_fn(pos, u[:, 2:5]).detach()
    kd, rough, metal = mat[:, 0:3], mat[:, 4], mat[:, 5]
    alpha = brdf.alpha_from_roughness(rough)
    w_view = brdf.to_local(-state.direction, nrm)
    p_diff, p_spec = brdf.lobe_probabilities(kd, metal, torch.sum(-state.direction * nrm, dim=-1))

    # NEE at the bounce hit (env sample + shadow ray + MIS)
    ldir, le, lpdf = envlight.sample_li(env_tex, env_dist, u[:, 0:2])
    w_l = brdf.to_local(ldir, nrm)
    f = brdf.brdf_eval(w_view, w_l, kd, metal, alpha, p_diff, p_spec)
    bpdf = brdf.brdf_pdf(w_view, w_l, alpha, p_diff, p_spec)
    mis = lpdf / torch.clamp_min(lpdf + bpdf, 1e-12)
    nee_ok = hit_mask & (lpdf > 1e-12) & (w_l[:, 2] > 1e-6)
    nee_o, nee_tm = pos + nrm * 1e-4, torch.where(nee_ok, 1e9, 0.0)
    extra_vis = None
    if extra_occ is not None:
        eo, ed, etm = extra_occ
        ne = eo.shape[0]
        occ = tracer.occluded(torch.cat([eo, nee_o]), torch.cat([ed, ldir]),
                              torch.cat([etm, nee_tm]), incoherent=True)
        extra_vis, vis = ~occ[:ne], ~occ[ne:]
    else:
        vis = ~tracer.occluded(nee_o, ldir, nee_tm, incoherent=True)
    nee = state.throughput * f * le * (mis * vis / torch.clamp_min(lpdf, 1e-12))[:, None]
    nee_contrib = torch.where(nee_ok[:, None], nee, 0.0)

    # continuation
    s = brdf.brdf_sample(w_view, kd, metal, alpha, u=_brdf_u(u[:, 5:10]))
    ndir = brdf.to_global(s.w_light_l, nrm)
    lpdf_next = envlight.pdf_li(env_dist, ndir)
    mis_next = torch.where(s.specular_bounce, 1.0, s.pdf / torch.clamp_min(s.pdf + lpdf_next, 1e-12))
    alive = hit_mask & s.valid
    next_state = BounceState(
        origin=pos + nrm * 1e-4, direction=ndir,
        throughput=torch.where(alive[:, None], state.throughput * s.weight * mis_next[:, None], 0.0),
        alive=alive, specular=s.specular_bounce,
    )
    if extra_occ is not None:
        return escape_contrib.detach(), nee_contrib.detach(), next_state, pos, extra_vis
    return escape_contrib.detach(), nee_contrib.detach(), next_state, pos


def render_indirect(gb_mask, position, normal, view_dir, kd, roughness, metallic,
                    tracer: Tracer, verts, tris, material_fn, env_tex, env_dist,
                    bounces: int = 2, u: Optional[torch.Tensor] = None,
                    generator: Optional[torch.Generator] = None, extra_occ=None):
    """Total indirect radiance at the primary hits, no gradients;
    u [N, 5 + 10*bounces] or drawn from ``generator``.  extra_occ: optional
    (origins, dirs, t_max) occlusion batch fused into the first bounce's
    NEE launch; then returns (total, extra_occluded) instead of total."""
    N = position.shape[0]
    if u is None:
        u = torch.rand((N, indirect_u_width(bounces)), generator=generator, device=position.device)
    with torch.no_grad():
        state = spawn_bounce(gb_mask, position, normal, view_dir, kd, roughness, metallic,
                             u[:, 0:SPAWN_U])
        total = torch.zeros_like(position)
        env_tex = env_tex.detach()
        vface_tab = face_corners(verts.detach(), tris)
        extra_occluded = None
        if extra_occ is not None and bounces == 0:
            extra_occluded = tracer.occluded(*extra_occ, incoherent=True)
        for b in range(bounces):
            c0 = SPAWN_U + BOUNCE_U * b
            out = trace_bounce(state, tracer, vface_tab, material_fn, env_tex, env_dist,
                               u[:, c0:c0 + BOUNCE_U], extra_occ=extra_occ if b == 0 else None)
            escape_c, nee_c, state = out[0], out[1], out[2]
            if b == 0 and extra_occ is not None:
                extra_occluded = ~out[4]
            # segment-0 escapes are direct light, covered by the direct estimator
            if b > 0:
                total = total + escape_c
            total = total + nee_c
    if extra_occ is not None:
        return total, extra_occluded
    return total
