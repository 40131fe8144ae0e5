"""The "dump" renderer: deterministic all-texel environment lighting
(counterpart of mirres_restir_nerf_mesh_tpu/render/dump.py, after the
upstream project's render_dump).

Every pixel sums f * Le * cos * dw * V over every envmap texel (GGX
specular, Lambert diffuse), with no sampling noise: the upstream project's
material dumps and relighting previews.  Visibility comes from a mesh
``Tracer`` (one any-hit launch a texel chunk: K1, or K3 on a small mesh),
from a soft ``visibility_fn`` such as ``nerf_visibility_fn`` (the radiance
field's transmittance along the light ray), or is 1.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from ..models import envlight
from ..models import nerf as nerf_model
from ..ops.tracer import Tracer
from . import brdf

VIS_RAY_CHUNK = 65536   # light rays a field query of nerf_visibility_fn takes (bounds its memory)


def envmap_dirs_and_weights(h: int, w: int, device="cpu") -> Tuple[torch.Tensor, torch.Tensor]:
    """World direction and solid angle of every texel of an h x w lat-long
    map, row-major -> ([h*w, 3], [h*w]) on ``device``.  Computed on the
    host, so that every device traces the same directions (the card's sin
    and cos round apart from the CPU's by an ulp, which can flip a grazing
    shadow ray)."""
    vv = (torch.arange(h, dtype=torch.float32) + 0.5) / h
    uu = (torch.arange(w, dtype=torch.float32) + 0.5) / w
    V, U = torch.meshgrid(vv, uu, indexing="ij")
    uv = torch.stack([U.reshape(-1), 1.0 - V.reshape(-1)], dim=-1)
    d_remap = envlight.uv_to_dir(uv)
    dirs = torch.stack([-d_remap[:, 0], d_remap[:, 2], d_remap[:, 1]], dim=-1)
    theta = (torch.arange(h, dtype=torch.float32) + 0.5) / h * math.pi
    solid = (2 * math.pi / w) * (math.pi / h) * torch.sin(theta)
    return dirs.to(device), torch.repeat_interleave(solid, w).to(device)


def render_dump(position: torch.Tensor, normal: torch.Tensor, view_dir: torch.Tensor,
                mask: torch.Tensor, kd: torch.Tensor, roughness: torch.Tensor,
                metallic: torch.Tensor, env_tex: torch.Tensor, tracer: Optional[Tracer] = None,
                visibility_fn=None, texel_chunk: int = 64) -> Dict[str, torch.Tensor]:
    """Full-envmap direct lighting of P shading points ([P, 3] position,
    normal, view_dir; [P] mask, roughness, metallic; [P, 3] kd) under
    env_tex [He, We, 3] -> image_brdf, diffuse_light, specular_light [P, 3]
    (the env's radiance along view_dir where the mask is off)."""
    P = position.shape[0]
    He, We = env_tex.shape[0], env_tex.shape[1]
    dirs, dw = envmap_dirs_and_weights(He, We, position.device)
    le_all = env_tex.reshape(-1, 3)
    T = dirs.shape[0]

    alpha = brdf.alpha_from_roughness(roughness)
    w_view = brdf.to_local(-view_dir, normal)
    spec_albedo = brdf.spec_albedo_from(kd, metallic)
    diffuse = torch.zeros((P, 3), device=position.device)
    specular = torch.zeros((P, 3), device=position.device)
    org_p = position + normal * 1e-4

    for s in range(0, T, texel_chunk):
        e = min(s + texel_chunk, T)
        n_t = e - s
        le = le_all[s:e] * dw[s:e, None]                              # Le * dw [n, 3]
        dd = dirs[s:e][None].expand(P, n_t, 3).reshape(-1, 3)
        org = torch.repeat_interleave(org_p, n_t, dim=0)
        if tracer is not None:
            vis = (~tracer.occluded(org, dd, 1e9)).to(torch.float32)
        elif visibility_fn is not None:
            vis = visibility_fn(org, dd)
        else:
            vis = torch.ones((P * n_t,), device=position.device)
        vis = vis.reshape(P, n_t)

        w_l = brdf.to_local(dd.reshape(P, n_t, 3), normal[:, None].expand(P, n_t, 3))
        wv = w_view[:, None].expand(P, n_t, 3)
        dterm = brdf.diffuse_light(wv, w_l)                           # [P, n]
        sterm = brdf.specular_eval(wv, w_l, spec_albedo[:, None].expand(P, n_t, 3),
                                   alpha[:, None].expand(P, n_t))     # [P, n, 3]
        diffuse = diffuse + torch.einsum("pn,nc->pc", dterm * vis, le)
        specular = specular + torch.einsum("pnc,pn,nc->pc", sterm, vis, le)

    color = kd * (1.0 - metallic[:, None]) * diffuse + specular
    bg = envlight.eval_le(env_tex, view_dir)
    m = mask[:, None]
    return {
        "image_brdf": torch.where(m, color, bg),
        "diffuse_light": torch.where(m, diffuse, 0.0),
        "specular_light": torch.where(m, specular, 0.0),
    }


def nerf_visibility_fn(params, spec: nerf_model.NeRFSpec, n_steps: int = 64, t_max: float = 2.0,
                       sigma_scale: float = 1.0):
    """Soft visibility from the radiance field's density: V = exp(-sum sigma
    dt) over n_steps midpoints of [0, t_max] along the light ray, points
    clipped to the bound; VIS_RAY_CHUNK rays a density call (each ray's
    value does not depend on it)."""
    dt = t_max / n_steps

    def fn(origins: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
        ts = (torch.arange(n_steps, dtype=torch.float32, device=origins.device) + 0.5) * dt
        out = []
        for r0 in range(0, origins.shape[0], VIS_RAY_CHUNK):
            o, d = origins[r0:r0 + VIS_RAY_CHUNK], dirs[r0:r0 + VIS_RAY_CHUNK]
            pts = torch.clamp(o[:, None, :] + d[:, None, :] * ts[None, :, None],
                              -spec.bound, spec.bound)
            sig = nerf_model.density(params, pts.reshape(-1, 3), spec)["sigma"]
            tau = torch.sum(sig.reshape(o.shape[0], n_steps).float(), dim=1) * dt * sigma_scale
            out.append(torch.exp(-tau))
        return torch.cat(out) if out else origins.new_zeros((0,))

    return fn
