"""Falcor-style GGX BRDF (counterpart of mirres_restir_nerf_mesh_tpu/render/brdf.py).

All functions work in the local shading frame (z = normal).  Sampling takes
pre-drawn uniforms ``u = (u_sel [N], u_d [N,2], u_s [N,2])`` or draws them
from a ``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from ..utils.math import luminance, onb_frame

F0 = 0.04
K_MIN_GGX_ALPHA = 0.01 ** 2
INV_PI = 1.0 / math.pi


def _norm(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))


def to_local(w: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    t, b, nn = onb_frame(n)
    return torch.stack([torch.sum(w * t, -1), torch.sum(w * b, -1), torch.sum(w * nn, -1)], dim=-1)


def to_global(w: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    t, b, nn = onb_frame(n)
    return w[..., 0:1] * t + w[..., 1:2] * b + w[..., 2:3] * nn


def fresnel_schlick(f0, f90, cos_theta):
    return f0 + (f90 - f0) * torch.clamp_min(1.0 - cos_theta, 0.0) ** 5


def ndf_ggx(alpha, cos_theta):
    a2 = alpha * alpha
    d = (cos_theta * a2 - cos_theta) * cos_theta + 1.0
    return a2 / torch.clamp_min(d * d * math.pi, 1e-12)


def _lambda_ggx(alpha_sqr, cos_theta):
    c2 = torch.clamp(cos_theta, 1e-6, 1.0) ** 2
    tan2 = torch.clamp_min(1.0 - c2, 0.0) / c2
    lam = 0.5 * (-1.0 + torch.sqrt(1.0 + alpha_sqr * tan2))
    return torch.where(cos_theta <= 0, 0.0, lam)


def smith_ggx_correlated(alpha, cos_i, cos_o):
    a2 = alpha * alpha
    return 1.0 / torch.clamp_min(1.0 + _lambda_ggx(a2, cos_i) + _lambda_ggx(a2, cos_o), 1e-12)


def alpha_from_roughness(linear_roughness):
    a = linear_roughness * linear_roughness
    return torch.where(a < K_MIN_GGX_ALPHA, 0.0, a)


def spec_albedo_from(kd: torch.Tensor, metallic: torch.Tensor) -> torch.Tensor:
    return F0 * (1.0 - metallic[..., None]) + kd * metallic[..., None]


def diffuse_light(w_view_l, w_light_l):
    """NdotL/pi, zero below the horizon."""
    ok = torch.minimum(w_view_l[..., 2], w_light_l[..., 2]) >= 1e-6
    return torch.where(ok, torch.clamp_min(INV_PI * w_light_l[..., 2], 0.0), 0.0)


def specular_eval(w_view_l, w_light_l, spec_albedo, alpha):
    """F*D*G/(4*NdotV)."""
    ok = torch.minimum(w_view_l[..., 2], w_light_l[..., 2]) >= 1e-6
    h = w_view_l + w_light_l
    h = h / torch.clamp_min(_norm(h), 1e-12)
    vdoth = torch.sum(w_view_l * h, dim=-1)
    D = ndf_ggx(alpha, h[..., 2])
    G = smith_ggx_correlated(alpha, w_view_l[..., 2], w_light_l[..., 2])
    Fr = fresnel_schlick(spec_albedo, 1.0, vdoth[..., None])
    val = Fr * (D * G * 0.25 / torch.clamp_min(w_view_l[..., 2], 1e-6))[..., None]
    val = torch.where((alpha > 0)[..., None], val, 0.0)
    return torch.where(ok[..., None], val, 0.0)


def lobe_probabilities(kd, metallic, n_dot_v) -> Tuple[torch.Tensor, torch.Tensor]:
    """Normalized (pDiffuse, pSpecular)."""
    spec = spec_albedo_from(kd, metallic)
    dielectric = 1.0 - metallic
    p_diff = luminance(kd) * dielectric
    p_spec = luminance(fresnel_schlick(spec, 1.0, n_dot_v[..., None])) * (metallic + dielectric)
    norm = p_diff + p_spec
    inv = torch.where(norm > 0, 1.0 / torch.clamp_min(norm, 1e-12), 0.0)
    return p_diff * inv, p_spec * inv


def diffuse_pdf(w_light_l):
    return torch.clamp_min(w_light_l[..., 2], 0.0) * INV_PI


def specular_pdf(w_view_l, w_light_l, alpha):
    ok = torch.minimum(w_view_l[..., 2], w_light_l[..., 2]) >= 1e-6
    h = w_view_l + w_light_l
    h = h / torch.clamp_min(_norm(h), 1e-12)
    vdoth = torch.sum(w_view_l * h, dim=-1)
    pdf = ndf_ggx(alpha, h[..., 2]) * h[..., 2] / torch.clamp_min(4.0 * vdoth, 1e-12)
    return torch.where(ok & (alpha > 0) & (vdoth > 0), pdf, 0.0)


def brdf_eval(w_view_l, w_light_l, kd, metallic, alpha, p_diff, p_spec):
    """Full BRDF value with the reference's cosine folding."""
    spec = spec_albedo_from(kd, metallic)
    diff = (kd * (1.0 - metallic[..., None])) * diffuse_light(w_view_l, w_light_l)[..., None]
    diff = torch.where((p_diff > 0)[..., None], diff, 0.0)
    specv = specular_eval(w_view_l, w_light_l, spec, alpha)
    specv = torch.where((p_spec > 0)[..., None], specv, 0.0)
    return diff + specv


def brdf_pdf(w_view_l, w_light_l, alpha, p_diff, p_spec):
    return p_diff * diffuse_pdf(w_light_l) + p_spec * specular_pdf(w_view_l, w_light_l, alpha)


def _sample_disk_concentric(u):
    u = 2.0 * u - 1.0
    ux, uy = u[..., 0], u[..., 1]
    big_x = ux.abs() > uy.abs()
    r = torch.where(big_x, ux, uy)

    def safe(a, b):
        return a / torch.where(b.abs() < 1e-12, 1.0, b)

    phi = torch.where(big_x, safe(uy, ux) * (math.pi / 4),
                      math.pi / 2 - safe(ux, uy) * (math.pi / 4))
    zero = (ux == 0) & (uy == 0)
    d = r[..., None] * torch.stack([torch.cos(phi), torch.sin(phi)], dim=-1)
    return torch.where(zero[..., None], 0.0, d)


def sample_cosine_hemisphere(u):
    d = _sample_disk_concentric(u)
    z = torch.sqrt(torch.clamp_min(1.0 - torch.sum(d * d, dim=-1), 0.0))
    return torch.cat([d, z[..., None]], dim=-1), z * INV_PI


def sample_ggx_ndf(alpha, u):
    """Sample a half vector from D(h) h.z."""
    a2 = alpha * alpha
    phi = u[..., 1] * 2 * math.pi
    tan2 = a2 * u[..., 0] / torch.clamp_min(1.0 - u[..., 0], 1e-9)
    cos_t = 1.0 / torch.sqrt(1.0 + tan2)
    r = torch.sqrt(torch.clamp_min(1.0 - cos_t * cos_t, 0.0))
    h = torch.stack([torch.cos(phi) * r, torch.sin(phi) * r, cos_t], dim=-1)
    return h, ndf_ggx(alpha, cos_t) * cos_t


class BRDFSample(NamedTuple):
    w_light_l: torch.Tensor        # [N,3] sampled direction, local frame
    pdf: torch.Tensor              # [N]
    weight: torch.Tensor           # [N,3] f/pdf
    specular_bounce: torch.Tensor  # [N] bool
    valid: torch.Tensor            # [N] bool


def draw_brdf_u(n: int, generator: Optional[torch.Generator], device):
    """(u_sel [n], u_d [n,2], u_s [n,2])."""
    return (torch.rand((n,), generator=generator, device=device),
            torch.rand((n, 2), generator=generator, device=device),
            torch.rand((n, 2), generator=generator, device=device))


def brdf_sample(w_view_l, kd, metallic, alpha, u=None,
                generator: Optional[torch.Generator] = None) -> BRDFSample:
    """One-sample lobe-selected BRDF sampling; both lobes are sampled and the
    selected one is kept."""
    if u is None:
        u = draw_brdf_u(w_view_l.shape[0], generator, w_view_l.device)
    u_sel, u_d, u_s = u
    p_diff, p_spec = lobe_probabilities(kd, metallic, w_view_l[..., 2])

    wi_d, _ = sample_cosine_hemisphere(u_d)
    h, _ = sample_ggx_ndf(alpha, u_s)
    vdoth = torch.sum(w_view_l * h, dim=-1)
    wi_s = 2.0 * vdoth[..., None] * h - w_view_l

    pick_diff = u_sel < p_diff
    wi = torch.where(pick_diff[..., None], wi_d, wi_s)

    sharp_spec = ~pick_diff & (torch.sqrt(alpha) <= 0.15)
    pdf = p_diff * diffuse_pdf(wi) + p_spec * specular_pdf(w_view_l, wi, alpha)
    pdf = torch.where(sharp_spec, p_spec * specular_pdf(w_view_l, wi, alpha), pdf)

    f = brdf_eval(w_view_l, wi, kd, metallic, alpha, p_diff, p_spec)
    valid = (wi[..., 2] > 1e-6) & (w_view_l[..., 2] > 1e-6) & (pdf > 1e-12)
    weight = torch.where(valid[..., None], f / torch.clamp_min(pdf, 1e-12)[..., None], 0.0)
    return BRDFSample(w_light_l=wi, pdf=torch.where(valid, pdf, 0.0), weight=weight,
                      specular_bounce=sharp_spec, valid=valid)
