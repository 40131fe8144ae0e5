"""Trainable environment light: lat-long texture + importance sampling
(counterpart of mirres_restir_nerf_mesh_tpu/models/envlight.py).

Ported: ``eval_le``, the quantile-table sampler ``build_sampler`` (M
entries, rebuilt every frame since the env is trainable) and the
``EnvSampler`` branch of ``sample_li`` / ``pdf_li``.  The exact 2-level CDF
and alias-table variants come later.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from ..utils.math import luminance


def ngp_dir(d: torch.Tensor) -> torch.Tensor:
    """World-axis remap (x, y, z) -> (-x, z, y) before the lat-long lookup."""
    return torch.stack([-d[..., 0], d[..., 2], d[..., 1]], dim=-1)


def dir_to_uv(d: torch.Tensor) -> torch.Tensor:
    """Remapped dir -> (u, v); v = 1 at the +y pole."""
    d = torch.clamp(d, -1.0, 1.0)
    theta = torch.arccos(torch.clamp(d[..., 1], -1.0, 1.0))
    phi = torch.atan2(d[..., 2], d[..., 0])
    phi = torch.where(phi < 0, phi + 2 * math.pi, phi)
    return torch.stack([phi / (2 * math.pi), 1.0 - theta / math.pi], dim=-1)


def uv_to_dir(uv: torch.Tensor) -> torch.Tensor:
    """(u, v) -> remapped dir."""
    phi = uv[..., 0] * 2 * math.pi
    theta = (1.0 - uv[..., 1]) * math.pi
    st, ct = torch.sin(theta), torch.cos(theta)
    return torch.stack([st * torch.cos(phi), ct, st * torch.sin(phi)], dim=-1)


def _bilinear(tex: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Bilinear lookup, u wraps, v clamps; texel centers at (x + 0.5) / W,
    row 0 at v = 1.  At the top edge (y0 < 0) both rows clamp to row 0."""
    H, W, C = tex.shape
    flat = tex.reshape(H * W, C)
    x = uv[..., 0] * W - 0.5
    y = (1.0 - uv[..., 1]) * H - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = torch.where(y0 < 0, 0.0, y - y0)[..., None]
    xi = x0.to(torch.int64) % W
    xi1 = (xi + 1) % W
    yi = torch.clamp(y0.to(torch.int64), 0, H - 1)
    yi1 = torch.clamp_max(yi + 1, H - 1)
    c00, c10 = flat[yi * W + xi], flat[yi * W + xi1]
    c01, c11 = flat[yi1 * W + xi], flat[yi1 * W + xi1]
    return (c00 * (1 - fx) + c10 * fx) * (1 - fy) + (c01 * (1 - fx) + c11 * fx) * fy


def eval_le(tex: torch.Tensor, dir_world: torch.Tensor) -> torch.Tensor:
    """Environment radiance for world directions [..., 3]."""
    d = ngp_dir(dir_world)
    sin_theta = torch.sqrt(torch.clamp_min(1.0 - d[..., 1] ** 2, 0.0))
    le = _bilinear(tex, dir_to_uv(d))
    return torch.where(sin_theta[..., None] < 1e-4, 0.0, le)


class EnvSampler(NamedTuple):
    """O(1) importance sampler: table[k] = texel at CDF quantile (k+0.5)/M;
    pdf = count_in_table / M per texel over the texel solid angle (0 where
    a texel got no entry), the sampler's actual density."""

    table: torch.Tensor   # [M] int64 texel at each quantile
    pdf: torch.Tensor     # [H, W] solid-angle pdf


def build_sampler(tex: torch.Tensor, m: int = 65536) -> EnvSampler:
    H, W = tex.shape[0], tex.shape[1]
    dev = tex.device
    v = (torch.arange(H, dtype=torch.float32, device=dev) + 0.5) / H
    sin_t = torch.sin(math.pi * v).flip(0)
    weight = (luminance(tex) * sin_t[:, None] + 1e-10).reshape(-1)
    p = weight / torch.sum(weight)
    cdf = torch.cumsum(p, dim=0)
    qs = (torch.arange(m, dtype=torch.float32, device=dev) + 0.5) / m
    table = torch.clamp(torch.searchsorted(cdf, qs, right=True), 0, H * W - 1)
    cnt = torch.bincount(table, minlength=H * W).to(torch.float32)
    omega = (2 * math.pi / W) * (math.pi / H) * sin_t[:, None]
    pdf = (cnt.reshape(H, W) / m) / torch.clamp_min(omega, 1e-12)
    return EnvSampler(table=table, pdf=pdf)


def sample_li(tex: torch.Tensor, dist: EnvSampler, rnd: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Importance-sample the environment; rnd [..., 2] in [0, 1) ->
    (dir_world [..., 3], Le [..., 3], pdf_solid_angle [...])."""
    if not isinstance(dist, EnvSampler):
        raise TypeError("only the EnvSampler branch of sample_li is ported")
    H, W = tex.shape[0], tex.shape[1]
    m = dist.table.shape[0]
    u1, u2 = rnd[..., 0], rnd[..., 1]
    k = torch.clamp((u1 * m).to(torch.int32), 0, m - 1)
    frac = u1 * m - k
    texel = dist.table[k.long()]
    row = texel // W
    col = texel % W
    u = (col.to(torch.float32) + u2) / W
    v_tex = (row.to(torch.float32) + torch.clamp(frac, 0.0, 1.0 - 1e-6)) / H
    uv = torch.stack([u, 1.0 - v_tex], dim=-1)
    d_remap = uv_to_dir(uv)
    dir_world = torch.stack([-d_remap[..., 0], d_remap[..., 2], d_remap[..., 1]], dim=-1)
    return dir_world, _bilinear(tex, uv), dist.pdf[row, col]


def pdf_li(dist: EnvSampler, dir_world: torch.Tensor) -> torch.Tensor:
    """Solid-angle pdf of the sampler at world directions."""
    if not isinstance(dist, EnvSampler):
        raise TypeError("only the EnvSampler branch of pdf_li is ported")
    H, W = dist.pdf.shape
    uv = dir_to_uv(ngp_dir(dir_world))
    col = torch.clamp((uv[..., 0] * W).to(torch.int32), 0, W - 1).long()
    row = torch.clamp(((1.0 - uv[..., 1]) * H).to(torch.int32), 0, H - 1).long()
    return dist.pdf[row, col]
