"""Trainable environment light: lat-long texture + importance sampling
(counterpart of mirres_restir_nerf_mesh_tpu/models/envlight.py).

Three samplers of luminance x sin(theta):

- ``EnvSampler`` (``build_sampler``): the O(1) M-entry quantile table the
  renderer rebuilds every frame, since the env is trainable;
- ``EnvDistribution`` (``build_distribution``): the exact 2-level CDF,
  inverted by a row search and a column search a sample;
- ``AliasTable`` (``build_alias_table``, ``sample_li_alias``): Vose's alias
  table, built on the host by the reference's sequential loop.

``sample_li`` / ``pdf_li`` take either of the first two.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple, Union

import numpy as np
import torch

from ..device import resolve_device
from ..utils.math import luminance


def init_envlight(h: int = 256, w: int = 512, bias: float = 0.5, device="cuda") -> torch.Tensor:
    return torch.full((h, w, 3), bias, dtype=torch.float32, device=resolve_device(device))


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


def eval_le_nearest(tex: torch.Tensor, dir_world: torch.Tensor) -> torch.Tensor:
    """Nearest-texel radiance, for resampling target functions only (RIS is
    unbiased for any target evaluated consistently); radiance that reaches
    the image keeps the bilinear ``eval_le``."""
    H, W = tex.shape[0], tex.shape[1]
    d = ngp_dir(dir_world)
    uv = dir_to_uv(d)
    x = torch.remainder((uv[..., 0] * W).to(torch.int32), W).long()
    y = torch.clamp(((1.0 - uv[..., 1]) * H).to(torch.int32), 0, H - 1).long()
    le = tex.reshape(H * W, -1)[y * W + x]
    sin_theta = torch.sqrt(torch.clamp_min(1.0 - d[..., 1] ** 2, 0.0))
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


def _world_from_uv(uv: torch.Tensor) -> torch.Tensor:
    """(u, v) -> world direction (the inverse of ngp_dir after uv_to_dir)."""
    d_remap = uv_to_dir(uv)
    return torch.stack([-d_remap[..., 0], d_remap[..., 2], d_remap[..., 1]], dim=-1)


class EnvDistribution(NamedTuple):
    pdf2d: torch.Tensor     # [H, W] conditional pdf over u per row (mean 1)
    row_cdf: torch.Tensor   # [H, W+1]
    mpdf: torch.Tensor      # [H] marginal pdf over v (mean 1)
    mcdf: torch.Tensor      # [H+1]


def build_distribution(tex: torch.Tensor) -> EnvDistribution:
    """The exact luminance x sin(theta) 2-D distribution: each row's
    conditional CDF over u and the marginal CDF over rows."""
    H, W = tex.shape[0], tex.shape[1]
    dev = tex.device
    v = (torch.arange(H, dtype=torch.float32, device=dev) + 0.5) / H
    sin_t = torch.sin(math.pi * v).flip(0)        # row 0 (top) has v close to 1
    weight = luminance(tex) * sin_t[:, None] + 1e-10
    row_sum = torch.sum(weight, dim=1)
    cond_pdf = weight / row_sum[:, None] * W
    row_cdf = torch.cat([torch.zeros((H, 1), device=dev),
                         torch.cumsum(weight / row_sum[:, None], dim=1)], dim=1)
    total = torch.sum(row_sum)
    mpdf = row_sum / total * H
    mcdf = torch.cat([torch.zeros((1,), device=dev), torch.cumsum(row_sum / total, dim=0)])
    return EnvDistribution(cond_pdf, row_cdf, mpdf, mcdf)


def _sample_li_exact(tex: torch.Tensor, dist: EnvDistribution, rnd: torch.Tensor):
    """CDF inversion: the row by the marginal CDF, the column by that row's
    conditional CDF (searchsorted right, minus one), the leftover mass as
    the in-texel offset."""
    H, W = tex.shape[0], tex.shape[1]
    shape = rnd.shape[:-1]
    u1, u2 = rnd[..., 0].reshape(-1).contiguous(), rnd[..., 1].reshape(-1).contiguous()
    row = torch.clamp(torch.searchsorted(dist.mcdf, u2, right=True) - 1, 0, H - 1)
    fv = torch.clamp((u2 - dist.mcdf[row]) / torch.clamp_min(dist.mpdf[row] / H, 1e-12), 0.0, 1.0)
    cdf_rows = dist.row_cdf[row].contiguous()
    col = torch.clamp(torch.searchsorted(cdf_rows, u1[:, None].contiguous(), right=True)[:, 0] - 1,
                      0, W - 1)
    cel_lo = torch.gather(cdf_rows, 1, col[:, None])[:, 0]
    pdf_rc = dist.pdf2d[row, col]
    fu = torch.clamp((u1 - cel_lo) / torch.clamp_min(pdf_rc / W, 1e-12), 0.0, 1.0)
    uv = torch.stack([(col + fu) / W, 1.0 - (row + fv) / H], dim=-1)
    sin_theta = torch.clamp_min(torch.sin((1.0 - uv[..., 1]) * math.pi), 1e-6)
    pdf = pdf_rc * dist.mpdf[row] / (2.0 * math.pi * math.pi * sin_theta)
    return (_world_from_uv(uv).reshape(*shape, 3), _bilinear(tex, uv).reshape(*shape, -1),
            pdf.reshape(shape))


def sample_li(tex: torch.Tensor, dist: Union[EnvSampler, EnvDistribution], rnd: torch.Tensor,
              nearest_le: bool = False) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Importance-sample the environment; rnd [..., 2] in [0, 1) ->
    (dir_world [..., 3], Le [..., 3], pdf_solid_angle [...]).  dist: an
    ``EnvSampler`` (O(1) table draw) or an ``EnvDistribution`` (exact CDF
    inversion).

    nearest_le (``EnvSampler`` only): Le is the sampled texel's own value,
    zeroed in the pole cone as ``eval_le_nearest`` zeroes it (the light
    tiles' convention: their Le only enters resampling targets); else the
    bilinear lookup."""
    if isinstance(dist, EnvDistribution):
        if nearest_le:
            raise ValueError("nearest_le needs an EnvSampler")
        return _sample_li_exact(tex, dist, rnd)
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
    if nearest_le:
        le = tex.reshape(H * W, -1)[texel]
        sin_theta = torch.sqrt(torch.clamp_min(1.0 - d_remap[..., 1] ** 2, 0.0))
        le = torch.where(sin_theta[..., None] < 1e-4, 0.0, le)
    else:
        le = _bilinear(tex, uv)
    return dir_world, le, dist.pdf[row, col]


def pdf_li(dist: Union[EnvSampler, EnvDistribution], dir_world: torch.Tensor) -> torch.Tensor:
    """Solid-angle pdf of the sampler at world directions."""
    exact = isinstance(dist, EnvDistribution)
    H, W = dist.pdf2d.shape if exact else dist.pdf.shape
    uv = dir_to_uv(ngp_dir(dir_world))
    col = torch.clamp((uv[..., 0] * W).to(torch.int32), 0, W - 1).long()
    row = torch.clamp(((1.0 - uv[..., 1]) * H).to(torch.int32), 0, H - 1).long()
    if not exact:
        return dist.pdf[row, col]
    sin_theta = torch.sin((1.0 - uv[..., 1]) * math.pi)
    pdf = dist.pdf2d[row, col] * dist.mpdf[row] / (
        2.0 * math.pi * math.pi * torch.clamp_min(sin_theta, 1e-6))
    return torch.where(sin_theta.abs() < 1e-4, 0.0, pdf)


class AliasTable(NamedTuple):
    """Vose alias table over the envmap texels (the O(1) variant of the 2-D
    CDF)."""

    q: torch.Tensor       # [H*W] acceptance probability a slot
    alias: torch.Tensor   # [H*W] int64 alias texel a slot
    pdf: torch.Tensor     # [H, W] solid-angle pdf a texel


def build_alias_table(tex: torch.Tensor) -> AliasTable:
    """Host-side O(n) Vose construction in numpy: the reference's sequential
    partition loop, in its pop order, so ``alias`` and ``q`` come out the
    same.  The table lands on the texture's device."""
    t = tex.detach().cpu().numpy().astype(np.float32)
    H, W = t.shape[0], t.shape[1]
    v = (np.arange(H, dtype=np.float32) + 0.5) / H
    sin_t = np.sin(np.pi * v)[::-1]
    lum = 0.2126 * t[..., 0] + 0.7152 * t[..., 1] + 0.0722 * t[..., 2]
    w = (lum * sin_t[:, None] + 1e-10).reshape(-1)
    p = w / w.sum()
    n = p.size
    q = p * n
    alias = np.arange(n, dtype=np.int64)
    small = [i for i in range(n) if q[i] < 1.0]
    large = [i for i in range(n) if q[i] >= 1.0]
    while small and large:
        s, l = small.pop(), large.pop()
        alias[s] = l
        q[l] = q[l] + q[s] - 1.0
        (small if q[l] < 1.0 else large).append(l)
    omega = (2 * np.pi / W) * (np.pi / H) * sin_t[:, None]
    pdf = (p.reshape(H, W) / np.maximum(omega, 1e-12)).astype(np.float32)
    dev = tex.device
    return AliasTable(q=torch.as_tensor(np.clip(q, 0.0, None).astype(np.float32), device=dev),
                      alias=torch.as_tensor(alias, device=dev),
                      pdf=torch.as_tensor(pdf, device=dev))


def sample_li_alias(tex: torch.Tensor, table: AliasTable, rnd: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """O(1) draw through the alias table, the contract of ``sample_li``; the
    leftover uniform mass of the slot becomes the in-texel v offset."""
    H, W = tex.shape[0], tex.shape[1]
    n = H * W
    u1, u2 = rnd[..., 0], rnd[..., 1]
    slot = torch.clamp((u1 * n).to(torch.int32), 0, n - 1).long()
    frac = u1 * n - slot
    q = table.q[slot]
    take_alias = frac >= q
    texel = torch.where(take_alias, table.alias[slot], slot)
    row = texel // W
    col = texel % W
    leftover = torch.where(take_alias, (frac - q) / torch.clamp_min(1.0 - q, 1e-8),
                           frac / torch.clamp_min(q, 1e-8))
    u = (col.to(torch.float32) + u2) / W
    v_tex = (row.to(torch.float32) + torch.clamp(leftover, 0.0, 1.0 - 1e-6)) / H
    uv = torch.stack([u, 1.0 - v_tex], dim=-1)
    return _world_from_uv(uv), _bilinear(tex, uv), table.pdf[row, col]
