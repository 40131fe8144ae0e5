"""Occupancy-accelerated ray marching and volume compositing (counterpart of
mirres_restir_nerf_mesh_tpu/ops/marching.py).

Same static-shape design as the reference:

1. a lattice of S candidate t values per ray (dt = clamp(t * dt_gamma,
   dt_min, dt_max), dt_min = 2 sqrt(3) / max_steps, dt_max = 2 sqrt(3)
   bound / H), shifted by one uniform per ray when perturbed;
2. the occupancy byte of every candidate (per-cascade mip selection);
3. the occupied candidates compacted into [N, K] samples with a per-ray
   stride, so a ray crossing more than K occupied cells is subsampled
   uniformly (dt scaled by the stride);
4. compositing with an exclusive cumulative product of transmittance.

The reference picks the <= K selected candidates with a one-hot matmul on
the MXU and reads single-cascade occupancy through supercell bitmask rows;
both are exact and both are TPU devices.  Here the selected candidates are
scattered to (ray, rank among the selected), targets that are unique, and
the occupancy byte is a plain gather: the same values.

The transmittance (``ExclusiveTransmittance``) runs forward as
``torch.cumprod`` of the shifted ``1 - alpha``; its backward is
``cumprod_backward``, torch's own formula for cumprod's gradient in the same
operations (so the same bits) but without the host test for zeros that
torch's makes to choose between its two forms.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

SQRT3 = math.sqrt(3.0)


def near_far_from_aabb(rays_o: torch.Tensor, rays_d: torch.Tensor, aabb: torch.Tensor,
                       min_near: float = 0.05) -> Tuple[torch.Tensor, torch.Tensor]:
    """Slab test against aabb [6] = (min xyz, max xyz) -> nears, fars [N];
    rays that miss get near = far = 1e10."""
    inv_d = 1.0 / torch.where(torch.abs(rays_d) < 1e-15, 1e-15, rays_d)
    t0 = (aabb[None, 0:3] - rays_o) * inv_d
    t1 = (aabb[None, 3:6] - rays_o) * inv_d
    tmin = torch.minimum(t0, t1).amax(dim=-1)
    tmax = torch.maximum(t0, t1).amin(dim=-1)
    near = torch.clamp_min(tmin, min_near)
    far = torch.maximum(tmax, near + 1e-6)
    miss = (tmax < tmin) | (tmax < min_near)
    return torch.where(miss, 1e10, near), torch.where(miss, 1e10, far)


class MarchResult(NamedTuple):
    xyzs: torch.Tensor   # [N, K, 3] sample positions (clamped to bound)
    dirs: torch.Tensor   # [N, 3]   ray dirs as given
    ts: torch.Tensor     # [N, K]   sample t (0 where not valid)
    dts: torch.Tensor    # [N, K]   step size times the stride (0 where not valid)
    valid: torch.Tensor  # [N, K]   bool


def _candidate_ts(nears: torch.Tensor, S: int, dt_min: float, dt_max: float, dt_gamma: float,
                  noise: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Candidate t lattice [N, S] and each candidate's dt [N, S]."""
    t0 = nears if noise is None else nears + torch.clamp(nears * dt_gamma, dt_min, dt_max) * noise
    if dt_gamma == 0.0:
        steps = torch.arange(S, dtype=torch.float32, device=nears.device)
        ts = t0[:, None] + steps[None, :] * dt_min
        return ts, torch.full_like(ts, dt_min)
    # t_{i+1} = t_i + clamp(t_i * dt_gamma, dt_min, dt_max)
    ts, dts, t = [], [], t0
    for _ in range(S):
        dt = torch.clamp(t * dt_gamma, dt_min, dt_max)
        ts.append(t)
        dts.append(dt)
        t = t + dt
    return torch.stack(ts, dim=1), torch.stack(dts, dim=1)


def _occupancy_at(occ: torch.Tensor, pts: torch.Tensor, dts: torch.Tensor,
                  bound: float) -> torch.Tensor:
    """Occupancy byte > 0 at pts [..., 3], the cascade chosen as the larger
    of the level that holds the point and the level whose cell covers dt."""
    C, H = occ.shape[0], occ.shape[1]
    pts = torch.clamp(pts, -bound, bound)
    flat_occ = occ.reshape(-1)
    if C == 1:
        mip_bound = min(1.0, bound)
        g = torch.clamp(((pts / mip_bound) * 0.5 + 0.5) * H, 0, H - 1).to(torch.int64)
        return flat_occ[(g[..., 0] * H + g[..., 1]) * H + g[..., 2]] > 0
    mag = pts.abs().amax(dim=-1)
    lvl_pos = torch.clamp(torch.ceil(torch.log2(torch.clamp_min(mag, 1e-8))).to(torch.int64),
                          0, C - 1)
    lvl_dt = torch.clamp(torch.ceil(torch.log2(torch.clamp_min(dts * H / (2.0 * SQRT3), 1e-8)))
                         .to(torch.int64), 0, C - 1)
    level = torch.maximum(lvl_pos, lvl_dt)
    mip_bound = torch.clamp_max(2.0 ** level.to(torch.float32), bound)
    g = torch.clamp(((pts / mip_bound[..., None]) * 0.5 + 0.5) * H, 0, H - 1).to(torch.int64)
    return flat_occ[((level * H + g[..., 0]) * H + g[..., 1]) * H + g[..., 2]] > 0


def march_rays(rays_o: torch.Tensor, rays_d: torch.Tensor, occ: torch.Tensor, nears: torch.Tensor,
               fars: torch.Tensor, bound: float, K: int = 64, max_steps: int = 1024,
               dt_gamma: float = 0.0, noise: Optional[torch.Tensor] = None,
               contract: bool = False, n_candidates: Optional[int] = None) -> MarchResult:
    """March N rays through the occupancy grid into [N, K] samples.

    noise: [N] uniforms in [0, 1) that shift each ray's lattice (perturb),
    or None.  n_candidates caps the lattice length S below max_steps without
    changing dt (candidates at t >= far are masked, so a cap of at least
    ceil(max span / dt_min) + 1 is exact; see train/stage0.py
    march_candidates_for)."""
    N = rays_o.shape[0]
    S = max_steps if n_candidates is None else min(n_candidates, max_steps)
    K = min(K, S)
    H = occ.shape[1]
    dt_min = 2.0 * SQRT3 / max_steps
    dt_max = 2.0 * SQRT3 * bound / H

    ts, dts = _candidate_ts(nears, S, dt_min, dt_max, dt_gamma, noise)    # [N,S]
    pts = rays_o[:, None, :] + rays_d[:, None, :] * ts[..., None]
    mask = (ts < fars[:, None]) & _occupancy_at(occ, pts, dts, bound)
    del pts

    # every stride-th occupied candidate, at most K a ray
    n_occ = mask.sum(dim=-1)
    stride = torch.clamp_min((n_occ + K - 1) // K, 1)
    rank = torch.cumsum(mask, dim=-1) - 1
    sel = mask & (rank % stride[:, None] == 0)
    rank_sel = torch.cumsum(sel, dim=-1) - 1
    # the selected candidates to (ray, rank_sel); the rest to a dropped column K
    tgt = torch.where(sel, rank_sel, K)
    ts_out = torch.zeros((N, K + 1), device=ts.device).scatter_(1, tgt, ts)[:, :K]
    valid = torch.zeros((N, K + 1), dtype=torch.bool, device=ts.device).scatter_(
        1, tgt, sel)[:, :K]
    validf = valid.to(ts.dtype)
    if dt_gamma == 0.0:
        dts_out = (dts[:, :1] * stride[:, None].to(dts.dtype)) * validf
    else:
        dts_sel = torch.zeros((N, K + 1), device=ts.device).scatter_(1, tgt, dts)[:, :K]
        dts_out = dts_sel * stride[:, None].to(dts.dtype) * validf

    xyzs = rays_o[:, None, :] + rays_d[:, None, :] * ts_out[..., None]
    xyzs = torch.clamp(xyzs, -bound, bound)
    if contract:
        mag = xyzs.abs().amax(dim=-1, keepdim=True)
        m = torch.clamp_min(mag, 1e-8)
        xyzs = xyzs * torch.where(mag > 1.0, (2.0 - 1.0 / m) / m, 1.0)
    return MarchResult(xyzs=xyzs, dirs=rays_d, ts=ts_out, dts=dts_out, valid=valid)


def cumprod_backward(g: torch.Tensor, y: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """The gradient of y [N, K] from the gradient g of T = cumprod(y, -1), in
    the operations of torch's own formula: the form it takes where any y is
    0, which gives the bits of its other form where none is, so no test on
    the host picks between them.  Before a row's first zero: the reversed
    cumulative sum of T g over y; at the first zero: the products of the y
    up to the second zero against g, times T before the zero; after: 0."""
    w = T * g
    zeros = (y == 0).cumsum(-1)
    before = zeros == 0
    grad = torch.where(before, w.masked_fill(~before, 0.0).flip(-1).cumsum(-1).flip(-1).div(y),
                       0.0)
    one = zeros == 1
    first = one.max(-1, keepdim=True).indices
    at_first = torch.zeros_like(one).scatter_(-1, first, True) & one
    between = one & ~at_first
    at = (y.masked_fill(~between, 1.0).cumprod(-1).mul_(g.masked_fill(zeros != 1, 0.0))
          .sum(-1, keepdim=True)
          .mul_(torch.gather(T, -1, (first - 1).relu_()).masked_fill_(first == 0, 1.0)))
    return torch.where(at_first, at, grad)


class ExclusiveTransmittance(torch.autograd.Function):
    """x [N, K] (``1 - alpha``) -> T [N, K], T_j the product of x_i over
    i < j: ``torch.cumprod`` of the shifted x, and its gradient
    (``cumprod_backward``), bit for bit, with nothing synchronized; x's last
    column gets a zero gradient, as it weighs nothing."""

    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        y = torch.cat([torch.ones_like(x[:, :1]), x[:, :-1]], dim=-1)
        T = torch.cumprod(y, dim=-1)
        ctx.save_for_backward(y, T)
        return T

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g: torch.Tensor) -> torch.Tensor:
        y, T = ctx.saved_tensors
        gy = cumprod_backward(g, y, T)
        return torch.cat([gy[:, 1:], torch.zeros_like(gy[:, :1])], dim=-1)


class CompositeResult(NamedTuple):
    weights: torch.Tensor      # [N, K]
    weights_sum: torch.Tensor  # [N]
    depth: torch.Tensor        # [N]
    image: torch.Tensor        # [N, 3]


def composite_rays(sigmas: torch.Tensor, rgbs: torch.Tensor, ts: torch.Tensor, dts: torch.Tensor,
                   valid: torch.Tensor, T_thresh: float = 1e-4,
                   alpha_mode: bool = False) -> CompositeResult:
    """alpha = 1 - exp(-sigma dt) (or sigma clipped to [0, 1] in alpha_mode,
    the NeuS path); T by exclusive cumprod of (1 - alpha)
    (``ExclusiveTransmittance``); samples where T has fallen below T_thresh
    weigh zero."""
    if alpha_mode:
        alpha = torch.clamp(sigmas, 0.0, 1.0)
    else:
        alpha = 1.0 - torch.exp(-sigmas * dts)
    alpha = torch.where(valid, alpha, 0.0)
    T = ExclusiveTransmittance.apply(1.0 - alpha)
    w = torch.where(T >= T_thresh, alpha * T, 0.0)
    return CompositeResult(weights=w, weights_sum=w.sum(dim=-1), depth=(w * ts).sum(dim=-1),
                           image=(w[..., None] * rgbs).sum(dim=-2))


def sph_from_ray(rays_o: torch.Tensor, rays_d: torch.Tensor, radius: float) -> torch.Tensor:
    """(theta, phi) [N, 2] where each ray leaves the sphere of ``radius``."""
    b = torch.sum(rays_o * rays_d, dim=-1)
    c = torch.sum(rays_o * rays_o, dim=-1) - radius * radius
    t = -b + torch.sqrt(torch.clamp_min(b * b - c, 0.0))
    p = rays_o + rays_d * t[:, None]
    theta = torch.atan2(torch.sqrt(p[:, 0] ** 2 + p[:, 1] ** 2), p[:, 2])
    return torch.stack([theta, torch.atan2(p[:, 1], p[:, 0])], dim=-1)


def flatten_rays(counts: torch.Tensor, total: int) -> torch.Tensor:
    """Ray index of each of ``total`` points from per-ray sample counts."""
    offsets = torch.cumsum(counts, dim=0)[:-1]
    out = torch.zeros((total,), dtype=torch.int32, device=counts.device)
    out.index_add_(0, torch.clamp(offsets, 0, total - 1).long(),
                   torch.ones_like(offsets, dtype=torch.int32))
    return torch.cumsum(out, dim=0, dtype=torch.int32)
