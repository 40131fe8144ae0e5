"""Screen-space denoisers (counterpart of mirres_restir_nerf_mesh_tpu/render/denoise.py).

- Edge-avoiding a-trous wavelet (EAW) filter: 5x5 B3-spline taps, weights
  exp(-d2/phi) over colour / normal / position, iterated with the step
  width halving each pass.
- Bilateral filter: gaussian x clamped-dot(normal)^128 x relative-depth
  weights.
- ``normal_ao`` (the screen-space AO of the lambda_extra_kd loss) and
  ``variance_phi``.

Plain PyTorch stencils over [H, W, C] images (shifts with zero padding),
as in the reference, which never had Pallas kernels for them.  Gradients
flow through the colour only: the colour weights are detached where the
reference stops their gradient.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

_B3 = np.outer([1 / 16, 1 / 4, 3 / 8, 1 / 4, 1 / 16], [1 / 16, 1 / 4, 3 / 8, 1 / 4, 1 / 16])
# 25-tap offset pattern of the variance estimate
_OFF25 = [(i - 2, j - 2) for j in range(5) for i in range(5)]


def _shift2d(x: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """out[y, x] = x[y - dy, x - dx], zero outside ([H, W, ...])."""
    H, W = x.shape[0], x.shape[1]
    tail = (0, 0) * (x.dim() - 2)
    xp = F.pad(x, tail + (max(dx, 0), max(-dx, 0), max(dy, 0), max(-dy, 0)))
    return xp[max(-dy, 0):max(-dy, 0) + H, max(-dx, 0):max(-dx, 0) + W]


def _valid2d(H: int, W: int, dy: int, dx: int, device) -> torch.Tensor:
    yy = torch.arange(H, device=device)[:, None]
    xx = torch.arange(W, device=device)[None, :]
    return (yy - dy >= 0) & (yy - dy < H) & (xx - dx >= 0) & (xx - dx < W)


def eaw_step(color, normal, pos, mask, step_width: int, c_phi: float, n_phi: float,
             p_phi: float) -> torch.Tensor:
    """One a-trous pass: color / normal / pos [H,W,3], mask [H,W] bool."""
    H, W = color.shape[0], color.shape[1]
    cval_ng = color.detach()
    num = torch.zeros_like(color)
    den = torch.zeros((H, W, 1), device=color.device)
    for ky in range(5):
        for kx in range(5):
            dy, dx = (ky - 2) * step_width, (kx - 2) * step_width
            k = float(_B3[ky, kx])
            ctmp = _shift2d(color, dy, dx)
            ntmp = _shift2d(normal, dy, dx)
            ptmp = _shift2d(pos, dy, dx)
            ok = _valid2d(H, W, dy, dx, color.device) & _shift2d(mask[..., None], dy, dx)[..., 0]
            d2c = torch.sum((cval_ng - ctmp.detach()) ** 2, -1)
            w_c = torch.clamp_max(torch.exp(-d2c / c_phi), 1.0)
            d2n = torch.sum((normal - ntmp) ** 2, -1)
            w_n = torch.clamp_max(torch.exp(-d2n / n_phi), 1.0)
            d2p = torch.sum((pos - ptmp) ** 2, -1)
            w_p = torch.clamp_max(torch.exp(-d2p / p_phi), 1.0)
            w = torch.where(ok, w_c * w_n * w_p * k, 0.0)[..., None]
            num = num + ctmp * w
            den = den + w
    out = num / torch.clamp_min(den, 1e-8)
    return torch.where(mask[..., None], out, color)


def eaw_denoise(color, normal, pos, mask, iterations: int = 4, step_width: int = 8,
                c_phi: float = 1.0, n_phi: float = 0.1, p_phi: float = 0.1,
                differentiable: bool = True) -> torch.Tensor:
    """Iterated a-trous filtering, the step width halving each pass."""
    if not differentiable:
        color, normal, pos = color.detach(), normal.detach(), pos.detach()
    sw = step_width
    for _ in range(iterations):
        color = eaw_step(color, normal, pos, mask, max(int(sw), 1), c_phi, n_phi, p_phi)
        sw //= 2
    return color


def normal_ao(normal: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Screen-space AO from local normal agreement over an 8x8 window:
    ao = clamp(50 * (1 - mean clamped dot(n_center, n_nbr)), 0, 1) over
    valid hit pixels, 0 on misses; normal [H,W,3], mask [H,W] -> [H,W],
    no gradients."""
    normal = normal.detach()
    H, W = normal.shape[0], normal.shape[1]
    s = torch.zeros((H, W), device=normal.device)
    cnt = torch.zeros((H, W), device=normal.device)
    for dy in range(-4, 4):
        for dx in range(-4, 4):
            ntmp = _shift2d(normal, dy, dx)
            ok = _valid2d(H, W, dy, dx, normal.device) & _shift2d(mask[..., None], dy, dx)[..., 0]
            d = torch.clamp(torch.sum(normal * ntmp, -1), 0.0, 1.0)
            s = s + torch.where(ok, d, 0.0)
            cnt = cnt + ok
    w = 1.0 - s / torch.clamp_min(cnt, 1.0)
    return torch.where(mask, torch.clamp(w * 50.0, 0.0, 1.0), 0.0)


def variance_phi(color, normal, pos, mask, step_width: int) -> torch.Tensor:
    """Per-pixel phi from the local 25-tap variance: (2 * sum_c var(color),
    0.1 * sum_c var(normal), 0.1 * sum_c var(pos)), 1e-6 on misses; [H,W,3]."""
    H, W = color.shape[0], color.shape[1]
    dev = color.device
    sums = [torch.zeros((H, W, 3), device=dev) for _ in range(3)]
    sqs = [torch.zeros((H, W, 3), device=dev) for _ in range(3)]
    cnt = torch.zeros((H, W, 1), device=dev)
    for ox, oy in _OFF25:
        dy, dx = oy * step_width, ox * step_width
        ok = _valid2d(H, W, dy, dx, dev)[..., None]
        for idx, buf in enumerate((color, normal, pos)):
            t = _shift2d(buf, dy, dx)
            sums[idx] = sums[idx] + torch.where(ok, t, 0.0)
            sqs[idx] = sqs[idx] + torch.where(ok, t * t, 0.0)
        cnt = cnt + ok
    cnt = torch.clamp_min(cnt, 1.0)
    phis = []
    for idx, scale in ((0, 2.0), (1, 0.1), (2, 0.1)):
        mean = sums[idx] / cnt
        var = torch.clamp_min(sqs[idx] / cnt - mean * mean, 0.0)
        phis.append(scale * torch.sum(var, dim=-1))
    return torch.where(mask[..., None], torch.stack(phis, dim=-1), 1e-6)


def _pow128(x: torch.Tensor) -> torch.Tensor:
    """x^128 by seven squarings (the reference's integer power)."""
    for _ in range(7):
        x = x * x
    return x


def bilateral_denoise(color, normal, zdz, sigma: float = 2.0) -> torch.Tensor:
    """Bilateral filter: gaussian distance x clamped-dot(normal)^128 x
    exp(-|dz| / (dz_scale * dist)) (the depth weight detached); colour
    [H,W,3], normal [H,W,3], zdz [H,W,2] depth and depth-gradient scale ->
    the normalized filtered colour."""
    H, W = color.shape[0], color.shape[1]
    variance = sigma * sigma
    rad = int(2 * math.ceil(sigma * 2.5) + 1)
    c_z, c_dz = zdz[..., 0], zdz[..., 1]
    num = torch.zeros_like(color)
    den = torch.zeros((H, W), device=color.device)
    for fy in range(-rad, rad + 1):
        for fx in range(-rad, rad + 1):
            dist_sqr = fx * fx + fy * fy
            dist = float(np.sqrt(dist_sqr))
            w_xy = float(np.exp(-dist_sqr / (2.0 * variance)))
            t_col = _shift2d(color, fy, fx)
            t_nrm = _shift2d(normal, fy, fx)
            t_z = _shift2d(zdz, fy, fx)
            ok = _valid2d(H, W, fy, fx, color.device)
            w_normal = _pow128(torch.clamp(torch.sum(t_nrm * normal, -1), 1e-8, 1.0))
            w_depth = torch.exp(-torch.abs(t_z[..., 0] - c_z) / torch.clamp_min(c_dz * dist, 1e-8))
            w = torch.where(ok, w_xy * w_normal * w_depth.detach(), 0.0)
            num = num + t_col * w[..., None]
            den = den + w
    return num / torch.clamp_min(den, 1e-4)[..., None]
