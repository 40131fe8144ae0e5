"""Small math helpers (counterpart of mirres_restir_nerf_mesh_tpu/utils/math.py)."""

from __future__ import annotations

import torch


def safe_normalize(x: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    """Normalize along the last axis, guarding the zero vector."""
    return x / torch.sqrt(torch.clamp_min(torch.sum(x * x, dim=-1, keepdim=True), eps))


def luminance(rgb: torch.Tensor) -> torch.Tensor:
    """Rec.709 luminance."""
    return rgb[..., 0] * 0.2126 + rgb[..., 1] * 0.7152 + rgb[..., 2] * 0.0722


def linear_to_srgb(x: torch.Tensor) -> torch.Tensor:
    x = torch.clamp(x, 0.0, 1.0)
    return torch.where(x <= 0.0031308, 12.92 * x,
                       1.055 * (torch.clamp_min(x, 1e-8) ** (1.0 / 2.4)) - 0.055)


class TruncExp(torch.autograd.Function):
    """exp whose gradient is taken at the input clamped to [-15, 15]
    (the reference's custom_vjp ``trunc_exp``): g * exp(clip(x, -15, 15))."""

    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(x)
        return torch.exp(x)

    @staticmethod
    def backward(ctx, g: torch.Tensor) -> torch.Tensor:
        (x,) = ctx.saved_tensors
        return g * torch.exp(torch.clamp(x, -15.0, 15.0))


def trunc_exp(x: torch.Tensor) -> torch.Tensor:
    return TruncExp.apply(x)


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cross product over the last axis, in jnp.cross's operation order."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1)


def onb_frame(n: torch.Tensor):
    """Orthonormal basis (t, b, n) around n, branchless (Frisvad/Duff)."""
    s = torch.where(n[..., 2:3] >= 0.0, 1.0, -1.0)
    a = -1.0 / (s + n[..., 2:3])
    b = n[..., 0:1] * n[..., 1:2] * a
    s0, a0, b0 = s[..., 0], a[..., 0], b[..., 0]
    t = torch.stack([1.0 + s0 * n[..., 0] * n[..., 0] * a0, s0 * b0, -s0 * n[..., 0]], dim=-1)
    bt = torch.stack([b0, s0 + n[..., 1] * n[..., 1] * a0, -n[..., 1]], dim=-1)
    return t, bt, n
