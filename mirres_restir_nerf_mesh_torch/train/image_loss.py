"""Image-space losses: SMAPE / MSE / RelMSE with log or tonemap transforms,
MAPE and Huber (counterpart of mirres_restir_nerf_mesh_tpu/train/image_loss.py,
after the upstream project's loss library)."""

from __future__ import annotations

import torch


def _tonemap_srgb(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x <= 0.0031308, 12.92 * x,
                       1.055 * torch.clamp_min(x, 1e-8) ** (1 / 2.4) - 0.055)


def _transform(x: torch.Tensor, mode: str) -> torch.Tensor:
    if mode == "log":
        return torch.log(torch.clamp(x, 0.0, 65535.0) + 1.0)
    if mode == "tonemap":
        return _tonemap_srgb(torch.clamp(x, 0.0, 65535.0))
    return x


def image_loss(img: torch.Tensor, ref: torch.Tensor, loss: str = "l1",
               transform: str = "none") -> torch.Tensor:
    """loss in {l1, mse, smape, relmse}, transform in {none, log, tonemap}."""
    a = _transform(img, transform)
    b = _transform(ref, transform)
    if loss == "mse":
        return torch.mean((a - b) ** 2)
    if loss == "smape":
        return torch.mean(torch.abs(a - b) / (torch.abs(a) + torch.abs(b) + 0.01))
    if loss == "relmse":
        return torch.mean((a - b) ** 2 / (b * b + 0.01))
    return torch.mean(torch.abs(a - b))


def mape_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean absolute percentage error."""
    return torch.mean(torch.abs(pred - target) / (torch.abs(target) + 1e-2))


def huber_loss(pred: torch.Tensor, target: torch.Tensor, delta: float = 0.1) -> torch.Tensor:
    """Huber loss, scaled by 1 / delta inside the quadratic zone."""
    d = torch.abs(pred - target)
    return torch.mean(torch.where(d <= delta, 0.5 * d * d / delta, d - 0.5 * delta))
