"""Image quality metrics (counterpart of
mirres_restir_nerf_mesh_tpu/train/metrics.py): PSNR, SSIM (11-tap
Gaussian, sigma 1.5, standard constants) and an LPIPS callable.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..device import resolve_device


def psnr(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    mse = torch.mean((pred - gt) ** 2)
    return -10.0 * torch.log10(torch.clamp_min(mse, 1e-12))


def _gaussian_kernel(size: int = 11, sigma: float = 1.5, device="cpu") -> torch.Tensor:
    ax = torch.arange(size, dtype=torch.float32, device=device) - (size - 1) / 2.0
    g = torch.exp(-0.5 * (ax / sigma) ** 2)
    g = g / torch.sum(g)
    return torch.outer(g, g)


def ssim(pred: torch.Tensor, gt: torch.Tensor, max_val: float = 1.0) -> torch.Tensor:
    """SSIM over [H, W, C] images (valid 11 x 11 Gaussian window)."""
    k = _gaussian_kernel(device=pred.device)[None, None]      # [1,1,11,11]

    def filt(x):
        return F.conv2d(x.permute(2, 0, 1)[:, None], k)[:, 0].permute(1, 2, 0)

    c1 = (0.01 * max_val) ** 2
    c2 = (0.03 * max_val) ** 2
    mu_p, mu_g = filt(pred), filt(gt)
    mu_p2, mu_g2, mu_pg = mu_p * mu_p, mu_g * mu_g, mu_p * mu_g
    # variances clamped at 0: the filtered second moment can dip below mu^2
    sp = torch.clamp_min(filt(pred * pred) - mu_p2, 0.0)
    sg = torch.clamp_min(filt(gt * gt) - mu_g2, 0.0)
    spg = filt(pred * gt) - mu_pg
    num = (2 * mu_pg + c1) * (2 * spg + c2)
    den = (mu_p2 + mu_g2 + c1) * (sp + sg + c2)
    return torch.mean(num / den)


def lpips_available() -> bool:
    try:
        import lpips  # noqa: F401

        return True
    except Exception:
        return False


def lpips_fn(weights_path: str = "", device="cuda"):
    """LPIPS(vgg) callable on numpy [H, W, 3] images, on ``device``, with
    ``.kind``.

    Preference order: the ``lpips`` package (the published metric; it loads
    torchvision's VGG16 weights) -> vendored weights through train/lpips.py
    -> the random-VGG perceptual fallback (values not comparable to
    published LPIPS)."""
    dev = resolve_device(device)
    if lpips_available():
        import lpips
        import numpy as np

        net = lpips.LPIPS(net="vgg").to(dev)

        def _fn(pred, gt):
            p = torch.as_tensor(np.asarray(pred), device=dev).permute(2, 0, 1)[None] * 2 - 1
            g = torch.as_tensor(np.asarray(gt), device=dev).permute(2, 0, 1)[None] * 2 - 1
            with torch.no_grad():
                return float(net(p.float(), g.float()))

        _fn.kind = "vgg"
        return _fn

    from .lpips import make_lpips

    return make_lpips(weights_path, dev)
