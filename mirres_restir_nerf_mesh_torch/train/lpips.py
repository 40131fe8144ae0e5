"""LPIPS perceptual metric / loss on a VGG16 backbone in PyTorch
(counterpart of mirres_restir_nerf_mesh_tpu/train/lpips.py).

VGG16 conv features tapped after relu1_2 / relu2_2 / relu3_3 / relu4_3 /
relu5_3, unit-normalized along channels, squared differences reduced by
non-negative 1x1 "lin" weights and averaged over space, summed over taps.

The params are a dict in the JAX package's layout (``conv{i}_w`` HWIO
[3, 3, Cin, Cout], ``conv{i}_b``, ``lin{j}_w``), so one ``.npz`` serves
both packages:

- ``load_weights(path)``: a vendored ``.npz`` gives the published metric
  (``cfg.lpips_weights``; ``convert_state_dicts`` maps the official torch
  state dicts onto it);
- ``random_params(generator)``: He-initialized features with uniform lin
  weights from a ``torch.Generator`` (seed 0 by default), the "random-VGG"
  perceptual distance.  Its values differ from the JAX package's
  ``PRNGKey(0)`` draw; both carry the kind ``random-vgg`` and neither is
  comparable to published LPIPS numbers.
"""

from __future__ import annotations

import functools
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device

# VGG16 conv plan: (out_channels, tap_after_this_layer)
_PLAN: List[Tuple[int, bool]] = [
    (64, False), (64, True),          # relu1_2
    (128, False), (128, True),        # relu2_2
    (256, False), (256, False), (256, True),    # relu3_3
    (512, False), (512, False), (512, True),    # relu4_3
    (512, False), (512, False), (512, True),    # relu5_3
]
# max-pool before these layer indices (after each tapped block)
_POOL_BEFORE = {2, 4, 7, 10}

_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)

# torchvision VGG16 `features` indices of the 13 conv layers, in order
_VGG16_CONV_IDX = [0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28]


def random_params(generator: Optional[torch.Generator] = None,
                  device="cuda") -> Dict[str, Any]:
    """He-initialized random-feature VGG + uniform lin weights on ``device``,
    drawn on the generator's device (by default a CPU generator seeded 0,
    so the fallback's values do not depend on ``device``)."""
    dev = resolve_device(device)
    g = generator if generator is not None else torch.Generator().manual_seed(0)
    params: Dict[str, Any] = {}
    cin, taps = 3, 0
    for i, (cout, tap) in enumerate(_PLAN):
        std = float(np.sqrt(2.0 / (3 * 3 * cin)))
        w = torch.randn((3, 3, cin, cout), generator=g, device=g.device) * std
        params[f"conv{i}_w"] = w.to(dev)
        params[f"conv{i}_b"] = torch.zeros((cout,), device=dev)
        if tap:
            params[f"lin{taps}_w"] = torch.full((cout,), 1.0 / cout, device=dev)
            taps += 1
        cin = cout
    return params


def load_weights(path: str, device="cuda") -> Optional[Dict[str, Any]]:
    """Vendored-weights loader (.npz with conv{i}_w/b, lin{j}_w)."""
    if not path or not os.path.exists(path):
        return None
    dev = resolve_device(device)
    raw = np.load(path)
    return {k: torch.as_tensor(np.asarray(raw[k], np.float32), device=dev) for k in raw.files}


def convert_state_dicts(vgg_sd: Dict[str, np.ndarray],
                        lin_sd: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """The official torch state dicts (torchvision ``vgg16().features``,
    ``features.{i}.weight`` OIHW; the lpips package's ``lin{j}.model.1.weight``
    [1, C, 1, 1]) -> this module's numpy layout."""
    out: Dict[str, np.ndarray] = {}
    for i, idx in enumerate(_VGG16_CONV_IDX):
        w = np.asarray(vgg_sd[f"features.{idx}.weight"], np.float32)  # [O,I,kh,kw]
        b = np.asarray(vgg_sd[f"features.{idx}.bias"], np.float32)
        if w.shape[0] != _PLAN[i][0] or w.shape[2:] != (3, 3):
            raise ValueError(f"features.{idx}.weight has shape {w.shape}, expected "
                             f"[{_PLAN[i][0]}, Cin, 3, 3]")
        out[f"conv{i}_w"] = np.transpose(w, (2, 3, 1, 0))             # HWIO
        out[f"conv{i}_b"] = b
    for j in range(5):
        out[f"lin{j}_w"] = np.asarray(lin_sd[f"lin{j}.model.1.weight"], np.float32).reshape(-1)
    return out


def _features(params: Dict[str, Any], x: torch.Tensor) -> List[torch.Tensor]:
    """x [N, 3, H, W] in [-1, 1] -> tapped feature maps [N, C, h, w]."""
    shift = torch.tensor(_SHIFT, dtype=x.dtype, device=x.device)[None, :, None, None]
    scale = torch.tensor(_SCALE, dtype=x.dtype, device=x.device)[None, :, None, None]
    h = (x - shift) / scale
    feats = []
    for i, (_, tap) in enumerate(_PLAN):
        if i in _POOL_BEFORE:
            h = F.max_pool2d(h, 2, 2)
        h = F.relu(F.conv2d(h, params[f"conv{i}_w"].permute(3, 2, 0, 1), params[f"conv{i}_b"],
                            padding=1))
        if tap:
            feats.append(h)
    return feats


def lpips_distance(params: Dict[str, Any], pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """pred / gt [H, W, 3] (or [N, H, W, 3]) in [0, 1] -> scalar (or [N])
    distance; differentiable."""
    squeeze = pred.dim() == 3
    if squeeze:
        pred, gt = pred[None], gt[None]
    fp = _features(params, pred.permute(0, 3, 1, 2) * 2.0 - 1.0)
    fg = _features(params, gt.permute(0, 3, 1, 2) * 2.0 - 1.0)
    total = 0.0
    for j, (a, b) in enumerate(zip(fp, fg)):
        na = a / torch.clamp_min(torch.linalg.vector_norm(a, dim=1, keepdim=True), 1e-10)
        nb = b / torch.clamp_min(torch.linalg.vector_norm(b, dim=1, keepdim=True), 1e-10)
        w = torch.clamp_min(params[f"lin{j}_w"], 0.0)
        total = total + torch.mean(torch.sum((na - nb) ** 2 * w[None, :, None, None], dim=1),
                                   dim=(1, 2))
    return total[0] if squeeze else total


@functools.lru_cache(maxsize=4)
def _default_params_cached(weights_path: str, device: str):
    p = load_weights(weights_path, device=device)
    if p is None:
        return random_params(device=device), "random-vgg"
    return p, "vgg"


def default_params(weights_path: str = "", device="cuda"):
    """(params on ``device``, kind) for ``weights_path`` (cached)."""
    return _default_params_cached(weights_path, str(resolve_device(device)))


def lpips_kind(weights_path: str = "") -> str:
    """'vgg' (vendored official weights) or 'random-vgg' (fallback); what
    ``load_weights`` would return, without loading."""
    return "vgg" if weights_path and os.path.exists(weights_path) else "random-vgg"


def make_lpips(weights_path: str = "", device="cuda"):
    """-> (pred, gt) -> float distance, on numpy or tensor [H, W, 3] images;
    the callable's ``.kind`` names its weights."""
    dev = resolve_device(device)
    params, kind = default_params(weights_path, dev)

    def put(x):
        if isinstance(x, torch.Tensor):
            return x.to(dev, torch.float32)
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    @torch.no_grad()
    def _fn(pred, gt):
        return float(lpips_distance(params, put(pred), put(gt)))

    _fn.kind = kind
    return _fn
