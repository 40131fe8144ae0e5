"""Weights carried across from the JAX package.

``params_from_jax`` takes the leaves of the reference's ``Stage1Params`` as
numpy arrays (the same nested dicts and lists: ``nerf = {"encoder",
"sigma_net": [...], "color_net": [...]}``, ``mat = {"encoder", "net": [...]}``,
``env`` [H,W,3], ``offsets`` [V,3]) and returns the port's params on the
device, so both packages compute the same frame.  ``params_to_numpy`` is its
inverse.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .device import resolve_device
from .render.stage1 import Stage1Params


def _to_torch(x: Any, dev: torch.device):
    if isinstance(x, dict):
        return {k: _to_torch(v, dev) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_to_torch(v, dev) for v in x]
    return torch.tensor(np.asarray(x, dtype=np.float32), device=dev)


def _to_numpy(x: Any):
    if isinstance(x, dict):
        return {k: _to_numpy(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_to_numpy(v) for v in x]
    return x.detach().cpu().numpy()


def params_from_jax(nerf, mat, env, offsets, device="cuda") -> Stage1Params:
    dev = resolve_device(device)
    return Stage1Params(nerf=_to_torch(nerf, dev), offsets=_to_torch(offsets, dev),
                        mat=_to_torch(mat, dev), env=_to_torch(env, dev))


def params_to_numpy(params: Stage1Params):
    """(nerf, mat, env, offsets) as numpy leaves, the layout params_from_jax takes."""
    return (_to_numpy(params.nerf), _to_numpy(params.mat), _to_numpy(params.env),
            _to_numpy(params.offsets))
