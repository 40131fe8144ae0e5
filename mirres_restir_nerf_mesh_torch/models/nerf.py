"""Instant-NGP-style radiance field, forward (counterpart of
mirres_restir_nerf_mesh_tpu/models/nerf.py: ``density``, ``color``,
``rgb_only``, ``init_nerf``).  MLPs run in ``compute_dtype`` (bf16 on the
card); params stay float32.  Stage-0 parts (normals, NeuS alpha) come later.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch

from ..device import resolve_device
from ..ops.hashgrid import HashGridSpec, hashgrid_encode, init_hashgrid
from ..ops.sh import sh_encode
from ..utils.math import trunc_exp


@dataclass(frozen=True)
class NeRFSpec:
    bound: float = 1.0
    num_layers: int = 2
    hidden_dim: int = 64
    geo_feat_dim: int = 15
    num_layers_color: int = 3
    hidden_dim_color: int = 64
    sh_degree: int = 4
    sdf: bool = False
    compute_dtype: Any = torch.float32
    grid_levels: int = 16
    grid_log2_hashmap_size: int = 19
    grid_base_resolution: int = 16
    grid_desired_resolution: int = 0   # 0 -> 2048 * bound

    @property
    def grid(self) -> HashGridSpec:
        return HashGridSpec(
            num_levels=self.grid_levels, level_dim=2,
            base_resolution=self.grid_base_resolution,
            log2_hashmap_size=self.grid_log2_hashmap_size,
            desired_resolution=self.grid_desired_resolution or int(2048 * self.bound),
        )


def init_nerf(generator: Optional[torch.Generator], spec: NeRFSpec,
              device="cuda") -> Dict[str, Any]:
    dev = resolve_device(device)

    def lin(i, o):
        lim = 1.0 / i ** 0.5
        return torch.rand((i, o), generator=generator, device=dev) * (2 * lim) - lim

    sigma_net, d = [], spec.grid.output_dim
    for l in range(spec.num_layers):
        d_out = (1 + spec.geo_feat_dim) if l == spec.num_layers - 1 else spec.hidden_dim
        sigma_net.append(lin(d, d_out))
        d = d_out
    color_net, d = [], spec.sh_degree ** 2 + spec.geo_feat_dim
    for l in range(spec.num_layers_color):
        d_out = 3 if l == spec.num_layers_color - 1 else spec.hidden_dim_color
        color_net.append(lin(d, d_out))
        d = d_out
    params = {"encoder": init_hashgrid(generator, spec.grid, device=dev),
              "sigma_net": sigma_net, "color_net": color_net}
    if spec.sdf:
        params["variance"] = torch.tensor(0.3, device=dev)
    return params


def _mlp(ws, h, dtype):
    h = h.to(dtype)
    for l, w in enumerate(ws):
        h = h @ w.to(dtype)
        if l != len(ws) - 1:
            h = torch.relu(h)
    return h.to(torch.float32)


def density(params: Dict[str, Any], x: torch.Tensor, spec: NeRFSpec,
            stochastic_u: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """x [N,3] -> {'sigma': [N], 'geo_feat': [N,15]} (raw SDF in sdf mode)."""
    h = hashgrid_encode(params["encoder"], x, spec.grid, bound=spec.bound,
                        stochastic_u=stochastic_u)
    h = _mlp(params["sigma_net"], h, spec.compute_dtype)
    raw = h[..., 0]
    return {"sigma": raw if spec.sdf else trunc_exp(raw), "geo_feat": h[..., 1:]}


def color(params: Dict[str, Any], geo_feat: torch.Tensor, d: torch.Tensor,
          spec: NeRFSpec) -> torch.Tensor:
    """Direction-conditioned color head; d normalized -> [N,3] in [0,1]."""
    h = torch.cat([sh_encode(d, spec.sh_degree), geo_feat], dim=-1)
    return torch.sigmoid(_mlp(params["color_net"], h, spec.compute_dtype))


def rgb_only(params: Dict[str, Any], x: torch.Tensor, d: torch.Tensor,
             spec: NeRFSpec) -> torch.Tensor:
    """Color query without sigma (used by stage 1)."""
    return color(params, density(params, x, spec)["geo_feat"], d, spec)
