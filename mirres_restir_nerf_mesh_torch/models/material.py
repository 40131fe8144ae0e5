"""Neural 3D material texture (counterpart of
mirres_restir_nerf_mesh_tpu/models/material.py): hash grid -> 2-layer MLP
-> sigmoid -> [min, max] remap.  Channels: kd rgb, ks occlusion (unused),
roughness, metallic."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

from ..device import resolve_device
from ..ops.hashgrid import HashGridSpec, hashgrid_encode, init_hashgrid
from ..utils.profiling import count_sync


@dataclass(frozen=True)
class MaterialSpec:
    bound: float = 1.0
    channels: int = 6
    hidden: int = 32
    min_vals: Tuple[float, ...] = (0.0, 0.0, 0.0, 0.0, 0.08, 0.0)
    max_vals: Tuple[float, ...] = (1.0, 1.0, 1.0, 0.0, 1.0, 0.0)
    compute_dtype: Any = torch.float32

    @property
    def grid(self) -> HashGridSpec:
        return HashGridSpec(num_levels=16, level_dim=2, base_resolution=16,
                            log2_hashmap_size=19, desired_resolution=int(4096 * self.bound))


def init_material(generator: Optional[torch.Generator], spec: MaterialSpec,
                  device="cuda") -> Dict[str, Any]:
    dev = resolve_device(device)
    in_dim = spec.grid.output_dim

    def lin(i, o):
        lim = 1.0 / i ** 0.5
        return torch.rand((i, o), generator=generator, device=dev) * (2 * lim) - lim

    return {
        "encoder": init_hashgrid(generator, spec.grid, device=dev),
        "net": [lin(in_dim, spec.hidden), lin(spec.hidden, spec.channels)],
    }


def sample_material(params: Dict[str, Any], x: torch.Tensor, spec: MaterialSpec,
                    stochastic_u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x [N,3] in [-bound, bound] -> material [N, 6] in [min, max].
    stochastic_u [N,3]: one-corner hash-grid estimator uniforms (Monte-Carlo
    consumers such as the bounce re-query); None = exact interpolation."""
    h = hashgrid_encode(params["encoder"], x, spec.grid, bound=spec.bound,
                        stochastic_u=stochastic_u)
    dt = spec.compute_dtype
    h = torch.relu(h.to(dt) @ params["net"][0].to(dt))
    h = (h @ params["net"][1].to(dt)).to(torch.float32)
    s = torch.sigmoid(h)
    count_sync("material_range", x.is_cuda, 2)
    mn = torch.tensor(spec.min_vals, dtype=torch.float32, device=x.device)
    mx = torch.tensor(spec.max_vals, dtype=torch.float32, device=x.device)
    return mn + (mx - mn) * s


def split_material(mat: torch.Tensor):
    """-> (kd [N,3], roughness [N], metallic [N])."""
    return mat[..., 0:3], mat[..., 4], mat[..., 5]
