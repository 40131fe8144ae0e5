"""Instant-NGP-style radiance field (counterpart of
mirres_restir_nerf_mesh_tpu/models/nerf.py): hash grid -> sigma MLP
(``trunc_exp`` density, or a raw SDF value with a ``variance`` parameter in
sdf mode) and geometry features -> SH-direction colour MLP.  MLPs run in
``compute_dtype`` (bf16 on the card); params stay float32.  Normals by
finite differences or by autograd with respect to the position (a graph
the SDF losses differentiate once more, with respect to the params), and
the NeuS SDF -> alpha conversion.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch

from ..device import resolve_device
from ..ops.hashgrid import HashGridSpec, hashgrid_encode, init_hashgrid
from ..ops.sh import sh_encode
from ..utils.math import safe_normalize, trunc_exp


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
    # without autograd the ReLU overwrites its input: the occupancy update's
    # [2^21, 64] hidden layer is then held once, not twice
    relu = torch.relu if torch.is_grad_enabled() else torch.relu_
    h = h.to(dtype)
    for l, w in enumerate(ws):
        h = h @ w.to(dtype)
        if l != len(ws) - 1:
            h = relu(h)
    return h.to(torch.float32)


def density(params: Dict[str, Any], x: torch.Tensor, spec: NeRFSpec,
            stochastic_u: Optional[torch.Tensor] = None,
            max_level=None) -> Dict[str, torch.Tensor]:
    """x [N,3] -> {'sigma': [N], 'geo_feat': [N,15]} (raw SDF in sdf mode).
    stochastic_u [N, 3]: the one-corner hash-grid estimator's uniforms;
    max_level: progressive levels (hashgrid_encode)."""
    return density_from_features(params, hashgrid_encode(
        params["encoder"], x, spec.grid, bound=spec.bound, stochastic_u=stochastic_u,
        max_level=max_level), spec)


def density_from_features(params: Dict[str, Any], h: torch.Tensor,
                          spec: NeRFSpec) -> Dict[str, torch.Tensor]:
    """``density`` from the hash-grid features h [N, L*C]."""
    # cast first: called with the encode's output, nothing then holds the
    # float32 features while the first layer runs (the occupancy update's peak)
    h = h.to(spec.compute_dtype)
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


def forward(params: Dict[str, Any], x: torch.Tensor, d: torch.Tensor, spec: NeRFSpec,
            max_level=None, stochastic_u: Optional[torch.Tensor] = None):
    """Full field: sigma [N], rgb [N,3]."""
    res = density(params, x, spec, stochastic_u=stochastic_u, max_level=max_level)
    return res["sigma"], color(params, res["geo_feat"], d, spec)


def forward_from_features(params: Dict[str, Any], h: torch.Tensor, d: torch.Tensor,
                          spec: NeRFSpec):
    """``forward`` from the hash-grid features h [N, L*C]: sigma [N], rgb [N,3]."""
    res = density_from_features(params, h, spec)
    return res["sigma"], color(params, res["geo_feat"], d, spec)


def normal_fd(params: Dict[str, Any], x: torch.Tensor, spec: NeRFSpec,
              epsilon: float = 1e-4) -> torch.Tensor:
    """Central finite-difference gradient of sigma (or the SDF), [N,3]."""
    def sig(p):
        return density(params, torch.clamp(p, -spec.bound, spec.bound), spec)["sigma"]

    grads = []
    for ax in range(3):
        e = torch.zeros((1, 3), device=x.device)
        e[0, ax] = epsilon
        grads.append(0.5 * (sig(x + e) - sig(x - e)) / epsilon)
    return torch.stack(grads, dim=-1)


def normal_autodiff(params: Dict[str, Any], x: torch.Tensor, spec: NeRFSpec,
                    max_level=None) -> torch.Tensor:
    """Gradient of sigma (or the SDF) with respect to the position, [N,3].
    Built with create_graph when grad mode is on, so that a loss on the
    normal (eikonal) reaches the params; computed under enable_grad so an
    eval render (no_grad) gets it too."""
    create = torch.is_grad_enabled()
    with torch.enable_grad():
        p = x.detach().requires_grad_(True)
        sig = density(params, p, spec, max_level=max_level)["sigma"]
        (g,) = torch.autograd.grad(sig.sum(), p, create_graph=create)
    return g if create else g.detach()


def neus_alpha(sdf: torch.Tensor, variance: torch.Tensor, normal: torch.Tensor,
               dirs: torch.Tensor, dts: torch.Tensor, cos_anneal_ratio=1.0) -> torch.Tensor:
    """NeuS SDF -> alpha of each sample, [N]."""
    inv_s = torch.clamp(torch.exp(variance * 10.0), 1e-6, 1e6)
    true_cos = torch.sum(dirs * safe_normalize(normal), dim=-1)
    iter_cos = -(torch.relu(-true_cos * 0.5 + 0.5) * (1.0 - cos_anneal_ratio)
                 + torch.relu(-true_cos) * cos_anneal_ratio)
    prev_cdf = torch.sigmoid((sdf - iter_cos * dts * 0.5) * inv_s)
    next_cdf = torch.sigmoid((sdf + iter_cos * dts * 0.5) * inv_s)
    return torch.clamp((prev_cdf - next_cdf + 1e-5) / (prev_cdf + 1e-5), 0.0, 1.0)
