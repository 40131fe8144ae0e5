"""Multi-resolution hash-grid encoder, forward (counterpart of
mirres_restir_nerf_mesh_tpu/ops/hashgrid.py).

Same level layout as the reference (dense levels with stride resolution+1,
xor-hashed levels with primes (1, 2654435761, 805459861) modulo the level
size).  The reference hashes in uint32 and lets products wrap; here the
values ride in int64 and every product is masked to 32 bits, which gives the
same indices.  Two paths: exact trilinear interpolation over the 8 corners,
and the one-corner stochastic estimator that picks corner bit
``u_d < frac_d`` per axis (unbiased; the bounce material re-query uses it).
The reference's dense levels (table of at least (resolution+1)^3 rows) read
their corners through a packed-cell table whose axes run (z, y, x) while
the cell id runs (x, y, z): corner (cx, cy, cz) there reads the table row of
grid point (x+cz, y+cy, z+cx) and weighs it as corner (cx, cy, cz).  The
port reproduces that pairing so the features match.  Plain PyTorch: the
forward has no TPU kernel.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device

PRIMES = (1, 2654435761, 805459861)
_U32 = 0xFFFFFFFF
# 8 corner offsets of the trilinear cell, [8, 3] (x slowest, as the reference)
CORNERS = np.stack(np.meshgrid(*([np.arange(2)] * 3), indexing="ij"), axis=-1).reshape(-1, 3)


@dataclass(frozen=True)
class HashGridSpec:
    """Static metadata for a hash-grid encoder instance."""

    input_dim: int = 3
    num_levels: int = 16
    level_dim: int = 2
    base_resolution: int = 16
    log2_hashmap_size: int = 19
    per_level_scale: float = 2.0
    desired_resolution: Optional[int] = None

    @property
    def scale_factor(self) -> float:
        if self.desired_resolution is not None:
            return 2.0 ** (
                math.log2(self.desired_resolution / self.base_resolution) / (self.num_levels - 1)
            )
        return self.per_level_scale

    @property
    def output_dim(self) -> int:
        return self.num_levels * self.level_dim

    def level_meta(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """(offsets[num_levels+1], scales, resolutions, is_dense)."""
        max_params = 2 ** self.log2_hashmap_size
        offsets, scales, resolutions, dense = [0], [], [], []
        offset = 0
        for lvl in range(self.num_levels):
            scale = self.base_resolution * (self.scale_factor ** lvl) - 1.0
            res = int(math.ceil(scale)) + 1
            n_dense = (res + 1) ** self.input_dim
            params_in_level = int(math.ceil(min(max_params, n_dense) / 8) * 8)
            scales.append(scale)
            resolutions.append(res)
            dense.append(n_dense <= max_params)
            offset += params_in_level
            offsets.append(offset)
        return (np.array(offsets, dtype=np.int64), np.array(scales, dtype=np.float64),
                np.array(resolutions, dtype=np.int64), np.array(dense, dtype=bool))

    @property
    def n_params(self) -> int:
        return int(self.level_meta()[0][-1])


def init_hashgrid(generator: Optional[torch.Generator], spec: HashGridSpec,
                  std: float = 1e-4, device="cuda") -> torch.Tensor:
    """Embedding table init U(-std, std)."""
    u = torch.rand((spec.n_params, spec.level_dim), generator=generator,
                   device=resolve_device(device))
    return u * (2 * std) - std


def level_index(pgc: torch.Tensor, dense: bool, resolution: int, size: int) -> torch.Tensor:
    """Row index within a level of integer grid points pgc [..., 3] (int64)."""
    if dense:
        R1 = resolution + 1
        idx = (pgc[..., 0] + pgc[..., 1] * R1 + pgc[..., 2] * (R1 * R1)) & _U32
    else:
        idx = (
            ((pgc[..., 0] * PRIMES[0]) & _U32)
            ^ ((pgc[..., 1] * PRIMES[1]) & _U32)
            ^ ((pgc[..., 2] * PRIMES[2]) & _U32)
        )
    return idx % size


def hashgrid_encode(embeddings: torch.Tensor, x: torch.Tensor, spec: HashGridSpec,
                    bound: float = 1.0, stochastic_u: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """Encode x in [-bound, bound]^3 -> [N, num_levels*level_dim].

    stochastic_u: [N, 3] uniforms for the one-corner estimator (one triple
    per point, shared across levels); None = exact trilinear interpolation."""
    x01 = torch.clamp((x + bound) / (2.0 * bound), 0.0, 1.0)
    offsets, scales, resolutions, dense = spec.level_meta()
    corners = torch.as_tensor(CORNERS, device=x.device)                 # [8,3]
    cmask = corners == 1
    corners_zyx = corners.flip(1)
    feats = []
    for lvl in range(spec.num_levels):
        offset = int(offsets[lvl])
        size = int(offsets[lvl + 1] - offsets[lvl])
        pos = x01 * float(scales[lvl]) + 0.5
        pg = torch.floor(pos)
        frac = pos - pg
        pgi = pg.to(torch.int64)
        if stochastic_u is not None:
            pgc = pgi + (stochastic_u < frac).to(torch.int64)
            idx = level_index(pgc, bool(dense[lvl]), int(resolutions[lvl]), size)
            feats.append(embeddings[offset + idx])
            continue
        w = torch.where(cmask[None], frac[:, None, :], 1.0 - frac[:, None, :])
        w = w[..., 0] * w[..., 1] * w[..., 2]                           # [N,8]
        R1 = int(resolutions[lvl]) + 1
        packed = bool(dense[lvl]) and size >= R1 * R1 * R1
        pgc = pgi[:, None, :] + (corners_zyx if packed else corners)[None]   # [N,8,3]
        idx = level_index(pgc, bool(dense[lvl]), int(resolutions[lvl]), size)
        vals = embeddings[offset + idx]                                 # [N,8,C]
        feats.append(torch.sum(vals * w[..., None], dim=1))
    return torch.cat(feats, dim=-1)
