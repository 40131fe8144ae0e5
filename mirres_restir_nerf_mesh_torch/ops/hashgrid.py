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
port reproduces that pairing so the features match.

Every table row an encode reads goes through one ``GatherRows`` over the
absolute row ids of all levels ([N, 8L] exact, [N, L] stochastic): the
forward is a plain row index (the reference's ``jnp.take``), the backward
one scatter-add into the whole table, kernel K4 on the card
(ops/scatter.py).  The reference splits that backward per level, and sends
its packed dense levels through XLA's scatter, only because its MXU one-hot
must fit VMEM; atomics have no such limit and compute the same sums.
``hashgrid_tv_loss`` reads all its rows through one ``GatherRows`` as well,
so its table gradient is one K4 launch too.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..utils.profiling import count_upload
from .scatter import scatter_add

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


class GatherRows(torch.autograd.Function):
    """table [R, C], idx [...] int32 absolute row ids -> table[idx] [..., C]
    (counterpart of the reference's ``_gather_rows_multi``).  Saves only the
    index; the backward scatter-adds the incoming gradient into a zeroed
    [R, C] table with ``scatter_add`` (K4 on the card), passing the index's
    [points, columns] layout."""

    @staticmethod
    def forward(ctx, table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(idx)
        ctx.n_rows = table.shape[0]
        return table.index_select(0, idx.reshape(-1)).reshape(*idx.shape, table.shape[1])

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        (idx,) = ctx.saved_tensors
        if not ctx.needs_input_grad[0]:
            return None, None
        # [points, columns]: K4 groups equal rows of one column (one level's corner)
        cols = idx.reshape(-1, idx.shape[-1]) if idx.dim() >= 2 else idx
        return scatter_add(cols, g.reshape(*cols.shape, g.shape[-1]), ctx.n_rows), None


def encode_rows(x: torch.Tensor, spec: HashGridSpec, bound: float = 1.0,
                stochastic_u: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The table rows an encode reads: (rows [N, 8L] int32 absolute row ids,
    level-major, and the trilinear weights [N, L, 8]) on the exact path,
    (rows [N, L], None) on the stochastic one."""
    # clip as jnp.clip does: a point on the box face takes half the gradient
    # (it matters to the normal by autograd of a sample clamped to the box)
    x01 = (x + bound) / (2.0 * bound)
    x01 = torch.minimum(torch.maximum(x01, x01.new_zeros(())), x01.new_ones(()))
    offsets, scales, resolutions, dense = spec.level_meta()
    count_upload("hashgrid_corners", x.device)
    corners = torch.as_tensor(CORNERS, device=x.device)                 # [8,3]
    cmask = corners == 1
    corners_zyx = corners.flip(1)
    rows, weights = [], []
    for lvl in range(spec.num_levels):
        offset = int(offsets[lvl])
        size = int(offsets[lvl + 1] - offsets[lvl])
        pos = x01 * float(scales[lvl]) + 0.5
        pg = torch.floor(pos)
        frac = pos - pg
        pgi = pg.to(torch.int64)
        if stochastic_u is not None:
            pgc = pgi + (stochastic_u < frac).to(torch.int64)
            rows.append(offset + level_index(pgc, bool(dense[lvl]), int(resolutions[lvl]), size)[:, None])
            continue
        w = torch.where(cmask[None], frac[:, None, :], 1.0 - frac[:, None, :])
        weights.append(w[..., 0] * w[..., 1] * w[..., 2])               # [N,8]
        R1 = int(resolutions[lvl]) + 1
        packed = bool(dense[lvl]) and size >= R1 * R1 * R1
        pgc = pgi[:, None, :] + (corners_zyx if packed else corners)[None]   # [N,8,3]
        rows.append(offset + level_index(pgc, bool(dense[lvl]), int(resolutions[lvl]), size))
    idx = torch.cat(rows, dim=1).to(torch.int32)
    return idx, (torch.stack(weights, dim=1) if weights else None)


def hashgrid_encode(embeddings: torch.Tensor, x: torch.Tensor, spec: HashGridSpec,
                    bound: float = 1.0, stochastic_u: Optional[torch.Tensor] = None,
                    max_level=None) -> torch.Tensor:
    """Encode x in [-bound, bound]^3 -> [N, num_levels*level_dim].

    stochastic_u: [N, 3] uniforms for the one-corner estimator (one triple
    per point, shared across levels); None = exact trilinear interpolation.
    max_level: levels >= max_level output zeros (progressive levels; an int
    or a scalar tensor)."""
    N, L, C = x.shape[0], spec.num_levels, embeddings.shape[1]
    idx, w = encode_rows(x, spec, bound, stochastic_u)
    vals = GatherRows.apply(embeddings, idx)                            # [N,K,C]
    if w is None:
        feats = vals.reshape(N, L, C)
    else:
        feats = torch.sum(vals.reshape(N, L, 8, C) * w[..., None], dim=2)
    if max_level is not None:
        lvl = torch.arange(L, device=x.device)
        count_upload("max_level", x.device, max_level)
        feats = feats * (lvl < torch.as_tensor(max_level, device=x.device)).to(feats.dtype)[:, None]
    return feats.reshape(N, L * C)


def hashgrid_tv_loss(embeddings: torch.Tensor, x: torch.Tensor, spec: HashGridSpec,
                     bound: float = 1.0, max_points: int = 4096) -> torch.Tensor:
    """Total variation at sampled points: for the first max_points points'
    base grid point at every level, the mean squared difference to its +1
    neighbour along each axis, summed over levels and axes.  The 4 rows a
    level reads per point (base, +x, +y, +z) of all levels go through one
    ``GatherRows`` ([P, 4L] absolute row ids), so the gradient is one
    scatter-add (K4 on the card)."""
    x = x[:max_points]
    x01 = torch.clamp((x + bound) / (2.0 * bound), 0.0, 1.0)
    offsets, scales, resolutions, dense = spec.level_meta()
    count_upload("tv_steps", x.device)
    steps = torch.tensor([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]], device=x.device)
    cols = []
    for lvl in range(spec.num_levels):
        size = int(offsets[lvl + 1] - offsets[lvl])
        pg = torch.floor(x01 * float(scales[lvl]) + 0.5).to(torch.int64)
        pgc = pg[:, None, :] + steps[None]                                  # [P,4,3]
        cols.append(int(offsets[lvl]) +
                    level_index(pgc, bool(dense[lvl]), int(resolutions[lvl]), size))
    vals = GatherRows.apply(embeddings, torch.cat(cols, dim=1).to(torch.int32))   # [P,4L,C]
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for lvl in range(spec.num_levels):
        base = vals[:, 4 * lvl]
        for d in range(1, 4):
            total = total + torch.mean((vals[:, 4 * lvl + d] - base) ** 2)
    return total
