"""Multi-resolution hash-grid encoder, forward (counterpart of
mirres_restir_nerf_mesh_tpu/ops/hashgrid.py).

The level layout is the reference's (dense levels with stride
resolution+1, xor-hashed levels with primes (1, 2654435761, 805459861)
modulo the level size), worked out once per grid spec (``HashGridSpec.layout``;
on a device, ``level_tensors``).  One formula, ``grid_rows``, maps every
level's integer grid points to table rows: the exact encode's 8 corners,
the one-corner encode's one and the TV loss's 4 points.  The one-corner
estimator picks corner bit ``u_d < frac_d`` per axis (unbiased; the bounce
material re-query uses it).  The reference's dense levels (table of at
least (resolution+1)^3 rows) read their corners through a packed-cell table
whose axes run (z, y, x) while the cell id runs (x, y, z): corner
(cx, cy, cz) there reads the table row of grid point (x+cz, y+cy, z+cx) and
weighs it as corner (cx, cy, cz); the layout's corner table keeps that
pairing so the features match.

The exact encode reads its rows through one ``GatherRows`` over every
level's row ids ([N, 8L]): the forward is a plain row index (the
reference's ``jnp.take``), the backward one scatter-add into the whole
table, kernel K4 on the card (ops/scatter.py).  The one-corner encode
(``OneCornerEncode``, kernel K5 on the card) and the TV loss take the same
K4 backward.  The reference splits that backward per level, and sends its
packed dense levels through XLA's scatter, only because its MXU one-hot
must fit VMEM; atomics have no such limit and compute the same sums.
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..cuda_build import check, stream_ptr
from ..device import resolve_device
from ..utils.profiling import count, count_upload
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

    @property
    @functools.lru_cache(maxsize=None)
    def layout(self) -> LevelLayout:
        """Every level's constants, worked out once per spec (equal specs
        share them)."""
        max_params = 2 ** self.log2_hashmap_size
        # a Python power a level, as the reference computes the scales
        scales = np.array([self.base_resolution * (self.scale_factor ** lvl) - 1.0
                           for lvl in range(self.num_levels)], dtype=np.float64)
        resolutions = np.ceil(scales).astype(np.int64) + 1
        R1 = resolutions + 1
        # R1^3 in Python integers (a fine level's overflows int64), capped past the table size
        n_dense = np.array([min(r ** self.input_dim, max_params + 1) for r in R1.tolist()])
        sizes = -(-np.minimum(max_params, n_dense) // 8) * 8
        dense = n_dense <= max_params
        packed = dense & (sizes >= n_dense)
        return LevelLayout(
            offsets=np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64), sizes=sizes,
            scales=scales, scales32=scales.astype(np.float32), resolutions=resolutions, dense=dense,
            mult=np.where(dense[:, None], np.stack([np.ones_like(R1), R1, R1 * R1], axis=1),
                          np.array(PRIMES, dtype=np.int64)),
            packed=packed, corners=np.where(packed[:, None, None], CORNERS[:, ::-1], CORNERS))

    @property
    def n_params(self) -> int:
        return int(self.layout.offsets[-1])


@dataclass(frozen=True, eq=False)
class LevelLayout:
    """Every level's constants, host arrays of [L] unless shaped otherwise."""

    offsets: np.ndarray      # int64 [L + 1]: level l owns rows offsets[l]:offsets[l + 1]
    sizes: np.ndarray        # int64: each level's rows, a multiple of 8
    scales: np.ndarray       # float64: the positions' scale, base * factor^l - 1
    scales32: np.ndarray     # float32: the scales rounded as every path multiplies by them
    resolutions: np.ndarray  # int64: ceil(scale) + 1
    dense: np.ndarray        # bool: a row for each grid point (else xor-hashed)
    mult: np.ndarray         # int64 [L, 3]: per-axis factors, (1, R1, R1^2) dense, PRIMES hashed
    packed: np.ndarray       # bool: dense with at least R1^3 rows, corners run (z, y, x)
    corners: np.ndarray      # int64 [L, 8, 3]: the grid-point offset corner k reads at level l


class LevelTensors(NamedTuple):
    """A layout's constants on one device, shaped to broadcast with [..., L, K, 3] grid points."""

    scales: torch.Tensor    # [L, 1, 1] float32
    mult: torch.Tensor      # [L, 1, 3] int64
    dense: torch.Tensor     # [L, 1] bool
    sizes: torch.Tensor     # [L, 1] int64
    offsets: torch.Tensor   # [L, 1] int64
    corners: torch.Tensor   # [L, 8, 3] int64, the layout's corner table
    steps: torch.Tensor     # [4, 3] int64: the TV loss's base point, +x, +y, +z


@functools.lru_cache(maxsize=None)
def level_tensors(spec: HashGridSpec, device: torch.device) -> LevelTensors:
    """The layout's ``LevelTensors`` on ``device``, made once per spec and
    device in two uploads."""
    lay, L = spec.layout, spec.num_levels
    ints = np.concatenate([lay.mult, lay.dense[:, None], lay.sizes[:, None],
                           lay.offsets[:-1, None], lay.corners.reshape(L, 24)], axis=1)
    count_upload("hashgrid_levels", device)
    ints = torch.as_tensor(ints, device=device)[:, None]                 # [L,1,30]
    count_upload("hashgrid_levels", device)
    scales = torch.as_tensor(lay.scales32, device=device).view(L, 1, 1)
    steps = torch.cat([torch.zeros((1, 3), dtype=torch.int64, device=device),
                       torch.eye(3, dtype=torch.int64, device=device)])
    return LevelTensors(scales, ints[..., 0:3], ints[..., 3] != 0, ints[..., 4], ints[..., 5],
                        ints[:, 0, 6:].reshape(L, 8, 3), steps)


def grid_rows(pg: torch.Tensor, steps: torch.Tensor, lv: LevelTensors) -> torch.Tensor:
    """The absolute row ids [..., L, K] int64 of the integer grid points
    ``pg + steps`` ([..., L, 1, 3] plus steps broadcasting to [..., L, K, 3]):
    a dense level's sum of the per-axis products, a hashed level's xor of
    them, masked to 32 bits, modulo the level's size, plus its offset.  The
    reference hashes in uint32 and lets products wrap; int64 products masked
    after the xor give the same bits (& distributes over ^)."""
    prod = (pg + steps).mul_(lv.mult)
    a, b, c = prod.unbind(-1)
    idx = torch.where(lv.dense, prod.sum(-1), a ^ b ^ c)
    return idx.bitwise_and_(_U32).remainder_(lv.sizes).add_(lv.offsets)


def init_hashgrid(generator: Optional[torch.Generator], spec: HashGridSpec,
                  std: float = 1e-4, device="cuda") -> torch.Tensor:
    """Embedding table init U(-std, std)."""
    u = torch.rand((spec.n_params, spec.level_dim), generator=generator,
                   device=resolve_device(device))
    return u * (2 * std) - std


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
    lv = level_tensors(spec, x.device)
    N, L = x.shape[0], spec.num_levels
    # clip as jnp.clip does: a point on the box face takes half the gradient
    # (it matters to the normal by autograd of a sample clamped to the box)
    x01 = (x + bound) / (2.0 * bound)
    x01 = torch.minimum(torch.maximum(x01, x01.new_zeros(())), x01.new_ones(()))
    pos = x01.view(N, 1, 1, 3) * lv.scales + 0.5                          # [N,L,1,3]
    pg = torch.floor(pos)
    frac = pos - pg
    pg = pg.to(torch.int64)
    if stochastic_u is not None:
        rows = grid_rows(pg, stochastic_u.reshape(N, 1, 1, 3) < frac, lv)
        return rows.to(torch.int32).view(N, L), None
    # two corners at a time: all eight at once would hold [N, L, 8, 3] int64
    # grid points, 3 KB a point at 16 levels, above the encode's peak
    rows = torch.cat([grid_rows(pg, c, lv).to(torch.int32) for c in lv.corners.split(2, dim=1)],
                     dim=2)
    # corner (cx, cy, cz) weighs (frac or 1 - frac by its bit) along x, y, z
    wx, wy, wz = torch.stack([1.0 - frac, frac], dim=-1).unbind(-2)      # [N,L,1,2]
    w = wx[..., :, None, None] * wy[..., None, :, None] * wz[..., None, None, :]
    return rows.view(N, 8 * L), w.view(N, L, 8)


MAX_LEVELS = 32


class _LevelBlock(ctypes.Structure):
    """K5's per-level constants, passed by value in its launch's parameters
    (``LevelBlock`` in csrc/hashgrid_encode.cu): scales rounded to fp32,
    level l dense where bit l of ``dense`` is set."""

    _fields_ = [("num_levels", ctypes.c_int), ("dense", ctypes.c_uint32),
                ("scale", ctypes.c_float * MAX_LEVELS), ("offset", ctypes.c_uint32 * MAX_LEVELS),
                ("size", ctypes.c_uint32 * MAX_LEVELS),
                ("mult", (ctypes.c_uint32 * 3) * MAX_LEVELS)]


@functools.lru_cache(maxsize=None)
def level_block(spec: HashGridSpec) -> _LevelBlock:
    """The ``_LevelBlock`` of a grid spec, made once per spec on the host."""
    L = spec.num_levels
    if not 1 <= L <= MAX_LEVELS:
        raise ValueError(f"hashgrid_encode: K5 takes 1 to {MAX_LEVELS} levels, got {L}")
    lay = spec.layout
    blk = _LevelBlock(num_levels=L, dense=sum(1 << lvl for lvl in range(L) if lay.dense[lvl]))
    blk.scale[:L] = lay.scales32.tolist()
    blk.offset[:L] = lay.offsets[:-1].tolist()
    blk.size[:L] = lay.sizes.tolist()
    for lvl in range(L):
        blk.mult[lvl][:] = (lay.mult[lvl] & _U32).tolist()
    return blk


@functools.lru_cache(maxsize=None)
def _k5():
    """K5's bound C entry, bound once."""
    from ..cuda_build import load

    launch = load("hashgrid_encode").hashgrid_encode_launch
    launch.restype = ctypes.c_int
    vp = ctypes.c_void_p
    launch.argtypes = [vp, vp, vp, ctypes.c_longlong, ctypes.c_float, ctypes.c_float,
                       ctypes.POINTER(_LevelBlock), vp, vp, vp]
    return launch


def one_corner_plain(table: torch.Tensor, x: torch.Tensor, u: torch.Tensor, spec: HashGridSpec,
                     bound: float = 1.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K5: ``encode_rows`` with ``stochastic_u`` and
    ``GatherRows``' row index -> (features [N, L*C], rows [N, L] int32)."""
    rows, _ = encode_rows(x, spec, bound, stochastic_u=u)
    feats = table.index_select(0, rows.reshape(-1))
    return feats.reshape(x.shape[0], spec.num_levels * table.shape[1]), rows


def one_corner_kernel(table: torch.Tensor, x: torch.Tensor, u: torch.Tensor, spec: HashGridSpec,
                      bound: float = 1.0, with_rows: bool = True
                      ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Launch K5 on the card -> (features [N, 2L] fp32, rows [N, L] int32,
    or None without ``with_rows``).  Raises on what K5 does not take."""
    blk = level_block(spec)
    if spec.level_dim != 2 or table.dim() != 2 or table.shape[1] != 2:
        raise ValueError(f"hashgrid_encode: K5 takes a [R, 2] table, got {tuple(table.shape)} "
                         f"for level_dim {spec.level_dim}")
    if not (table.device == x.device == u.device and table.is_cuda):
        raise ValueError(f"hashgrid_encode: table on {table.device}, x on {x.device}, "
                         f"stochastic_u on {u.device}; K5 takes all three on one card")
    if not (table.dtype == x.dtype == u.dtype == torch.float32):
        raise TypeError(f"hashgrid_encode: K5 takes float32, got table {table.dtype}, "
                        f"x {x.dtype}, stochastic_u {u.dtype}")
    if x.dim() != 2 or x.shape[1] != 3 or u.shape != x.shape:
        raise ValueError(f"hashgrid_encode: x and stochastic_u must be [N, 3], got "
                         f"{tuple(x.shape)} and {tuple(u.shape)}")
    if table.shape[0] < spec.n_params:
        raise ValueError(f"hashgrid_encode: the table has {table.shape[0]} rows, the grid "
                         f"{spec.n_params}")
    N, L = x.shape[0], spec.num_levels
    feats = torch.empty((N, 2 * L), dtype=torch.float32, device=x.device)
    rows = torch.empty((N, L), dtype=torch.int32, device=x.device) if with_rows else None
    if N:
        table = table.contiguous()
        if table.data_ptr() % 8:
            table = table.clone()
        x, u = x.contiguous(), u.contiguous()
        check(_k5()(x.data_ptr(), u.data_ptr(), table.data_ptr(), N, float(bound), 2.0 * bound,
                    ctypes.byref(blk), feats.data_ptr(), None if rows is None else rows.data_ptr(),
                    stream_ptr(x.device)), "hashgrid_encode")
        count("launches.hashgrid_encode")
    return feats, rows


class OneCornerEncode(torch.autograd.Function):
    """The one-corner encode of every level: (table [R, C], x [N, 3],
    u [N, 3], spec, bound, with_rows) -> features [N, L*C].  K5 on the
    card, ``one_corner_plain`` on the CPU.  Saves only the rows (written
    when ``with_rows``); the backward is ``GatherRows``' K4 scatter-add on
    the [points, levels] layout.  x and u get no gradient: the rows are
    integers."""

    @staticmethod
    def forward(ctx, table, x, u, spec, bound, with_rows):
        if table.is_cuda or x.is_cuda or u.is_cuda:
            feats, rows = one_corner_kernel(table, x, u, spec, bound, with_rows)
        else:
            feats, rows = one_corner_plain(table, x, u, spec, bound)
        if with_rows:
            ctx.save_for_backward(rows)
        ctx.n_rows = table.shape[0]
        return feats

    @staticmethod
    def backward(ctx, g):
        if not ctx.needs_input_grad[0]:
            return (None,) * 6
        (rows,) = ctx.saved_tensors
        upd = g.reshape(*rows.shape, g.shape[-1] // rows.shape[-1])
        return (scatter_add(rows, upd, ctx.n_rows),) + (None,) * 5


def hashgrid_encode(embeddings: torch.Tensor, x: torch.Tensor, spec: HashGridSpec,
                    bound: float = 1.0, stochastic_u: Optional[torch.Tensor] = None,
                    max_level=None) -> torch.Tensor:
    """Encode x in [-bound, bound]^3 -> [N, num_levels*level_dim].

    stochastic_u: [N, 3] uniforms for the one-corner estimator (one triple
    per point, shared across levels; ``OneCornerEncode``, K5 on the card);
    None = exact trilinear interpolation.
    max_level: levels >= max_level output zeros (progressive levels; an int
    or a scalar tensor)."""
    N, L, C = x.shape[0], spec.num_levels, embeddings.shape[1]
    if stochastic_u is not None:
        with_rows = torch.is_grad_enabled() and embeddings.requires_grad
        feats = OneCornerEncode.apply(embeddings, x, stochastic_u, spec, bound, with_rows)
        if max_level is None:
            return feats
        feats = feats.view(N, L, C)
    else:
        idx, w = encode_rows(x, spec, bound)
        vals = GatherRows.apply(embeddings, idx)                        # [N,8L,C]
        feats = torch.sum(vals.reshape(N, L, 8, C) * w[..., None], dim=2)
    if max_level is not None:
        lvl = torch.arange(L, device=x.device)
        count_upload("max_level", x.device, max_level)
        feats = feats * (lvl < torch.as_tensor(max_level, device=x.device)).to(feats.dtype)[:, None]
    return feats.reshape(N, L * C)


def tv_rows(x: torch.Tensor, spec: HashGridSpec, bound: float = 1.0) -> torch.Tensor:
    """The rows the TV loss reads at points x [P, 3]: every level's base
    grid point and its +x, +y, +z neighbours, as [P, 4L] int32 absolute row
    ids, level-major.  All levels at once, in a number of operators that
    does not grow with the levels."""
    lv = level_tensors(spec, x.device)
    x01 = torch.clamp((x + bound) / (2.0 * bound), 0.0, 1.0)
    P = x01.shape[0]
    # x01 * scale and + 0.5 round apart, as in the encode; the sum is at
    # least 0.5, so the conversion's truncation is its floor
    pg = (x01.view(P, 1, 1, 3) * lv.scales + 0.5).to(torch.int64)             # [P,L,1,3]
    return grid_rows(pg, lv.steps, lv).to(torch.int32).view(P, 4 * spec.num_levels)


def hashgrid_tv_loss(embeddings: torch.Tensor, x: torch.Tensor, spec: HashGridSpec,
                     bound: float = 1.0, max_points: int = 4096) -> torch.Tensor:
    """Total variation at sampled points: for the first max_points points'
    base grid point at every level, the mean squared difference to its +1
    neighbour along each axis, summed over levels and axes.

    Formed over all levels at once: the rows of ``tv_rows`` go through one
    ``GatherRows``, so the gradient is one scatter-add (K4 on the card),
    and the levels' and axes' means, which share the denominator P * C,
    are one sum of squares."""
    return tv_loss_of_rows(embeddings, tv_rows(x[:max_points], spec, bound), spec)


def tv_loss_of_rows(embeddings: torch.Tensor, idx: torch.Tensor,
                    spec: HashGridSpec) -> torch.Tensor:
    """``hashgrid_tv_loss`` from the rows ``tv_rows`` gives."""
    P, L, C = idx.shape[0], spec.num_levels, embeddings.shape[1]
    base, nbrs = GatherRows.apply(embeddings, idx).view(P, L, 4, C).split([1, 3], dim=2)
    return F.mse_loss(nbrs, base.expand_as(nbrs), reduction="sum") / (P * C)
