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

The exact encode reads its table rows through one ``GatherRows`` over the
absolute row ids of all levels ([N, 8L]): the forward is a plain row index
(the reference's ``jnp.take``), the backward one scatter-add into the whole
table, kernel K4 on the card (ops/scatter.py).  The one-corner encode is
``OneCornerEncode``: on the card kernel K5 (csrc/hashgrid_encode.cu) forms
the [N, L] row ids and gathers every level's features in one launch; on
the CPU its plain version (``encode_rows`` and the same row index) runs.
Its backward is the same K4 scatter-add, over the rows K5 wrote.  The
reference splits that backward per level, and sends its packed dense
levels through XLA's scatter, only because its MXU one-hot must fit VMEM;
atomics have no such limit and compute the same sums.
``hashgrid_tv_loss`` is formed over all levels at once (``tv_rows``: the
rows of every level in one pass, a fixed number of operators) and reads
them through one ``GatherRows`` as well, so its table gradient is one K4
launch too.
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass
from typing import Optional, Tuple

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


def _level_ints(spec: HashGridSpec) -> np.ndarray:
    """Each level's integer constants, [L, 6] int64: ``level_index``'s
    per-axis factors (1, R1, R1^2) on a dense level, the primes on a
    hashed one; dense (0 or 1); size; offset."""
    offsets, _, resolutions, dense = spec.level_meta()
    R1 = resolutions + 1
    mult = np.where(dense[:, None], np.stack([np.ones_like(R1), R1, R1 * R1], axis=1),
                    np.array(PRIMES, dtype=np.int64)[None])
    return np.concatenate([mult, dense[:, None], np.diff(offsets)[:, None], offsets[:-1, None]],
                          axis=1)


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
    if not 1 <= spec.num_levels <= MAX_LEVELS:
        raise ValueError(f"hashgrid_encode: K5 takes 1 to {MAX_LEVELS} levels, "
                         f"got {spec.num_levels}")
    ints = _level_ints(spec)
    blk = _LevelBlock(num_levels=spec.num_levels,
                      dense=sum(1 << lvl for lvl in range(spec.num_levels) if ints[lvl, 3]))
    for lvl, scale in enumerate(spec.level_meta()[1].astype(np.float32)):
        blk.scale[lvl] = scale
        blk.offset[lvl], blk.size[lvl] = int(ints[lvl, 5]), int(ints[lvl, 4])
        blk.mult[lvl][:] = [int(m) & _U32 for m in ints[lvl, 0:3]]
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


@functools.lru_cache(maxsize=None)
def _tv_levels(spec: HashGridSpec, device: torch.device) -> Tuple[torch.Tensor, ...]:
    """The TV loss's per-level constants on ``device``, made once per spec
    and device: (scales [L, 1, 1] float32, steps [4, 3] (base, +x, +y, +z),
    mult [L, 1, 3], dense [L, 1], sizes [L, 1], offsets [L, 1]), from
    ``_level_ints``."""
    count_upload("tv_levels", device)
    ints = torch.as_tensor(_level_ints(spec), dtype=torch.int64, device=device)[:, None]  # [L,1,6]
    count_upload("tv_levels", device)
    scales = torch.as_tensor(spec.level_meta()[1], dtype=torch.float32,
                             device=device)[:, None, None]
    steps = torch.cat([torch.zeros((1, 3), dtype=torch.int64, device=device),
                       torch.eye(3, dtype=torch.int64, device=device)])
    return (scales, steps, ints[..., 0:3], ints[..., 3] != 0, ints[..., 4], ints[..., 5])


def tv_rows(x: torch.Tensor, spec: HashGridSpec, bound: float = 1.0) -> torch.Tensor:
    """The rows the TV loss reads at points x [P, 3]: every level's base
    grid point and its +x, +y, +z neighbours, as ``level_index`` gives
    them, as [P, 4L] int32 absolute row ids, level-major.  All levels at
    once, in a number of operators that does not grow with the levels."""
    scales, steps, mult, dense, sizes, offsets = _tv_levels(spec, x.device)
    x01 = torch.clamp((x + bound) / (2.0 * bound), 0.0, 1.0)
    P = x01.shape[0]
    # x01 * scale and + 0.5 round apart, as in the encode; the sum is at
    # least 0.5, so the conversion's truncation is its floor
    pg = (x01.view(P, 1, 1, 3) * scales + 0.5).to(torch.int64)                 # [P,L,1,3]
    prod = (pg + steps).mul_(mult)                                             # [P,L,4,3]
    # a dense level masks the sum of the products, a hashed level xors the
    # masked products; masking after the xor is the same (& distributes
    # over ^)
    a, b, c = prod.unbind(-1)
    idx = torch.where(dense, prod.sum(-1), a ^ b ^ c)
    idx = idx.bitwise_and_(_U32).remainder_(sizes).add_(offsets)
    return idx.to(torch.int32).view(P, 4 * spec.num_levels)


def hashgrid_tv_loss(embeddings: torch.Tensor, x: torch.Tensor, spec: HashGridSpec,
                     bound: float = 1.0, max_points: int = 4096) -> torch.Tensor:
    """Total variation at sampled points: for the first max_points points'
    base grid point at every level, the mean squared difference to its +1
    neighbour along each axis, summed over levels and axes.

    Formed over all levels at once: the rows of ``tv_rows`` go through one
    ``GatherRows``, so the gradient is one scatter-add (K4 on the card),
    and the levels' and axes' means, which share the denominator P * C,
    are one sum of squares."""
    idx = tv_rows(x[:max_points], spec, bound)
    P, L, C = idx.shape[0], spec.num_levels, embeddings.shape[1]
    base, nbrs = GatherRows.apply(embeddings, idx).view(P, L, 4, C).split([1, 3], dim=2)
    return F.mse_loss(nbrs, base.expand_as(nbrs), reduction="sum") / (P * C)
