"""Scatter-add of update rows into a zeroed table: kernel K4 (counterpart of
mirres_restir_nerf_mesh_tpu/ops/pallas_scatter.py ``pallas_scatter_add``),
the backward of the hash-grid row gather (ops/hashgrid.py ``GatherRows``).

``scatter_add`` launches the CUDA kernel (csrc/scatter_add.cu) for tensors
on the card and runs ``scatter_add_plain`` for tensors on the CPU; on the
card the plain version serves only as the yardstick of correctness.
Semantics of both: ``out[idx[i]] += upd[i]`` in the update's dtype (fp32 on
the card), rows with ``idx < 0`` (padding) or ``idx >= table_rows`` dropped.
The TPU kernel rounds each update to bf16 for its MXU product; the port
computes the fp32 sum that the reference's CPU path (``.at[].add``) gives.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..cuda_build import check, stream_ptr
from ..utils.profiling import count

_VP = ctypes.c_void_p


def scatter_add_plain(idx: torch.Tensor, upd: torch.Tensor, table_rows: int) -> torch.Tensor:
    """Plain PyTorch version of K4: zeros [table_rows, C] + index_add_ of the
    rows whose index lies in [0, table_rows).  idx [M] or [N, Kc] (then
    upd [N, Kc, C] or [N * Kc, C])."""
    idx = idx.reshape(-1)
    upd = upd.reshape(idx.shape[0], upd.shape[-1])
    keep = (idx >= 0) & (idx < table_rows)
    out = torch.zeros((table_rows, upd.shape[1]), dtype=upd.dtype, device=upd.device)
    return out.index_add_(0, idx[keep].long(), upd[keep])


@functools.lru_cache(maxsize=None)
def _kernel():
    """The bound C entries (launch, shared-memory size), bound once."""
    from ..cuda_build import load

    lib = load("scatter_add")
    launch = lib.scatter_add_launch
    launch.restype = ctypes.c_int
    launch.argtypes = [_VP, _VP, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       _VP, _VP]
    smem = lib.scatter_add_smem
    smem.restype = ctypes.c_longlong
    smem.argtypes = [ctypes.c_int, ctypes.c_int]
    return launch, smem


def _check_inputs(idx, upd, table_rows):
    if idx.device != upd.device:
        raise ValueError(f"scatter_add: idx on {idx.device}, upd on {upd.device}")
    if idx.dtype != torch.int32 or idx.dim() not in (1, 2):
        raise TypeError(f"scatter_add: idx must be [M] or [N, Kc] int32, got {idx.dtype} "
                        f"{tuple(idx.shape)}")
    if upd.dim() not in (2, 3) or upd.shape[:-1].numel() != idx.numel() or \
            (upd.dim() == 3 and upd.shape[:2] != idx.shape):
        raise ValueError(f"scatter_add: upd must be [M, C] (or [N, Kc, C]) with M = {idx.numel()}, "
                         f"got {tuple(upd.shape)}")
    if not upd.is_floating_point():
        raise TypeError(f"scatter_add: upd must be floating point, got {upd.dtype}")
    if upd.is_cuda and upd.dtype != torch.float32:
        raise TypeError(f"scatter_add: the kernel takes float32 updates, got {upd.dtype}")
    if not (0 <= table_rows < 2 ** 31):
        raise ValueError(f"scatter_add: table_rows {table_rows} out of the int32 range")


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """x contiguous with a 16-byte aligned start (the kernel's vector loads)."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def scatter_add_into(out: torch.Tensor, idx: torch.Tensor, upd: torch.Tensor) -> None:
    """Launch K4 on the card: out [rows, C] += the updates (no zeroing, no
    counting; ``scatter_add`` is the entry point).  idx [M] or [N, Kc]:
    with the column layout a warp groups equal rows of one column."""
    launch, smem = _kernel()
    C = upd.shape[-1]
    Kc = idx.shape[1] if idx.dim() == 2 else 1
    if smem(Kc, C) == 0:     # too wide for one block: the 1-D layout
        Kc = 1
    if smem(Kc, C) == 0:
        raise ValueError(f"scatter_add: {C} channels do not fit the kernel's block")
    N = idx.numel() // Kc
    idx, upd = _aligned(idx), _aligned(upd)
    if N and out.shape[0]:
        check(launch(idx.data_ptr(), upd.data_ptr(), N, Kc, C, out.shape[0], out.data_ptr(),
                     stream_ptr(upd.device)), "scatter_add")


def scatter_add(idx: torch.Tensor, upd: torch.Tensor, table_rows: int) -> torch.Tensor:
    """idx [M] int32 (-1 = padding), upd [M, C] -> [table_rows, C], zero
    where no update lands.  idx may also come as [N, Kc] (an encode's
    points x columns, upd [N, Kc, C] or [N * Kc, C]): the kernel then
    groups equal rows column by column."""
    _check_inputs(idx, upd, table_rows)
    if not upd.is_cuda:
        return scatter_add_plain(idx, upd, table_rows)
    out = torch.zeros((table_rows, upd.shape[-1]), dtype=torch.float32, device=upd.device)
    if idx.numel() and table_rows:
        scatter_add_into(out, idx, upd)
        count("launches.scatter_add")
    return out
