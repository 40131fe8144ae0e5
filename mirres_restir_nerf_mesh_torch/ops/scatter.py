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

import torch

_VP = ctypes.c_void_p


def scatter_add_plain(idx: torch.Tensor, upd: torch.Tensor, table_rows: int) -> torch.Tensor:
    """Plain PyTorch version of K4: zeros [table_rows, C] + index_add_ of the
    rows whose index lies in [0, table_rows)."""
    keep = (idx >= 0) & (idx < table_rows)
    out = torch.zeros((table_rows, upd.shape[1]), dtype=upd.dtype, device=upd.device)
    return out.index_add_(0, idx[keep].long(), upd[keep])


def _bind(lib):
    fn = lib.scatter_add_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [_VP, _VP, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, _VP, _VP]
    return fn


def _check_inputs(idx, upd, table_rows):
    if idx.device != upd.device:
        raise ValueError(f"scatter_add: idx on {idx.device}, upd on {upd.device}")
    if idx.dtype != torch.int32 or idx.dim() != 1:
        raise TypeError(f"scatter_add: idx must be [M] int32, got {idx.dtype} {tuple(idx.shape)}")
    if upd.dim() != 2 or upd.shape[0] != idx.shape[0]:
        raise ValueError(f"scatter_add: upd must be [M, C] with M = {idx.shape[0]}, "
                         f"got {tuple(upd.shape)}")
    if not upd.is_floating_point():
        raise TypeError(f"scatter_add: upd must be floating point, got {upd.dtype}")
    if upd.is_cuda and upd.dtype != torch.float32:
        raise TypeError(f"scatter_add: the kernel takes float32 updates, got {upd.dtype}")
    if not (0 <= table_rows < 2 ** 31):
        raise ValueError(f"scatter_add: table_rows {table_rows} out of the int32 range")


def scatter_add(idx: torch.Tensor, upd: torch.Tensor, table_rows: int) -> torch.Tensor:
    """idx [M] int32 (-1 = padding), upd [M, C] -> [table_rows, C], zero
    where no update lands."""
    _check_inputs(idx, upd, table_rows)
    if not upd.is_cuda:
        return scatter_add_plain(idx, upd, table_rows)
    from ..cuda_build import check, load, stream_ptr

    idx, upd = idx.contiguous(), upd.contiguous()
    if upd.data_ptr() % 8:      # the kernel reads a row of two as one float2
        upd = upd.clone()
    M, C = upd.shape
    out = torch.zeros((table_rows, C), dtype=torch.float32, device=upd.device)
    if M and table_rows:
        launch = _bind(load("scatter_add"))
        check(launch(idx.data_ptr(), upd.data_ptr(), M, table_rows, C, out.data_ptr(),
                     stream_ptr(upd.device)), "scatter_add")
        scatter_add.launches += 1
    return out


scatter_add.launches = 0
