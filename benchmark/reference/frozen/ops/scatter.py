"""Scatter-add of update rows into a zeroed table: the plain version of
kernel K4 (``index_add_``), the backward of the hash-grid row gather."""

from __future__ import annotations

import torch


def scatter_add(idx: torch.Tensor, upd: torch.Tensor, table_rows: int) -> torch.Tensor:
    """zeros [table_rows, C] + index_add_ of the rows whose index lies in
    [0, table_rows).  idx [M] or [N, Kc] (then upd [N, Kc, C] or
    [N * Kc, C])."""
    idx = idx.reshape(-1)
    upd = upd.reshape(idx.shape[0], upd.shape[-1])
    keep = (idx >= 0) & (idx < table_rows)
    out = torch.zeros((table_rows, upd.shape[1]), dtype=upd.dtype, device=upd.device)
    return out.index_add_(0, idx[keep].long(), upd[keep])
