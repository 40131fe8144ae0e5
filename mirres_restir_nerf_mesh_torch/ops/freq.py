"""Frequency (sin/cos positional) encoder (counterpart of
mirres_restir_nerf_mesh_tpu/ops/freq.py): per input the layout is
[x, sin(2^0 x), cos(2^0 x), ..., sin(2^{L-1} x), cos(2^{L-1} x)]."""

from __future__ import annotations

import torch


def freq_encode(x: torch.Tensor, degree: int = 12) -> torch.Tensor:
    """x [..., D] -> [..., D * (1 + 2 * degree)]."""
    outs = [x]
    for i in range(degree):
        s = x * (2.0 ** i)
        outs += [torch.sin(s), torch.cos(s)]
    return torch.cat(outs, dim=-1)
