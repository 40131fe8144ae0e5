"""Morton (Z-order) codes (counterpart of mirres_restir_nerf_mesh_tpu/ops/morton.py).

The reference computes in uint32 and lets products wrap; here the values
ride in int64 and every step masks to 32 bits, which gives the same codes.
"""

from __future__ import annotations

import torch

_U32 = 0xFFFFFFFF


def _expand_bits(v: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of v out to every third bit."""
    v = (v * 0x00010001) & 0xFF0000FF
    v = (v * 0x00000101) & 0x0F00F00F
    v = (v * 0x00000011) & 0xC30C30C3
    v = (v * 0x00000005) & 0x49249249
    return v


def morton3d(coords: torch.Tensor) -> torch.Tensor:
    """coords [..., 3] int in [0, 1024) -> [...] int64 holding the uint32 code."""
    c = coords.to(torch.int64) & _U32
    code = (
        _expand_bits(c[..., 0])
        | (_expand_bits(c[..., 1]) << 1)
        | (_expand_bits(c[..., 2]) << 2)
    )
    return code & _U32
