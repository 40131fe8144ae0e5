"""Hit record of every tracer (counterpart of the JAX ops/bvh.py HitResult;
the LBVH itself is not ported)."""

from __future__ import annotations

from typing import NamedTuple

import torch


class HitResult(NamedTuple):
    t: torch.Tensor        # [R] hit distance (inf if miss)
    prim: torch.Tensor     # [R] int64 original primitive id (-1 if miss)
    u: torch.Tensor        # [R] barycentric u
    v: torch.Tensor        # [R] barycentric v
    normal: torch.Tensor   # [R, 3] geometric normal (unnormalized cross)
