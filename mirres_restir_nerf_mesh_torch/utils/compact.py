"""Live-lane compaction (counterpart of mirres_restir_nerf_mesh_tpu/utils/compact.py
``masked_apply``).

The reference sorts live lanes first and runs fixed chunks under lax.cond
because XLA needs static shapes.  Eager PyTorch takes the live lanes by
boolean index and runs the payload once on them; dead lanes get the same
constant fills.  Randoms ride as ordinary row-wise args, so the compacted
call equals the full-width call on live lanes.  ``apply_in_chunks`` bounds
the temporaries of a wide rowwise payload.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from .profiling import count_sync


def masked_apply(fn: Callable, mask: torch.Tensor, args: Sequence[torch.Tensor],
                 fills: Sequence[float], chunks: int = 4, total_rows: Optional[int] = None):
    """Apply a rowwise ``fn(*args) -> out or (out1, ...)`` ([P, C_j] outputs)
    to the live rows only.  chunks <= 1 (or P not divisible by chunks, as in
    the reference) disables compaction: a plain call.  total_rows: the row
    count that rule reads (default P; the whole frame's when these rows are
    one rank's band)."""
    P = mask.shape[0]
    if chunks <= 1 or (P if total_rows is None else total_rows) % chunks != 0:
        return fn(*args)
    count_sync("compact_live", mask.is_cuda)
    live = torch.nonzero(mask)[:, 0]
    outs = fn(*(a[live] for a in args))
    single = not isinstance(outs, tuple)
    res = []
    for o, f in zip((outs,) if single else outs, fills):
        full = torch.full((P,) + tuple(o.shape[1:]), f, dtype=o.dtype, device=o.device)
        res.append(full.index_put((live,), o))
    return res[0] if single else tuple(res)


def apply_in_chunks(fn: Callable, args: Sequence[torch.Tensor], rows: int):
    """Rowwise ``fn(*args) -> (out1, ...)`` over chunks of at most ``rows``
    rows, outputs concatenated: the same result with bounded temporaries."""
    N = args[0].shape[0]
    if N <= rows:
        return fn(*args)
    parts = [fn(*(a[i:i + rows] for a in args)) for i in range(0, N, rows)]
    return tuple(torch.cat(p, dim=0) for p in zip(*parts))
