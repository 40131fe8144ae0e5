"""Stage-0 trainer (counterpart of mirres_restir_nerf_mesh_tpu/train/stage0.py).

Ported so far: ``lr_schedule``, which the stage-1 optimizer shares.  The
stage-0 step comes with stage 0.
"""

from __future__ import annotations

import torch

from ..config import Config


def lr_schedule(cfg: Config):
    """Warmup to step 500, then exponential decay to 0.1x at cfg.iters; the
    step is an int, the factor a float32 scalar tensor (as the reference
    evaluates it)."""
    iters = cfg.iters

    def fn(step) -> torch.Tensor:
        s = torch.as_tensor(step, dtype=torch.float32)
        warm = 0.01 + 0.99 * (s / 500.0)
        decay = 0.1 ** ((s - 500.0) / max(iters - 500.0, 1.0))
        return torch.where(s <= 500, warm, decay)

    return fn
