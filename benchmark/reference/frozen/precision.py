"""The control's precision switch: with ``lowered(True)`` the MLPs of the
radiance field and the material field round their inputs and weights
through float8 e4m3 (the precision below the configuration's bfloat16)
before each product, each tensor scaled by its largest magnitude over
448 (e4m3's largest normal) as a float8 product would scale it; the
gradient passes the rounding unchanged (straight through)."""

from __future__ import annotations

import contextlib

import torch

_STATE = {"fp8": False}


def q(x: torch.Tensor) -> torch.Tensor:
    """x itself, or x rounded through scaled float8 e4m3 in x's dtype."""
    if not _STATE["fp8"]:
        return x
    with torch.no_grad():
        s = torch.clamp_min(x.abs().amax().float(), 1e-30) / 448.0
        r = ((x.float() / s).to(torch.float8_e4m3fn).float() * s).to(x.dtype)
    return x + (r - x).detach()


@contextlib.contextmanager
def lowered(on: bool):
    old = _STATE["fp8"]
    _STATE["fp8"] = bool(on)
    try:
        yield
    finally:
        _STATE["fp8"] = old
