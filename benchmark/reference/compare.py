"""The numbers that decide ``correct`` for a training cell, from the
program's readings and the reference's over the same first steps:

- ``loss``: the widest relative gap of a step's loss;
- ``grad``: the worst leaf's gap between the norms of the first gradient
  as the optimizer got it (program: its first Adam moment after one step
  / (1 - b1); reference: the same), over the larger of the reference's
  norm of that leaf and of the median leaf;
- ``change``: the same of the parameters' change over the followed steps,
  leaving out leaves whose reference gradient is under a thousandth of the
  median leaf's (they move under Adam by round-off alone);
- ``hits`` / ``occlusions``: the share of the sampled closest hits / the
  sampled occlusion answers of the program's tracer that the brute force
  contradicts, drawn among all live rays (those the tracer marked
  uncertain included);
- ``grid`` (stage 0): the relative L2 gap of the occupancy density grid
  after the first update;
- ``<number>.settled`` (stage 0): the same numbers over the steps followed
  at the window's batch, after the settle steps.
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Optional

import torch

GROUP_ORDER = ("net", "vert", "mat", "mat_enc", "light")


def flat(by_group: Dict[str, List[float]]) -> List[float]:
    return [x for g in GROUP_ORDER if g in by_group for x in by_group[g]]


def worst_leaf_gap(prog: List[float], ref: List[float], keep: Optional[List[bool]] = None) -> float:
    if len(prog) != len(ref):
        return float("inf")
    keep = keep or [True] * len(ref)
    kept = [r for r, k in zip(ref, keep) if k]
    if not kept:
        return 0.0
    med = statistics.median(kept)
    gaps = [abs(p - r) / max(r, med) if max(r, med) > 0 else abs(p - r)
            for p, r, k in zip(prog, ref, keep) if k]
    return max(gaps)


def loss_gap(prog: List[float], ref: List[float]) -> float:
    if len(prog) != len(ref):
        return float("inf")
    return max(abs(p - r) / max(abs(r), 1e-30) for p, r in zip(prog, ref))


def grid_gap(prog: torch.Tensor, ref: torch.Tensor) -> float:
    p, r = prog.double().flatten(), ref.double().flatten()
    return float(torch.linalg.vector_norm(p - r) / torch.clamp_min(torch.linalg.vector_norm(r),
                                                                    1e-30))


def readings(program: Dict, reference: Dict) -> Dict[str, float]:
    g_ref = flat(reference["grad_norms"])
    med = statistics.median(g_ref)
    keep = [g >= 1e-3 * med for g in g_ref]
    out = {
        "loss": loss_gap(program["losses"], reference["losses"]),
        "grad": worst_leaf_gap(flat(program["grad_norms"]), g_ref),
        "change": worst_leaf_gap(flat(program["change_norms"]), flat(reference["change_norms"]),
                                 keep),
    }
    for k in ("hits", "occlusions"):
        if f"{k}_wrong_share" in reference:
            out[k] = reference[f"{k}_wrong_share"]
    if "density_grid" in program and "density_grid" in reference:
        out["grid"] = grid_gap(program["density_grid"], reference["density_grid"])
    if "settled" in program and "settled" in reference:
        for k, v in readings(program["settled"], reference["settled"]).items():
            out[f"{k}.settled"] = v
    return out


def leaf_gaps(program: Dict, reference: Dict) -> Dict[str, List[float]]:
    """Each leaf's gap of the first gradient's norm and of the change's norm
    (the terms whose worst is ``grad`` / ``change``), for a look at the
    readings."""
    out = {}
    for key in ("grad_norms", "change_norms"):
        p, r = flat(program[key]), flat(reference[key])
        med = statistics.median(r) if r else 0.0
        out[key] = [abs(a - b) / max(b, med) if max(b, med) > 0 else abs(a - b)
                    for a, b in zip(p, r)]
    return out
