"""The result line and the checks printed beside their limits."""

from __future__ import annotations

import json
import sys
from typing import Dict, Optional

FORBIDDEN = ("jax", "jaxlib", "flax", "mirres_restir_nerf_mesh_tpu")


def forbidden_modules(modules=None) -> list:
    """Top-level names of loaded modules that the benchmark may not load,
    compared whole (the part before the first dot)."""
    mods = sys.modules if modules is None else modules
    tops = {m.split(".", 1)[0] for m in mods}
    return sorted(t for t in FORBIDDEN if t in tops)


def checks_block(readings: Dict[str, Optional[float]], limits: Dict[str, float]) -> Dict:
    """{name: {"value", "limit"}} in the limits' order; a reading that is
    missing is null (and fails)."""
    return {k: {"value": readings.get(k), "limit": lim} for k, lim in limits.items()}


def passed(block: Dict) -> bool:
    return all(v["value"] is not None and v["value"] <= v["limit"] for v in block.values())


def line(correct: bool, attempted: int, failed: int, metrics: Dict[str, Dict],
         device: Dict, breakdown: Optional[Dict], checks: Dict) -> str:
    out = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
           "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return json.dumps(out)


def print_checks(block: Dict, why: str = "") -> None:
    """The compared numbers beside their limits, as the last lines on
    standard error."""
    if why:
        print(f"check: {why}", file=sys.stderr)
    for k, v in block.items():
        print(f"check {k}: {v['value']} (limit {v['limit']})", file=sys.stderr)
    sys.stderr.flush()
