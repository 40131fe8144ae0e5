"""A tiny copy of the benchmark's cells for the CPU: the same BENCHMARK.json,
with the cells that wait for a fix of the program (``waiting/``) added,
traffic, limits, metric readers and peaks, with each configuration cut to a
size a test run can hold (4 hash levels of 2^12, 24 x 24 views, a
20,480-face mesh, spp 2, small ReSTIR tables)."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from benchmark.harness import spec

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
CELLS = [w["name"] for w in spec.with_waiting(ROOT)["workloads"]]

TINY_SET = {
    "stage1_train": {"hash_levels": 4, "hash_log2_size": 12, "spp": 2,
                     "restir_light_tile_count": 8, "restir_light_tile_size": 64,
                     "restir_initial_light_samples": 8, "restir_neighbor_offset_count": 256,
                     "env_h": 16, "env_w": 32},
    "stage0_train": {"hash_levels": 4, "hash_log2_size": 12, "num_rays": 256,
                     "num_points": 4096, "grid_size": 32},
}


def tiny_root(tmp: Path) -> Path:
    """A checkout-shaped directory under tmp holding the tiny cells."""
    bench = spec.with_waiting(ROOT)
    (tmp / "benchmark" / "configs").mkdir(parents=True)
    for sub in ("traffic", "limits", "metrics"):
        shutil.copytree(BENCH / sub, tmp / "benchmark" / sub)
    shutil.copy(BENCH / "peaks.json", tmp / "benchmark" / "peaks.json")
    for w in bench["workloads"]:
        c = next(c for c in bench["configs"] if c["name"] == w["config"])
        cfg = json.loads((ROOT / c["file"]).read_text())
        kind = json.loads((BENCH / "traffic" / f"{w['traffic']}.json").read_text())["kind"]
        cfg["set"] = {**cfg.get("set", {}), **TINY_SET[kind]}
        sc = cfg["scene"]
        sc.update(hw=24, views=3)
        if "mesh" in sc:
            sc["mesh"]["level"] = 5
        if "env" in sc:
            sc["env"].update(h=16, w=32)
        (tmp / c["file"]).write_text(json.dumps(cfg))
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    traffic = tmp / "benchmark" / "traffic"
    for p in traffic.glob("*.json"):      # a short settle for the tiny stage 0, to an update
        t = json.loads(p.read_text())
        if "settle_steps" in t:
            t["settle_steps"] = 16
            p.write_text(json.dumps(t))
    return tmp


def args(cell: str, seed: int = 2147483659, trace: int = 0):
    from benchmark import run

    return run.parse(["--workload", cell, "--seed", str(seed), "--seconds", "0.5",
                      "--trace", str(trace)])
