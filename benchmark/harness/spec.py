"""Finding a cell and everything it names, by name, under the benchmark's
folders: ``BENCHMARK.json`` at the root of the checkout, the configuration
``file`` it names, ``traffic/<traffic>.json``, ``limits/<cell>.json`` and a
reader ``metrics/<name>.py`` for each metric (or ``metrics/<base>.py``,
``<base>`` being the name before its first dot, which then serves every
metric of that base).  A new configuration, traffic mix, limit set or
metric is a new file; nothing here lists them.  ``waiting/<cell>.json``
holds the entries of a cell that waits for a fix of the program; only the
harness's tests and tools read it."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


class SpecError(RuntimeError):
    pass


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def benchmark_json(root: Path = ROOT) -> Dict:
    p = root / "BENCHMARK.json"
    if not p.exists():
        raise SpecError(f"no BENCHMARK.json at {root}")
    return load_json(p)


def with_waiting(root: Path = ROOT) -> Dict:
    """BENCHMARK.json with the entries of each ``waiting/<cell>.json`` (a
    cell that waits for a fix of the program) added: for the harness's
    tests and tools, never for a run.

    A waiting entry whose ``name`` BENCHMARK.json already has under the same
    key is skipped, so each name stands once.  A cell therefore moves in by
    appending its entries to BENCHMARK.json alone; its waiting file may stay
    until it is pruned."""
    bench = benchmark_json(root)
    out = {k: list(v) if isinstance(v, list) else v for k, v in bench.items()}
    for p in sorted((root / "benchmark" / "waiting").glob("*.json")):
        w = load_json(p)
        for key in ("configs", "workloads", "end_to_end", "per_layer"):
            have = {e["name"] for e in out[key]}
            out[key] = out[key] + [e for e in w.get(key, []) if e["name"] not in have]
    return out


def cell(bench: Dict, name: str) -> Dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SpecError(f"no workload named {name!r} in BENCHMARK.json")


def config(bench: Dict, name: str, root: Path = ROOT) -> Dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return load_json(root / c["file"])
    raise SpecError(f"no configuration named {name!r} in BENCHMARK.json")


def traffic(name: str, bench_dir: Path = BENCH_DIR) -> Dict:
    p = bench_dir / "traffic" / f"{name}.json"
    if not p.exists():
        raise SpecError(f"no traffic file {p}")
    return load_json(p)


def limits(cell_name: str, bench_dir: Path = BENCH_DIR) -> Dict[str, float]:
    p = bench_dir / "limits" / f"{cell_name}.json"
    if not p.exists():
        raise SpecError(f"no limits file {p}")
    return {k: float(v["limit"]) for k, v in load_json(p)["limits"].items()}


def metrics_of(bench: Dict, cell_name: str, trace: bool) -> List[Dict]:
    """The metrics a run of the cell reports: its end-to-end metrics with
    --trace 0, its per-layer metrics with --trace 1 (an entry without a
    ``workloads`` key belongs to every cell)."""
    key = "per_layer" if trace else "end_to_end"
    return [m for m in bench[key] if cell_name in m.get("workloads", [cell_name])]


def reader(name: str, bench_dir: Path = BENCH_DIR) -> ModuleType:
    """The reader module of a metric: metrics/<name>.py, else
    metrics/<base>.py."""
    base = name.split(".", 1)[0]
    for stem in (name, base):
        p = bench_dir / "metrics" / f"{stem}.py"
        if p.exists():
            spec = importlib.util.spec_from_file_location(f"benchmark_metric_{stem}", p)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod
    raise SpecError(f"no reader for metric {name!r} under {bench_dir / 'metrics'}")


def read_metric(name: str, ctx, bench_dir: Path = BENCH_DIR) -> Optional[float]:
    """The metric's value from its reader, or None when it finds nothing."""
    v = reader(name, bench_dir).read(name, ctx)
    return None if v is None else float(v)
