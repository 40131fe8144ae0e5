"""Tracing and structured metrics (counterpart of
mirres_restir_nerf_mesh_tpu/utils/profiling.py).

- ``trace(dir)``: a torch.profiler trace (CPU and, on a card, CUDA
  activity) written as a Chrome trace.  It runs only where it is asked
  for: once the profiler has run in a process, every later launch costs
  the host more.
- ``PhaseTimer``: wall-clock seconds per named phase; CUDA is synchronized
  at both edges of a phase, so a phase holds its device work.
- ``MetricsWriter``: append-only JSONL scalars, one record a line with the
  step and the seconds since the writer was made.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict
from typing import Dict, Iterator

import torch


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Profile the block; writes ``log_dir/trace.json`` (Chrome / Perfetto)."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class PhaseTimer:
    """Accumulates wall-clock seconds per named phase."""

    def __init__(self) -> None:
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        _sync()
        t0 = time.perf_counter()
        yield
        _sync()
        self.totals[name] += time.perf_counter() - t0
        self.counts[name] += 1

    def summary(self) -> str:
        parts = []
        for k in sorted(self.totals, key=lambda k: -self.totals[k]):
            avg = self.totals[k] / max(self.counts[k], 1)
            parts.append(f"{k}: {self.totals[k]:.2f}s total, {avg*1000:.1f}ms avg x{self.counts[k]}")
        return " | ".join(parts)


class MetricsWriter:
    """Append-only JSONL scalar log: one line per record with step + wall time."""

    def __init__(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.path = path
        self._t0 = time.time()

    def write(self, step: int, **scalars) -> None:
        rec = {"step": step, "t": round(time.time() - self._t0, 3)}
        rec.update({k: (float(v) if hasattr(v, "__float__") else v) for k, v in scalars.items()})
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")
