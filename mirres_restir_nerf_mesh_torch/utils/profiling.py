"""Spans, counters and structured metrics (counterpart of
mirres_restir_nerf_mesh_tpu/utils/profiling.py).

- ``span(name)``: a ``torch.profiler.record_function`` range while the
  profiler runs, else a shared no-op context.  A range is a
  ``user_annotation`` event of the same Chrome trace as the kernels, so
  spans and device work share one clock.  Off, a span costs a check of
  the profiler's state: 0.3-0.6 us on an H100 machine's host, where a
  bare ``record_function`` costs 8-11 us.
- ``count(name, n)``, ``counters()``, ``reset_counters()``: one registry
  of host integers, always on: kernel launches (``launches.<wrapper>``),
  train steps (``steps.stage0``, ``steps.stage1``) and device-to-host
  synchronizations (``sync.<site>``).
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
from typing import ContextManager, Dict, Iterator

import torch
from torch.profiler import record_function

_OFF = contextlib.nullcontext()
_profiler_enabled = torch._C._autograd._profiler_enabled


def span(name: str) -> ContextManager:
    """A profiler range named ``name`` while the profiler runs, else a
    no-op."""
    return record_function(name) if _profiler_enabled() else _OFF


_COUNTS: Dict[str, int] = defaultdict(int)


def count(name: str, n: int = 1) -> None:
    """Add n to the registry's counter ``name``."""
    _COUNTS[name] += n


def count_sync(site: str, on_card: bool, n: int = 1) -> None:
    """Count n device-to-host synchronizations at ``site`` (``sync.<site>``)
    where they happen: on a card."""
    if on_card:
        _COUNTS["sync." + site] += n


def count_upload(site: str, device, x=None) -> None:
    """Count the synchronization of a blocking copy of host data to
    ``device`` (``sync.<site>``) where it is a card; ``x``, where given, is
    what is copied, and one already on a card is not copied."""
    dev = device if isinstance(device, torch.device) else torch.device(device)
    if dev.type == "cuda" and not (isinstance(x, torch.Tensor) and x.is_cuda):
        _COUNTS["sync." + site] += 1


def counters() -> Dict[str, int]:
    """A copy of every counter."""
    return dict(_COUNTS)


def reset_counters() -> None:
    _COUNTS.clear()


def rates(now: Dict[str, int], before: Dict[str, int], steps: str) -> Dict[str, float]:
    """Syncs and launches a step between two ``counters()`` readings: the
    ``sync.*`` and ``launches.*`` totals over the change of ``steps``; {}
    when no step was taken."""
    n = now.get(steps, 0) - before.get(steps, 0)
    if n <= 0:
        return {}
    out = {}
    for prefix in ("sync", "launches"):
        tot = sum(v - before.get(k, 0) for k, v in now.items() if k.startswith(prefix + "."))
        out[f"{prefix}_per_step"] = tot / n
    return out


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
