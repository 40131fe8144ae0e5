"""A profiled stretch and what is read from it: torch.profiler over CPU
and CUDA activity, exported as a Chrome trace into the run's temporary
directory, parsed and deleted.

- ``busy_s``: the union of the device's kernels, copies and sets;
  ``window_s``: the stretch's wall time (from before its first launch to
  after the closing synchronize).
- ``kernels``: (name, start us, duration us) of each device operation;
  ``ranges``: (name, start us, duration us) of each host-side
  ``record_function`` range (the program's spans).
- ``breakdown``: the device operations that took most time, and the
  longest idle gaps summed by what the host was doing (the innermost
  range or operator open on the host at the gap's start).
"""

from __future__ import annotations

import heapq
import json
import os
import sys
import time
from collections import defaultdict
from typing import Callable, Dict, List, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("user_annotation", "cpu_op")


def union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Merged [start, end) intervals, sorted."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def covered(intervals: List[Tuple[float, float]]) -> float:
    return sum(e - s for s, e in union(intervals))


class Profile:
    def __init__(self, events: List[Dict], window_s: float):
        self.window_s = window_s
        self.kernels = [(e["name"], float(e["ts"]), float(e.get("dur", 0.0))) for e in events
                        if e.get("cat") in DEVICE_CATS]
        self.ranges = [(e["name"], float(e["ts"]), float(e.get("dur", 0.0))) for e in events
                       if e.get("cat") == "user_annotation"]
        self.host = [(e["name"], float(e["ts"]), float(e.get("dur", 0.0)), e.get("cat"))
                     for e in events if e.get("cat") in HOST_CATS]
        self.busy = union([(ts, ts + d) for _, ts, d in self.kernels])
        self.busy_s = sum(e - s for s, e in self.busy) / 1e6

    def kernel_seconds(self, match: Callable[[str], bool]) -> float:
        return sum(d for n, _, d in self.kernels if match(n)) / 1e6

    def range_seconds(self, match: Callable[[str], bool]) -> float:
        """Wall seconds covered by the host ranges whose name matches
        (nested or overlapping ranges counted once)."""
        return covered([(ts, ts + d) for n, ts, d in self.ranges if match(n)]) / 1e6

    def breakdown(self, top: int = 10) -> Dict[str, list]:
        ops: Dict[str, float] = defaultdict(float)
        for n, _, d in self.kernels:
            ops[n[:120]] += d / 1e6
        gaps: Dict[str, float] = defaultdict(float)
        starts = [e0 for (_, e0), _ in zip(self.busy, self.busy[1:])]
        for (_, e0), (s1, _), what in zip(self.busy, self.busy[1:], self._doing(starts)):
            gaps[what] += (s1 - e0) / 1e6
        return {"device_ops": sorted(([k, v] for k, v in ops.items()), key=lambda x: -x[1])[:top],
                "idle_gaps": sorted(([k, v] for k, v in gaps.items()), key=lambda x: -x[1])[:top]}

    def _doing(self, times: List[float]) -> List[str]:
        """For each time (ascending), the innermost host range and operator
        open at it, by a sweep over the host events in start order."""
        host = sorted(self.host, key=lambda h: h[1])
        open_: List[tuple] = []          # heap of (end, duration, name, cat)
        out, k = [], 0
        for t in times:
            while k < len(host) and host[k][1] <= t:
                n, ts, d, cat = host[k]
                heapq.heappush(open_, (ts + d, d, n, cat))
                k += 1
            while open_ and open_[0][0] < t:
                heapq.heappop(open_)
            rng = min(((d, n) for _, d, n, c in open_ if c == "user_annotation"), default=None)
            op = min(((d, n) for _, d, n, c in open_ if c == "cpu_op"), default=None)
            parts = [x[1] for x in (rng, op) if x is not None]
            out.append(" / ".join(parts)[:120] if parts else "(no host range)")
        return out


def profiled(fn: Callable[[], None], tmpdir: str) -> Profile:
    """Run fn under the profiler; the trace file is removed once read."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    path = os.path.join(tmpdir, "bench_trace.json")
    with profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    prof.export_chrome_trace(path)
    t2 = time.perf_counter()
    try:
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    print(f"profiler: stop {t1 - t0 - window_s:.1f} s, export {t2 - t1:.1f} s, "
          f"parse {time.perf_counter() - t2:.1f} s, {len(events)} events", file=sys.stderr)
    return Profile([e for e in events if e.get("ph") == "X"], window_s)
