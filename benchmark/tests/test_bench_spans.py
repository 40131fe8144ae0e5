"""The readers of the program's spans and counters on a synthetic profile:
forward_ms, backward_ms, optimizer_ms, randoms_ms, occ_update_span_ms,
unspanned_idle_share and host_syncs return the times, shares and rates of
known ranges, gaps and counts, and nothing where the program has no such
span or counter."""

import sys
import types

import pytest

from benchmark.harness import spec
from benchmark.harness.trace import Profile

US = 1e-3       # one trace microsecond in ms


def event(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def ctx(ranges, steps=2, kind="stage0_train"):
    """Busy [0, 10), [20, 30), [60, 70), [100, 110): idle gaps of 10, 30 and
    30 us starting at 10, 30 and 70; ``ranges`` (name, start, duration)."""
    events = [event("kernel", "k", s, 10) for s in (0, 20, 60, 100)]
    events += [event("user_annotation", n, s, d) for n, s, d in ranges]
    events += [event("cpu_op", "aten::mul", 70, 5)]          # an operator is no program range
    return types.SimpleNamespace(profile=Profile(events, 110e-6), profiled_steps=steps,
                                 traffic={"kind": kind})


RANGES = [("randoms", 0, 4), ("forward", 5, 20), ("march", 6, 3), ("backward", 28, 12),
          ("optimizer", 71, 19), ("occ_update", 40, 8), ("occ_update", 50, 12),
          ("randoms", 55, 2)]


@pytest.mark.parametrize("metric, want", [
    ("forward_ms.train0", 20 * US / 2), ("backward_ms.train0", 12 * US / 2),
    ("optimizer_ms.train0", 19 * US / 2), ("randoms_ms.train0", 6 * US / 2),
    ("occ_update_span_ms.train0", 10 * US),
    # the gaps at 10 (forward) and 30 (backward) start inside a range, the
    # one at 70 before the optimizer opens
    ("unspanned_idle_share.train0", 100.0 * 30 / 70)])
def test_span_readers(metric, want):
    assert spec.read_metric(metric, ctx(RANGES)) == pytest.approx(want)


@pytest.mark.parametrize("metric", ["forward_ms.train0", "backward_ms.train0",
                                    "optimizer_ms.train0", "randoms_ms.train0",
                                    "occ_update_span_ms.train0"])
def test_span_readers_read_nothing_without_the_span(metric):
    assert spec.read_metric(metric, ctx([("march", 6, 3)])) is None
    assert spec.read_metric(metric, types.SimpleNamespace(profile=None)) is None


def test_unspanned_share_of_a_program_without_ranges():
    assert spec.read_metric("unspanned_idle_share.train0", ctx([])) is None
    every_gap = [("field", 0, 110)]
    assert spec.read_metric("unspanned_idle_share.train0", ctx(every_gap)) == 0.0


def test_host_syncs_from_the_registry(monkeypatch):
    from mirres_restir_nerf_mesh_torch.utils import profiling

    counts = {"steps.stage0": 4, "steps.stage1": 1, "sync.aabb": 4, "sync.tv_steps": 6,
              "launches.scatter_add": 8}
    monkeypatch.setattr(profiling, "counters", lambda: dict(counts))
    assert spec.read_metric("host_syncs.train0", ctx([])) == 2.5
    assert spec.read_metric("host_syncs.train1", ctx([], kind="stage1_train")) == 10.0
    counts.pop("steps.stage0")
    assert spec.read_metric("host_syncs.train0", ctx([])) is None


def test_host_syncs_of_a_program_without_the_registry(monkeypatch):
    monkeypatch.setitem(sys.modules, "mirres_restir_nerf_mesh_torch.utils.profiling",
                        types.ModuleType("profiling"))
    assert spec.read_metric("host_syncs.train0", ctx([])) is None
