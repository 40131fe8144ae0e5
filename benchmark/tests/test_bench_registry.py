"""Every configuration, traffic mix, limit set and metric of BENCHMARK.json
is found by name, and a file added under the benchmark's folders is picked
up without an edit."""

import json
import shutil

import pytest

from benchmark.harness import spec

BENCH = spec.benchmark_json()
ALL = spec.with_waiting()
KEYS = ("configs", "workloads", "end_to_end", "per_layer")


def names(bench, key):
    return [e["name"] for e in bench[key]]


def files_are_found(bench):
    for w in bench["workloads"]:
        spec.config(bench, w["config"])
        t = spec.traffic(w["traffic"])
        assert "kind" in t and "follow_steps" in t
        assert spec.limits(w["name"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert hasattr(spec.reader(m["name"]), "read")
        assert set(m.get("workloads", [])) <= set(names(bench, "workloads")), m["name"]


def cells_report_enough(bench):
    for w in bench["workloads"]:
        e2e = [m["name"] for m in spec.metrics_of(bench, w["name"], False)]
        per = [m["name"] for m in spec.metrics_of(bench, w["name"], True)]
        assert "setup_s" in e2e and len(e2e) >= 2 and per
        moved = {m["moves"] for m in spec.metrics_of(bench, w["name"], True)}
        assert moved <= set(e2e)


def waiting_is_apart(root):
    """with_waiting()'s cells are BENCHMARK.json's and the waiting ones; a
    waiting cell that BENCHMARK.json lacks is not in it, so no run finds it;
    every name stands once under each key of with_waiting(); every
    configuration of BENCHMARK.json is used by one of its cells."""
    bench, every = spec.benchmark_json(root), spec.with_waiting(root)
    waiting = {w["name"] for p in (root / "benchmark" / "waiting").glob("*.json")
               for w in spec.load_json(p).get("workloads", [])}
    assert set(names(every, "workloads")) == set(names(bench, "workloads")) | waiting
    for cell in waiting - set(names(bench, "workloads")):
        with pytest.raises(spec.SpecError):
            spec.cell(bench, cell)
    for key in KEYS:
        assert len(names(every, key)) == len(set(names(every, key))), key
    assert all(c["name"] in {w["config"] for w in bench["workloads"]} for c in bench["configs"])


@pytest.mark.parametrize("bench", [BENCH, ALL], ids=["benchmark", "with_waiting"])
def test_every_named_file_is_found(bench):
    files_are_found(bench)


@pytest.mark.parametrize("bench", [BENCH, ALL], ids=["benchmark", "with_waiting"])
def test_each_cell_reports_setup_another_end_to_end_and_a_per_layer_metric(bench):
    cells_report_enough(bench)


def test_waiting_cells_are_not_run():
    waiting_is_apart(spec.ROOT)


def test_a_waiting_cell_moves_in_by_additions_alone(tmp_path):
    """Appending a waiting cell's entries to BENCHMARK.json, and editing
    nothing, makes it a whole cell that reports the end-to-end metrics
    BENCHMARK.json already has: the move adds no end-to-end entry, which a
    change that adds a configuration may not add."""
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(spec.BENCH_DIR / "waiting", tmp_path / "benchmark" / "waiting")
    w = spec.load_json(tmp_path / "benchmark" / "waiting" / "train1-restir-800.json")
    moved = spec.benchmark_json(tmp_path)
    before = set(names(moved, "end_to_end"))
    assert not w.get("end_to_end")
    assert {m["moves"] for m in w["per_layer"]} <= before
    for key in KEYS:
        moved[key] += w.get(key, [])
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(moved, indent=2))

    every = spec.with_waiting(tmp_path)
    for key in KEYS:
        assert names(every, key) == names(moved, key), key
    waiting_is_apart(tmp_path)
    files_are_found(moved)
    cells_report_enough(moved)
    assert set(names(moved, "end_to_end")) == before
    assert {m["name"] for m in spec.metrics_of(moved, "train1-restir-800", False)} == {
        "mfu", "peak_mem_GB", "setup_s"}


def test_added_files_are_picked_up(tmp_path):
    bench_dir = tmp_path / "benchmark"
    for sub in ("traffic", "limits", "metrics"):
        shutil.copytree(spec.BENCH_DIR / sub, bench_dir / sub)
    (bench_dir / "traffic" / "new-mix.json").write_text(
        json.dumps({"kind": "stage1_train", "follow_steps": 3}))
    (bench_dir / "limits" / "new-cell.json").write_text(
        json.dumps({"limits": {"loss": {"limit": 0.5}}}))
    (bench_dir / "metrics" / "new_metric.py").write_text(
        "def read(name, ctx):\n    return 41.0 + len(name.split('.'))\n")
    assert spec.traffic("new-mix", bench_dir)["kind"] == "stage1_train"
    assert spec.limits("new-cell", bench_dir) == {"loss": 0.5}
    assert spec.read_metric("new_metric", None, bench_dir) == 42.0
    assert spec.read_metric("new_metric.anycell", None, bench_dir) == 43.0
    # a reader of the full name wins over its base
    (bench_dir / "metrics" / "new_metric.cellb.py").write_text(
        "def read(name, ctx):\n    return None\n")
    assert spec.read_metric("new_metric.cellb", None, bench_dir) is None


def test_unknown_names_raise():
    with pytest.raises(spec.SpecError):
        spec.cell(BENCH, "no-such-cell")
    with pytest.raises(spec.SpecError):
        spec.traffic("no-such-mix")
    with pytest.raises(spec.SpecError):
        spec.reader("no_such_metric.x")
