"""Every configuration, traffic mix, limit set and metric of BENCHMARK.json
is found by name, and a file added under the benchmark's folders is picked
up without an edit."""

import json
import shutil

import pytest

from benchmark.harness import spec

BENCH = spec.benchmark_json()
ALL = spec.with_waiting()


@pytest.mark.parametrize("bench", [BENCH, ALL], ids=["benchmark", "with_waiting"])
def test_every_named_file_is_found(bench):
    for w in bench["workloads"]:
        spec.config(bench, w["config"])
        t = spec.traffic(w["traffic"])
        assert "kind" in t and "follow_steps" in t
        assert spec.limits(w["name"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert hasattr(spec.reader(m["name"]), "read")


@pytest.mark.parametrize("bench", [BENCH, ALL], ids=["benchmark", "with_waiting"])
def test_each_cell_reports_setup_another_end_to_end_and_a_per_layer_metric(bench):
    for w in bench["workloads"]:
        e2e = [m["name"] for m in spec.metrics_of(bench, w["name"], False)]
        per = [m["name"] for m in spec.metrics_of(bench, w["name"], True)]
        assert "setup_s" in e2e and len(e2e) >= 2 and per
        moved = {m["moves"] for m in spec.metrics_of(bench, w["name"], True)}
        assert moved <= set(e2e)


def test_waiting_cells_are_not_run():
    names = {w["name"] for w in BENCH["workloads"]}
    assert {w["name"] for w in ALL["workloads"]} > names
    assert all(c["name"] in {w["config"] for w in BENCH["workloads"]} for c in BENCH["configs"])


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
