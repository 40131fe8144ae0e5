"""A tiny run of each cell on the CPU, past the harness's look for a card:
sound, it reads ``correct`` true; with the timed path broken underneath
(``benchmark/tools/faults.py``: a step that returns its state unchanged,
half of the batch left out with the mean over the rest, an answer altered
where it is produced), it reads ``correct`` false.  The cells run on one
card, so they have no exchange between cards to leave out."""

import pytest
import torch

from benchmark import run
from benchmark.harness import spec
from benchmark.tools import faults

from .tiny import CELLS, args, tiny_root

@pytest.fixture(scope="module")
def root(tmp_path_factory):
    torch.set_num_threads(4)
    return tiny_root(tmp_path_factory.mktemp("tiny"))


def _kind(root, cell):
    bench = spec.benchmark_json(root)
    return spec.traffic(spec.cell(bench, cell)["traffic"], root / "benchmark")["kind"]


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(root, cell):
    out = run.run_cell(args(cell), device="cpu", root=root)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert set(out["metrics"]) >= {"setup_s"}


@pytest.mark.parametrize("fault", faults.NAMES)
@pytest.mark.parametrize("cell", CELLS)
def test_fault_reads_incorrect(root, cell, fault, monkeypatch):
    kind = _kind(root, cell)

    def plant(drv, phase):
        if phase == "setup":
            faults.plant(fault, monkeypatch.setattr, kind)

    out = run.run_cell(args(cell), device="cpu", plant=plant, root=root)
    assert not out["correct"], out["checks"]


@pytest.mark.cuda
def test_cell_runs_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    import subprocess
    import sys

    cell = spec.benchmark_json()["workloads"][0]["name"]
    p = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", cell, "--seed",
                        "2147483661", "--seconds", "5", "--trace", "0"], cwd=spec.ROOT,
                       capture_output=True, text=True, timeout=1200)
    assert p.returncode == 0, p.stderr[-4000:]
    import json

    assert json.loads(p.stdout.strip().splitlines()[-1])["correct"]
