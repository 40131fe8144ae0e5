"""The control: the reference in the precision below the configuration's
(float8 MLPs for the configured bfloat16) put in the program's place reads
``correct`` false against the reference, at a size a test run can hold
(on the card it is read at the cell's own size by
``python3 -m benchmark.tools.readings --control-seeds ...``)."""

import pytest
import torch

from benchmark.harness import drivers, result, spec
from benchmark.reference.compare import readings
from benchmark.run import reference_of

from .tiny import CELLS, tiny_root

@pytest.mark.parametrize("cell", CELLS)
def test_control_reads_incorrect(tmp_path, cell):
    torch.set_num_threads(4)
    root = tiny_root(tmp_path / "root")
    bench = spec.benchmark_json(root)
    w = spec.cell(bench, cell)
    config = spec.config(bench, w["config"], root)
    traffic = spec.traffic(w["traffic"], root / "benchmark")
    drv = drivers.make(cell, config, traffic, 2147483663, "cpu", str(tmp_path / "ws"))
    drv.setup()
    ref_mod = reference_of(traffic["kind"])
    steps = int(traffic["follow_steps"])
    ref = ref_mod.run(config, drv.scene, drv.records, 2147483663, steps, "cpu")
    ctl = ref_mod.run(config, drv.scene, drv.records, 2147483663, steps, "cpu", fp8=True)
    lim = spec.limits(cell, root / "benchmark")
    assert result.passed(result.checks_block(readings(drv.program, ref), lim))
    assert not result.passed(result.checks_block(readings(ctl, ref), lim))
