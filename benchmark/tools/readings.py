"""The readings that set a cell's limits, on the card, in one process:

    python3 -m benchmark.tools.readings --workload <cell> --seeds 1,2,3 \
        [--control-seeds 4,5,6] [--faults half,altered --fault-seeds 7,8,9] [--out f.json]

For each seed of ``--seeds``: the program's set-up (the Trainer and its
followed steps, as a run takes them), the program freed, the reference,
the compared numbers (the lower readings: sound runs).  For each control
seed: the same, then the reference once more in the lower precision
(float8 MLPs) in the program's place, compared with the reference (the
upper readings).  For each fault and fault seed: the program's set-up with
the fault planted (``faults.py``), then the reference.  Prints one JSON
line a reading and writes them all to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--faults", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent.parent.parent))
    ap.add_argument("--out", default="")
    a = ap.parse_args(argv)

    from benchmark.harness import drivers, spec
    from benchmark.reference.compare import leaf_gaps, readings
    from benchmark.run import reference_of
    from benchmark.tools import faults

    root = Path(a.root)
    bench = spec.with_waiting(root)
    cell = spec.cell(bench, a.workload)
    config = spec.config(bench, cell["config"], root)
    traffic = spec.traffic(cell["traffic"], root / "benchmark")
    ref_mod = reference_of(traffic["kind"])
    steps = int(traffic["follow_steps"])
    tmp = Path(os.environ.get("TMPDIR") or tempfile.gettempdir()) / "mirres-readings"
    out = []

    def seeds(s):
        return [int(x) for x in s.split(",") if x]

    def program(seed, fault=None):
        shutil.rmtree(tmp, ignore_errors=True)
        tmp.mkdir(parents=True)
        patches = faults.Patches()
        if fault:
            faults.plant(fault, patches.set, traffic["kind"])
        try:
            drv = drivers.make(cell["name"], config, traffic, seed, a.device, str(tmp))
            drv.setup()
        finally:
            patches.restore()
        res = (drv.program, drv.records, drv.scene)
        drv.free()
        return res

    def emit(rec):
        out.append(rec)
        print(json.dumps(rec), flush=True)

    for seed in seeds(a.seeds):
        t0 = time.time()
        prog, records, scene = program(seed)
        ref = ref_mod.run(config, scene, records, seed, steps, a.device)
        emit({"kind": "sound", "seed": seed, "readings": readings(prog, ref),
              "losses": prog["losses"], "uncertain": prog.get("uncertain"),
              "checked": ref.get("tracer_checked"),
              "uncertain_sampled": ref.get("tracer_uncertain_sampled"),
              "uncertain_share": ref.get("tracer_uncertain_share"),
              "leaf_gaps": leaf_gaps(prog, ref), "seconds": time.time() - t0})
    for seed in seeds(a.control_seeds):
        prog, records, scene = program(seed)
        ref = ref_mod.run(config, scene, records, seed, steps, a.device)
        ctl = ref_mod.run(config, scene, records, seed, steps, a.device, fp8=True)
        emit({"kind": "control", "seed": seed, "readings": readings(ctl, ref),
              "program": readings(prog, ref), "leaf_gaps": leaf_gaps(ctl, ref)})
    for fault in [f for f in a.faults.split(",") if f]:
        for seed in seeds(a.fault_seeds):
            prog, records, scene = program(seed, fault)
            try:
                ref = ref_mod.run(config, scene, records, seed, steps, a.device)
                emit({"kind": f"fault:{fault}", "seed": seed, "readings": readings(prog, ref)})
            except Exception as e:      # the reference cannot follow the broken program
                emit({"kind": f"fault:{fault}", "seed": seed,
                      "error": f"{type(e).__name__}: {e}"})
    if a.out:
        Path(a.out).parent.mkdir(parents=True, exist_ok=True)
        Path(a.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
