"""One run of one cell of the port's benchmark.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds ``BENCHMARK.json``, ``benchmark/``
and the port (``mirres_restir_nerf_mesh_torch``), on a machine with the
cards the cell asks for.  It makes the cell's inputs from the seed, builds
or loads the kernels (``build/torch_kernels``), sets up the Trainer and
drives its first steps (the set-up, ``setup_s``), measures a window of
whole steps for ``--seconds`` (``--trace 1``: then profiles a short
stretch and reads the per-layer metrics from it), frees the program and
runs the reference over the first steps, and prints as its last line of
standard output one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and last
``checks`` (each compared number with its limit; they are also the last
lines of standard error).  It exits non-zero without a result when no card
or too few cards are visible, when the program cannot be imported, or when
JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def cache_env(root: Path) -> None:
    """Build and kernel caches at fixed paths inside the checkout; no
    library the port loads may pull in JAX (transformers' flax path)."""
    build = root / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def parse(argv: Optional[List[str]]) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="One run of one cell of the port's benchmark.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def log(msg: str) -> None:
    """A progress line on standard error, with the seconds since start."""
    print(f"[{time.perf_counter() - T_START:8.2f} s] {msg}", file=sys.stderr, flush=True)


def device_block(count: int, peak_bytes: int, prof=None) -> Dict:
    import torch

    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count,
           "memory_peak_bytes": int(peak_bytes)}
    if prof is not None:
        dev["busy_s"] = prof.busy_s
        dev["window_s"] = prof.window_s
    return dev


def gpu_state() -> str:
    """nvidia-smi's SM clock, power draw and temperature (a diagnostic)."""
    import subprocess

    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
                            "--format=csv,noheader"], capture_output=True, text=True, timeout=30)
        return r.stdout.strip() if r.returncode == 0 else "nvidia-smi failed"
    except (OSError, subprocess.SubprocessError):
        return "no nvidia-smi"


def power_limit() -> Optional[str]:
    import subprocess

    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True, timeout=30)
        return r.stdout.strip().splitlines()[0] if r.returncode == 0 else None
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def steal_s() -> float:
    """The host's steal time so far, in seconds over all its cores (the
    hypervisor's; /proc/stat), 0 where it cannot be read."""
    try:
        with open("/proc/stat") as f:
            return int(f.readline().split()[8]) / os.sysconf("SC_CLK_TCK")
    except (OSError, IndexError, ValueError):
        return 0.0


class HostWatch:
    """What the host did over the window, for the run's log: the process's
    CPU seconds, its involuntary context switches, the host's steal time and
    the garbage collector's passes and seconds."""

    def __enter__(self):
        import gc
        import resource

        self.gc_n, self.gc_s, self._t = 0, 0.0, None
        gc.callbacks.append(self._gc)
        self.ru0 = resource.getrusage(resource.RUSAGE_SELF)
        self.steal0 = steal_s()
        return self

    def _gc(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.gc_n += 1
            self.gc_s += time.perf_counter() - self._t

    def __exit__(self, *exc):
        import gc
        import resource

        gc.callbacks.remove(self._gc)
        ru, ru0 = resource.getrusage(resource.RUSAGE_SELF), self.ru0
        cpu = ru.ru_utime + ru.ru_stime - ru0.ru_utime - ru0.ru_stime
        self.note = (f"process cpu {cpu:.2f} s, {ru.ru_nivcsw - ru0.ru_nivcsw} involuntary "
                     f"switches, host steal "
                     f"{steal_s() - self.steal0:.2f} s, gc {self.gc_n} passes {self.gc_s:.3f} s")
        return False


class Context:
    """What the metric readers read (``benchmark/metrics/*.py``)."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def run_cell(args, device="cuda", plant=None, root: Path = ROOT) -> Dict:
    """Set-up, window, reference and comparison -> the result as a dict
    (``plant``: a function that breaks the program after set-up, for the
    fault tests)."""
    import json

    import torch

    from benchmark.harness import counting, drivers, result, spec
    from benchmark.harness.trace import profiled

    bench = spec.benchmark_json(root)
    cell = spec.cell(bench, args.workload)
    config = spec.config(bench, cell["config"], root)
    traffic = spec.traffic(cell["traffic"], root / "benchmark")
    limits = spec.limits(cell["name"], root / "benchmark")
    cuda = torch.device(device).type == "cuda"
    tmp = Path(os.environ.get("TMPDIR") or tempfile.gettempdir()) / "mirres-bench"
    workdir = tmp / cell["name"]
    shutil.rmtree(workdir, ignore_errors=True)
    workdir.mkdir(parents=True)

    drv = drivers.make(cell["name"], config, traffic, args.seed, device, str(workdir))
    drv.log = log
    if plant is not None:
        plant(drv, "setup")
    drv.setup()
    log(f"set-up done: {drv.i} steps taken")
    if plant is not None:
        plant(drv, "window")
    if cuda:
        torch.cuda.synchronize()
        peak_setup = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - T_START

    log("window")
    with HostWatch() as host:
        win = drv.window(args.seconds)
    st = sorted(win["step_s"])
    log(f"window done: {win['steps']} steps in {win['seconds']:.3f} s; host s a step "
        f"min {st[0]:.3f} median {st[len(st) // 2]:.3f} max {st[-1]:.3f}; {drv.state_note()}; "
        f"{host.note}; {gpu_state()}")
    peak_window = torch.cuda.max_memory_allocated() if cuda else 0
    prof, work = None, counting.WorkCounts()
    n_prof = int(traffic.get("trace_steps", 1))
    if args.trace:
        def stretch():
            for _ in range(n_prof):
                drv.step()

        log("profiled stretch")
        drv.spans.on = True
        f0 = drv.flops
        with counting.counting_work(work):
            prof = profiled(stretch, str(tmp)) if cuda else None
            if not cuda:
                stretch()
        log("profile read")
        log(flops_note(win, None if f0 is None else drv.flops - f0, work.flops, n_prof))
    failed = drv.failed_steps()
    peaks = json.load(open(root / "benchmark" / "peaks.json"))
    kind = torch.cuda.get_device_name(0) if cuda else "cpu"
    ctx = Context(cell=cell, config=config, traffic=traffic, setup_s=setup_s, window=win,
                  peak_window_bytes=peak_window,
                  profile=prof, profiled_steps=n_prof, work=work, spans=drv.spans.seconds,
                  peaks=peaks.get(kind))
    metrics = {}
    for m in spec.metrics_of(bench, cell["name"], bool(args.trace)):
        v = spec.read_metric(m["name"], ctx, root / "benchmark")
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device_info = device_block(cell["chips"], max(peak_setup, peak_window), prof) if cuda else {
        "platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}
    breakdown = prof.breakdown() if prof is not None else None
    log("metrics read")
    attempted = win["steps"] + (n_prof if args.trace else 0)

    # the reference, once the program is freed
    program, records, scene = drv.program, drv.records, drv.scene
    drv.free()
    del drv
    why = ""
    log("reference")
    try:
        ref = reference_of(traffic["kind"]).run(config, scene, records, args.seed,
                                                int(traffic["follow_steps"]), device)
        from benchmark.reference.compare import readings

        got = readings(program, ref)
    except Exception as e:      # a reference that cannot follow the program
        got, why = {}, f"the reference could not follow the program: {type(e).__name__}: {e}"
    log(f"reference done: {got}")
    checks = result.checks_block(got, limits)
    correct = result.passed(checks) and failed == 0
    return {"correct": correct, "attempted": attempted, "failed": failed, "metrics": metrics,
            "device": device_info, "breakdown": breakdown, "checks": checks, "why": why}


def flops_note(win: Dict, shape_flops: Optional[int], wrapper_flops: int, steps: int) -> str:
    """The profiled stretch's model FLOPs from the steps' shapes beside the
    wrappers' count of the same steps, and the window's FLOPs a second by
    each (a diagnostic for the run's log)."""
    window = None if win["flops"] is None else win["flops"] / win["seconds"]
    by_wrappers = wrapper_flops / steps * win["steps"] / win["seconds"]
    return (f"FLOPs over the stretch of {steps} steps: shapes {shape_flops!r}, wrappers "
            f"{wrapper_flops!r}; the window's FLOP/s {window!r} from its own steps' shapes, "
            f"{by_wrappers!r} from the wrappers' a step")


def reference_of(kind: str):
    if kind == "stage1_train":
        from benchmark.reference import stage1
        return stage1
    if kind == "stage0_train":
        from benchmark.reference import stage0
        return stage0
    raise ValueError(f"no reference for traffic kind {kind!r}")


def main(argv: Optional[List[str]] = None) -> int:
    args = parse(argv)
    cache_env(ROOT)
    if not (ROOT / "mirres_restir_nerf_mesh_torch").is_dir():
        print("benchmark: the port (mirres_restir_nerf_mesh_torch) is not in this checkout",
              file=sys.stderr)
        return 2
    import torch

    from benchmark.harness import result, spec

    chips = spec.cell(spec.benchmark_json(ROOT), args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: {args.workload} needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible",
              file=sys.stderr)
        return 2
    out = run_cell(args)
    bad = result.forbidden_modules()
    if bad:
        print(f"benchmark: loaded forbidden modules: {', '.join(bad)}", file=sys.stderr)
        return 3
    print(f"card: {power_limit()}", file=sys.stderr)
    print(result.line(out["correct"], out["attempted"], out["failed"], out["metrics"],
                      out["device"], out["breakdown"], out["checks"]), flush=True)
    result.print_checks(out["checks"], out["why"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
