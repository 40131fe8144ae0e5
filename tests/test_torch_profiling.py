"""utils/profiling.py's spans and counter registry, and where the port puts
them: a tiny stage-0 Trainer (the published ``-O`` flags at the benchmark
tests' stage-0 size: 4 hash levels of 2^12, 256 rays, 4096 points, grid
32, three 24^2 views) driven as the training loop drives it.

- ``span`` opens a ``record_function`` range only while the profiler runs.
- Under ``torch.profiler`` two steps show every stage-0 span, with
  ``march``, ``field`` and ``composite`` inside ``forward``.
- The registry counts ``steps.stage0``; on the CPU no kernel launches and
  no synchronization is counted; ``train``'s metrics line carries the
  syncs and launches a step.
- On the card only (marked ``cuda``): over 4 stage-0 steps with their
  occupancy update and a batch rebuild, a stage-1 ReSTIR train step on the
  tile route and a frame on the dense route, the synchronizations that
  ``torch.cuda.set_sync_debug_mode("warn")`` reports equal the registry's
  ``sync.*`` increments.  Run it there without the suite's conftest:
  ``python -m pytest tests/test_torch_profiling.py --noconftest -p no:cacheprovider``.
"""

import json
import os
import traceback
import warnings
from collections import Counter

import pytest
import torch

from mirres_restir_nerf_mesh_torch.data.synthetic import make_synthetic_frames
from mirres_restir_nerf_mesh_torch.main import config_from_args
from mirres_restir_nerf_mesh_torch.train.trainer import Trainer
from mirres_restir_nerf_mesh_torch.utils import profiling

STAGE0_ARGV = ["scene", "-O", "--bound", "1", "--scale", "0.8", "--dt_gamma", "0", "--stage", "0",
               "--lambda_tv", "1e-8", "--iters", "50000", "--ckpt", "scratch",
               "--hash_levels", "4", "--hash_log2_size", "12", "--num_rays", "256",
               "--num_points", "4096", "--grid_size", "32"]
STAGE0_SPANS = ("randoms", "occ_draws", "occ_update", "batch", "forward", "backward",
                "optimizer", "adapt_num_rays")


def tiny_trainer(ws: str, device="cpu", hw: int = 24) -> Trainer:
    cfg = config_from_args(STAGE0_ARGV + ["--workspace", ws])
    data = make_synthetic_frames(n_frames=3, H=hw, W=hw, radius=4.0311 * 0.8)
    return Trainer("ngp", cfg, data, workspace=ws, device=device)


def loop_step(t: Trainer, i: int) -> None:
    """One step of the training loop's stage-0 body."""
    rand = t._stage0_randoms()
    if i % t.cfg.update_extra_interval == 0:
        t.state = t.occ_update(t.state, draws=t._occupancy_draws())
    t.state, _ = t.train_step(t.state, rand=rand)


def test_span_off_enters_no_record_function(monkeypatch):
    opened = []
    monkeypatch.setattr(profiling, "record_function", lambda name: opened.append(name))
    with profiling.span("x"):
        pass
    assert opened == []
    assert profiling.span("x") is profiling.span("y")          # one shared no-op


def test_span_on_is_a_profiler_range():
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("outer"):
            torch.ones(4).sum()
    assert any(e.name == "outer" for e in prof.events())


def test_registry():
    before = profiling.counters()
    profiling.count("test.a")
    profiling.count("test.a", 2)
    profiling.count_sync("test_site", on_card=False)
    profiling.count_sync("test_site", on_card=True, n=3)
    profiling.count_upload("test_up", "cpu")
    profiling.count_upload("test_up", "cuda")
    profiling.count_upload("test_up", "cuda", torch.zeros(1))     # a CPU tensor is copied
    now = profiling.counters()
    assert now["test.a"] - before.get("test.a", 0) == 3
    assert now["sync.test_site"] - before.get("sync.test_site", 0) == 3
    assert now["sync.test_up"] - before.get("sync.test_up", 0) == 2
    now["test.a"] = -1                                             # a copy
    assert profiling.counters()["test.a"] != -1
    r = profiling.rates({"steps.x": 4, "sync.a": 10, "sync.b": 2, "launches.k": 8},
                        {"steps.x": 2, "sync.a": 6}, "steps.x")
    assert r == {"sync_per_step": 3.0, "launches_per_step": 4.0}
    assert profiling.rates({"steps.x": 2}, {"steps.x": 2}, "steps.x") == {}


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    """Two loop steps (the first with an occupancy update) and a batch
    adaptation under the CPU profiler -> (host ranges, counters before,
    counters after, the trainer)."""
    from torch.profiler import ProfilerActivity, profile

    torch.manual_seed(0)
    t = tiny_trainer(str(tmp_path_factory.mktemp("profiling")))
    before = profiling.counters()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(2):
            loop_step(t, i)
        t._adapt_num_rays(1.0)
    after = profiling.counters()
    ranges = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
              if e.name in STAGE0_SPANS + ("march", "field", "composite")]
    return ranges, before, after, t


def test_stage0_spans(traced):
    ranges = traced[0]
    names = {n for n, _, _ in ranges}
    assert set(STAGE0_SPANS) <= names
    fwd = [(s, e) for n, s, e in ranges if n == "forward"]
    assert len(fwd) == 2
    for part in ("march", "field", "composite"):
        inner = [(s, e) for n, s, e in ranges if n == part]
        assert len(inner) == 2
        assert all(any(fs <= s and e <= fe for fs, fe in fwd) for s, e in inner)


def test_stage0_counters(traced):
    _, before, after, _ = traced
    delta = {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}
    assert delta.get("steps.stage0") == 2
    # the CPU runs the kernels' plain versions and never waits on a card
    assert not [k for k in delta if k.startswith(("launches.", "sync."))]


def test_train_log_line_carries_rates(traced):
    t = traced[3]
    t.train(max_steps=t.global_step + 1)
    recs = [json.loads(x) for x in open(os.path.join(t.workspace, "metrics_ngp.jsonl"))]
    last = [r for r in recs if "it_per_s" in r][-1]
    assert last["sync_per_step"] == 0.0 and last["launches_per_step"] == 0.0


class SyncWarnings:
    """The synchronizations that torch.cuda.set_sync_debug_mode("warn")
    reports inside the block, each with the innermost line of the port on
    its stack, and the registry's sync.* increments."""

    def __enter__(self):
        self._w = warnings.catch_warnings()
        self._w.__enter__()
        warnings.simplefilter("always")
        self.where = Counter()
        warnings.showwarning = self._show
        torch.cuda.synchronize()
        self.before = profiling.counters()
        torch.cuda.set_sync_debug_mode("warn")
        self.where.clear()           # what switching the mode on reported is not the program's
        return self

    def _show(self, message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        port = [f for f in traceback.extract_stack()[:-1]
                if "mirres_restir_nerf_mesh_torch" in f.filename]
        at = f"{os.path.basename(port[-1].filename)}:{port[-1].lineno}" if port else "no port line"
        self.where[f"{os.path.basename(filename)}:{lineno} in {at}"] += 1

    def __exit__(self, *exc):
        torch.cuda.set_sync_debug_mode("default")
        now = profiling.counters()
        self._w.__exit__(*exc)
        self.reported = sum(self.where.values())
        self.sites = {k: v - self.before.get(k, 0) for k, v in now.items()
                      if k.startswith("sync.") and v != self.before.get(k, 0)}
        self.counted = sum(self.sites.values())
        return False

    def __str__(self):
        return f"reported at {dict(self.where)}, counted {self.sites}"


@pytest.mark.cuda
def test_sync_counter_matches_sync_debug_mode(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from mirres_restir_nerf_mesh_torch import bench, cuda_build
    from mirres_restir_nerf_mesh_torch.render.stage1 import render_stage1
    from mirres_restir_nerf_mesh_torch.train import stage1 as train1
    from mirres_restir_nerf_mesh_torch.train.losses import build_topology

    cuda_build.build()
    dev = torch.device("cuda")
    runs = {}
    t = tiny_trainer(str(tmp_path / "s0"), device=dev, hw=64)
    with SyncWarnings() as runs["stage0"]:
        for i in range(4):
            loop_step(t, i)
        t._adapt_num_rays(1.0)                       # grows the batch: rebuilds the step
    assert t.cfg.num_rays > 256

    restir = dict(bench.RESTIR, restir_tiles=8, restir_tile_size=64, restir_light_samples=8,
                  restir_offsets=256)
    cam = bench.camera(64, 64, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    for faces, what in ((20_000, "stage1 tile-route step"), (6_000, "stage1 dense-route frame")):
        v, f = bench.bench_mesh(faces)
        verts, tris = torch.as_tensor(v, device=dev), torch.as_tensor(f, device=dev)
        static = bench.frame_static(tris, 64, 64, 2, torch.bfloat16, 4, **bench.BUDGET, **restir)
        params = bench.make_params(v.shape[0], 0, dev, 4)
        if "step" in what:
            cfg = bench.train_config(2, use_restir=True)
            state = train1.init_state(gen, cfg, static, params.nerf, v.shape[0], device=dev)
            step = train1.make_train_step(cfg, static, verts, build_topology(f, v.shape[0]))
            with SyncWarnings() as runs[what]:
                step(state, cam, generator=gen)
        else:
            with SyncWarnings() as runs[what]:
                render_stage1(params, static, verts, cam["rays_o"], cam["rays_d"], generator=gen)
    wrong = {k: str(r) for k, r in runs.items() if not 0 < r.reported == r.counted}
    for k, r in wrong.items():
        print(f"{k}: {r}")
    assert not wrong, list(wrong)
