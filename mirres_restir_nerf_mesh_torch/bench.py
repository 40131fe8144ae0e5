"""The port's benchmark: the root bench.py's operating point through the
port, on the card.

    python3 -m mirres_restir_nerf_mesh_torch.bench [--seed N] [--device cuda]

Prints per-sample lines, then as its last line one JSON object with the
keys of the root bench.py's line (``BENCH_r05.json``): the headline
``stage1_trainstep_Mrays_per_s`` (bench.py's nominal rays a ReSTIR frame
over the median train step), the forward frame, the traced rays, coverage,
the uncertain counts and stage 0; ``vs_baseline`` is null (no TPU figure is
a target of the port).  It adds ``card`` (nvidia-smi's name and power
limit, or ``"cpu"``), the sample counts, the train step's peak memory and
the K1 / K4 launches a step.

Operating point (bench.py:75-118, 186-214, 254-330): the marching-tets
blob at 96^3 decimated to 100,000 faces, bench.py's sky + sun env, the
synthetic orbit camera at radius 1.3 at 256^2, spp 32, 2 bounces, bf16;
ReSTIR with 128 light tiles of 1024, 32 + 1 candidates, 5 neighbours in 30
px, 8192 offsets, denoise_iters 4; tracer budgets k_cap 640 / queue_avg
256 (coherent) and 640 / 64 (incoherent), which drop no candidate.  Stage
0: 8192 rays x 64 samples compacted to 2^18 points, grid 128,
adaptive_num_rays, 16 levels of 2^19, bf16, 8 frames of 256^2.  Weights
and draws come from ``--seed`` through explicit ``torch.Generator``s.

Timing (host clock between two ``torch.cuda.synchronize()``): one warm
frame, step and stage-0 group, untimed; then 10 frames (the vertex offsets
moved by 1e-6 (i + 1) a frame, as bench.py does, so the cluster rebuild
always runs), 10 train steps (the loss read each step) and 5 stage-0
groups of 16 steps; the occupancy update once after a settle call.
Medians, with ``spread`` = max |t - median| / median.  No profiler runs in
the process.  The run fails (non-zero exit, no result line) on an
uncertain count above 0, a non-finite output, or K1 / K4 launches a step
other than 1 + 2 x bounces + spp / 3 (counted on the card only: on the CPU
the wrappers run their plain versions and count nothing).

``run`` takes the sizes (``BenchSize``) so that a test can run it at a
tiny width on the CPU; chip_smoke.py phases 4c, 4d and 4f time through
``time_frames``, ``time_steps`` and ``time_stage0``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from .config import Config, finalize
from .convert import params_from_jax, params_to_numpy
from .data.provider import RayDataset
from .data.synthetic import frame_batch, make_synthetic_dataset, make_synthetic_frames
from .device import resolve_device
from .export.meshops import decimate, marching_tets
from .models.material import MaterialSpec, init_material
from .models.nerf import NeRFSpec, init_nerf
from .render.stage1 import Stage1Params, Stage1Static, render_stage1
from .train import stage0 as s0
from .train import stage1 as train1
from .train.losses import build_topology


@dataclass(frozen=True)
class BenchSize:
    """The sizes of a run; the defaults are bench.py's operating point."""

    hw: int = 256
    spp: int = 32
    faces: int = 100_000
    trainsteps: int = 10
    frames: int = 10
    restir_tiles: int = 128
    restir_tile_size: int = 1024
    restir_light_samples: int = 32
    restir_offsets: int = 8192
    nerf_levels: int = 16             # the radiance field's hash levels (stage 0 and 1)
    stage0_groups: int = 5
    stage0_steps: int = 16
    stage0_rays: int = 8192
    stage0_points: int = 2 ** 18
    stage0_grid: int = 128
    stage0_hw: int = 256
    stage0_frames: int = 8


POINT = BenchSize()
BOUNCES = 2
NEIGHBORS = 5
# tracer budgets that drop no candidate on the bench mesh (~624 clusters)
BUDGET = dict(k_cap=640, queue_avg=256, k_cap_incoherent=640, queue_avg_incoherent=64)
# bench.py's ReSTIR static
RESTIR = dict(use_restir=True, restir_tiles=POINT.restir_tiles,
              restir_tile_size=POINT.restir_tile_size,
              restir_light_samples=POINT.restir_light_samples, restir_brdf_samples=1,
              restir_neighbors=NEIGHBORS, restir_radius=30.0,
              restir_offsets=POINT.restir_offsets, denoise_iters=4)
K4_STEP_LAUNCHES = 3        # material, jittered material, NeRF encode backward


def rays_per_frame(H: int, W: int, spp: int, neighbors: int, bounces: int,
                   unbiased_spatial: bool) -> int:
    """bench.py's nominal rays a frame: the primary G-buffer, then per spp
    the initial and final visibility, 2 x neighbours cross visibility and a
    closest hit + NEE shadow a bounce."""
    spatial = (2 * neighbors) if unbiased_spatial else 0
    return H * W * (1 + spp * (1 + spatial + 1 + 2 * bounces))


def spread_of(times) -> float:
    med = statistics.median(times)
    return max(abs(t - med) for t in times) / med


def card_line() -> str:
    """nvidia-smi's name and power limit of the first card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def make_counters():
    """The launches of every kernel wrapper since the last zero(), from the
    registry's ``launches.<wrapper>`` counters -> (zero, read)."""
    from .utils.profiling import counters

    names = ("queue_trace", "grid_trace", "dense_hit", "dense_occluded", "scatter_add")
    start: dict = {}

    def zero():
        start.clear()
        start.update(counters())

    def read():
        now = counters()
        return {n: now.get(f"launches.{n}", 0) - start.get(f"launches.{n}", 0) for n in names}

    return zero, read


def sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


# ------------------------------------------------------------ the set-up
def bench_mesh(target_faces: int):
    """bench.py's representative mesh: marching tets of a bumpy blob (96^3),
    QEM-decimated to target_faces -> (verts [V, 3] f32, tris [F, 3] i32)."""
    n = 96
    ax = np.linspace(-1, 1, n, dtype=np.float32)
    X, Y, Z = np.meshgrid(ax, ax, ax, indexing="ij")
    r = np.sqrt(X ** 2 + Y ** 2 + Z ** 2)
    field = 0.55 + 0.06 * np.sin(9 * X) * np.sin(7 * Y) * np.cos(5 * Z) - r
    verts, tris = marching_tets(field, 0.0, origin=(-1, -1, -1), spacing=(2 / (n - 1),) * 3)
    return decimate(verts, tris, target_faces)


def sky_env():
    """bench.py's sky + sun HDR environment [64, 128, 3]."""
    eh, ew = 64, 128
    theta = (np.arange(eh) + 0.5) / eh * np.pi
    sky = np.clip(np.cos(theta), 0, None)[:, None] ** 1.5
    env = np.tile((0.08 + 0.5 * sky)[:, :, None], (1, ew, 3)).astype(np.float32)
    env[6:9, 30:34] = [60.0, 55.0, 45.0]
    env[eh - 10:] *= [1.15, 0.9, 0.7]
    return env


def nerf_spec(compute_dtype, levels: int = POINT.nerf_levels) -> NeRFSpec:
    return NeRFSpec(bound=1.0, compute_dtype=compute_dtype, grid_levels=levels)


def frame_static(tris, H, W, spp, compute_dtype, levels: int = POINT.nerf_levels, **kw):
    """bench.py's Stage1Static (2 bounces) at H x W, spp, with kw (BUDGET,
    RESTIR, ...)."""
    return Stage1Static(
        tris=tris, nerf_spec=nerf_spec(compute_dtype, levels),
        mat_spec=MaterialSpec(bound=1.0, compute_dtype=compute_dtype),
        spp=spp, bounces=BOUNCES, H=H, W=W, **kw,
    )


def make_params(n_verts: int, seed: int, device, levels: int = POINT.nerf_levels):
    """Random weights from a seed, carried through the params_from_jax
    layout; zero offsets, the sky + sun env."""
    g = torch.Generator(device=device).manual_seed(seed)
    p = Stage1Params(nerf=init_nerf(g, nerf_spec(torch.float32, levels), device=device),
                     offsets=torch.zeros((n_verts, 3), device=device),
                     mat=init_material(g, MaterialSpec(bound=1.0), device=device),
                     env=torch.as_tensor(sky_env(), device=device))
    return params_from_jax(*params_to_numpy(p), device=device)


def camera(H, W, device):
    """bench.py's frame: the synthetic orbit camera at radius 1.3, its rays,
    and the analytic sphere's pixels on white and alpha."""
    poses, intr, images = make_synthetic_dataset(n_frames=1, H=H, W=W, radius=1.3)
    return frame_batch(poses[0], intr, images[0], device)


def train_config(spp: int, use_restir: bool = False):
    """bench.py's train-step config (the frame's ReSTIR and denoiser settings
    come from the static)."""
    return finalize(Config(bound=1.0, stage=1, iters=7500, use_brdf=True, use_restir=use_restir,
                           spp=spp, pt_bounces=BOUNCES, env_h=64, env_w=128, ssaa=1,
                           lambda_tv=0.0))


def stage0_bench_config(size: BenchSize = POINT):
    """bench.py's stage-0 point (bench.py:276-279)."""
    return finalize(Config(bound=1.0, num_rays=size.stage0_rays, samples_per_ray=64,
                           num_points=size.stage0_points, dt_gamma=0.0, lambda_tv=1e-8,
                           grid_size=size.stage0_grid, adaptive_num_rays=True))


def check_state(state, aux):
    """Finite loss, params and Adam moments (a non-finite gradient makes the
    moments non-finite), uncertain_count 0."""
    if not bool(torch.isfinite(aux["loss"])):
        raise AssertionError(f"train step: loss {float(aux['loss'])}")
    for g, leaves in train1.group_leaves(state.params).items():
        st = state.opt_state[g]
        for x in leaves + st.mu + st.nu:
            if not bool(torch.isfinite(x).all()):
                raise AssertionError(f"train step: non-finite params or moments in group {g}")
    if float(aux["uncertain_count"]) != 0:
        raise AssertionError(f"train step: uncertain_count {float(aux['uncertain_count'])}")


def check_outputs(out, P):
    """Every floating output finite, with P rows."""
    for k, v in out.items():
        if not torch.is_floating_point(v):
            continue
        if not bool(torch.isfinite(v).all()):
            raise AssertionError(f"frame output {k!r} is not finite")
        if v.dim() and v.shape[0] != P:
            raise AssertionError(f"frame output {k!r} has shape {tuple(v.shape)}")


def _no_log(*a):
    pass


# --------------------------------------------------------------- timing
def time_frames(params, static, verts, cam, gen, n: int, counts, name: str = "frame",
                log: Callable = _no_log):
    """One warm frame, then the counters zeroed and n frames, each between
    two syncs, the vertex offsets moved by 1e-6 (i + 1); the counters read
    -> (times, the last frame's outputs, per-frame readings, launches).
    Every frame's outputs are checked finite."""
    zero_counts, read_counts = counts
    dev = cam["rays_o"].device
    P = cam["rays_o"].shape[0]
    out = render_stage1(params, static, verts, cam["rays_o"], cam["rays_d"], generator=gen)
    check_outputs(out, P)
    sync(dev)
    zero_counts()
    times, traced, uncertain, coverage = [], [], [], []
    for i in range(n):
        p_i = params._replace(offsets=params.offsets + 1e-6 * (i + 1))
        sync(dev)
        t0 = time.perf_counter()
        out = render_stage1(p_i, static, verts, cam["rays_o"], cam["rays_d"], generator=gen)
        sync(dev)
        times.append(time.perf_counter() - t0)
        check_outputs(out, P)
        traced.append(float(out["traced_rays"]))
        uncertain.append(float(out["uncertain_count"]))
        coverage.append(float(out["mask"].to(torch.float32).mean()))
        log(f"{name} {i}: {times[-1]:.4f} s, uncertain {uncertain[-1]:.0f}, "
            f"traced {traced[-1]:.0f}")
    launches = read_counts()
    return times, out, dict(traced=traced, uncertain=uncertain, coverage=coverage), launches


def time_steps(cfg, static, params, verts, topo, cam, gen, n: int, counts,
               name: str = "train step", log: Callable = _no_log):
    """A fresh train state (bench.py's: the material from gen, params' NeRF,
    the sky + sun env), one warm step, then the peak memory reset, the
    counters zeroed and n steps, each between two syncs with the loss read,
    every state checked (check_state); the counters read -> (times, state,
    aux, per-step readings, launches, peak GB or None on the CPU)."""
    zero_counts, read_counts = counts
    dev = cam["rays_o"].device
    state = train1.init_state(gen, cfg, static, params.nerf, params.offsets.shape[0], device=dev)
    state = state._replace(params=state.params._replace(env=params.env.clone()))
    step = train1.make_train_step(cfg, static, verts, topo)
    state, aux = step(state, cam, generator=gen)
    check_state(state, aux)
    sync(dev)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    zero_counts()
    times, losses, uncertain = [], [], []
    for i in range(n):
        sync(dev)
        t0 = time.perf_counter()
        state, aux = step(state, cam, generator=gen)
        losses.append(float(aux["loss"]))
        sync(dev)
        times.append(time.perf_counter() - t0)
        uncertain.append(float(aux["uncertain_count"]))
        log(f"{name} {i}: {times[-1]:.4f} s, loss {losses[-1]:.6f}, "
            f"uncertain {uncertain[-1]:.0f}")
        check_state(state, aux)
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9 if cuda else None
    return times, state, aux, dict(loss=losses, uncertain=uncertain), launches, peak


def stage0_finite(state, aux, name):
    """Finite loss, params and Adam moments."""
    if not bool(torch.isfinite(aux["loss"])):
        raise AssertionError(f"{name}: loss {float(aux['loss'])}")
    for x in s0.tree_leaves(state.params) + state.opt_state.mu + state.opt_state.nu:
        if not bool(torch.isfinite(x).all()):
            raise AssertionError(f"{name}: non-finite params or moments")


def time_stage0(dev, gen, counts, size: BenchSize = POINT, log: Callable = _no_log):
    """bench.py's stage-0 point: the synthetic frames, the field in bf16, one
    occupancy update to settle the grid, one warm group, then the counters
    zeroed and size.stage0_groups groups of size.stage0_steps sequential
    steps (one sync a group), the counters read; then one settle and one
    timed occupancy update -> (readings, the state, the step, its config)."""
    zero_counts, read_counts = counts
    cfg = stage0_bench_config(size)
    sampler = RayDataset(make_synthetic_frames(n_frames=size.stage0_frames, H=size.stage0_hw,
                                               W=size.stage0_hw, bound=cfg.bound),
                         bound=cfg.bound, device=dev)
    spec = nerf_spec(torch.bfloat16, size.nerf_levels)
    state = s0.init_state(gen, cfg, spec, device=dev)
    step_fn = s0.make_train_step(cfg, spec, sampler)
    occ_update = s0.make_occ_update(cfg, spec)
    state = occ_update(state, gen)
    cuda = torch.device(dev).type == "cuda"
    times = []
    for g in range(1 + size.stage0_groups):
        if g == 1:
            sync(dev)
            if cuda:
                torch.cuda.reset_peak_memory_stats()
            zero_counts()
        sync(dev)
        t0 = time.perf_counter()
        for _ in range(size.stage0_steps):
            state, aux = step_fn(state, gen)
        sync(dev)
        times.append(time.perf_counter() - t0)
        log(f"stage-0 group {g} ({'warm' if g == 0 else 'timed'}): {times[-1]:.4f} s for "
            f"{size.stage0_steps} steps, loss {float(aux['loss']):.6f}")
        stage0_finite(state, aux, "stage-0 step")
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9 if cuda else None
    state = occ_update(state, gen)
    sync(dev)
    t0 = time.perf_counter()
    state = occ_update(state, gen)
    sync(dev)
    occ_s = time.perf_counter() - t0
    timed = times[1:]
    step_s = statistics.median(timed) / size.stage0_steps
    pts = min(cfg.num_points, cfg.num_rays * cfg.samples_per_ray)
    steps = size.stage0_steps * size.stage0_groups
    res = {"group_s": times, "step_s": step_s, "it_per_s": 1.0 / step_s,
           "Msamples_per_s": pts / step_s / 1e6, "spread": spread_of(timed),
           "groups": size.stage0_groups, "max_memory_allocated_GB": peak,
           "march_lattice_S": step_fn.march_candidates,
           "num_points_last": int(aux["num_points"]), "loss_last": float(aux["loss"]),
           "occ_update_s": occ_s, "occ_rate": float(state.occ.occ.float().mean()),
           "K4_launches_per_step": launches["scatter_add"] / steps, "launches": launches}
    return res, state, step_fn, cfg, spec, sampler


# --------------------------------------------------------------- the line
def result_line(card: str, size: BenchSize, frames, steps, stage0) -> dict:
    """The bench line from time_frames' (times, readings), time_steps'
    (times, readings, launches, peak) and time_stage0's readings."""
    f_times, f_read = frames
    t_times, t_read, t_launches, peak = steps
    nominal = rays_per_frame(size.hw, size.hw, size.spp, NEIGHBORS, BOUNCES, True)
    ts, fs = statistics.median(t_times), statistics.median(f_times)
    traced = statistics.mean(f_read["traced"])
    n = len(t_times)
    return {
        "metric": "stage1_trainstep_Mrays_per_s",
        "value": nominal / ts / 1e6,
        "unit": "Mrays/s/card",
        "vs_baseline": None,
        "card": card,
        "coverage": statistics.mean(f_read["coverage"]),
        "trainstep_s": ts,
        "trainstep_spread": spread_of(t_times),
        "trainstep_uncertain": max(t_read["uncertain"]),
        "trainstep_n": n,
        "forward_Mrays_per_s": nominal / fs / 1e6,
        "forward_frame_s": fs,
        "forward_spread": spread_of(f_times),
        "forward_n": len(f_times),
        "nominal_rays_per_frame": nominal,
        "traced_rays_per_frame": traced,
        "traced_Mrays_per_s": traced / fs / 1e6,
        "uncertain_per_frame": statistics.mean(f_read["uncertain"]),
        "stage0_it_per_s": stage0["it_per_s"],
        "stage0_Msamples_per_s": stage0["Msamples_per_s"],
        "stage0_spread": stage0["spread"],
        "stage0_occ_update_s": stage0["occ_update_s"],
        "stage0_groups": stage0["groups"],
        "max_memory_allocated_GB": peak,
        "K1_launches_per_step": t_launches["queue_trace"] / n,
        "K4_launches_per_step": t_launches["scatter_add"] / n,
    }


def check_line(line: dict, cuda: bool, spp: int) -> list:
    """The bench's gates -> failures: no uncertain ray, and on the card K1
    1 + 2 x bounces + spp and K4 3 launches a ReSTIR step."""
    fails = []
    if line["trainstep_uncertain"] != 0 or line["uncertain_per_frame"] != 0:
        fails.append(f"uncertain rays: train step {line['trainstep_uncertain']}, frame "
                     f"{line['uncertain_per_frame']}")
    k1 = 1 + 2 * BOUNCES + spp
    if cuda and (line["K1_launches_per_step"] != k1 or
                 line["K4_launches_per_step"] != K4_STEP_LAUNCHES):
        fails.append(f"{line['K1_launches_per_step']} K1 / {line['K4_launches_per_step']} K4 "
                     f"launches a step, {k1} / {K4_STEP_LAUNCHES} expected")
    return fails


def run(device="cuda", seed: int = 0, size: BenchSize = POINT,
        log: Callable = _no_log) -> dict:
    """The benchmark at ``size`` on ``device`` (a CUDA request without a
    card raises) -> the result line; AssertionError on a failed gate."""
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    card = card_line() if cuda else "cpu"
    if cuda:
        from . import cuda_build

        t0 = time.perf_counter()
        cuda_build.build()
        log(f"kernels built in {time.perf_counter() - t0:.2f} s")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    counts = make_counters()
    t0 = time.perf_counter()
    v, f = bench_mesh(size.faces)
    log(f"mesh: {f.shape[0]} triangles ({time.perf_counter() - t0:.1f} s)")
    verts, tris = torch.as_tensor(v, device=dev), torch.as_tensor(f, device=dev)
    restir = dict(RESTIR, restir_tiles=size.restir_tiles, restir_tile_size=size.restir_tile_size,
                  restir_light_samples=size.restir_light_samples,
                  restir_offsets=size.restir_offsets)
    static = frame_static(tris, size.hw, size.hw, size.spp, torch.bfloat16, size.nerf_levels,
                          **BUDGET, **restir)
    cam = camera(size.hw, size.hw, dev)
    params = make_params(v.shape[0], seed, dev, size.nerf_levels)
    gen = torch.Generator(device=dev).manual_seed(seed)
    f_times, _, f_read, _ = time_frames(params, static, verts, cam, gen, size.frames, counts,
                                        "restir frame", log)
    topo = build_topology(f, v.shape[0])
    t_times, _, _, t_read, t_launches, peak = time_steps(
        train_config(size.spp, use_restir=True), static, params, verts, topo, cam, gen,
        size.trainsteps, counts, "restir train step", log)
    stage0 = time_stage0(dev, gen, counts, size, log)[0]
    line = result_line(card, size, (f_times, f_read), (t_times, t_read, t_launches, peak),
                       stage0)
    fails = check_line(line, cuda, size.spp)
    if fails:
        raise AssertionError("bench: " + "; ".join(fails) + " " + json.dumps(line))
    return line


def main(argv=None, size: BenchSize = POINT) -> None:
    """The command line; ``size`` is for tests (the operating point by
    default)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    line = run(args.device, args.seed, size, log=lambda *a: print(*a, flush=True))
    print(json.dumps(line), flush=True)


if __name__ == "__main__":
    sys.exit(main())
