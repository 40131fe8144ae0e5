#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port's stage-1 forward frame on one NVIDIA card.

    python3 chip_smoke.py [--seed N] [--out DIR] [--profile]

Phases (any failure exits non-zero):

1. Require CUDA; print the card's name and power limit (nvidia-smi).
2. Build the hand-written kernels from ``mirres_restir_nerf_mesh_torch/csrc``
   (one nvcc per source, started together); print the build seconds and
   ptxas' register / shared-memory report.
3. Hold each kernel against its plain PyTorch version on the card, at the
   shapes of the frame, and time both with CUDA events (median):
   K3 (dense hit) on a ~6k-triangle mesh; K1 (tile tracer) closest hit on the
   65,536 primary rays of the ~100k-triangle bench mesh, closest and any
   hit on a 1M-ray bounce-shaped batch (surface origins, cosine directions,
   "morton" sort, k_cap 640, queue_avg 64), and any hit on one spp's
   direct-light shadow batch (the covered G-buffer points towards
   env-sampled directions, as sample_direct_mis traces them; same budget).
   Hit prims agree on >= 99.99% of
   rays, the uncertain masks are equal, and t, u, v agree within 1e-5
   relative where the prims agree.
4. The main path: the launch counters are zeroed, then ``render_stage1``
   (use_restir=False) renders bench.py's operating point (256x256, spp 32,
   2 bounces, ~100k triangles, k_cap 640, queue_avg 256/64, bf16 MLPs) once
   warm and three times timed, and a ~6k-triangle mesh frame (dense path)
   once; the counters are read right after.  Outputs must be finite,
   uncertain_count 0, and both kernels launched.
5. Reference check: a 64x64, spp-2 frame of the small mesh in fp32 on the
   card against the same frame on the CPU (the plain versions, which the
   CPU tests hold against the JAX package), same weights and randoms.
6. Print the kernel table as one JSON line, the card line, and as the last
   line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and fp32 (non-tensor) FLOP/s
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
# fp32 operations of one Moeller-Trumbore test (csrc/mt.cuh: 9 cross, 5 det,
# 1 reciprocal, 3 tvec, 6 u, 9 qvec, 6 v, 6 t) and of one ray/box slab test
MT_FLOPS = 45
SLAB_FLOPS = 22

PRIM_AGREE = 0.9999
RTOL = 1e-5

# bench.py's operating point
FRAME_HW = 256
FRAME_SPP = 32
BENCH_FACES = 100_000
SMALL_FACES = 6_000
BOUNCE_RAYS = 1 << 20
TIMED_FRAMES = 3


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warm: bool = True) -> float:
    """Median device time of fn() over reps runs (CUDA events), after one
    warm run unless the caller has just run it."""
    import torch

    if warm:
        fn()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        torch.cuda.synchronize()
        times.append(s.elapsed_time(e))
    return float(statistics.median(times))


def bench_mesh(target_faces: int):
    """bench.py's representative mesh: marching tets of a bumpy blob (96^3),
    QEM-decimated to target_faces."""
    import numpy as np

    from mirres_restir_nerf_mesh_torch.export.meshops import decimate, marching_tets

    n = 96
    ax = np.linspace(-1, 1, n, dtype=np.float32)
    X, Y, Z = np.meshgrid(ax, ax, ax, indexing="ij")
    r = np.sqrt(X ** 2 + Y ** 2 + Z ** 2)
    field = 0.55 + 0.06 * np.sin(9 * X) * np.sin(7 * Y) * np.cos(5 * Z) - r
    verts, tris = marching_tets(field, 0.0, origin=(-1, -1, -1), spacing=(2 / (n - 1),) * 3)
    return decimate(verts, tris, target_faces)


def sky_env():
    """bench.py's sky + sun HDR environment [64, 128, 3]."""
    import numpy as np

    eh, ew = 64, 128
    theta = (np.arange(eh) + 0.5) / eh * np.pi
    sky = np.clip(np.cos(theta), 0, None)[:, None] ** 1.5
    env = np.tile((0.08 + 0.5 * sky)[:, :, None], (1, ew, 3)).astype(np.float32)
    env[6:9, 30:34] = [60.0, 55.0, 45.0]
    env[eh - 10:] *= [1.15, 0.9, 0.7]
    return env


def bounce_rays(verts, tris, n: int, gen):
    """Bounce-shaped batch: origins on random faces (outward-facing normal,
    1e-4 offset), cosine-distributed directions around the normal."""
    import torch

    from mirres_restir_nerf_mesh_torch.utils.math import cross, onb_frame, safe_normalize

    dev = verts.device
    t = tris.long()
    f = torch.randint(0, t.shape[0], (n,), generator=gen, device=dev)
    b = torch.rand((n, 2), generator=gen, device=dev)
    b = torch.where((b.sum(1) > 1.0)[:, None], 1.0 - b, b)
    v0, v1, v2 = verts[t[f, 0]], verts[t[f, 1]], verts[t[f, 2]]
    p = v0 + b[:, 0:1] * (v1 - v0) + b[:, 1:2] * (v2 - v0)
    nrm = safe_normalize(cross(v1 - v0, v2 - v0))
    nrm = torch.where((torch.sum(nrm * p, -1) < 0)[:, None], -nrm, nrm)
    u = torch.rand((n, 2), generator=gen, device=dev)
    r, phi = torch.sqrt(u[:, 0]), 2 * math.pi * u[:, 1]
    loc = torch.stack([r * torch.cos(phi), r * torch.sin(phi),
                       torch.sqrt(torch.clamp_min(1 - u[:, 0], 0.0))], -1)
    tb, bt, nn = onb_frame(nrm)
    d = loc[:, 0:1] * tb + loc[:, 1:2] * bt + loc[:, 2:3] * nn
    return (p + nrm * 1e-4).contiguous(), safe_normalize(d).contiguous()


def hit_agreement(name, hk, hp, unc_k=None, unc_p=None):
    """prim agreement >= PRIM_AGREE, equal uncertain masks, t/u/v within RTOL
    where prims agree -> (agree fraction, max abs err)."""
    import torch

    same = hk.prim == hp.prim
    agree = float(same.float().mean())
    m = same & (hp.prim >= 0)
    err = 0.0
    for f in ("t", "u", "v"):
        a, b = getattr(hk, f)[m], getattr(hp, f)[m]
        if a.numel():
            err = max(err, float((a - b).abs().max()))
            torch.testing.assert_close(a, b, rtol=RTOL, atol=1e-6, msg=f"{name}: {f} differs")
    if agree < PRIM_AGREE:
        raise AssertionError(f"{name}: prims agree on {agree:.6f} < {PRIM_AGREE}")
    if unc_k is not None and not torch.equal(unc_k, unc_p):
        raise AssertionError(f"{name}: uncertain masks differ")
    return agree, err


def check_dense(cm_small, rays_o, rays_d):
    """K3 against its plain version on the primary rays of the small mesh."""
    import torch

    from mirres_restir_nerf_mesh_torch.ops import dense_tracer as dt
    from mirres_restir_nerf_mesh_torch.ops.bvh import HitResult

    tris_cm = dt.tris_cm_from_soa(cm_small.soa)
    d = rays_d / rays_d.norm(dim=-1, keepdim=True)
    k = dt.dense_hit(tris_cm, rays_o, d)
    torch.cuda.synchronize()
    p = dt.dense_hit_plain(tris_cm, rays_o, d)

    def hr(x):
        z = torch.zeros_like(x[0])
        return HitResult(t=x[0], prim=x[1], u=x[2], v=x[3], normal=z)

    agree, err = hit_agreement("K3 dense_hit", hr(k), hr(p))
    ms = cuda_ms(lambda: dt.dense_hit(tris_cm, rays_o, d), 10)
    plain_ms = cuda_ms(lambda: dt.dense_hit_plain(tris_cm, rays_o, d), 3, warm=False)
    N, M = rays_o.shape[0], int((cm_small.soa[9] >= 0).sum())
    flops = N * M * MT_FLOPS
    nbytes = 10 * tris_cm.shape[1] * 4 + N * 6 * 4 + N * 4 * 4
    return dict(shape=f"{N} rays x {M} triangles", prim_agree=agree, max_abs_err=err, ms=ms,
                plain_ms=plain_ms, **bound(flops, nbytes))


def bound(flops: float, nbytes: float) -> dict:
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return dict(flops=flops, bytes=nbytes, bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes")


def shadow_rays(verts, tris, cm, cam, env, gen):
    """One spp's direct-light shadow batch, as sample_direct_mis traces it
    in the frame: the covered G-buffer points (live lanes only), offset 1e-4
    along the shading normal, towards env-sampled directions; t_max 1e9
    where the sample is usable, else 0 -> (origins, directions, t_max)."""
    import torch

    from mirres_restir_nerf_mesh_torch.models import envlight
    from mirres_restir_nerf_mesh_torch.ops.tracer import Tracer
    from mirres_restir_nerf_mesh_torch.render import brdf
    from mirres_restir_nerf_mesh_torch.render.gbuffer import (prepare_shading_normal,
                                                              raycast_gbuffer)

    gb = raycast_gbuffer(verts, tris, Tracer(cm, k_cap=640, queue_avg=256),
                         cam["rays_o"], cam["rays_d"])
    nrm = prepare_shading_normal(gb.view_dir, gb.normal, gb.face_normal)[gb.mask]
    pos = gb.position[gb.mask]
    tex = torch.as_tensor(env, device=pos.device)
    u = torch.rand((pos.shape[0], 2), generator=gen, device=pos.device)
    ldir, _, lpdf = envlight.sample_li(tex, envlight.build_sampler(tex), u)
    ok = (lpdf > 1e-12) & (brdf.to_local(ldir, nrm)[:, 2] > 1e-6)
    return ((pos + nrm * 1e-4).contiguous(), ldir.contiguous(),
            torch.where(ok, 1e9, 0.0))


def check_tile(name, cm, rays_o, rays_d, any_hit, sort, k_cap, queue_avg, t_max=1e10):
    """K1 against its plain version on one launch's prepared work."""
    import torch

    from mirres_restir_nerf_mesh_torch.ops import tile_tracer as tt

    work = tt.prepare_trace(cm, rays_o, rays_d, t_max=t_max, k_cap=k_cap, sort_octants=sort,
                            queue_avg=queue_avg)
    args = (cm.geom_cm, work.rays_cm, work.cand, work.octs, work.n_active, 1e-4, any_hit)
    out_k = tt.queue_trace(*args)
    torch.cuda.synchronize()
    stats = {}
    out_p = tt.queue_trace_plain(*args, stats=stats)
    hk = tt.finish_trace(cm, work, out_k, any_hit)
    hp = tt.finish_trace(cm, work, out_p, any_hit)
    agree, err = hit_agreement(name, hk.hit, hp.hit, hk.uncertain, hp.uncertain)
    ms = cuda_ms(lambda: tt.queue_trace(*args), 10)
    plain_ms = cuda_ms(lambda: tt.queue_trace_plain(*args), 3, warm=False)
    T, _, R = work.rays_cm.shape
    S = cm.geom_cm.shape[2]
    items = int(work.n_active.sum())
    flops = stats["items"] * R * SLAB_FLOPS + stats["useful_pairs"] * S * MT_FLOPS
    nbytes = (cm.geom_cm.numel() * 4 + work.rays_cm.numel() * 4 + items * 8 + T * 4
              + T * 5 * R * 4)
    return dict(shape=f"{rays_o.shape[0]} rays ({int((work.t_max > 1e-4).sum())} live), "
                      f"{T} tiles, {items} items, "
                      f"{stats['useful_pairs']} useful (ray, cluster) pairs",
                any_hit=any_hit, sort=str(sort), k_cap=k_cap, queue_avg=queue_avg,
                prim_agree=agree, uncertain=int(hk.uncertain.sum()), max_abs_err=err, ms=ms,
                plain_ms=plain_ms, **bound(flops, nbytes))


def frame_static(tris, H, W, spp, compute_dtype, **kw):
    from mirres_restir_nerf_mesh_torch.models.material import MaterialSpec
    from mirres_restir_nerf_mesh_torch.models.nerf import NeRFSpec
    from mirres_restir_nerf_mesh_torch.render.stage1 import Stage1Static

    return Stage1Static(
        tris=tris, nerf_spec=NeRFSpec(bound=1.0, compute_dtype=compute_dtype),
        mat_spec=MaterialSpec(bound=1.0, compute_dtype=compute_dtype),
        spp=spp, bounces=2, use_restir=False, H=H, W=W, **kw,
    )


def make_params(n_verts: int, seed: int, device):
    """Random weights from a seed, carried through the params_from_jax layout."""
    import torch

    from mirres_restir_nerf_mesh_torch.convert import params_from_jax, params_to_numpy
    from mirres_restir_nerf_mesh_torch.models.material import MaterialSpec, init_material
    from mirres_restir_nerf_mesh_torch.models.nerf import NeRFSpec, init_nerf
    from mirres_restir_nerf_mesh_torch.render.stage1 import Stage1Params

    g = torch.Generator(device=device).manual_seed(seed)
    p = Stage1Params(nerf=init_nerf(g, NeRFSpec(bound=1.0), device=device),
                     offsets=torch.zeros((n_verts, 3), device=device),
                     mat=init_material(g, MaterialSpec(bound=1.0), device=device),
                     env=torch.as_tensor(sky_env(), device=device))
    return params_from_jax(*params_to_numpy(p), device=device)


def camera(H, W, device):
    from mirres_restir_nerf_mesh_torch.data.synthetic import frame_rays, synthetic_cameras

    poses, intr = synthetic_cameras(n_frames=1, H=H, W=W, radius=1.3)
    return frame_rays(poses[0], intr, H, W, device)


def check_outputs(out, P):
    import torch

    for k, v in out.items():
        if not torch.is_floating_point(v):
            continue
        if not bool(torch.isfinite(v).all()):
            raise AssertionError(f"frame output {k!r} is not finite")
        if v.dim() and v.shape[0] != P:
            raise AssertionError(f"frame output {k!r} has shape {tuple(v.shape)}")


# outputs whose value at a pixel follows from its own G-buffer hit; the rest
# are Monte Carlo estimates, where one sampling decision that flips between
# card and CPU rounding moves a pixel by a whole sample
DETERMINISTIC = ("image", "weights_sum", "depth", "normal", "kd", "ks", "kd_grad", "ks_grad",
                 "normal_grad", "xyzs")


def compare_frames(gpu, cpu, P, out_dir):
    """Card vs CPU frame: mask and face_id agree on >= 99.9% of pixels; on the
    pixels whose face ids agree, every deterministic output within 1e-3 abs +
    1e-3 rel on >= 99.9% of them, every Monte Carlo output on >= 98% of them
    with its frame mean within 1% relative.  (The env sampler's CDF is a
    cumsum that the card rounds in another order than the CPU, so a few
    texels get one table entry more or less, which moves their pdf, and the
    MIS weights of samples landing there, by about 1%.)  Both frames go to
    out_dir/reference_check.npz when out_dir is given."""
    import numpy as np
    import torch

    if out_dir is not None:
        np.savez_compressed(out_dir / "reference_check.npz",
                            **{f"gpu_{k}": v.detach().cpu().numpy() for k, v in gpu.items()},
                            **{f"cpu_{k}": v.detach().numpy() for k, v in cpu.items()})
    fid = gpu["face_id"].cpu() == cpu["face_id"]
    res = {"mask": float((gpu["mask"].cpu() == cpu["mask"]).float().mean()),
           "face_id": float(fid.float().mean())}
    fails = [k for k in ("mask", "face_id") if res[k] < 0.999]
    for k, v in cpu.items():
        if k in ("mask", "face_id") or not torch.is_floating_point(v) or v.dim() == 0:
            continue
        g = gpu[k].detach().cpu().reshape(P, -1).double()
        c = v.detach().reshape(P, -1).double()
        ok = float(((g - c).abs() <= 1e-3 + 1e-3 * c.abs()).all(dim=1)[fid].float().mean())
        mean_rel = float((g.mean(0) - c.mean(0)).abs().max() / c.mean(0).abs().max().clamp_min(1e-9))
        res[k] = {"within": ok, "mean_rel": mean_rel}
        if ok < (0.999 if k in DETERMINISTIC else 0.98) or (
                k not in DETERMINISTIC and mean_rel > 0.01):
            fails.append(k)
    log("reference check (card vs CPU, 64x64 spp 2 fp32): " + json.dumps(res))
    if fails:
        raise AssertionError(f"reference check failed for {fails}")
    return res


def profile_frame(render, out_dir):
    """torch.profiler over one frame: device busy time (sum of kernel times)
    against the frame's wall time, the top kernels, and the device span of
    the frame's ranges (gbuffer, fields, indirect, direct, antialias,
    tile_prep / tile_kernel / tile_finish) -> summary dict; the full table
    goes to out_dir/frame_profile.txt when out_dir is given."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        render()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    ev = prof.key_averages()
    ranges = ("gbuffer", "fields", "indirect", "direct", "antialias", "tile_prep",
              "tile_kernel", "tile_finish")
    dev_ms = {e.key: getattr(e, "self_device_time_total", 0.0) / 1e3 for e in ev}
    # device-side work: kernels, copies and fills carry no host time; the
    # ranges' device spans (first to last kernel, gaps included) and the
    # host ops' own device totals would count the same kernels again
    kernels = {k: v for k, v in dev_ms.items()
               if k not in ranges and next(e for e in ev if e.key == k).cpu_time_total == 0}
    busy = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:10]
    if out_dir is not None:
        (out_dir / "frame_profile.txt").write_text(ev.table(sort_by="self_device_time_total",
                                                            row_limit=60))
    return {"wall_ms": wall_ms, "device_busy_ms": busy, "idle_share": 1.0 - busy / wall_ms,
            "range_device_span_ms": {k: dev_ms.get(k, 0.0) for k in ranges},
            "top_kernels_ms": [[k[:80], v] for k, v in top]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None,
                    help="directory for the full results, the profile table and both "
                         "reference-check frames (default: none written)")
    ap.add_argument("--profile", action="store_true",
                    help="also profile one bench frame (torch.profiler) after the main path")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs an NVIDIA card",
              file=sys.stderr)
        return 2
    from mirres_restir_nerf_mesh_torch import cuda_build
    from mirres_restir_nerf_mesh_torch.models import envlight
    from mirres_restir_nerf_mesh_torch.ops import dense_tracer, tile_tracer
    from mirres_restir_nerf_mesh_torch.ops.cluster_bvh import build_clusters
    from mirres_restir_nerf_mesh_torch.render.stage1 import draw_frame_randoms, render_stage1

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    out_dir = None
    if args.out:
        out_dir = Path(args.out)
        out_dir.mkdir(parents=True, exist_ok=True)

    # ---- 2. build
    t0 = time.perf_counter()
    logs = cuda_build.build(force=True)
    build_s = time.perf_counter() - t0
    log(f"build: {build_s:.2f} s for {', '.join(cuda_build.KERNELS)}")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "smem" in line or "spill" in line:
                log(f"  ptxas[{name}]: {line.strip()}")

    # ---- meshes, cameras, weights
    t0 = time.perf_counter()
    v_big, f_big = bench_mesh(BENCH_FACES)
    v_small, f_small = bench_mesh(SMALL_FACES)
    log(f"meshes: {f_big.shape[0]} and {f_small.shape[0]} triangles "
        f"({time.perf_counter() - t0:.1f} s)")
    vb, fb = torch.as_tensor(v_big, device=dev), torch.as_tensor(f_big, device=dev)
    vs, fs = torch.as_tensor(v_small, device=dev), torch.as_tensor(f_small, device=dev)
    cm_big, cm_small = build_clusters(vb, fb), build_clusters(vs, fs)
    H = W = FRAME_HW
    P = H * W
    cam = camera(H, W, dev)
    log(f"clusters: bench {tuple(cm_big.prim.shape)}, small {tuple(cm_small.prim.shape)}")

    # ---- 3. kernels against their plain versions
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    k3 = check_dense(cm_small, cam["rays_o"], cam["rays_d"])
    log("K3 dense_hit: " + json.dumps(k3))
    d_prim = cam["rays_d"] / cam["rays_d"].norm(dim=-1, keepdim=True)
    k1_checks = [check_tile("K1 closest, primary", cm_big, cam["rays_o"], d_prim, False, False,
                            640, 256)]
    bo, bd = bounce_rays(vb, fb, BOUNCE_RAYS, gen)
    k1_checks.append(check_tile("K1 closest, bounce", cm_big, bo, bd, False, "morton", 640, 64))
    k1_checks.append(check_tile("K1 any, bounce", cm_big, bo, bd, True, "morton", 640, 64,
                                t_max=1e9))
    so, sd, st_max = shadow_rays(vb, fb, cm_big, cam, sky_env(), gen)
    k1_checks.append(check_tile("K1 any, direct shadow", cm_big, so, sd, True, "morton", 640, 64,
                                t_max=st_max))
    for c in k1_checks:
        log("K1 tile_trace: " + json.dumps(c))
    del bo, bd, so, sd, st_max
    torch.cuda.empty_cache()

    # ---- 4. the main path: counters zeroed, frames rendered, counters read
    static = frame_static(f_big, H, W, FRAME_SPP, torch.bfloat16, k_cap=640, queue_avg=256,
                          k_cap_incoherent=640, queue_avg_incoherent=64)
    params = make_params(v_big.shape[0], args.seed, dev)
    static_s = frame_static(f_small, H, W, FRAME_SPP, torch.bfloat16)
    params_s = make_params(v_small.shape[0], args.seed, dev)
    tile_tracer.queue_trace.launches = 0
    dense_tracer.dense_hit.launches = 0
    times, outs = [], None
    for i in range(1 + TIMED_FRAMES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = render_stage1(params, static, vb, cam["rays_o"], cam["rays_d"], generator=gen)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        log(f"frame {i} ({'warm' if i == 0 else 'timed'}): {times[-1]:.3f} s, "
            f"uncertain {float(outs['uncertain_count']):.0f}, "
            f"traced {float(outs['traced_rays']):.0f}")
    k1_frame = tile_tracer.queue_trace.launches
    out_s = render_stage1(params_s, static_s, vs, cam["rays_o"], cam["rays_d"], generator=gen)
    torch.cuda.synchronize()
    launches = {"tile_trace": tile_tracer.queue_trace.launches,
                "dense_hit": dense_tracer.dense_hit.launches}
    check_outputs(outs, P)
    check_outputs(out_s, P)
    frame_s = float(statistics.median(times[1:]))
    nominal = P * (1 + FRAME_SPP * 6)
    frame = {
        "H": H, "W": W, "spp": FRAME_SPP, "bounces": 2, "triangles": int(f_big.shape[0]),
        "frame_s": frame_s, "frame_s_all": times,
        "nominal_rays_per_frame": nominal,
        "nominal_Mrays_per_s": nominal / frame_s / 1e6,
        "traced_rays_per_frame": float(outs["traced_rays"]),
        "coverage": float(outs["mask"].float().mean()),
        "uncertain_count": float(outs["uncertain_count"]),
        "K1_launches_per_frame": k1_frame / (1 + TIMED_FRAMES),
        "small_mesh_triangles": int(f_small.shape[0]),
        "small_mesh_uncertain": float(out_s["uncertain_count"]),
        "small_mesh_coverage": float(out_s["mask"].float().mean()),
        "launches": launches,
    }
    log("frame: " + json.dumps(frame))
    if args.profile:
        prof = profile_frame(lambda: render_stage1(params, static, vb, cam["rays_o"],
                                                   cam["rays_d"], generator=gen), out_dir)
        log("frame profile: " + json.dumps(prof))
    if frame["uncertain_count"] != 0 or frame["small_mesh_uncertain"] != 0:
        raise AssertionError("uncertain_count != 0 at the bench budgets")
    if launches["tile_trace"] <= 0 or launches["dense_hit"] <= 0:
        raise AssertionError(f"a kernel of the path never launched: {launches}")

    # ---- 5. reference check: card vs CPU on a small fp32 frame
    Hs = Ws = 64
    cam_s = camera(Hs, Ws, "cpu")
    st = frame_static(f_small, Hs, Ws, 2, torch.float32)
    p_cpu = make_params(v_small.shape[0], args.seed, "cpu")
    p_gpu = type(p_cpu)(*(tree_to(x, dev) for x in p_cpu))
    rnd = draw_frame_randoms(Hs * Ws, st, torch.Generator().manual_seed(args.seed + 1), "cpu")
    ref = render_stage1(p_cpu, st, torch.as_tensor(v_small), cam_s["rays_o"], cam_s["rays_d"],
                        rand=rnd)
    got = render_stage1(p_gpu, st, vs, cam_s["rays_o"].to(dev), cam_s["rays_d"].to(dev),
                        rand=type(rnd)(*(x.to(dev) for x in rnd)))
    agree = compare_frames(got, ref, Hs * Ws, out_dir)
    agree["env_table_entries_differing"] = int(
        (envlight.build_sampler(p_gpu.env).table.cpu()
         != envlight.build_sampler(p_cpu.env).table).sum())
    log(f"env sampler table entries differing, card vs CPU: {agree['env_table_entries_differing']}")

    # ---- 6. results; K1's headline is the direct-shadow batch, the shape of
    # 64 of its 69 launches a frame
    k1 = k1_checks[3]
    kernels = [
        dict(name="tile_trace (K1)", route="cuda",
             source="mirres_restir_nerf_mesh_torch/csrc/tile_trace.cu",
             replaces="mirres_restir_nerf_mesh_tpu/ops/tile_tracer.py:190",
             launches=launches["tile_trace"],
             max_abs_err=max(c["max_abs_err"] for c in k1_checks),
             ms=k1["ms"], plain_ms=k1["plain_ms"], bound_ms=k1["bound_ms"],
             bound_by=k1["bound_by"], library_ms=None, checks=k1_checks),
        dict(name="dense_hit (K3)", route="cuda",
             source="mirres_restir_nerf_mesh_torch/csrc/dense_hit.cu",
             replaces="mirres_restir_nerf_mesh_tpu/ops/pallas_tracer.py:40",
             launches=launches["dense_hit"], max_abs_err=k3["max_abs_err"],
             ms=k3["ms"], plain_ms=k3["plain_ms"], bound_ms=k3["bound_ms"],
             bound_by=k3["bound_by"], library_ms=None, checks=[k3]),
    ]
    if out_dir is not None:
        (out_dir / "chip_smoke.json").write_text(json.dumps(
            {"card": card, "build_s": build_s, "kernels": kernels, "frame": frame,
             "reference_check": agree}, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


def tree_to(x, dev):
    if isinstance(x, dict):
        return {k: tree_to(v, dev) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [tree_to(v, dev) for v in x]
    return x.to(dev)


if __name__ == "__main__":
    sys.exit(main())
