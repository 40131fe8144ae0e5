#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port's stage-1 forward frame and train step,
with and without ReSTIR DI, on one NVIDIA card.

    python3 chip_smoke.py [--seed N] [--out DIR] [--profile]
    python3 chip_smoke.py --k3-route    (the dense route alone; see k3_route)

Phases (any failure exits non-zero):

1. Require CUDA; print the card's name and power limit (nvidia-smi).
2. Build the hand-written kernels from ``mirres_restir_nerf_mesh_torch/csrc``
   (one nvcc per source, started together); print the build seconds and
   ptxas' register / shared-memory report.
3. Hold each kernel against its plain PyTorch version on the card, at the
   shapes of the frame, and time both with CUDA events (median).
   K3 (dense tracer, the route of meshes of at most 8192 padded triangle
   slots) on the 6,000-triangle small mesh, at the launches of its frames,
   the rays in the route's order (incoherent batches of at least 65,536
   rays sorted by octant and origin, as Tracer asks): closest hit on the 65,536 primary rays and on a
   1M-ray bounce-shaped batch; any hit on that batch (t_max 1e9), on one
   spp's direct-shadow batch (dead lanes included) and on one spatial
   cross-visibility launch recorded from the small-mesh ReSTIR frame (t_max
   per ray); closest and any hit on a ragged batch (50,001 rays; 61
   clusters of 99, so M is no multiple of the staged block and its rows do
   not start on 16 bytes).  Each at the wrapper's split and unsplit: rows
   (t, index, u, v) or the mask equal to the plain version's bit for bit;
   event, device (queued) and host ms, the bound, the --fmad=false issue
   floor of the same operations, the occluded share and the dead lanes.
   K1 (tile tracer) closest hit on the
   65,536 primary rays of the ~100k-triangle bench mesh, closest and any
   hit on a 1M-ray bounce-shaped batch (surface origins, cosine directions,
   "morton" sort, k_cap 640, queue_avg 64), and any hit on one spp's
   direct-light shadow batch (the covered G-buffer points towards
   env-sampled directions, as sample_direct_mis traces them; same budget),
   and any hit on the rays of one spatial cross-visibility launch recorded
   from a ReSTIR bench frame (the shape of 32 of its 37 launches).  K2 (the
   tile tracer without the work budget, ``queue=False``) on the primary
   rays and the direct-shadow batch, each batch traced first through the
   K2 path, the public entry points (``intersect_tiles_t`` /
   ``occluded_tiles_t`` with queue=False, the counters zeroed just before
   and read just after): their hits and uncertain masks must equal the
   budgeted (K1) entry points', which are exact at these budgets.  K1 and
   K2 run at the split the wrapper picks for the launch (blocks per tile,
   from the SM count) and, where that is not 1, unsplit as well: their
   output rows must equal the plain version's exactly (hence prims 100%,
   max abs error 0, equal uncertain masks).  Each check prints its split,
   the event time of the wrapper call, its device time (CUDA events
   around 20 calls queued behind a sleep kernel that outlasts their
   issue, so that the host's launch cost drops out) and its host time, and
   event and device time for the unsplit kernel where the split is not 1.  (No profiler runs before the main path: once torch.profiler has run
   in a process, every later launch costs the host more, and the frames
   and steps here are host-bound.)  K4 (scatter-add, the hash-grid
   backward) at one material encode's backward of the bench frame: the
   covered G-buffer points' 16 levels x 8 corners of absolute row ids
   ([N, 128], the layout GatherRows passes) into the 6,328,848-row
   material table, random fp32 updates, through the 2-D and the 1-D entry,
   and the same updates all into 8 rows (contention); within
   1e-5 * sum|upd| at each row; timed beside its plain version and the one
   PyTorch call that computes the same function (index_add_ on a zeroed
   table): event times of the calls, and device times of the kernel alone,
   the zeroing alone and index_add_ alone on inputs and a table allocated
   beforehand (queued the same way).
4. The main path: the launch counters are zeroed, then ``render_stage1``
   (use_restir=False) renders bench.py's operating point (256x256, spp 32,
   2 bounces, ~100k triangles, k_cap 640, queue_avg 256/64, bf16 MLPs) once
   warm and three times timed; the counters are read right after.  Then,
   counters zeroed again, the same frame of the 6,000-triangle small mesh
   (the dense route), one warm and three timed.  Outputs must be finite,
   uncertain_count 0, K1 launched on the bench mesh, and on the small mesh
   K3 alone: 3 closest-hit (primary, 2 bounces) and 66 any-hit (2 NEE, 64
   direct shadows) launches a frame.
4b. The lighter train step (the counters zeroed again): bench.py's
   train-step config with use_restir=False and denoise_iters=0, on the
   bench frame's pixels and alpha and its sky + sun env, one warm and three
   timed steps.  Loss, params and Adam moments (hence gradients) must be
   finite, uncertain_count 0, and K4 launched 3 times a step (material,
   jittered material and NeRF encodes).
4c. bench.py's own frame (the counters zeroed again): use_restir=True (128
   light tiles of 1024, 32 light + 1 BRDF candidates, 5 neighbours in a 30
   px radius, 8192 offsets, unbiased spatial reuse with visibility
   threading) and denoise_iters=4, one warm and three timed frames: frame
   s, nominal Mrays/s (bench.py's count, 65,536 x (1 + 32 x 16) rays),
   traced rays, coverage, peak memory; uncertain_count 0 and 37 K1
   launches a frame (1 primary, 2 bounces x (closest hit + NEE with the
   initial winners' visibility fused in), 32 spatial cross visibility).
4d. bench.py's own train step with that static (the counters zeroed
   again): one warm and three timed steps, loss, peak memory, K4 launched
   3 times and K1 37 times a step, uncertain_count 0.
4e. bench.py's ReSTIR frame (use_restir=True, denoise_iters=4) on the small
   mesh (the counters zeroed again): one warm and three timed frames, frame
   s and coverage; uncertain_count 0 and K3 alone, 3 closest-hit and 34
   any-hit (2 NEE with the initial visibility fused in, 32 spatial cross
   visibility) launches a frame.
5. Reference check: a 64x64, spp-2 frame of the small mesh in fp32 on the
   card against the same frame on the CPU (the plain versions, which the
   CPU tests hold against the JAX package), same weights and randoms.
5b. The same for one train step: loss within 1e-3 relative; per optimizer
   group the gradient within 5e-2 relative L2 with cosine >= 0.999, and the
   NeRF group's gradient (its image depends on the G-buffer hits alone, no
   Monte Carlo decision) within 1e-4.  The params after the step are held
   to the same 5e-2 / 0.999 per group over the entries whose CPU gradient
   lies clearly above the card's difference from it, |g_cpu| > 8 |g_card -
   g_cpu| (the count kept is printed; the reading over all entries is
   printed, not gated).  Below that rule an entry's gradient is noise:
   about 1% of the pixels take other Monte Carlo decisions on the card, as
   in phase 5, and Adam's first step moves every entry by about +-lr
   whatever its gradient's size, so a noise-level entry lands 2 lr apart
   when its sign flips (~4% of the offsets' and the material encoder's L2
   over all entries).  Where the rule holds, the two gradients have one
   sign and the two steps agree.  ``--plant-k4-fault scale|drop`` runs this
   phase alone with K4's updates scaled by 1.01 or one K4 launch of three
   dropped, and exits 0 only if the phase then fails.
5c. The same for a 64x64, spp-2, fp32 ReSTIR frame of the small mesh with
   normal-AO, without and with the denoiser (denoise_iters 2): mask,
   face_id and every deterministic buffer (normal_ao included) agree on
   >= 99.9% of pixels; image_brdf, diffuse_light and specular_light frame
   means within 1e-2 relative.  The per-pixel agreement share of each
   Monte Carlo buffer is printed: spatial reuse and the denoiser carry a
   sampling decision that differs on the card to neighbouring pixels.
6. Print the kernel table as one JSON line (K1, K2, K3 closest hit, K3 any
   hit, K4), the card line, and as the last line {"ok": true, "device":
   {...}}.
"""

from __future__ import annotations

import argparse
import functools
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
# the part of a Moeller-Trumbore test that K3 runs before its first cull can
# drop it (9 cross, 5 det, 3 tvec, 5 u numerator)
MT_CULL_FLOPS = 22
# fp32 operations of K3's warp-bundle test of one group of 4 triangles
# (csrc/dense_hit.cu group_maybe) up to its distance cut: the group's box
# (4 x (6 adds + 18 min/max)) and the ball, margin and limit test (44); the
# cone test after it is not counted
GROUP_FLOPS = 140
# the issue rate of one fp32 operation per instruction (code built with
# --fmad=false): 128 fp32 lanes per SM at the H100 SXM's 1.98 GHz boost clock
FP32_LANES_PER_SM = 128
SM_CLOCK_HZ = 1.98e9

PRIM_AGREE = 0.9999
RTOL = 1e-5

# bench.py's operating point
FRAME_HW = 256
FRAME_SPP = 32
BENCH_FACES = 100_000
SMALL_FACES = 6_000
BOUNCE_RAYS = 1 << 20
TIMED_FRAMES = 3
TIMED_STEPS = 3
K4_STEP_LAUNCHES = 3        # material, jittered material, NeRF encode backward
# bench.py's ReSTIR static and its nominal rays per frame: primary, then per
# spp initial visibility, 2 x 5 spatial cross visibility, final visibility,
# 2 bounces x (closest hit + NEE)
RESTIR = dict(use_restir=True, restir_tiles=128, restir_tile_size=1024, restir_light_samples=32,
              restir_brdf_samples=1, restir_neighbors=5, restir_radius=30.0, restir_offsets=8192,
              denoise_iters=4)
RESTIR_RAYS_PER_SPP = 1 + 2 * 5 + 1 + 2 * 2
# K3 launches a small-mesh frame (closest, any hit): primary + 2 bounces;
# lighter: 2 NEE + 32 spp x 2 direct shadows, ReSTIR: 2 NEE (initial
# visibility fused in) + 32 spatial cross visibility
K3_FRAME = (3, 2 + 2 * FRAME_SPP)
K3_RESTIR_FRAME = (3, 2 + FRAME_SPP)


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


def host_ms(fn) -> float:
    """Host time of one fn() call that only launches work (no sync inside),
    after a warm call."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    return ms


def queued_ms(fn, n: int = 20, reps: int = 5) -> float:
    """Device time of one fn() that only launches work on inputs and
    outputs allocated beforehand: CUDA events around n calls queued behind
    a sleep kernel three times as long as the host takes to issue them, so
    the card runs them back to back whatever the host's launch cost;
    median over reps of the span / n."""
    import torch

    cycles = int(max(10.0, 3 * n * host_ms(fn)) * 2e6)    # ~2 GHz SM clock
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        torch.cuda._sleep(cycles)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(n):
            fn()
        e.record()
        torch.cuda.synchronize()
        times.append(s.elapsed_time(e) / n)
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


def same_bits(a, b) -> bool:
    """Equal bit for bit (floats compared as their int32 bits: -0 is not +0)."""
    import torch

    def raw(x):
        return x.view(torch.int32) if x.is_floating_point() else x

    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(raw(a), raw(b))


def check_k3(name, cm, rays_o, rays_d, t_max=None, sort=False):
    """K3 against its plain version on one launch of the dense route: the
    rays in the route's order (``dense_order``; sort = the route's
    sort_octants), closest hit (t_max None) or any hit below t_max.  At the
    wrapper's split and, where that is not 1, unsplit: rows (t, index, u,
    v) or the mask equal to the plain version's bit for bit.  Times: event
    ms of the wrapper call, its device ms (queued_ms) and host ms; event and
    device ms unsplit.  Bound: the work the kernel cannot skip on this
    run's data, from the plain mirror of its warp-bundle cull
    (``bundle_keep_plain``) at the least limit a ray can reach (closest:
    its hit's t, for every ray; any hit: t_max, for the live rays left
    unoccluded): MT_CULL_FLOPS (the operations before its first cull) per
    (ray, triangle) test of a group a warp keeps, one test per occluded
    ray, the rest of a full test (45 operations) per hit, and GROUP_FLOPS
    per group test of a warp that culls, against 67 TFLOP/s; beside it the issue floor of the
    same operations as single instructions (``--fmad=false``) on 128 fp32
    lanes per SM, and, as a label, the bound of the uncut work (every live
    triangle of every ray the unculled kernel would test)."""
    import torch

    from mirres_restir_nerf_mesh_torch.ops import dense_tracer as dt
    from mirres_restir_nerf_mesh_torch.ops import tile_tracer as tt

    tris = cm.soa
    any_hit = t_max is not None
    ro, rd, tm, _ = tt.dense_order(cm, rays_o, rays_d, 1e10 if t_max is None else t_max, sort)
    N, Mcols = ro.shape[0], tris.shape[1]
    M = int((tris[9] >= 0).sum())
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    n_blk = -(-Mcols // dt.KERNEL_BM)
    auto = dt.split_factor(-(-N // dt.THREADS), sms, n_blk)
    if any_hit:
        def run(split=None):
            return dt.dense_occluded(tris, ro, rd, tm, split=split)

        p = dt.dense_occluded_plain(tris, ro, rd, tm)
    else:
        def run(split=None):
            return dt.dense_hit(tris, ro, rd, split=split)

        p = dt.dense_hit_plain(tris, ro, rd)
    torch.cuda.synchronize()
    splits = [auto] + ([1] if auto != 1 else [])
    for sp in splits:
        k = run(sp)
        torch.cuda.synchronize()
        pairs = [(k, p)] if any_hit else list(zip(k, p))
        bad = [i for i, (a, b) in enumerate(pairs) if not same_bits(a, b)]
        if bad:
            raise AssertionError(f"{name} (split {sp}): rows {bad} differ from the plain "
                                 "version's")
    res = dict(shape=f"{N} rays x {M} triangles ({Mcols} slots)", any_hit=any_hit,
               sort=str(sort), split=auto, splits_checked=splits, rows_equal=True,
               max_abs_err=0.0,
               ms=cuda_ms(run, 10), device_ms=queued_ms(run), host_ms=host_ms(run))
    if auto != 1:
        res["ms_split_1"] = cuda_ms(lambda: run(1), 10)
        res["device_ms_split_1"] = queued_ms(lambda: run(1))
    plain = (lambda: dt.dense_occluded_plain(tris, ro, rd, tm)) if any_hit else \
        (lambda: dt.dense_hit_plain(tris, ro, rd))
    res["plain_ms"] = cuda_ms(plain, 2, warm=False)
    live = tm > 1e-4
    if any_hit:
        # the bundles of the live rays left unoccluded, up to their t_max;
        # an occluded ray takes at least one test
        keep, culls = dt.bundle_keep_plain(tris, ro, rd, tm, live & ~p)
        rays = live & ~p
        occ = int(p.sum())
        hits, uncut = occ, (int(live.sum()) - occ) * M + occ
        res.update(live=int(live.sum()), dead=N - int(live.sum()), occluded=occ,
                   occluded_share=occ / max(int(live.sum()), 1))
        nbytes = 10 * Mcols * 4 + N * 7 * 4 + N
    else:
        # the bundles of all rays, up to their closest hit
        keep, culls = dt.bundle_keep_plain(tris, ro, rd, p[0])
        rays = torch.ones((N,), dtype=torch.bool, device=ro.device)
        hits, uncut = int((p[1] >= 0).sum()), N * M
        res["hit_share"] = hits / N
        nbytes = 10 * Mcols * 4 + N * 6 * 4 + N * 4 * 4
    W, G = keep.shape
    per_warp = torch.cat([rays, rays.new_zeros(32 * W - N)]).reshape(W, 32).sum(1)
    real = torch.cat([tris[9] >= 0, torch.zeros(4 * G - Mcols, dtype=torch.bool,
                                                 device=ro.device)]).reshape(G, 4).sum(1)
    tests = int(((keep.double() @ real.double()) * per_warp).sum()) + (hits if any_hit else 0)
    group_tests = int(((per_warp > 0) & culls).sum()) * G
    flops = tests * MT_CULL_FLOPS + hits * (MT_FLOPS - MT_CULL_FLOPS) + group_tests * GROUP_FLOPS
    res.update(tests=tests, group_tests=group_tests, kept_share=tests / max(uncut, 1),
               issue_floor_ms=flops / (sms * FP32_LANES_PER_SM * SM_CLOCK_HZ) * 1e3,
               **bound(flops, nbytes),
               uncut_tests=uncut, uncut_bound_ms=uncut * MT_FLOPS / FP32_FLOP_PER_S * 1e3)
    return res


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


def kernel_vs_plain(name, work, cm, run, args):
    """Run the kernel (split None = its own choice, then split 1 where that
    differs) and the plain version on one launch's prepared work: rows
    must be equal, as must the finished hits and uncertain masks -> (stats
    of the plain version, hit agreement, max abs error, splits checked)."""
    import torch

    from mirres_restir_nerf_mesh_torch.ops import tile_tracer as tt

    stats = {}
    out_p = tt.queue_trace_plain(*args, stats=stats)
    hp = tt.finish_trace(cm, work, out_p, args[-1])
    T = work.rays_cm.shape[0]
    auto = tt.split_factor(T, torch.cuda.get_device_properties(0).multi_processor_count)
    splits = [auto] + ([1] if auto != 1 else [])
    err = 0.0
    for sp in splits:
        out_k = run(*args, split=sp)
        torch.cuda.synchronize()
        hk = tt.finish_trace(cm, work, out_k, args[-1])
        agree, e = hit_agreement(f"{name} (split {sp})", hk.hit, hp.hit, hk.uncertain,
                                 hp.uncertain)
        err = max(err, e, float((out_k - out_p).abs().max()))
        if not torch.equal(out_k, out_p):
            raise AssertionError(f"{name} (split {sp}): kernel rows differ from the plain "
                                 f"version's on {int((out_k != out_p).sum())} entries")
    return stats, agree, err, splits, hk


def k1_times(run, args, splits):
    """At the kernel's own split: event ms of the wrapper call, its device
    ms (queued_ms: the int32 casts, the key memset, the kernel and the
    finish kernel) and its host ms; event and device ms at split 1 where
    that differs."""
    res = dict(ms=cuda_ms(lambda: run(*args), 10), device_ms=queued_ms(lambda: run(*args)),
               host_ms=host_ms(lambda: run(*args)))
    if len(splits) > 1:
        res["ms_split_1"] = cuda_ms(lambda: run(*args, split=1), 10)
        res["device_ms_split_1"] = queued_ms(lambda: run(*args, split=1))
    return res


def check_tile(name, cm, rays_o, rays_d, any_hit, sort, k_cap, queue_avg, t_max=1e10):
    """K1 against its plain version on one launch's prepared work."""
    from mirres_restir_nerf_mesh_torch.ops import tile_tracer as tt

    work = tt.prepare_trace(cm, rays_o, rays_d, t_max=t_max, k_cap=k_cap, sort_octants=sort,
                            queue_avg=queue_avg)
    args = (cm.geom_cm, work.rays_cm, work.cand, work.octs, work.n_active, 1e-4, any_hit)
    stats, agree, err, splits, hk = kernel_vs_plain(name, work, cm, tt.queue_trace, args)
    times = k1_times(tt.queue_trace, args, splits)
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
                split=splits[0], splits_checked=splits,
                prim_agree=agree, uncertain=int(hk.uncertain.sum()), max_abs_err=err, **times,
                plain_ms=plain_ms, **bound(flops, nbytes))


def check_grid(name, cm, rays_o, rays_d, any_hit, sort, k_cap, queue_avg, counts,
               t_max=1e10):
    """The K2 path on one batch, then K2 against its plain version.

    The public entry point with queue=False runs with the launch counters
    zeroed just before and read just after (`counts`: (zero, read)), and
    its hits and uncertain mask are held against the budgeted (K1) entry
    point's.  Then the kernel and queue_trace_plain (with the tiles'
    counts) run on that launch's prepared work."""
    import torch

    from mirres_restir_nerf_mesh_torch.ops import tile_tracer as tt

    zero, read = counts
    kw = dict(k_cap=k_cap, sort_octants=sort)
    zero()
    if any_hit:
        grid = tt.occluded_tiles_t(cm, rays_o, rays_d, t_max, queue=False, **kw)
    else:
        res = tt.intersect_tiles_t(cm, rays_o, rays_d, t_max=t_max, queue=False, **kw)
        grid = (res.hit.prim, res.uncertain)
    torch.cuda.synchronize()
    path_launches = read()
    if any_hit:
        queue = tt.occluded_tiles_t(cm, rays_o, rays_d, t_max, queue_avg=queue_avg, **kw)
    else:
        res = tt.intersect_tiles_t(cm, rays_o, rays_d, t_max=t_max, queue_avg=queue_avg, **kw)
        queue = (res.hit.prim, res.uncertain)
    entry_equal = float((grid[0] == queue[0]).float().mean())
    entry_uncertain = int(grid[1].sum()) + int(queue[1].sum())
    del grid, queue

    work = tt.prepare_trace(cm, rays_o, rays_d, t_max=t_max, queue=False, **kw)
    args = (cm.geom_cm, work.rays_cm, work.cand, work.octs, work.counts, 1e-4, any_hit)
    stats, agree, err, splits, hk = kernel_vs_plain(name, work, cm, tt.grid_trace, args)
    times = k1_times(tt.grid_trace, args, splits)
    plain_ms = cuda_ms(lambda: tt.queue_trace_plain(*args), 3, warm=False)
    T, _, R = work.rays_cm.shape
    S = cm.geom_cm.shape[2]
    items = int(work.counts.sum())
    flops = stats["items"] * R * SLAB_FLOPS + stats["useful_pairs"] * S * MT_FLOPS
    nbytes = (cm.geom_cm.numel() * 4 + work.rays_cm.numel() * 4 + items * 8 + T * 4
              + T * 5 * R * 4)
    out = dict(shape=f"{rays_o.shape[0]} rays ({int((work.t_max > 1e-4).sum())} live), "
                     f"{T} tiles, {items} items (no budget), "
                     f"{stats['useful_pairs']} useful (ray, cluster) pairs",
               any_hit=any_hit, sort=str(sort), k_cap=k_cap, split=splits[0],
               splits_checked=splits, prim_agree=agree,
               uncertain=int(hk.uncertain.sum()), max_abs_err=err, **times, plain_ms=plain_ms,
               path_launches=path_launches, entry_points_equal=entry_equal,
               entry_points_uncertain=entry_uncertain, **bound(flops, nbytes))
    if path_launches["grid_trace"] != 1 or sum(path_launches.values()) != 1 or \
            entry_equal != 1.0 or entry_uncertain:
        raise AssertionError(f"{name}: the K2 path's entry point: {out}")
    return out


def record_occluded(run):
    """Run run() with every Tracer.occluded batch recorded -> [(rays_o,
    rays_d, t_max)] in launch order (copies)."""
    import torch

    from mirres_restir_nerf_mesh_torch.ops import tile_tracer
    from mirres_restir_nerf_mesh_torch.ops.tracer import Tracer

    calls = []
    orig = Tracer.occluded

    def recording(self, rays_o, rays_d, t_max, t_min=1e-4, incoherent=False):
        tm = tile_tracer._t_max_array(t_max, rays_o.shape[0], rays_o.device)
        calls.append((rays_o.clone(), rays_d.clone(), tm.clone()))
        return orig(self, rays_o, rays_d, t_max, t_min=t_min, incoherent=incoherent)

    Tracer.occluded = recording
    try:
        with torch.no_grad():
            run()
    finally:
        Tracer.occluded = orig
    return calls


def scatter_case(name, idx, upd, rows):
    """K4 through its entry point against its plain version (within
    1e-5 * sum|upd| at each row), then its times: event ms of the wrapper
    (zeroed table + kernel) beside zeros + index_add_, and the device ms of
    the kernel alone, of zeroing the table and of index_add_ alone, each
    on inputs and a table allocated beforehand (queued_ms)."""
    import torch

    from mirres_restir_nerf_mesh_torch.ops.scatter import (scatter_add, scatter_add_into,
                                                           scatter_add_plain)

    k = scatter_add(idx, upd, rows)
    torch.cuda.synchronize()
    p = scatter_add_plain(idx, upd, rows)
    err = (k - p).abs()
    tol = 1e-5 * scatter_add_plain(idx, upd.abs(), rows) + 1e-30
    if not bool((err <= tol).all()):
        raise AssertionError(f"{name}: differs from its plain version by {float(err.max())}")
    idx_l, upd_f = idx.reshape(-1).long(), upd.reshape(-1, upd.shape[-1])
    table = torch.zeros((rows, upd.shape[-1]), device=upd.device)

    def library():
        return torch.zeros_like(table).index_add_(0, idx_l, upd_f)

    return dict(max_abs_err=float(err.max()), max_err_over_tol=float((err / tol).max()),
                ms=cuda_ms(lambda: scatter_add(idx, upd, rows), 10),
                plain_ms=cuda_ms(lambda: scatter_add_plain(idx, upd, rows), 3),
                library_ms=cuda_ms(library, 10),
                device_ms=queued_ms(lambda: scatter_add_into(table, idx, upd)),
                zero_device_ms=queued_ms(table.zero_),
                library_device_ms=queued_ms(lambda: table.index_add_(0, idx_l, upd_f)))


def check_scatter(verts, tris, cm, cam, gen):
    """K4 against its plain version at one material encode's backward of
    the bench frame (the covered G-buffer points' [N, 128] row ids, random
    fp32 updates), through the 2-D entry GatherRows uses and the 1-D one,
    and on a contention-heavy input (the same count of updates, all into 8
    rows); each timed beside its plain version and index_add_."""
    import torch

    from mirres_restir_nerf_mesh_torch.models.material import MaterialSpec
    from mirres_restir_nerf_mesh_torch.ops import hashgrid
    from mirres_restir_nerf_mesh_torch.ops.tracer import Tracer
    from mirres_restir_nerf_mesh_torch.render.gbuffer import raycast_gbuffer

    gb = raycast_gbuffer(verts, tris, Tracer(cm, k_cap=640, queue_avg=256),
                         cam["rays_o"], cam["rays_d"])
    spec = MaterialSpec(bound=1.0).grid
    idx = hashgrid.encode_rows(gb.position[gb.mask], spec, bound=1.0)[0].contiguous()
    rows, C = spec.n_params, spec.level_dim
    upd = torch.randn((*idx.shape, C), generator=gen, device=idx.device)
    nbytes = idx.numel() * 4 + upd.numel() * 4 + rows * C * 4
    res = dict(shape=f"{int(gb.mask.sum())} points x {spec.num_levels} levels x 8 corners = "
                     f"{idx.numel()} updates of {C} into {rows} rows",
               **scatter_case("K4 scatter_add", idx, upd, rows), **bound(0, nbytes))
    flat = scatter_case("K4 scatter_add, 1-D entry", idx.reshape(-1), upd.reshape(-1, C), rows)
    few = torch.randint(0, 8, idx.shape, generator=gen, device=idx.device, dtype=torch.int32)
    hot = scatter_case("K4 scatter_add, all updates into 8 rows", few, upd, 8)
    res["one_d_entry"] = {k: flat[k] for k in ("max_abs_err", "ms", "device_ms")}
    res["contention"] = dict(shape=f"{idx.numel()} updates of {C} into 8 rows", **hot,
                             **bound(0, idx.numel() * 4 + upd.numel() * 4 + 8 * C * 4))
    return res


def frame_static(tris, H, W, spp, compute_dtype, **kw):
    from mirres_restir_nerf_mesh_torch.models.material import MaterialSpec
    from mirres_restir_nerf_mesh_torch.models.nerf import NeRFSpec
    from mirres_restir_nerf_mesh_torch.render.stage1 import Stage1Static

    return Stage1Static(
        tris=tris, nerf_spec=NeRFSpec(bound=1.0, compute_dtype=compute_dtype),
        mat_spec=MaterialSpec(bound=1.0, compute_dtype=compute_dtype),
        spp=spp, bounces=2, H=H, W=W, **kw,
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
    """bench.py's frame: the synthetic orbit camera at radius 1.3, its rays,
    and the analytic sphere's pixels on white and alpha."""
    from mirres_restir_nerf_mesh_torch.data.synthetic import frame_batch, make_synthetic_dataset

    poses, intr, images = make_synthetic_dataset(n_frames=1, H=H, W=W, radius=1.3)
    return frame_batch(poses[0], intr, images[0], device)


def train_config(spp: int, use_restir: bool = False):
    """bench.py's train-step config (the frame's ReSTIR and denoiser settings
    come from the static)."""
    from mirres_restir_nerf_mesh_torch.config import Config, finalize

    return finalize(Config(bound=1.0, stage=1, iters=7500, use_brdf=True, use_restir=use_restir,
                           spp=spp, pt_bounces=2, env_h=64, env_w=128, ssaa=1, lambda_tv=0.0))


def check_state(state, aux):
    """Finite loss, params and Adam moments (a non-finite gradient makes the
    moments non-finite), uncertain_count 0."""
    import torch

    from mirres_restir_nerf_mesh_torch.train.stage1 import group_leaves

    if not bool(torch.isfinite(aux["loss"])):
        raise AssertionError(f"train step: loss {float(aux['loss'])}")
    for g, leaves in group_leaves(state.params).items():
        st = state.opt_state[g]
        for x in leaves + st.mu + st.nu:
            if not bool(torch.isfinite(x).all()):
                raise AssertionError(f"train step: non-finite params or moments in group {g}")
    if float(aux["uncertain_count"]) != 0:
        raise AssertionError(f"train step: uncertain_count {float(aux['uncertain_count'])}")


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


def compare_frames(gpu, cpu, P, out_dir, label="64x64 spp 2 fp32", mc_within=0.98,
                   npz="reference_check.npz"):
    """Card vs CPU frame: mask and face_id agree on >= 99.9% of pixels; on the
    pixels whose face ids agree, every deterministic output (normal_ao
    included) within 1e-3 abs + 1e-3 rel on >= 99.9% of them, every Monte
    Carlo output on >= mc_within of them (None: reported, not gated) with
    its frame mean within 1% relative.  (The env sampler's CDF is a cumsum
    that the card rounds in another order than the CPU, so a few texels get
    one table entry more or less, which moves their pdf, and the MIS
    weights of samples landing there, by about 1%.)  Both frames go to
    out_dir/npz when out_dir is given."""
    import numpy as np
    import torch

    if out_dir is not None:
        np.savez_compressed(out_dir / npz,
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
        det = k in DETERMINISTIC or k == "normal_ao"
        if (det and ok < 0.999) or (not det and (mean_rel > 0.01 or (
                mc_within is not None and ok < mc_within))):
            fails.append(k)
    log(f"reference check (card vs CPU, {label}): " + json.dumps(res))
    if fails:
        raise AssertionError(f"reference check failed for {fails}")
    return res


FRAME_RANGES = ("gbuffer", "fields", "indirect", "direct", "antialias", "tile_prep",
                "tile_kernel", "tile_finish")
RESTIR_RANGES = ("gbuffer", "fields", "restir_initial", "indirect", "restir_temporal",
                 "restir_spatial", "restir_final", "denoise", "antialias", "tile_prep",
                 "tile_kernel", "tile_finish")


def profile_run(run, out_dir, ranges, table_name):
    """torch.profiler over one run(): device busy time (sum of kernel times)
    against its wall time, the top kernels, the device time of the kernels
    named dense* (K3), and the device span of the
    given record_function ranges -> summary dict; the full table goes to
    out_dir/table_name when out_dir is given."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    ev = prof.key_averages()
    dev_ms = {}
    for e in ev:    # a range can be listed twice (host op, device annotation)
        dev_ms[e.key] = max(dev_ms.get(e.key, 0.0), getattr(e, "self_device_time_total", 0.0) / 1e3)
    # device-side work: kernels, copies and fills carry no host time; the
    # ranges' device spans (first to last kernel, gaps included) and the
    # host ops' own device totals would count the same kernels again
    kernels = {k: v for k, v in dev_ms.items()
               if k not in ranges and next(e for e in ev if e.key == k).cpu_time_total == 0}
    busy = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:10]
    if out_dir is not None:
        (out_dir / table_name).write_text(ev.table(sort_by="self_device_time_total",
                                                   row_limit=60))
    return {"wall_ms": wall_ms, "device_busy_ms": busy, "idle_share": 1.0 - busy / wall_ms,
            # K3: dense_hit_kernel and its finish kernel
            "dense_kernels_device_ms": sum(v for k, v in kernels.items() if "dense" in k),
            "range_device_span_ms": {k: dev_ms.get(k, 0.0) for k in ranges},
            "top_kernels_ms": [[k[:80], v] for k, v in top]}


def profile_train_phases(state, static, verts, topo, batch, cfg, gen, out_dir, prefix="train"):
    """One train step cut into its three phases (forward: render and loss;
    backward: autograd.grad of every leaf; optimizer: the five Adam groups),
    each under its own torch.profiler (the backward's kernels launch from
    autograd's own thread, which a record_function range on this thread
    does not see) -> {phase: profile_run summary}."""
    import torch

    from mirres_restir_nerf_mesh_torch.train import stage1 as tr

    groups = {g: [x.detach().requires_grad_(True) for x in leaves]
              for g, leaves in tr.group_leaves(state.params).items()}
    params = tr.params_from_groups(state.params, groups)
    flat = [x for g in tr.GROUPS for x in groups[g]]
    box = {}

    def forward():
        box["loss"] = tr.stage1_loss(params, static, verts, topo, batch, cfg, gen)[0]

    def backward():
        box["grads"] = iter(torch.autograd.grad(box["loss"], flat, allow_unused=True))

    def optimizer():
        grads = {g: [next(box["grads"]) for _ in groups[g]] for g in tr.GROUPS}
        tr.make_optimizer(cfg).step(state.params, grads, state.opt_state)

    ranges = RESTIR_RANGES if static.use_restir else FRAME_RANGES
    return {name: profile_run(fn, out_dir, ranges if name == "forward" else (),
                              f"{prefix}_{name}_profile.txt")
            for name, fn in (("forward", forward), ("backward", backward),
                             ("optimizer", optimizer))}


def group_agreement(got, ref):
    """{group: (relative L2, cosine)} of two {group: [tensors]} (None = 0),
    each group's leaves taken as one vector, in float64 on the CPU."""
    import torch

    res = {}
    for g in ref:
        a = torch.cat([(torch.zeros_like(r) if x is None else x).detach().cpu().double().reshape(-1)
                       for x, r in zip(got[g], ref[g])])
        b = torch.cat([(torch.zeros_like(r) if r is None else r).detach().cpu().double().reshape(-1)
                       for r in ref[g]])
        na, nb = float(a.norm()), float(b.norm())
        res[g] = (float((a - b).norm()) / max(nb, 1e-300),
                  1.0 if na == nb == 0.0 else float(a @ b) / max(na * nb, 1e-300))
    return res


def state_to(state, dev):
    from mirres_restir_nerf_mesh_torch.train.stage1 import AdamState

    p = state.params
    params = type(p)(*(tree_to(x, dev) for x in p))
    opt = {g: AdamState(st.count, tree_to(st.mu, dev), tree_to(st.nu, dev))
           for g, st in state.opt_state.items()}
    return type(state)(params, opt, state.step)


def above_noise(g_card, g_cpu, factor: float = 8.0):
    """{group: [bool masks]}: entries whose CPU gradient exceeds factor x
    the card's difference from it (None = 0: no entry kept)."""
    import torch

    res = {}
    for g, ref in g_cpu.items():
        res[g] = []
        for a, b in zip(g_card[g], ref):
            if a is None or b is None:
                shape = (b if b is not None else a).shape
                res[g].append(torch.zeros(shape, dtype=torch.bool))
                continue
            a, b = a.detach().cpu().double(), b.detach().cpu().double()
            res[g].append(b.abs() > factor * (a - b).abs())
    return res


def select(tree, masks):
    """{group: [x[mask]]} of a {group: [tensors]}."""
    return {g: [x.detach().cpu()[m] for x, m in zip(tree[g], masks[g])] for g in masks}


def check_train_reference(v_small, f_small, vs_dev, seed, dev):
    """One train step of the 64x64, spp-2, fp32 small-mesh case on the card
    against the same step on the CPU: same params, state and randoms (bounds
    and the rule for the params after the step: the module docstring, phase
    5b).  "update" (params after minus before) is reported, not gated."""
    import torch

    from mirres_restir_nerf_mesh_torch.render.stage1 import draw_frame_randoms
    from mirres_restir_nerf_mesh_torch.train import stage1 as tr
    from mirres_restir_nerf_mesh_torch.train.losses import build_topology

    Hs = Ws = 64
    st = frame_static(f_small, Hs, Ws, 2, torch.float32)
    cfg = train_config(2)
    topo = build_topology(f_small, v_small.shape[0])
    p_cpu = make_params(v_small.shape[0], seed, "cpu")
    s_cpu = tr.Stage1State(p_cpu, tr.make_optimizer(cfg).init(p_cpu),
                           torch.zeros((), dtype=torch.int32))
    s_gpu = state_to(s_cpu, dev)
    b_cpu = camera(Hs, Ws, "cpu")
    b_gpu = {k: x.to(dev) for k, x in b_cpu.items()}
    rnd = draw_frame_randoms(Hs * Ws, st, torch.Generator().manual_seed(seed + 2), "cpu")
    rnd_gpu = rnd.to(dev)
    v_cpu = torch.as_tensor(v_small)
    loss_c, _, g_c = tr.loss_and_grads(p_cpu, st, v_cpu, topo, b_cpu, cfg, rand=rnd)
    loss_g, _, g_g = tr.loss_and_grads(s_gpu.params, st, vs_dev, topo, b_gpu, cfg, rand=rnd_gpu)
    new_c, _ = tr.make_train_step(cfg, st, v_cpu, topo)(s_cpu, b_cpu, rand=rnd)
    new_g, _ = tr.make_train_step(cfg, st, vs_dev, topo)(s_gpu, b_gpu, rand=rnd_gpu)
    before = tr.group_leaves(p_cpu)
    after_c, after_g = tr.group_leaves(new_c.params), tr.group_leaves(new_g.params)
    delta = {g: [a - b for a, b in zip(after_c[g], before[g])] for g in before}
    delta_g = {g: [a.cpu() - b for a, b in zip(after_g[g], before[g])] for g in before}
    keep = above_noise(g_g, g_c)
    res = {"loss_cpu": float(loss_c), "loss_card": float(loss_g),
           "loss_rel": abs(float(loss_g) - float(loss_c)) / abs(float(loss_c)),
           "grad": group_agreement(g_g, g_c),
           "params_after": group_agreement(select(after_g, keep), select(after_c, keep)),
           "params_after_kept": {g: [int(sum(int(m.sum()) for m in ms)),
                                     int(sum(m.numel() for m in ms))] for g, ms in keep.items()},
           "params_after_all": group_agreement(after_g, after_c),
           "update": group_agreement(delta_g, delta)}
    log("train reference check (card vs CPU, 64x64 spp 2 fp32): " + json.dumps(res))
    fails = ["loss"] if res["loss_rel"] > 1e-3 else []
    fails += ["grad:net"] if res["grad"]["net"][0] > 1e-4 else []
    for what in ("grad", "params_after"):
        fails += [f"{what}:{g}" for g, (rel, cos) in res[what].items() if rel > 5e-2 or cos < 0.999]
    if fails:
        raise AssertionError(f"train reference check failed for {fails}")
    return res


def check_k3_launches(name, launches, per_frame):
    """A small-mesh run of one warm and TIMED_FRAMES timed frames: K3
    closest and any hit launched per_frame times a frame, no K1 or K2."""
    frames = 1 + TIMED_FRAMES
    want = {"dense_hit": per_frame[0] * frames, "dense_occluded": per_frame[1] * frames,
            "queue_trace": 0, "grid_trace": 0}
    got = {k: launches[k] for k in want}
    if got != want:
        raise AssertionError(f"{name}: launches {got}, expected {want}")


def k3_route(seed: int, dev) -> None:
    """``--k3-route``: the dense route (K3) through the public entry points
    only (``intersect_tiles_t`` / ``occluded_tiles_t`` with the frame's sort
    mode, ``render_stage1``), so that this file, copied into an unpacked
    older checkout of the port and run there, times that checkout's K3 the
    same way.  Phase 3's K3 inputs from the same seeds; per shape the
    route's event ms and device ms (queued_ms); the small mesh's lighter and
    ReSTIR frames, one warm and TIMED_FRAMES timed (frame s, K3 launches a
    frame); then, under torch.profiler (last: it makes later launches
    costlier on the host), the device ms of the dense* kernels per route
    call (mean of 5) and in one frame of each.  One JSON line each."""
    import torch

    from mirres_restir_nerf_mesh_torch.ops import dense_tracer as dt
    from mirres_restir_nerf_mesh_torch.ops import tile_tracer as tt
    from mirres_restir_nerf_mesh_torch.ops.cluster_bvh import build_clusters
    from mirres_restir_nerf_mesh_torch.render.stage1 import render_stage1

    v, f = bench_mesh(SMALL_FACES)
    vs, fs = torch.as_tensor(v, device=dev), torch.as_tensor(f, device=dev)
    cm = build_clusters(vs, fs)
    cam = camera(FRAME_HW, FRAME_HW, dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 5)
    params = make_params(v.shape[0], seed, dev)
    statics = {"lighter": frame_static(f, FRAME_HW, FRAME_HW, FRAME_SPP, torch.bfloat16),
               "restir": frame_static(f, FRAME_HW, FRAME_HW, FRAME_SPP, torch.bfloat16,
                                      **RESTIR)}

    def frame(st):
        return render_stage1(params, st, vs, cam["rays_o"], cam["rays_d"], generator=gen)

    d_prim = cam["rays_d"] / cam["rays_d"].norm(dim=-1, keepdim=True)
    bo, bd = bounce_rays(vs, fs, BOUNCE_RAYS, gen)
    so, sd, st_max = shadow_rays(vs, fs, cm, cam, sky_env(), gen)
    calls = record_occluded(lambda: frame(statics["restir"]))
    n_cross = 2 * RESTIR["restir_neighbors"] * int(so.shape[0])
    xo, xd, xt = next(c for c in calls if c[0].shape[0] == n_cross)
    del calls
    routes = []
    for name, o, d, t_max, sort in (("primary, closest", cam["rays_o"], d_prim, None, False),
                                    ("bounce, closest", bo, bd, None, "morton"),
                                    ("bounce, any", bo, bd, 1e9, "morton"),
                                    ("direct shadow, any", so, sd, st_max, "morton"),
                                    ("spatial cross visibility, any", xo, xd, xt, "morton")):
        if t_max is None:
            route = functools.partial(tt.intersect_tiles_t, cm, o, d, sort_octants=sort)
            live = o.shape[0]
        else:
            route = functools.partial(tt.occluded_tiles_t, cm, o, d, t_max, sort_octants=sort)
            live = int((torch.broadcast_to(torch.as_tensor(t_max, device=dev), (o.shape[0],))
                        > 1e-4).sum())
        routes.append((route, dict(shape=name, rays=int(o.shape[0]), live=live,
                                   route_ms=cuda_ms(route, 10), route_device_ms=queued_ms(route))))
    counters = [c for c in (getattr(dt, "dense_hit", None), getattr(dt, "dense_occluded", None))
                if c is not None]
    frames = {}
    for name, st in statics.items():
        for c in counters:
            c.launches = 0
        times = []
        for _ in range(1 + TIMED_FRAMES):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            frame(st)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        frames[name] = dict(frame=name, frame_s=float(statistics.median(times[1:])),
                            frame_s_all=times,
                            launches_per_frame={c.__name__: c.launches / len(times)
                                                for c in counters})
    for route, row in routes:
        prof = profile_run(lambda: [route() for _ in range(5)], None, (), "")
        row["dense_device_ms_per_call"] = prof["dense_kernels_device_ms"] / 5
        log("K3 route: " + json.dumps(row))
    for name, st in statics.items():
        prof = profile_run(lambda: frame(st), None,
                           RESTIR_RANGES if name == "restir" else FRAME_RANGES, "")
        frames[name].update(dense_device_ms=prof["dense_kernels_device_ms"],
                            device_busy_ms=prof["device_busy_ms"], profiled_wall_ms=prof["wall_ms"])
        log("K3 frame: " + json.dumps(frames[name]))


def plant_k4_fault(kind: str):
    """Wrap K4's launch: 'scale' multiplies every update by 1.01, 'drop'
    skips the first of every three launches (one encode's backward a
    step)."""
    from mirres_restir_nerf_mesh_torch.ops import scatter

    orig = scatter.scatter_add_into
    calls = [0]

    def faulty(out, idx, upd):
        calls[0] += 1
        if kind == "scale":
            orig(out, idx, upd * 1.01)
        elif calls[0] % 3 != 1:
            orig(out, idx, upd)

    scatter.scatter_add_into = faulty


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None,
                    help="directory for the full results, the profile table and both "
                         "reference-check frames (default: none written)")
    ap.add_argument("--profile", action="store_true",
                    help="also profile one bench frame and one train step (torch.profiler) "
                         "after their main-path runs (the profiler leaves every later launch "
                         "costlier on the host: the phases after the first profile time slower)")
    ap.add_argument("--k3-route", action="store_true",
                    help="time only the dense route (K3) through the public entry points at "
                         "phase 3's K3 shapes and the small-mesh frames, with its device time "
                         "under torch.profiler, and exit (no result line); works on a copy "
                         "of this file run in an older checkout of the port")
    ap.add_argument("--plant-k4-fault", choices=("scale", "drop"), default=None,
                    help="run phase 5b alone with a fault planted in K4 (updates x 1.01, or "
                         "one launch of three dropped); exit 0 only if the phase fails")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs an NVIDIA card",
              file=sys.stderr)
        return 2
    from mirres_restir_nerf_mesh_torch import cuda_build
    from mirres_restir_nerf_mesh_torch.models import envlight
    from mirres_restir_nerf_mesh_torch.ops import dense_tracer, scatter, tile_tracer
    from mirres_restir_nerf_mesh_torch.ops.cluster_bvh import build_clusters
    from mirres_restir_nerf_mesh_torch.render.stage1 import draw_frame_randoms, render_stage1
    from mirres_restir_nerf_mesh_torch.train import stage1 as train1
    from mirres_restir_nerf_mesh_torch.train.losses import build_topology

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

    if args.k3_route:
        k3_route(args.seed, dev)
        return 0
    if args.plant_k4_fault:
        v_small, f_small = bench_mesh(SMALL_FACES)
        plant_k4_fault(args.plant_k4_fault)
        try:
            check_train_reference(v_small, f_small, torch.as_tensor(v_small, device=dev),
                                  args.seed, dev)
        except AssertionError as e:
            log(f"planted K4 fault '{args.plant_k4_fault}' caught by phase 5b: {e}")
            return 0
        log(f"planted K4 fault '{args.plant_k4_fault}' passed phase 5b")
        return 1

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
    d_prim = cam["rays_d"] / cam["rays_d"].norm(dim=-1, keepdim=True)
    # K3 on the small mesh, at the launches of its frames (the dense route:
    # incoherent batches in "morton" order, as Tracer asks for them)
    gen3 = torch.Generator(device=dev).manual_seed(args.seed + 5)
    params_s = make_params(v_small.shape[0], args.seed, dev)
    static_rs = frame_static(f_small, H, W, FRAME_SPP, torch.bfloat16, **RESTIR)
    k3_checks = [check_k3("K3 closest, primary", cm_small, cam["rays_o"], d_prim)]
    sbo, sbd = bounce_rays(vs, fs, BOUNCE_RAYS, gen3)
    k3_checks.append(check_k3("K3 closest, bounce", cm_small, sbo, sbd, sort="morton"))
    k3_checks.append(check_k3("K3 any, bounce", cm_small, sbo, sbd, t_max=1e9, sort="morton"))
    sso, ssd, sst = shadow_rays(vs, fs, cm_small, cam, sky_env(), gen3)
    k3_checks.append(check_k3("K3 any, direct shadow", cm_small, sso, ssd, t_max=sst,
                              sort="morton"))
    calls = record_occluded(lambda: render_stage1(params_s, static_rs, vs, cam["rays_o"],
                                                  cam["rays_d"], generator=gen3))
    n_cross_s = 2 * RESTIR["restir_neighbors"] * int(sso.shape[0])
    xo, xd, xt = next(c for c in calls if c[0].shape[0] == n_cross_s)
    del calls
    k3_checks.append(check_k3("K3 any, spatial cross visibility", cm_small, xo, xd, t_max=xt,
                              sort="morton"))
    # ragged: N not a multiple of the 128-ray block; 61 clusters of 99, so
    # M = 6,039 is not a multiple of the 256-triangle staged block and its
    # rows do not start on 16 bytes
    cm_rag = build_clusters(vs, fs, 99)
    nr = min(50_001, sbo.shape[0] - 1)
    k3_checks.append(check_k3("K3 closest, ragged", cm_rag, sbo[:nr], sbd[:nr]))
    k3_checks.append(check_k3("K3 any, ragged", cm_rag, sbo[:nr], sbd[:nr],
                              t_max=torch.rand(nr, generator=gen3, device=dev) * 2.0 - 0.5))
    for c in k3_checks:
        log("K3 dense: " + json.dumps(c))
    del sbo, sbd, sso, ssd, sst, xo, xd, xt
    k1_checks = [check_tile("K1 closest, primary", cm_big, cam["rays_o"], d_prim, False, False,
                            640, 256)]
    bo, bd = bounce_rays(vb, fb, BOUNCE_RAYS, gen)
    k1_checks.append(check_tile("K1 closest, bounce", cm_big, bo, bd, False, "morton", 640, 64))
    k1_checks.append(check_tile("K1 any, bounce", cm_big, bo, bd, True, "morton", 640, 64,
                                t_max=1e9))
    so, sd, st_max = shadow_rays(vb, fb, cm_big, cam, sky_env(), gen)
    k1_checks.append(check_tile("K1 any, direct shadow", cm_big, so, sd, True, "morton", 640, 64,
                                t_max=st_max))
    counters = (tile_tracer.queue_trace, tile_tracer.grid_trace, dense_tracer.dense_hit,
                dense_tracer.dense_occluded, scatter.scatter_add)

    def zero_counts():
        for c in counters:
            c.launches = 0

    def read_counts():
        return {c.__name__: c.launches for c in counters}

    # the K2 path: the queue=False entry points, one launch on each batch
    k2_checks = [check_grid("K2 closest, primary", cm_big, cam["rays_o"], d_prim, False, False,
                            640, 256, (zero_counts, read_counts)),
                 check_grid("K2 any, direct shadow", cm_big, so, sd, True, "morton", 640, 64,
                            (zero_counts, read_counts), t_max=st_max)]
    launches_grid = {k: sum(c["path_launches"][k] for c in k2_checks)
                     for k in k2_checks[0]["path_launches"]}
    budget = dict(k_cap=640, queue_avg=256, k_cap_incoherent=640, queue_avg_incoherent=64)
    static = frame_static(f_big, H, W, FRAME_SPP, torch.bfloat16, **budget)
    static_r = frame_static(f_big, H, W, FRAME_SPP, torch.bfloat16, **budget, **RESTIR)
    params = make_params(v_big.shape[0], args.seed, dev)
    # one ReSTIR bench frame with its shadow batches recorded: K1 on one
    # spatial cross-visibility launch, 2 x 5 pairs per covered pixel
    calls = record_occluded(lambda: render_stage1(params, static_r, vb, cam["rays_o"],
                                                  cam["rays_d"], generator=gen))
    n_cross = 2 * RESTIR["restir_neighbors"] * int(so.shape[0])
    xo, xd, xt = next(c for c in calls if c[0].shape[0] == n_cross)
    del calls
    k1_checks.append(check_tile("K1 any, spatial cross visibility", cm_big, xo, xd, True, "morton",
                                640, 64, t_max=xt))
    for c in k1_checks:
        log("K1 tile_trace: " + json.dumps(c))
    for c in k2_checks:
        log("K2 grid_trace: " + json.dumps(c))
    del bo, bd, xo, xd, xt, so, sd, st_max
    k4 = check_scatter(vb, fb, cm_big, cam, gen)
    log("K4 scatter_add: " + json.dumps(k4))
    torch.cuda.empty_cache()

    def timed_frames(st, name, n_frames=TIMED_FRAMES, prm=None, verts=None):
        """One warm and n_frames timed frames of bench.py's frame (or of
        another mesh: prm, verts) -> (times, last out)."""
        prm = params if prm is None else prm
        verts = vb if verts is None else verts
        times, out = [], None
        for i in range(1 + n_frames):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = render_stage1(prm, st, verts, cam["rays_o"], cam["rays_d"], generator=gen)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            log(f"{name} {i} ({'warm' if i == 0 else 'timed'}): {times[-1]:.3f} s, "
                f"uncertain {float(out['uncertain_count']):.0f}, "
                f"traced {float(out['traced_rays']):.0f}")
        return times, out

    def timed_steps(st, cfg, name):
        """One warm and TIMED_STEPS timed train steps from a fresh state ->
        (times, state, aux, peak GB)."""
        state = train1.init_state(gen, cfg, st, params.nerf, v_big.shape[0], device=dev)
        state = state._replace(params=state.params._replace(
            env=torch.as_tensor(sky_env(), device=dev)))
        train_step = train1.make_train_step(cfg, st, vb, topo)
        torch.cuda.reset_peak_memory_stats()
        times = []
        for i in range(1 + TIMED_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, aux = train_step(state, cam, generator=gen)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            log(f"{name} {i} ({'warm' if i == 0 else 'timed'}): {times[-1]:.3f} s, "
                f"loss {float(aux['loss']):.6f}, uncertain {float(aux['uncertain_count']):.0f}")
            check_state(state, aux)
        return times, state, aux, torch.cuda.max_memory_allocated() / 1e9

    # ---- 4. the main path: counters zeroed, frames rendered, counters read
    static_s = frame_static(f_small, H, W, FRAME_SPP, torch.bfloat16)
    zero_counts()
    times, outs = timed_frames(static, "frame")
    launches = read_counts()
    k1_frame = launches["queue_trace"]
    check_outputs(outs, P)
    # the small mesh's lighter frame: the dense route, K3 alone
    zero_counts()
    times_s, out_s = timed_frames(static_s, "small-mesh frame", prm=params_s, verts=vs)
    launches_s = read_counts()
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
        "launches": launches,
    }
    log("frame: " + json.dumps(frame))
    small = {
        "triangles": int(f_small.shape[0]), "frame_s": float(statistics.median(times_s[1:])),
        "frame_s_all": times_s, "coverage": float(out_s["mask"].float().mean()),
        "uncertain_count": float(out_s["uncertain_count"]),
        "K3_closest_per_frame": launches_s["dense_hit"] / (1 + TIMED_FRAMES),
        "K3_any_per_frame": launches_s["dense_occluded"] / (1 + TIMED_FRAMES),
        "launches": launches_s,
    }
    log("small-mesh frame: " + json.dumps(small))
    if args.profile:
        prof = profile_run(lambda: render_stage1(params, static, vb, cam["rays_o"],
                                                 cam["rays_d"], generator=gen),
                           out_dir, FRAME_RANGES, "frame_profile.txt")
        log("frame profile: " + json.dumps(prof))
        prof_s = profile_run(lambda: render_stage1(params_s, static_s, vs, cam["rays_o"],
                                                   cam["rays_d"], generator=gen),
                             out_dir, FRAME_RANGES, "small_frame_profile.txt")
        log("small-mesh frame profile: " + json.dumps(prof_s))
    if frame["uncertain_count"] != 0 or small["uncertain_count"] != 0:
        raise AssertionError("uncertain_count != 0 at the bench budgets")
    if launches["queue_trace"] <= 0:
        raise AssertionError(f"a kernel of the path never launched: {launches}")
    check_k3_launches("small-mesh frame", launches_s, K3_FRAME)
    del outs, out_s

    # ---- 4b. the lighter train step: counters zeroed, steps taken, counters read
    cfg = train_config(FRAME_SPP)
    topo = build_topology(f_big, v_big.shape[0])
    zero_counts()
    step_times, state, aux, peak = timed_steps(static, cfg, "train step")
    launches_train = read_counts()
    step_s = float(statistics.median(step_times[1:]))
    train = {
        "config": "bench.py train step, use_restir=False, denoise_iters=0",
        "step_s": step_s, "step_s_all": step_times,
        "nominal_Mrays_per_s": nominal / step_s / 1e6,
        "loss": float(aux["loss"]), "psnr": float(aux["psnr"]),
        "psnr_brdf": float(aux["psnr_brdf"]),
        "uncertain_count": float(aux["uncertain_count"]),
        "max_memory_allocated_GB": peak,
        "K4_launches_per_step": launches_train["scatter_add"] / (1 + TIMED_STEPS),
        "K1_launches_per_step": launches_train["queue_trace"] / (1 + TIMED_STEPS),
        "launches": launches_train,
    }
    log("train step: " + json.dumps(train))
    if args.profile:
        prof_train = profile_train_phases(state, static, vb, topo, cam, cfg, gen, out_dir)
        log("train step profile: " + json.dumps(prof_train))
    if launches_train["scatter_add"] != K4_STEP_LAUNCHES * (1 + TIMED_STEPS) or \
            launches_train["queue_trace"] <= 0:
        raise AssertionError(f"train step launches: {launches_train} "
                             f"({K4_STEP_LAUNCHES} K4 launches a step expected)")
    del state, aux
    torch.cuda.empty_cache()

    # ---- 4c. bench.py's own frame: ReSTIR + denoiser
    nominal_r = P * (1 + FRAME_SPP * RESTIR_RAYS_PER_SPP)
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    times_r, out_r = timed_frames(static_r, "restir frame")
    launches_rf = read_counts()
    check_outputs(out_r, P)
    frame_r_s = float(statistics.median(times_r[1:]))
    frame_r = {
        "config": "bench.py frame: use_restir=True, denoise_iters=4",
        "frame_s": frame_r_s, "frame_s_all": times_r,
        "nominal_rays_per_frame": nominal_r,
        "nominal_Mrays_per_s": nominal_r / frame_r_s / 1e6,
        "traced_rays_per_frame": float(out_r["traced_rays"]),
        "coverage": float(out_r["mask"].float().mean()),
        "uncertain_count": float(out_r["uncertain_count"]),
        "max_memory_allocated_GB": torch.cuda.max_memory_allocated() / 1e9,
        "K1_launches_per_frame": launches_rf["queue_trace"] / (1 + TIMED_FRAMES),
        "launches": launches_rf,
    }
    log("restir frame: " + json.dumps(frame_r))
    if args.profile:
        prof_r = profile_run(lambda: render_stage1(params, static_r, vb, cam["rays_o"],
                                                   cam["rays_d"], generator=gen),
                             out_dir, RESTIR_RANGES, "restir_frame_profile.txt")
        log("restir frame profile: " + json.dumps(prof_r))
    if frame_r["uncertain_count"] != 0:
        raise AssertionError("restir frame: uncertain_count != 0 at the bench budgets")
    k1_expected = 1 + 2 * 2 + FRAME_SPP     # primary, bounces (NEE fused), spatial per spp
    if frame_r["K1_launches_per_frame"] != k1_expected:
        raise AssertionError(f"restir frame: {frame_r['K1_launches_per_frame']} K1 launches a "
                             f"frame, {k1_expected} expected")
    del out_r
    torch.cuda.empty_cache()

    # ---- 4d. bench.py's own train step
    cfg_r = train_config(FRAME_SPP, use_restir=True)
    zero_counts()
    step_times_r, state, aux, peak_r = timed_steps(static_r, cfg_r, "restir train step")
    launches_rt = read_counts()
    step_r_s = float(statistics.median(step_times_r[1:]))
    train_r = {
        "config": "bench.py train step: use_restir=True, denoise_iters=4",
        "step_s": step_r_s, "step_s_all": step_times_r,
        "nominal_Mrays_per_s": nominal_r / step_r_s / 1e6,
        "loss": float(aux["loss"]), "psnr": float(aux["psnr"]),
        "psnr_brdf": float(aux["psnr_brdf"]),
        "uncertain_count": float(aux["uncertain_count"]),
        "max_memory_allocated_GB": peak_r,
        "K4_launches_per_step": launches_rt["scatter_add"] / (1 + TIMED_STEPS),
        "K1_launches_per_step": launches_rt["queue_trace"] / (1 + TIMED_STEPS),
        "launches": launches_rt,
    }
    log("restir train step: " + json.dumps(train_r))
    if args.profile:
        prof_rt = profile_train_phases(state, static_r, vb, topo, cam, cfg_r, gen, out_dir,
                                       prefix="restir_train")
        log("restir train step profile: " + json.dumps(prof_rt))
    if launches_rt["scatter_add"] != K4_STEP_LAUNCHES * (1 + TIMED_STEPS) or \
            train_r["K1_launches_per_step"] != k1_expected:
        raise AssertionError(f"restir train step launches: {launches_rt} ({K4_STEP_LAUNCHES} "
                             f"K4 and {k1_expected} K1 launches a step expected)")
    del state, aux
    torch.cuda.empty_cache()

    # ---- 4e. bench.py's ReSTIR frame on the small mesh: the dense route
    zero_counts()
    times_rs, out_rs = timed_frames(static_rs, "small-mesh restir frame", prm=params_s, verts=vs)
    launches_rs = read_counts()
    check_outputs(out_rs, P)
    small_r = {
        "config": "bench.py frame (use_restir=True, denoise_iters=4) on the small mesh",
        "frame_s": float(statistics.median(times_rs[1:])), "frame_s_all": times_rs,
        "coverage": float(out_rs["mask"].float().mean()),
        "uncertain_count": float(out_rs["uncertain_count"]),
        "K3_closest_per_frame": launches_rs["dense_hit"] / (1 + TIMED_FRAMES),
        "K3_any_per_frame": launches_rs["dense_occluded"] / (1 + TIMED_FRAMES),
        "launches": launches_rs,
    }
    log("small-mesh restir frame: " + json.dumps(small_r))
    if args.profile:
        prof_rs = profile_run(lambda: render_stage1(params_s, static_rs, vs, cam["rays_o"],
                                                    cam["rays_d"], generator=gen),
                              out_dir, RESTIR_RANGES, "small_restir_frame_profile.txt")
        log("small-mesh restir frame profile: " + json.dumps(prof_rs))
    if small_r["uncertain_count"] != 0:
        raise AssertionError("small-mesh restir frame: uncertain_count != 0")
    check_k3_launches("small-mesh restir frame", launches_rs, K3_RESTIR_FRAME)
    del out_rs

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
                        rand=rnd.to(dev))
    agree = compare_frames(got, ref, Hs * Ws, out_dir)
    agree["env_table_entries_differing"] = int(
        (envlight.build_sampler(p_gpu.env).table.cpu()
         != envlight.build_sampler(p_cpu.env).table).sum())
    log(f"env sampler table entries differing, card vs CPU: {agree['env_table_entries_differing']}")

    # ---- 5b. reference check: one train step, card vs CPU
    agree_train = check_train_reference(v_small, f_small, vs, args.seed, dev)

    # ---- 5c. reference check: a ReSTIR frame, without and with the denoiser
    agree_restir = {}
    for iters in (0, 2):
        st_r = frame_static(f_small, Hs, Ws, 2, torch.float32, compute_normal_ao=True,
                            **{**RESTIR, "denoise_iters": iters})
        rnd = draw_frame_randoms(Hs * Ws, st_r, torch.Generator().manual_seed(args.seed + 3),
                                 "cpu")
        ref = render_stage1(p_cpu, st_r, torch.as_tensor(v_small), cam_s["rays_o"],
                            cam_s["rays_d"], rand=rnd)
        got = render_stage1(p_gpu, st_r, vs, cam_s["rays_o"].to(dev), cam_s["rays_d"].to(dev),
                            rand=rnd.to(dev))
        agree_restir[f"denoise_iters={iters}"] = compare_frames(
            got, ref, Hs * Ws, out_dir, label=f"ReSTIR 64x64 spp 2 fp32, denoise_iters {iters}",
            mc_within=None, npz=f"restir_reference_check_{iters}.npz")

    # ---- 6. results.  K1's headline is the direct-shadow batch, the shape of
    # 64 of the 69 launches of the lighter frame (the spatial cross-visibility
    # check is 32 of the ReSTIR frame's 37); K2's is the primary rays.
    k1, k2 = k1_checks[3], k2_checks[0]
    paths = {"frame": launches, "small_frame": launches_s, "train_step": launches_train,
             "restir_frame": launches_rf, "restir_train_step": launches_rt,
             "small_restir_frame": launches_rs, "grid_trace_path": launches_grid}
    # K3's headlines: the primary rays (closest), the direct-shadow batch
    # (any hit: 64 of the lighter small-mesh frame's 66 any-hit launches)
    k3c, k3a = k3_checks[0], k3_checks[3]
    k3_closest = [c for c in k3_checks if not c["any_hit"]]
    k3_any = [c for c in k3_checks if c["any_hit"]]

    def by_path(name):
        return dict(launches=sum(p[name] for p in paths.values()),
                    launches_by_path={k: p[name] for k, p in paths.items()})

    kernels = [
        dict(name="tile_trace (K1)", route="cuda",
             source="mirres_restir_nerf_mesh_torch/csrc/tile_trace.cu",
             replaces="mirres_restir_nerf_mesh_tpu/ops/tile_tracer.py:190",
             **by_path("queue_trace"),
             max_abs_err=max(c["max_abs_err"] for c in k1_checks),
             ms=k1["ms"], device_ms=k1["device_ms"], split=k1["split"],
             plain_ms=k1["plain_ms"], bound_ms=k1["bound_ms"],
             bound_by=k1["bound_by"], library_ms=None, checks=k1_checks),
        dict(name="grid_trace (K2)", route="cuda",
             source="mirres_restir_nerf_mesh_torch/csrc/tile_trace.cu",
             replaces="mirres_restir_nerf_mesh_tpu/ops/tile_tracer.py:62",
             **by_path("grid_trace"),
             max_abs_err=max(c["max_abs_err"] for c in k2_checks),
             ms=k2["ms"], device_ms=k2["device_ms"], split=k2["split"],
             plain_ms=k2["plain_ms"], bound_ms=k2["bound_ms"],
             bound_by=k2["bound_by"], library_ms=None, checks=k2_checks),
        dict(name="dense_hit (K3, closest hit)", route="cuda",
             source="mirres_restir_nerf_mesh_torch/csrc/dense_hit.cu",
             replaces="mirres_restir_nerf_mesh_tpu/ops/pallas_tracer.py:40",
             **by_path("dense_hit"), max_abs_err=max(c["max_abs_err"] for c in k3_closest),
             ms=k3c["ms"], device_ms=k3c["device_ms"], split=k3c["split"],
             plain_ms=k3c["plain_ms"], bound_ms=k3c["bound_ms"], bound_by=k3c["bound_by"],
             issue_floor_ms=k3c["issue_floor_ms"], library_ms=None, checks=k3_closest),
        dict(name="dense_occluded (K3, any hit)", route="cuda",
             source="mirres_restir_nerf_mesh_torch/csrc/dense_hit.cu",
             replaces="mirres_restir_nerf_mesh_tpu/ops/pallas_tracer.py:40",
             **by_path("dense_occluded"), max_abs_err=max(c["max_abs_err"] for c in k3_any),
             ms=k3a["ms"], device_ms=k3a["device_ms"], split=k3a["split"],
             plain_ms=k3a["plain_ms"], bound_ms=k3a["bound_ms"], bound_by=k3a["bound_by"],
             issue_floor_ms=k3a["issue_floor_ms"], library_ms=None, checks=k3_any),
        dict(name="scatter_add (K4)", route="cuda",
             source="mirres_restir_nerf_mesh_torch/csrc/scatter_add.cu",
             replaces="mirres_restir_nerf_mesh_tpu/ops/pallas_scatter.py:37",
             **by_path("scatter_add"), max_abs_err=k4["max_abs_err"],
             ms=k4["ms"], device_ms=k4["device_ms"], plain_ms=k4["plain_ms"],
             bound_ms=k4["bound_ms"], bound_by=k4["bound_by"], library_ms=k4["library_ms"],
             library_device_ms=k4["library_device_ms"], checks=[k4]),
    ]
    if out_dir is not None:
        (out_dir / "chip_smoke.json").write_text(json.dumps(
            {"card": card, "build_s": build_s, "kernels": kernels, "frame": frame,
             "small_frame": small, "small_restir_frame": small_r, "train_step": train, "restir_frame": frame_r, "restir_train_step": train_r,
             "reference_check": agree,
             "train_reference_check": agree_train, "restir_reference_check": agree_restir},
            indent=1))
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
