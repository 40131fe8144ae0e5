#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port on one NVIDIA card: the stage-1 forward
frame and train step, with and without ReSTIR DI, stage 0 (the
radiance-field train step, occupancy update, eval render and mesh export),
the command line a user runs (stage 0, stage 1, test renders,
albedo_eval) on a blender-format scene and on a COLMAP workspace with
JPEG frames, sparse and dense depth, and both train steps data-parallel.

    python3 chip_smoke.py [--seed N] [--out DIR] [--profile]
    python3 chip_smoke.py --k3-route    (the dense route alone; see k3_route)
    python3 chip_smoke.py --dp          (phase 4j alone)
    python3 chip_smoke.py --dp-stage1 N (phase 4j (b) alone, N runs)
    python3 chip_smoke.py --last-modules    (phases 4h and 4i, then 4k)

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
   1e-5 * sum|upd| at each row of the plain version summed in fp64 (the
   exact sum; the distance to the fp32 plain version is printed); timed beside its plain version and the one
   PyTorch call that computes the same function (index_add_ on a zeroed
   table): event times of the calls, and device times of the kernel alone,
   the zeroing alone and index_add_ alone on inputs and a table allocated
   beforehand (queued the same way).  K4 at the stage-0 step's own two
   launches is checked the same way after phase 4f.
4. The main path (frames and steps are timed through the port's bench
   module, mirres_restir_nerf_mesh_torch/bench.py, which also holds the
   operating point's set-up: one warm sample, then the launch counters
   zeroed, the timed samples, the counters read): ``render_stage1``
   (use_restir=False) renders bench.py's operating point (256x256, spp 32,
   2 bounces, ~100k triangles, k_cap 640, queue_avg 256/64, bf16 MLPs)
   three times timed.  Then the same frame of the 6,000-triangle small
   mesh (the dense route), three timed.  Outputs must be finite,
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
   threading) and denoise_iters=4, one warm and the bench's 10 timed frames
   (the vertex offsets moved by 1e-6 (i + 1) a frame, as bench.py does): frame
   s, nominal Mrays/s (bench.py's count, 65,536 x (1 + 32 x 16) rays),
   traced rays, coverage, peak memory; uncertain_count 0 and 37 K1
   launches a frame (1 primary, 2 bounces x (closest hit + NEE with the
   initial winners' visibility fused in), 32 spatial cross visibility).
4d. bench.py's own train step with that static (the counters zeroed
   again): one warm and the bench's 10 timed steps, loss, peak memory, K4
   launched 3 times and K1 37 times a step, uncertain_count 0.
4e. bench.py's ReSTIR frame (use_restir=True, denoise_iters=4) on the small
   mesh (the counters zeroed again): one warm and three timed frames, frame
   s and coverage; uncertain_count 0 and K3 alone, 3 closest-hit and 34
   any-hit (2 NEE with the initial visibility fused in, 32 spatial cross
   visibility) launches a frame.
4f. bench.py's stage-0 point (bench.py:254-330; the counters zeroed again):
   8 synthetic frames of 256^2, the full-size field (16 levels of 2^19) in
   bf16, 8192 rays x 64 samples compacted to 2^18 points, grid 128, one
   occupancy update first; one warm and the bench's 5 timed groups of 16
   sequential steps, one sync a group: it/s, Msamples/s (2^18 a step),
   spread, peak memory, the march lattice length S and 2 K4 launches a
   step (the stochastic encode's backward, [262,144, 16] row ids into
   6,119,864 rows, and the TV loss's, [4096, 64]); loss, params and Adam
   moments finite; then one warm and one timed occupancy update.  Then
   K4 on the inputs recorded from one more step, each launch against its
   plain version and timed beside index_add_ (as phase 3).  Then the
   bench's JSON line from 4c, 4d and 4f, printed as ``bench: {...}`` and
   held to the bench's gates (no uncertain ray; 37 K1 and 3 K4 a step).
4g. Stage 0 as a user runs it (the counters zeroed again): the JAX
   package's learning test (tests/test_stage0.py: 300 iterations of 1024
   rays, an occupancy update every 16, PSNR on view 0 before and after) at
   full width in bf16 on 12 synthetic frames of 256^2, with that test's
   gates (loss below half its first value, PSNR up >= 4 dB and above 15,
   occupancy rate < 0.5, centre depth in (1.2, 1.9)) and one K4 launch a
   step (TV off there); then export_stage0_mesh from the EMA field at
   resolution 256 (the default 512 cut to fit the run) with the
   visibility culling: a non-empty mesh whose median vertex radius lies
   within 20% of the sphere's 0.5, and one closest-hit launch a training
   view (K1, or K3 for a mesh of at most 8192 slots).
4h. The CLI as a user runs it (the counters zeroed before and read after
   each run): the synthetic sphere written as a blender-format scene (12
   train, 2 val, 2 test frames of 128^2 RGBA through the port's PNG
   writer; bench.py's sky + sun as an .hdr through its RGBE writer), then
   ``mirres_restir_nerf_mesh_torch.main.main`` three times: stage 0 with
   -O at the default widths (500 iterations, marching grid 256), gates:
   val PSNR above 15, a mesh of median vertex radius within 20% of 0.5,
   2 K4 launches a step, one closest hit a training view in save_mesh, a
   checkpoint; stage 1 with BRDF and ReSTIR (10 iterations, 1024^2
   textures, fp32), gates: loss finite, the OBJ, textures and checkpoint
   written, 3 K4 launches a step and the tracer's launches of every frame
   (steps and val renders: 37 K1 on the tile route, or 3 closest + 34 any
   K3 on the dense route); the checkpoint loaded into a CPU Trainer with
   every leaf equal; the test renders with relighting (spp as trained),
   gates: test()'s artifact set for 2 frames, every EXR finite, the
   tracer's launches, no K4; then albedo_eval on the kd EXRs against the
   scene's albedo inside its alpha, a finite PSNR.  Per run: seconds,
   it/s under the Trainer, faces, route, launches, peak memory, the seconds
   of each eval frame and stage-1 step, save_mesh, and export_stage1 by
   phase (atlas, raster, material, inpaint, write).
4i. The repo's "your dataset" recipe (configs/general_config_for_your_dataset.txt)
   on a COLMAP workspace written here: the sphere inside a textured cube
   room (every pixel sees a surface, as in a capture), sparse/0/*.bin (a
   PINHOLE camera with fx != fy and an off-centre principal point; 24
   views of 320x240; 4,000 points, 10% of them moved off the surface, with
   tracks into the views that see them, 0.3 px noise, errors in [0.2,
   1.5]; 10% untracked keypoints), images/*.jpg (this file's baseline
   encoder, 4:2:0) and depths/*.npy (0.4 z + 0.7 of the true depth).
   load_colmap is held to it: the poses under the loader's own centre and
   scale (1e-5), the sparse tables to the tracks' projections,
   cam_near_far to their range, the aligned dense depth within a median
   relative error of 1e-3 despite the outliers.  Then, host seconds: the
   readers and load_colmap (with_images=False) at a real size (200 views,
   100k points, 5k tracked keypoints a view), read_jpeg a megapixel on two
   1008x756 frames (smooth; with noise, at a photograph's bit rate) and on
   a progressive one (tests/fixtures/progressive_room.jpg, written by
   Pillow: its pixels equal PIL's by the sha256 beside it), that frame and
   a 16-bit RGB PNG written here through _load_image (the pixels / 255, the
   PNG's high bytes / 255, as PIL reads them); the port's DPT (random
   weights, full width) on 2 frames
   at 384^2, the card against the CPU with TF32 off within 2e-4 of the
   map's max, ms a frame with TF32 off and at PyTorch's default; a DTU scene
   (cameras_sphere.npz with scale_mat, PNG image/ + mask/) through
   load_dtu, poses within 1e-4.  Then main() three times (the counters
   zeroed before each run and read after): stage 0 (-O --data_format
   colmap --bound 2, 500 iterations, marching grid 64), gates: val PSNR
   above 15, a mesh of median radius within 20% of the sphere's in the
   normalized scene, 2 K4 launches a step, one closest hit a training view
   in save_mesh, the sparse-depth branch in 5-15% of the steps; stage 1
   (--use_brdf --use_restir, 10 iterations, 1024^2 textures), gates: loss
   finite, uncertain_count 0, K4 3 a step, the tracer's launches of every
   frame; --test, gates: each test frame's artifacts, every EXR finite,
   the tracer's launches.
4j. Data parallelism (parallel/mesh.py): 2 gloo ranks spawned through
   ``parallel.mesh.launch``, both on this card (NCCL refuses two ranks on
   one device), against the one-card step in this process.  Each rank
   first checks every collective on CUDA tensors (gloo's are staged through
   pinned host memory).  Each step on the ranks is held to the one-card
   step that rank 0 takes first from the same state with the same draws:
   chained runs part (two one-card stage-0 runs from one seed, whose K4
   atomics sum in another order, part after a few steps, printed below;
   the ReSTIR step's Monte Carlo picks follow the params),
   so the steps start from a common state, as
   tests/test_torch_stage1_restir.py's step 2 does.  (a) bench.py's stage-0
   point (4f's config) in fp32, 16 steps from one seed: each step's params
   within tests/test_dp_trainer.py's rtol 2e-4 / atol 2e-5 and its
   num_points equal, both ranks' params and occupancy grid bit-identical (a
   gathered checksum), 2 K4 launches a step on each rank (the counters
   zeroed and read inside each rank), num_points equal to a chained
   one-card run's in this process at every step (the params after 16
   chained steps printed beside, and two one-card runs' against each
   other); then 3 groups of 16 bf16 steps timed at
   1 and 2 ranks, and the gradient all-reduce timed alone.  (b) bench.py's
   ReSTIR train step (4d's static) in fp32, 3 steps:
   uncertain_count 0 on every rank, params after each step within
   tests/test_dp_stage1.py's rtol 5e-4 / atol 5e-5, the first step's loss
   within 1e-5 relative,
   both ranks' state bit-identical, 37 K1 and 3 K4 launches a step on
   each rank; the bytes gathered and all-reduced a step, a band gather
   and the gradient all-reduce timed alone.  Beside the gate, before each
   step, readings of rank 0's one-card pass against the sharded pass from
   that state and those draws: the loss, the render outputs' and the
   ReSTIR final picks' pixels not bit-equal (and picks moved by more than
   1e-3), each optimizer group's gradient after the all-reduce (max |d|,
   share beyond 1e-6 relative), and for the envmap texels the step leaves
   outside the gate their gradients x 64 against Adam's eps, sign flips
   and the ranks' cancellation ratio; gated: every render output and pick
   bit-equal.  ``--dp-stage1 N`` runs (b) alone N times in one pair of
   ranks.  (c) ``torchrun
   --nproc_per_node 1 -m mirres_restir_nerf_mesh_torch.main`` (NCCL) on
   4h's blender scene, -O, 300 iterations: exit 0, rank 0's log says it
   joined the group, a checkpoint and the metrics written (and whether
   save_mesh found a surface, printed).
   Two ranks sharing one card measure correctness and overhead, not
   scaling.
4k. The last modules (the counters zeroed before each part's run and read
   after).  (a) The tracer kinds: on the bench mesh (K1's route) and the
   small mesh (K3's), the LBVH build timed, then 65,536 primary and 65,536
   bounce-shaped rays traced by ``lbvh``, ``cluster`` (10 candidates) and
   ``tile`` (k_cap and queue_avg at the cluster count: a budget that drops
   nothing; at phase 3's budgets 65,536 scattered bounce rays leave ~35k
   uncertain on the bench mesh), closest and any hit, t_max 1e9 and per
   ray: lbvh (exact) against tile (its uncertain_count 0): hit / miss
   equal on every ray,
   prims equal off ties (two hits within 1e-6 in t), t within 1e-5
   relative, occlusion masks equal; the cluster kind's agreement with lbvh
   printed as a share, and its hits equal to its own CPU run's on 4,096
   rays; ms a call for each kind; the small mesh's dense passes (tile and
   cluster) must launch K3.  (b) ``dense_intersect`` on the small mesh at
   the primary rays: one K3 launch; its rows equal the plain version's bit
   for bit at the wrapper's split and unsplit; its HitResult equal to the
   tile tracer's dense route's; event, device and host ms, the bound.  (c)
   A 64^2 spp-2 fp32 lighter frame of the small mesh with each kind from
   the same FrameRandoms: finite, image within 1e-5 mean absolute of the
   tile kind's, K3 launches (tile 3 closest + 6 any, cluster 9 closest,
   lbvh none).  (d) ``render_dump`` at 128^2 under a 16x32 env: through a
   Tracer on the bench mesh (K1) and the small mesh (K3), one launch a
   texel chunk, through ``nerf_visibility_fn`` of 4h's stage-0 field, and
   with no visibility; card against CPU over 64 of the pixels, the image
   and the diffuse light within 1e-4 relative on >= 99.9%, the specular
   light within 6.0e-4 (its GGX term's condition number at the smallest
   roughness times 4 fp32 roundings: DUMP_GATED).  (e) ``build_distribution`` / ``build_alias_table``
   card against CPU; ``sample_li`` (exact), ``pdf_li`` and
   ``sample_li_alias`` at 65,536 draws: directions within 1e-5, pdf within
   1e-5 relative on >= 99.9%; one ReSTIR initial pass with the
   EnvDistribution (64^2, visibility through K3): finite, card against CPU
   within 1e-4 on >= 99.9% of pixels.  (f) The tools: ``downscale`` over
   4i's JPEG frames (each read back by read_jpeg at half size),
   ``render_turntable`` 4 frames at stage 0 and stage 1 from 4h's
   workspace, ``live_viewer`` on a free port in a thread (the page and a
   /render at stage 0 and stage 1, decoded by read_jpeg, then ``--train``
   for 50 steps with the step advancing between two renders); s of each.
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
   phase and 5d with K4's updates scaled by 1.01 or a K4 launch dropped
   (5b: one of three, 5d: the stochastic encode's), and exits 0 only if
   5d then fails (5b passes the scale fault: Adam's first step is
   scale-invariant).
5c. The same for a 64x64, spp-2, fp32 ReSTIR frame of the small mesh with
   normal-AO, without and with the denoiser (denoise_iters 2): mask,
   face_id and every deterministic buffer (normal_ao included) agree on
   >= 99.9% of pixels; image_brdf, diffuse_light and specular_light frame
   means within 1e-2 relative.  The per-pixel agreement share of each
   Monte Carlo buffer is printed: spatial reuse and the denoiser carry a
   sampling decision that differs on the card to neighbouring pixels.
5d. The same for one stage-0 step of a small fp32 field (8 levels of 2^15,
   hidden 32, grid 32, 1024 rays, 32 samples, compaction to 8192 points,
   TV on) with the same Stage0Randoms: loss within 1e-4 relative, each
   gradient leaf (the encoder table included) within 1e-3 relative L2; and
   one occupancy update with the same draws: the grid within 1e-4 relative
   and the occupancy mask equal on >= 99.9% of cells.
6. Print the kernel table as one JSON line (K1, K2, K3 closest hit, K3 any
   hit, K3 through dense_intersect, K4, and K4 at the stage-0 encode and
   TV shapes), the card line, and as the last line {"ok": true, "device":
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

from mirres_restir_nerf_mesh_torch.bench import (BUDGET, K4_STEP_LAUNCHES, POINT, RESTIR,
                                                 bench_mesh, camera, card_line, check_line,
                                                 check_outputs, check_state, frame_static,
                                                 make_counters, make_params, result_line, sky_env,
                                                 stage0_bench_config, stage0_finite, time_frames,
                                                 time_stage0, time_steps, train_config)

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

# bench.py's operating point (mirres_restir_nerf_mesh_torch/bench.py: its
# sizes, BUDGET and RESTIR); phases 4, 4b and 4e time TIMED_* samples, 4c,
# 4d and 4f the bench's own counts
FRAME_HW = POINT.hw
FRAME_SPP = POINT.spp
BENCH_FACES = POINT.faces
SMALL_FACES = 6_000
BOUNCE_RAYS = 1 << 20
TIMED_FRAMES = 3
TIMED_STEPS = 3
# stage 0 (phases 4f, 4g): steps a timed group and groups timed (the bench's
# loop), K4 launches a step (the stochastic encode's and the TV loss's
# backward), the export's grid resolution (the default 512 cut to fit the run)
STAGE0_STEPS = POINT.stage0_steps
STAGE0_GROUPS = POINT.stage0_groups
K4_STAGE0_LAUNCHES = 2
STAGE0_EXPORT_RESOLUTION = 256
STAGE0_RANGES = ("march", "field", "composite")
STAGE0_CHECK_LEVELS = 8     # phase 5d's field: 8 levels of 2^15, hidden 32
# bench.py's nominal rays per frame: primary, then per spp initial
# visibility, 2 x 5 spatial cross visibility, final visibility, 2 bounces x
# (closest hit + NEE)
RESTIR_RAYS_PER_SPP = 1 + 2 * 5 + 1 + 2 * 2
# K3 launches a small-mesh frame (closest, any hit): primary + 2 bounces;
# lighter: 2 NEE + 32 spp x 2 direct shadows, ReSTIR: 2 NEE (initial
# visibility fused in) + 32 spatial cross visibility
K3_FRAME = (3, 2 + 2 * FRAME_SPP)
K3_RESTIR_FRAME = (3, 2 + FRAME_SPP)


def log(*a):
    print(*a, flush=True)


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
    res.update(k3_bound(tris, ro, rd, tm, p, any_hit))
    return res


def k3_bound(tris, ro, rd, tm, p, any_hit) -> dict:
    """The bound of one K3 launch on this run's data (see check_k3): p the
    plain version's answer (the mask, or the closest hit's rows)."""
    import torch

    from mirres_restir_nerf_mesh_torch.ops import dense_tracer as dt

    N, Mcols = ro.shape[0], tris.shape[1]
    M = int((tris[9] >= 0).sum())
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    res = {}
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
    """K4 through its entry point against its plain version in fp64 (within
    1e-5 * sum|upd| at each row; the distance to the fp32 plain version is
    printed beside it), then its times: event ms of the wrapper
    (zeroed table + kernel) beside zeros + index_add_, and the device ms of
    the kernel alone, of zeroing the table and of index_add_ alone, each
    on inputs and a table allocated beforehand (queued_ms)."""
    import torch

    from mirres_restir_nerf_mesh_torch.ops.scatter import (scatter_add, scatter_add_into,
                                                           scatter_add_plain)

    k = scatter_add(idx, upd, rows)
    torch.cuda.synchronize()
    # the plain version in fp64 is the exact sum: the gate reads the
    # kernel's own rounding, not that of index_add_'s fp32 atomics (on rows
    # with hundreds of near-cancelling updates, the TV loss's, the two
    # fp32 sums differ by up to ~1e-5 * sum|upd| between them)
    p = scatter_add_plain(idx, upd.double(), rows)
    err = (k.double() - p).abs()
    tol = 1e-5 * scatter_add_plain(idx, upd.abs().double(), rows) + 1e-30
    if not bool((err <= tol).all()):
        raise AssertionError(f"{name}: differs from its plain version by {float(err.max())}")
    err32 = float((k - scatter_add_plain(idx, upd, rows)).abs().max())
    del p
    idx_l, upd_f = idx.reshape(-1).long(), upd.reshape(-1, upd.shape[-1])
    table = torch.zeros((rows, upd.shape[-1]), device=upd.device)

    def library():
        return torch.zeros_like(table).index_add_(0, idx_l, upd_f)

    return dict(max_abs_err=float(err.max()), max_err_over_tol=float((err / tol).max()),
                max_abs_err_vs_fp32_plain=err32,
                ms=cuda_ms(lambda: scatter_add(idx, upd, rows), 10),
                host_ms=host_ms(lambda: scatter_add(idx, upd, rows)),
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
    """A small-mesh run of TIMED_FRAMES counted frames: K3 closest and any
    hit launched per_frame times a frame, no K1 or K2."""
    frames = TIMED_FRAMES
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
    zero_counts, read_counts = make_counters()
    frames = {}
    for name, st in statics.items():
        zero_counts()
        times = []
        for _ in range(1 + TIMED_FRAMES):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            frame(st)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        frames[name] = dict(frame=name, frame_s=float(statistics.median(times[1:])),
                            frame_s_all=times,
                            launches_per_frame={k: read_counts()[k] / len(times)
                                                for k in ("dense_hit", "dense_occluded")})
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


def stage0_learn_config():
    """The JAX package's own stage-0 learning test (tests/test_stage0.py)."""
    from mirres_restir_nerf_mesh_torch.config import Config, finalize

    return finalize(Config(bound=1.0, iters=300, num_rays=1024, max_steps=128,
                           samples_per_ray=32, samples_per_ray_infer=48, grid_size=32,
                           dt_gamma=0.0, lambda_tv=0.0, lambda_mask=0.1, density_thresh=10.0,
                           update_extra_interval=16))


def record_scatter(run):
    """The inputs of every K4 launch the hash grid makes inside run():
    [(idx, upd, rows)], copied."""
    from mirres_restir_nerf_mesh_torch.ops import hashgrid

    orig, calls = hashgrid.scatter_add, []

    def recording(idx, upd, rows):
        calls.append((idx.clone(), upd.clone(), rows))
        return orig(idx, upd, rows)

    hashgrid.scatter_add = recording
    try:
        run()
    finally:
        hashgrid.scatter_add = orig
    return calls


def check_scatter_stage0(calls, levels: int):
    """K4 at the stage-0 step's own launches (recorded from a step of 4f):
    the stochastic encode's backward ([P, L] row ids) and the TV loss's
    ([4096, 4L]); each against its plain version, timed beside index_add_,
    with its byte bound."""
    res = []
    for idx, upd, rows in calls:
        what = ("encode backward" if idx.shape[1] == levels else "TV loss backward")
        C = upd.shape[-1]
        nbytes = idx.numel() * 4 + upd.numel() * 4 + rows * C * 4
        res.append(dict(what=what, shape=f"[{idx.shape[0]}, {idx.shape[1]}] row ids = "
                                         f"{idx.numel()} updates of {C} into {rows} rows",
                        **scatter_case(f"K4 scatter_add, stage-0 {what}", idx, upd, rows),
                        **bound(0, nbytes)))
    return res


def profile_stage0_phases(state, step_fn, sampler, cfg, spec, gen, out_dir):
    """One stage-0 step cut into forward (batch, render, loss), backward
    (autograd.grad of every leaf) and optimizer (Adam, EMA), each under its
    own torch.profiler -> {phase: profile_run summary}."""
    import torch

    from mirres_restir_nerf_mesh_torch.train import stage0 as s0

    box = {}
    leaves = [x.detach().requires_grad_(True) for x in s0.tree_leaves(state.params)]
    params = s0.tree_unflatten(state.params, iter(leaves))
    n_march = step_fn.march_candidates

    def forward():
        rnd = s0.draw_stage0_randoms(sampler, cfg, n_march, gen)
        batch = sampler.sample(rnd.sample)
        box["loss"] = s0.stage0_loss(params, state.occ.occ, batch, rnd, cfg, spec,
                                     int(state.step), n_march)[0]

    def backward():
        box["grads"] = list(torch.autograd.grad(box["loss"], leaves, allow_unused=True))

    def optimizer():
        new, _ = s0.make_optimizer(cfg).step(state.params, box["grads"], state.opt_state)
        with torch.no_grad():
            s0.tree_unflatten(new, iter([0.95 * e + 0.05 * p for e, p in zip(
                s0.tree_leaves(state.ema_params), s0.tree_leaves(new))]))

    return {name: profile_run(fn, out_dir, STAGE0_RANGES if name == "forward" else (),
                              f"stage0_{name}_profile.txt")
            for name, fn in (("forward", forward), ("backward", backward),
                             ("optimizer", optimizer))}


def bench_size():
    """The bench's sizes at this file's constants (a CPU rehearsal cuts
    those): 4c and 4d time POINT.frames / POINT.trainsteps samples, 4f
    STAGE0_GROUPS groups of STAGE0_STEPS steps."""
    import dataclasses

    return dataclasses.replace(
        POINT, hw=FRAME_HW, spp=FRAME_SPP, faces=BENCH_FACES,
        restir_tiles=RESTIR["restir_tiles"], restir_tile_size=RESTIR["restir_tile_size"],
        restir_light_samples=RESTIR["restir_light_samples"],
        restir_offsets=RESTIR["restir_offsets"], stage0_steps=STAGE0_STEPS,
        stage0_groups=STAGE0_GROUPS)


def stage0_bench(dev, gen, counts, out_dir, profile: bool):
    """Phase 4f: the bench's stage-0 point through ``bench.time_stage0``
    (bench.py:254-330): 8 synthetic frames of 256^2, the full-size field in
    bf16, one occupancy update, one warm group, then the counters zeroed,
    STAGE0_GROUPS timed groups of STAGE0_STEPS sequential steps (one sync a
    group), the counters read; then one settle and one timed occupancy
    update; 2 K4 launches a step.  -> (result, the inputs of one step's K4
    launches, recorded after the counters were read, the field's levels)."""
    res, state, step_fn, cfg, spec, sampler = time_stage0(dev, gen, counts, bench_size(), log)
    res["config"] = ("bench.py stage 0: 8192 rays x 64 samples, num_points 2^18, "
                     "adaptive_num_rays, 16 levels of 2^19, grid 128, bf16, 8 frames of 256^2")
    log("stage-0 step: " + json.dumps(res))
    launches, steps = res["launches"], STAGE0_STEPS * STAGE0_GROUPS
    if launches["scatter_add"] != K4_STAGE0_LAUNCHES * steps:
        raise AssertionError(f"stage-0 step: {launches['scatter_add']} K4 launches in {steps} "
                             f"steps, {K4_STAGE0_LAUNCHES} a step expected")
    calls = record_scatter(lambda: step_fn(state, gen))
    if profile:
        res["profile"] = profile_stage0_phases(state, step_fn, sampler, cfg, spec, gen, out_dir)
        log("stage-0 step profile: " + json.dumps(res["profile"]))
    return res, calls, spec.grid_levels


def stage0_learn(dev, gen, counts, out_dir):
    """Phase 4g: stage 0 as a user runs it, by the recipe of the JAX
    package's learning test (tests/test_stage0.py: 300 iterations, an
    occupancy update every 16, PSNR on training view 0 before and after)
    at full width (NeRFSpec defaults, bf16) on 12 synthetic frames of
    256^2, then export_stage0_mesh from the EMA field at resolution 256
    with the visibility culling.  Gates: the learning test's own, and a
    non-empty mesh whose median vertex radius lies within 20% of the
    sphere's 0.5; the culling traced one closest hit a view (K1, or K3 for
    a small mesh)."""
    import numpy as np
    import torch

    from mirres_restir_nerf_mesh_torch.data.provider import RayDataset
    from mirres_restir_nerf_mesh_torch.data.synthetic import make_synthetic_frames
    from mirres_restir_nerf_mesh_torch.export import stage0_export as ex
    from mirres_restir_nerf_mesh_torch.models import nerf as nerf_model
    from mirres_restir_nerf_mesh_torch.train import stage0 as s0

    zero_counts, read_counts = counts
    cfg = stage0_learn_config()
    n_frames, HW = 12, 256
    data = make_synthetic_frames(n_frames=n_frames, H=HW, W=HW, bound=cfg.bound)
    HW = data.H
    sampler = RayDataset(data, bound=cfg.bound, device=dev)
    spec = nerf_model.NeRFSpec(bound=cfg.bound, compute_dtype=torch.bfloat16)
    state = s0.init_state(gen, cfg, spec, device=dev)
    step_fn = s0.make_train_step(cfg, spec, sampler)
    occ_update = s0.make_occ_update(cfg, spec)
    render_chunk = s0.make_render_fn(cfg, spec, use_ema=False)
    frame = sampler.frame_rays(0)
    gt = frame["pixels"].cpu().numpy().reshape(HW, HW, 3)

    def eval_frame():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img, depth = s0.render_frame(state, render_chunk, frame["rays_o"], frame["rays_d"], HW,
                                     HW)
        return img, depth, time.perf_counter() - t0

    def psnr(img):
        return float(-10.0 * np.log10(max(float(np.mean((img - gt) ** 2)), 1e-12)))

    img0, _, eval0_s = eval_frame()
    zero_counts()
    losses = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(cfg.iters):
        if i % cfg.update_extra_interval == 0:
            state = occ_update(state, gen)
        state, aux = step_fn(state, gen)
        losses.append(aux["loss"])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = read_counts()
    losses = [float(x) for x in losses]
    img1, depth1, eval1_s = eval_frame()
    res = {"config": "tests/test_stage0.py recipe at full width: 300 iterations of 1024 rays, "
                     "max_steps 128, 32 samples, grid 32, occupancy update every 16; "
                     "NeRFSpec defaults, bf16; 12 synthetic frames of 256^2",
           "train_s": train_s, "loss_first": losses[0], "loss_last": losses[-1],
           "psnr_before": psnr(img0), "psnr_after": psnr(img1),
           "occ_rate": float(state.occ.occ.float().mean()),
           "center_depth": float(depth1[HW // 2, HW // 2]),
           "eval_frame_s": [eval0_s, eval1_s], "launches": launches}
    log("stage-0 learning run: " + json.dumps(res))
    fails = []
    if not np.isfinite(losses).all() or not losses[-1] < 0.5 * losses[0]:
        fails.append("loss did not fall below half its first value")
    if not (res["psnr_after"] > res["psnr_before"] + 4.0 and res["psnr_after"] > 15.0):
        fails.append("PSNR gate")
    if not res["occ_rate"] < 0.5:
        fails.append("occupancy rate")
    if not 1.2 < res["center_depth"] < 1.9:
        fails.append("centre depth")
    if launches["scatter_add"] != cfg.iters:      # the encode's backward; TV is off here
        fails.append(f"{launches['scatter_add']} K4 launches in {cfg.iters} steps")
    if fails:
        raise AssertionError(f"stage-0 learning run failed: {fails}")

    # the export, the EMA field's density; the culling's result kept
    box, orig = {}, ex.mark_unseen_triangles

    def recording(*a, **k):
        box["unseen"] = orig(*a, **k)
        return box["unseen"]

    def density_fn(pts):
        return nerf_model.density(state.ema_params, pts, spec)["sigma"]

    ex.mark_unseen_triangles = recording
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        meshes = ex.export_stage0_mesh(
            density_fn, str(Path(out_dir or "build") / "stage0_mesh"), bound=cfg.bound,
            cascade=cfg.cascade, resolution=STAGE0_EXPORT_RESOLUTION,
            density_thresh=cfg.density_thresh, dataset=data, visibility_culling=True, device=dev)
    finally:
        ex.mark_unseen_triangles = orig
    export_s = time.perf_counter() - t0
    launches_x = read_counts()
    verts, tris = meshes[0] if meshes else (np.zeros((0, 3)), np.zeros((0, 3)))
    unseen = box.get("unseen", np.zeros(0, bool))
    radius = float(np.median(np.linalg.norm(verts, axis=1))) if len(verts) else 0.0
    res["export"] = {"resolution": STAGE0_EXPORT_RESOLUTION, "export_s": export_s,
                     "faces": int(tris.shape[0]), "verts": int(verts.shape[0]),
                     "faces_before_culling": int(unseen.shape[0]),
                     "unseen_share": float(unseen.mean()) if unseen.size else None,
                     "median_vertex_radius": radius, "launches": launches_x}
    log("stage-0 export: " + json.dumps(res["export"]))
    traced = launches_x["queue_trace"] + launches_x["dense_hit"]
    if tris.shape[0] == 0 or not abs(radius - 0.5) <= 0.1:
        raise AssertionError(f"stage-0 export: {tris.shape[0]} faces, median vertex radius "
                             f"{radius} (0.5 +- 20% expected)")
    if traced != n_frames or launches_x["dense_occluded"] or launches_x["grid_trace"]:
        raise AssertionError(f"stage-0 export: culling launches {launches_x}, one closest hit "
                             f"a view ({n_frames}) expected")
    return res


# phase 4h: the CLI as a user runs it.  A blender-format scene of the
# synthetic sphere (the JAX package's CLI test's cameras, tests/test_cli_e2e.py:
# 12 train, 2 val, 2 test frames of 128^2 RGBA; with ssaa 2 stage 1 renders
# 256^2, bench.py's pixel count), then main() for stage 0, stage 1 and the
# test renders, then albedo_eval.
CLI_HW = 128
CLI_SPLITS = (("train", 12, 0), ("val", 2, 1), ("test", 2, 2))
CLI_STAGE0_ITERS = 500
CLI_STAGE1_ITERS = 10
# the marching grid of 4h's save_mesh.  Its visibility culling keeps only
# the faces a training pixel's closest hit lands on (the reference's rule);
# the sphere covers ~2,200 pixels of a 128^2 view, so at 256^3 every seen
# face is isolated and the cleanup drops them all, while at 64^3 the seen
# faces join
CLI_MCUBES_RESO = 64
CLI_TEXTURE = 1024
# data/synthetic.py render_sphere_image's albedo.  Constant, so albedo_eval's
# per-channel median scale maps any spatially constant prediction onto it:
# its PSNR here checks the plumbing, not the albedo learned
CLI_ALBEDO = (0.8, 0.3, 0.2)
CLI_SPP = 32                     # the Config default
CLI_MIN_VAL_PSNR = 15.0
CLI_RADIUS = (0.5, 0.1)          # the sphere's radius, +-20% (4g's gate)
CLI_ARTIFACTS = ("rgb.png", "depth.png", "brdf.png", "kd.exr", "ks.exr", "normal.exr",
                 "diffuse.exr", "specular.exr")


def write_blender_scene(root: Path) -> None:
    """transforms_{split}.json and RGBA PNGs (the port's writer) of the
    synthetic sphere, and under root/albedo each test frame's ground-truth
    albedo (the sphere's constant albedo inside its alpha)."""
    import numpy as np

    from mirres_restir_nerf_mesh_torch.data.synthetic import orbit_pose, render_sphere_image
    from mirres_restir_nerf_mesh_torch.utils.image_io import write_png

    H = W = CLI_HW
    fx = 0.8 * W
    intr = np.array([fx, fx, W / 2, H / 2], np.float32)
    (root / "albedo").mkdir(parents=True, exist_ok=True)
    for split, n, seed in CLI_SPLITS:
        (root / split).mkdir(parents=True, exist_ok=True)
        rng = np.random.RandomState(seed)
        frames = []
        for k in range(n):
            theta = np.pi / 3 + rng.uniform(0, np.pi / 3)
            phi = 2 * np.pi * k / n + rng.uniform(0, 0.3)
            pose = orbit_pose(theta, phi, radius=2.0)
            img = render_sphere_image(pose, intr, H, W)
            write_png(str(root / split / f"r_{k}.png"), (img * 255).astype(np.uint8))
            frames.append({"file_path": f"{split}/r_{k}", "transform_matrix": pose.tolist()})
            if split == "test":
                alb = np.zeros((H, W, 4), np.float32)
                alb[..., :3] = CLI_ALBEDO
                alb[..., 3] = img[..., 3]
                write_png(str(root / "albedo" / f"r_{k:04d}_albedo.png"),
                          np.round(alb * 255).astype(np.uint8))
        (root / f"transforms_{split}.json").write_text(json.dumps(
            {"camera_angle_x": float(2 * np.arctan(0.5 * W / fx)), "frames": frames}))


def takes_dense_route(verts, tris, dev) -> bool:
    """Whether the tracer takes a mesh by the dense route (K3)."""
    import torch

    from mirres_restir_nerf_mesh_torch.ops.cluster_bvh import build_clusters
    from mirres_restir_nerf_mesh_torch.ops.tile_tracer import _takes_dense

    return _takes_dense(build_clusters(torch.as_tensor(verts, device=dev),
                                       torch.as_tensor(tris, device=dev)), 8192)


def restir_frame_launches(la, frames: int, dense: bool, spp: int) -> bool:
    """Whether ``la`` holds the tracer's launches of ``frames`` ReSTIR
    frames: primary + 2 bounces closest hit, 2 NEE (the initial visibility
    fused in) and one spatial cross-visibility launch a spp."""
    if dense:
        return (la["dense_hit"] == 3 * frames and la["dense_occluded"] == (2 + spp) * frames
                and la["queue_trace"] == 0)
    return (la["queue_trace"] == (1 + 2 * 2 + spp) * frames and la["dense_hit"] == 0
            and la["dense_occluded"] == 0)


class CliHarness:
    """Runs ``mirres_restir_nerf_mesh_torch.main.main`` with the launch
    counters zeroed just before and read just after, recording the Trainers
    it makes and the seconds (each between two syncs) of every eval render,
    save_mesh, stage-1 step and stage-1 export, the export by phase.
    ``close`` restores what it patched."""

    def __init__(self, counts):
        import torch

        from mirres_restir_nerf_mesh_torch.export import stage1_export
        from mirres_restir_nerf_mesh_torch.train import stage1 as train1
        from mirres_restir_nerf_mesh_torch.train import trainer as trainer_mod
        from mirres_restir_nerf_mesh_torch.utils.profiling import PhaseTimer

        self.zero_counts, self.read_counts = counts
        T = trainer_mod.Trainer
        self.trainers, self.times = [], {}
        self.export_timer = PhaseTimer()
        self._restore = [(T, "__init__", T.__init__),
                         (T, "_render_eval_outputs", T._render_eval_outputs),
                         (T, "save_mesh", T.save_mesh),
                         (train1, "make_train_step", train1.make_train_step),
                         (stage1_export, "export_stage1_mesh", stage1_export.export_stage1_mesh)]
        originals = [o for _, _, o in self._restore]
        times = self.times

        def clock(key, fn):
            def run(*a, **k):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                r = fn(*a, **k)
                torch.cuda.synchronize()
                times.setdefault(key, []).append(time.perf_counter() - t0)
                return r
            return run

        def init(tr, *a, **k):
            originals[0](tr, *a, **k)
            self.trainers.append(tr)

        T.__init__ = init
        T._render_eval_outputs = clock("eval_frame_s", originals[1])
        T.save_mesh = clock("save_mesh_s", originals[2])
        train1.make_train_step = lambda *a, **k: clock("stage1_step_s", originals[3](*a, **k))
        stage1_export.export_stage1_mesh = lambda *a, **k: clock("export_stage1_s", originals[4])(
            *a, **{**k, "timer": self.export_timer})

    def run(self, argv, ws: Path, dev):
        """main(argv) on dev -> (readings, its Trainer, metrics_ngp.jsonl's
        records)."""
        import torch

        from mirres_restir_nerf_mesh_torch import main as cli

        self.times.clear()
        self.export_timer.totals.clear()
        self.export_timer.counts.clear()
        n_before = len(self.trainers)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        self.zero_counts()
        t0 = time.perf_counter()
        cli.main(argv, device=dev)
        torch.cuda.synchronize()
        res = {"s": time.perf_counter() - t0, "launches": self.read_counts(),
               "max_memory_allocated_GB": torch.cuda.max_memory_allocated() / 1e9,
               **{k: v for k, v in self.times.items()}}
        if self.export_timer.totals:
            res["export_phases_s"] = dict(self.export_timer.totals)
        metrics = [json.loads(x) for x in (ws / "metrics_ngp.jsonl").read_text().splitlines()]
        return res, self.trainers[n_before], metrics

    def close(self):
        for obj, name, orig in self._restore:
            setattr(obj, name, orig)


def cli_run(dev, counts, out_dir, keep=None):
    """Phase 4h: ``mirres_restir_nerf_mesh_torch.main.main`` three times on a
    blender-format scene, then albedo_eval; the launch counters zeroed just
    before each run and read just after.

    1. stage 0 with -O (bf16, adaptive rays, mark-untrained, visibility
       culling) at the default widths, 500 iterations, marching grid 64;
    2. stage 1 with BRDF and ReSTIR, 10 iterations, 1024^2 textures;
    3. the test renders with relighting (the sky + sun .hdr), spp as trained.

    Gates: stage 0: val PSNR above 15, a non-empty mesh_0.ply whose median
    vertex radius lies within 20% of 0.5, 2 K4 launches a step, one closest
    hit a training view in save_mesh, a stage-0 checkpoint.  Stage 1: loss
    finite, uncertain_count 0 at the logged step (the Trainer's own
    budgets), the OBJ, both textures and a stage-1 checkpoint written, K4 3
    a step and the tracer's launches of each frame (train steps and val
    renders) for the route the mesh takes; its checkpoint loads into a CPU
    Trainer with every leaf equal to the card's state.  Test: the artifact
    set of test() for its 2 frames, every EXR finite when read back, the
    tracer's launches, no K4; albedo_eval's PSNR finite (a plumbing check:
    the ground truth is constant, see CLI_ALBEDO).  With ``keep`` (a list)
    the scene and workspace stay for phase 4k: keep gets {"tmp", "scene",
    "ws", "field": (the stage-0 EMA params, their NeRFSpec)}, and the
    caller cleans up."""
    import shutil
    import tempfile

    import numpy as np

    from mirres_restir_nerf_mesh_torch import albedo_eval
    from mirres_restir_nerf_mesh_torch import main as cli
    from mirres_restir_nerf_mesh_torch.export.meshio import read_ply
    from mirres_restir_nerf_mesh_torch.train import checkpoint as ckpt
    from mirres_restir_nerf_mesh_torch.train import trainer as trainer_mod
    from mirres_restir_nerf_mesh_torch.utils.exr import read_exr
    from mirres_restir_nerf_mesh_torch.utils.image_io import save_hdr

    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_cli_")
    base = Path(tmp.name)
    root, ws = base / "scene", base / "ws"
    write_blender_scene(root)
    hdr = str(base / "sky.hdr")
    save_hdr(hdr, sky_env())
    common = [str(root), "--workspace", str(ws), "--bound", "1", "--scale", "1.0"]
    argv = {
        "stage0": common + ["--stage", "0", "-O", "--iters", str(CLI_STAGE0_ITERS),
                            "--mcubes_reso", str(CLI_MCUBES_RESO), "--n_eval", "1",
                            "--n_ckpt", "1"],
        "stage1": common + ["--stage", "1", "--use_brdf", "--use_restir", "--iters",
                            str(CLI_STAGE1_ITERS), "--texture_size", str(CLI_TEXTURE),
                            "--n_eval", "1", "--n_ckpt", "1"],
        "test": common + ["--stage", "1", "--test", "--use_brdf", "--use_restir", "--eval_spp",
                          "0", "--relight_spp", "0", "--envmap_path", hdr, "--texture_size",
                          str(CLI_TEXTURE)],
    }
    harness = CliHarness(counts)
    T = trainer_mod.Trainer

    def run(name):
        return harness.run(argv[name], ws, dev)

    kept = None
    try:
        res = {}
        # ---- stage 0
        r0, tr0, metrics = run("stage0")
        verts, tris = read_ply(str(ws / "mesh_0.ply"))
        train_logs = [m for m in metrics if "it_per_s" in m]
        val = [m for m in metrics if "val_psnr" in m]
        r0.update(
            faces=int(tris.shape[0]), verts=int(verts.shape[0]),
            median_vertex_radius=float(np.median(np.linalg.norm(verts, axis=1)))
            if len(verts) else 0.0,
            it_per_s=train_logs[-1]["it_per_s"], loss_last=train_logs[-1]["loss"],
            num_rays_last=tr0.cfg.num_rays, val_psnr=val[-1]["val_psnr"] if val else None,
            march_lattice_S=tr0.train_step.march_candidates,
            checkpoints=sorted(p.name for p in (ws / "checkpoints").glob("ngp_stage0_*.pkl")))
        la = r0["launches"]
        r0["culling_route"] = "tile (K1)" if la["queue_trace"] else "dense (K3)"
        res["stage0"] = r0
        log("cli stage 0: " + json.dumps(r0))
        n_train = CLI_SPLITS[0][1]
        fails = []
        if not (r0["val_psnr"] or 0.0) > CLI_MIN_VAL_PSNR:
            fails.append(f"val PSNR {r0['val_psnr']}")
        if (tris.shape[0] == 0
                or not abs(r0["median_vertex_radius"] - CLI_RADIUS[0]) <= CLI_RADIUS[1]):
            fails.append(f"mesh: {tris.shape[0]} faces, median radius "
                         f"{r0['median_vertex_radius']}")
        if la["scatter_add"] != K4_STAGE0_LAUNCHES * CLI_STAGE0_ITERS:
            fails.append(f"{la['scatter_add']} K4 launches in {CLI_STAGE0_ITERS} steps")
        if (la["queue_trace"] + la["dense_hit"] != n_train or la["dense_occluded"]
                or la["grid_trace"]):
            fails.append(f"save_mesh launches {la}, one closest hit a view ({n_train})")
        if not r0["checkpoints"]:
            fails.append("no stage-0 checkpoint")
        if fails:
            raise AssertionError(f"cli stage 0 failed: {fails}")

        dense = takes_dense_route(verts, tris, dev)
        route = "dense (K3)" if dense else "tile (K1)"

        def frame_launches(la, frames):
            return restir_frame_launches(la, frames, dense, CLI_SPP)

        # ---- stage 1
        r1, tr1, metrics = run("stage1")
        last = [m for m in metrics if "it_per_s" in m][-1]
        r1.update(route=route, faces=int(tr1.tris.shape[0]), loss_last=last["loss"],
                  psnr_last=last.get("psnr"), uncertain_count=last.get("uncertain_count"),
                  it_per_s=last["it_per_s"],
                  val=[m for m in metrics if "val_psnr_brdf" in m][-1:],
                  checkpoints=sorted(p.name for p in (ws / "checkpoints").glob(
                      "ngp_stage1_*.pkl")))
        res["stage1"] = r1
        log("cli stage 1: " + json.dumps(r1))
        la = r1["launches"]
        frames1 = CLI_STAGE1_ITERS + 2 * CLI_SPLITS[1][1]   # steps, in-train and final val
        fails = []
        if not np.isfinite(r1["loss_last"]):
            fails.append(f"loss {r1['loss_last']}")
        if r1["uncertain_count"] != 0:
            fails.append(f"uncertain_count {r1['uncertain_count']}: the tracer dropped candidates")
        for f in ("mesh_0.obj", "feat0_0.png", "feat1_0.png"):
            if not (ws / f).exists():
                fails.append(f"{f} missing")
        if not r1["checkpoints"]:
            fails.append("no stage-1 checkpoint")
        if la["scatter_add"] != K4_STEP_LAUNCHES * CLI_STAGE1_ITERS:
            fails.append(f"{la['scatter_add']} K4 launches in {CLI_STAGE1_ITERS} steps")
        if not frame_launches(la, frames1) or la["grid_trace"]:
            fails.append(f"tracer launches {la} for {frames1} frames on the {route} route")
        if fails:
            raise AssertionError(f"cli stage 1 failed: {fails}")

        # the stage-1 checkpoint written on the card, in a CPU Trainer
        t0 = time.perf_counter()
        cfg1 = cli.config_from_args(argv["stage1"])
        cpu_tr = T("ngp", cfg1, cli.load_dataset(cfg1, "train"), workspace=str(ws), device="cpu")
        card_leaves, cpu_leaves = ckpt.numpy_leaves(tr1.state), ckpt.numpy_leaves(cpu_tr.state)
        differing = [k for k in card_leaves if k not in cpu_leaves
                     or card_leaves[k].dtype != cpu_leaves[k].dtype
                     or not np.array_equal(card_leaves[k], cpu_leaves[k])]
        res["checkpoint_on_cpu"] = {"leaves": len(card_leaves), "differing": differing[:8],
                                    "s": time.perf_counter() - t0}
        log("cli stage-1 checkpoint on the CPU: " + json.dumps(res["checkpoint_on_cpu"]))
        if differing or set(card_leaves) != set(cpu_leaves):
            raise AssertionError(f"stage-1 checkpoint on the CPU: leaves differ {differing[:8]}")
        del cpu_tr

        # ---- test renders with relighting, then albedo_eval
        rt, _, _ = run("test")
        results = ws / "results"
        n_test = CLI_SPLITS[2][1]
        want = {f"ngp_{i:04d}_{a}" for i in range(n_test) for a in CLI_ARTIFACTS}
        want.add("ngp_env_map.exr")
        got = {p.name for p in results.iterdir()}
        exr_finite = {p.name: bool(np.isfinite(read_exr(str(p))).all())
                      for p in sorted(results.glob("*.exr"))}
        t0 = time.perf_counter()
        alb = albedo_eval.main(["--pred_dir", str(results), "--gt_dir", str(root / "albedo")],
                               device=dev)
        rt.update(artifacts_missing=sorted(want - got), exr_finite=all(exr_finite.values()),
                  albedo_eval=alb, albedo_eval_s=time.perf_counter() - t0)
        rt["route"] = route
        res["test"] = rt
        log("cli test: " + json.dumps(rt))
        la = rt["launches"]
        fails = []
        if want - got:
            fails.append(f"missing {sorted(want - got)}")
        if not rt["exr_finite"]:
            fails.append(f"non-finite EXRs {[k for k, v in exr_finite.items() if not v]}")
        if not frame_launches(la, 2 * n_test) or la["scatter_add"] or la["grid_trace"]:
            fails.append(f"launches {la} for {2 * n_test} frames on the {route} route")
        if not np.isfinite(alb["psnr"]):
            fails.append(f"albedo_eval PSNR {alb['psnr']}")
        if fails:
            raise AssertionError(f"cli test failed: {fails}")
        if out_dir is not None:
            for f in ("log_ngp.txt", "metrics_ngp.jsonl"):
                shutil.copy(ws / f, Path(out_dir) / f"cli_{f}")
        if keep is not None:
            kept = dict(tmp=tmp, scene=root, ws=ws, field=(tr0.state.ema_params, tr0.nerf_spec))
        return res
    finally:
        harness.close()
        if kept is None:
            tmp.cleanup()
        else:
            keep.append(kept)


# phase 4i: the repo's "your dataset" recipe (configs/general_config_for_your_dataset.txt)
# on a COLMAP workspace of the analytic sphere: sparse/0/*.bin, JPEG images
# (this file's encoder), dense depth maps; then the loaders at a real size,
# read_jpeg per megapixel, the port's DPT on the card, and a DTU scene.
COLMAP_HW = (240, 320)                          # H, W
COLMAP_VIEWS = 24
COLMAP_POINTS = 4000
COLMAP_OUTLIER_SHARE = 0.1
COLMAP_UNTRACKED_SHARE = 0.1                    # keypoints without a 3-D point
COLMAP_PINHOLE = (262.0, 251.0, 163.7, 116.4)   # at 320 wide: fx != fy, off-centre principal point
COLMAP_NOISE_PX = 0.3
COLMAP_ERR = (0.2, 1.5)
COLMAP_DEPTH_AFFINE = (0.4, 0.7)                # depths/*.npy = 0.4 z + 0.7
# the sphere scene (radius 0.5 at the origin, cameras at 2) in COLMAP's
# world: x_world = WORLD_SCALE * R x + WORLD_SHIFT
COLMAP_WORLD_SCALE = 3.0
COLMAP_WORLD_SHIFT = (0.4, -0.2, 1.0)
COLMAP_WORLD_AXIS_ANGLE = ((0.3, 1.0, 0.2), 0.7)
COLMAP_BOUND = 2.0
# the room's half-size in the sphere scene's units: the cameras (at 2) stand
# inside it; scaled by the loader (cameras at 0.75 bound) it lies between
# the inner cascade's box [-1, 1]^3 and the bound, so mesh_0.ply holds the
# sphere and mesh_1.ply the walls
COLMAP_ROOM = 2.5
COLMAP_TEST_EVERY = 8                           # load_colmap's default split rule
COLMAP_JPEG_QUALITY = 90
COLMAP_STAGE0_ITERS = 500
COLMAP_STAGE1_ITERS = 10
COLMAP_TEXTURE = 1024
# the marching grid of save_mesh: the sphere covers ~13k pixels of a view,
# so at 64^3 the faces a training pixel's closest hit lands on join into a
# surface (ROADMAP Queue C), and its ~13k faces keep stage 1's traces within
# the Trainer's budgets at 640x480 (at 128^3 its 51.5k faces left 100,923
# rays uncertain)
COLMAP_MCUBES_RESO = 64
COLMAP_SPARSE_SHARE = (0.05, 0.15)              # the sampler's 10% branch, +-3.7 sigma at 500
COLMAP_RADIUS_TOL = 0.2                         # the mesh's median radius (4g's, 4h's gate)
COLMAP_MAX_DENSE_REL_ERR = 1e-3
COLMAP_POSE_ATOL = 1e-5
LOADER_REAL = dict(images=200, points=100_000, keypoints=5_000, track=10)
JPEG_TIMED_HW = (756, 1008)
# a progressive JPEG of the room at JPEG_TIMED_HW, written by Pillow (the
# card machine has no PIL); the .json beside it holds its pixels' sha256 as
# PIL decodes them (tests/test_torch_image_formats.py checks both)
PROGRESSIVE_FIXTURE = Path(__file__).resolve().parent / "tests" / "fixtures" / \
    "progressive_room.jpg"
DPT_FRAMES = 2
DPT_ATOL = 2e-4                                 # of the map's max (tests/test_depth_net.py)
DTU_VIEWS, DTU_HW = 6, (120, 160)

# baseline JPEG: ITU T.81 Annex K tables (quantization in natural order,
# Huffman code counts and symbols)
_JPEG_QUANT = (
    [16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55, 14, 13, 16, 24, 40, 57, 69,
     56, 14, 17, 22, 29, 51, 87, 80, 62, 18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81,
     104, 113, 92, 49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99],
    [17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99, 24, 26, 56, 99, 99, 99, 99,
     99, 47, 66, 99, 99, 99, 99, 99, 99] + [99] * 32)
_JPEG_HUFF = {
    (0, 0): ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], "000102030405060708090a0b"),
    (0, 1): ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0], "000102030405060708090a0b"),
    (1, 0): ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 125],
             "01020300041105122131410613516107227114328191a1082342b1c11552d1f02433627282090a16"
             "1718191a25262728292a3435363738393a434445464748494a535455565758595a63646566676869"
             "6a737475767778797a838485868788898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6"
             "b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8"
             "f9fa"),
    (1, 1): ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 119],
             "000102031104052131061241510761711322328108144291a1b1c109233352f0156272d10a162434"
             "e125f11718191a262728292a35363738393a434445464748494a535455565758595a636465666768"
             "696a737475767778797a82838485868788898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4"
             "b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8"
             "f9fa"),
}
_ZIGZAG = (0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48, 41,
           34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30,
           37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63)


def write_jpeg(path, rgb, quality: int = 90) -> None:
    """uint8 RGB [H, W, 3] -> a baseline JFIF JPEG at 4:2:0: JFIF's YCbCr,
    2x2 chroma means, a float DCT, libjpeg's quality scaling of the Annex K
    tables and Annex K's Huffman codes.  Kept here, apart from the port, so
    that the card run decodes files the port did not write."""
    import struct as st

    import numpy as np

    H, W = rgb.shape[:2]
    x = rgb.astype(np.float64)
    ycc = np.stack([x @ [0.299, 0.587, 0.114],
                    x @ [-0.168736, -0.331264, 0.5] + 128.0,
                    x @ [0.5, -0.418688, -0.081312] + 128.0], axis=-1)
    Hp, Wp = -(-H // 16) * 16, -(-W // 16) * 16
    ycc = np.pad(ycc, ((0, Hp - H), (0, Wp - W), (0, 0)), mode="edge")
    sub = ycc[..., 1:].reshape(Hp // 2, 2, Wp // 2, 2, 2).mean(axis=(1, 3))
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    qt = [np.clip((np.array(q) * scale + 50) // 100, 1, 255) for q in _JPEG_QUANT]
    u = np.arange(8)
    D = np.sqrt(np.where(u == 0, 1.0, 2.0) / 8)[:, None] * np.cos(
        (2 * u[None] + 1) * u[:, None] * np.pi / 16)

    def blocks(plane, q):
        h, w = plane.shape
        b = plane.reshape(h // 8, 8, w // 8, 8).transpose(0, 2, 1, 3) - 128.0
        c = np.round(D @ b @ D.T / q.reshape(8, 8)).astype(np.int64)
        return c.reshape(h // 8, w // 8, 64)[..., list(_ZIGZAG)]

    yb = blocks(ycc[..., 0], qt[0])
    cbb, crb = blocks(sub[..., 0], qt[1]), blocks(sub[..., 1], qt[1])
    codes = {}
    for key, (counts, hexvals) in _JPEG_HUFF.items():
        vals, code, k, table = bytes.fromhex(hexvals), 0, 0, {}
        for L in range(1, 17):
            for _ in range(counts[L - 1]):
                table[vals[k]] = format(code, f"0{L}b")
                code, k = code + 1, k + 1
            code <<= 1
        codes[key] = table

    def bits(v):
        s = abs(v).bit_length()
        return s, (format(v if v > 0 else v + (1 << s) - 1, f"0{s}b") if s else "")

    out, pred = [], [0, 0, 0]

    def put(block, comp, t):
        dc_tab, ac_tab = codes[(0, t)], codes[(1, t)]
        s, b = bits(int(block[0]) - pred[comp])
        pred[comp] = int(block[0])
        out.append(dc_tab[s] + b)
        nz = np.nonzero(block[1:])[0] + 1
        last = 0
        for k in nz.tolist():
            run = k - last - 1
            while run > 15:
                out.append(ac_tab[0xF0])
                run -= 16
            s, b = bits(int(block[k]))
            out.append(ac_tab[(run << 4) | s] + b)
            last = k
        if last < 63:
            out.append(ac_tab[0x00])

    for my in range(Hp // 16):
        for mx in range(Wp // 16):
            for dy in (0, 1):
                for dx in (0, 1):
                    put(yb[2 * my + dy, 2 * mx + dx], 0, 0)
            put(cbb[my, mx], 1, 1)
            put(crb[my, mx], 2, 1)
    s = "".join(out)
    s += "1" * (-len(s) % 8)
    data = int(s, 2).to_bytes(len(s) // 8, "big").replace(b"\xff", b"\xff\x00") if s else b""

    def seg(marker, body):
        return bytes([0xFF, marker]) + st.pack(">H", len(body) + 2) + body

    hdr = b"\xff\xd8" + seg(0xE0, b"JFIF\0\x01\x01\0\0\x01\0\x01\0\0")
    for i, q in enumerate(qt):
        hdr += seg(0xDB, bytes([i]) + bytes(int(v) for v in q[list(_ZIGZAG)]))
    hdr += seg(0xC0, st.pack(">BHHB", 8, H, W, 3) + bytes([1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1]))
    for (tc, th), (counts, hexvals) in _JPEG_HUFF.items():
        hdr += seg(0xC4, bytes([tc << 4 | th]) + bytes(counts) + bytes.fromhex(hexvals))
    hdr += seg(0xDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0]))
    Path(path).write_bytes(hdr + data + b"\xff\xd9")


def rotmat2qvec(R):
    """A rotation matrix as COLMAP's (w, x, y, z) quaternion, w >= 0."""
    import numpy as np

    (Rxx, Ryx, Rzx), (Rxy, Ryy, Rzy), (Rxz, Ryz, Rzz) = np.asarray(R)
    K = np.array([[Rxx - Ryy - Rzz, 0, 0, 0], [Ryx + Rxy, Ryy - Rxx - Rzz, 0, 0],
                  [Rzx + Rxz, Rzy + Ryz, Rzz - Rxx - Ryy, 0],
                  [Ryz - Rzy, Rzx - Rxz, Rxy - Ryx, Rxx + Ryy + Rzz]]) / 3.0
    w, v = np.linalg.eigh(K)
    q = v[[3, 0, 1, 2], np.argmax(w)]
    return -q if q[0] < 0 else q


def write_colmap_model(sparse: Path, W, H, pinhole, images, points):
    """COLMAP's binary model: one PINHOLE camera; images: (id, qvec, tvec,
    name, xy [M, 2], point ids [M]); points: (ids [P], xyz [P, 3], errors
    [P], track length [P])."""
    import struct as st

    import numpy as np

    sparse.mkdir(parents=True, exist_ok=True)
    (sparse / "cameras.bin").write_bytes(st.pack("<QiiQQ", 1, 1, 1, W, H)
                                         + st.pack("<4d", *pinhole))
    parts = [st.pack("<Q", len(images))]
    kp = np.dtype([("x", "<f8"), ("y", "<f8"), ("id", "<i8")])
    for iid, q, t, name, xy, pid in images:
        rec = np.empty(len(pid), kp)
        rec["x"], rec["y"], rec["id"] = xy[:, 0], xy[:, 1], pid
        parts += [st.pack("<i4d3di", iid, *q, *t, 1), name.encode() + b"\0",
                  st.pack("<Q", len(pid)), rec.tobytes()]
    (sparse / "images.bin").write_bytes(b"".join(parts))
    ids, xyz, err, track = points
    head = np.dtype([("id", "<u8"), ("xyz", "<f8", 3), ("rgb", "u1", 3), ("err", "<f8"),
                     ("n", "<u8")])
    rec = np.zeros(len(ids), head)
    rec["id"], rec["xyz"], rec["rgb"], rec["err"], rec["n"] = ids, xyz, 128, err, track
    parts = [st.pack("<Q", len(ids))]
    heads = [r.tobytes() for r in rec]
    for h, n in zip(heads, np.asarray(track).tolist()):
        parts += [h, bytes(8 * n)]
    (sparse / "points3D.bin").write_bytes(b"".join(parts))


def _axis_angle(axis, angle):
    import numpy as np

    a = np.asarray(axis, np.float64) / np.linalg.norm(axis)
    Kx = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
    return np.eye(3) + np.sin(angle) * Kx + (1 - np.cos(angle)) * Kx @ Kx


def room_view(pose, intr, H, W):
    """One view of the capture's scene: data/synthetic.py's sphere (radius
    0.5 at the origin, its shading) inside a cube room of half-size
    COLMAP_ROOM, whose walls carry a smooth colour pattern.  -> (RGB
    [H, W, 3] in [0, 1], z-depth [H, W] along the OpenGL camera's axis,
    the sphere's pixels)."""
    import numpy as np

    from mirres_restir_nerf_mesh_torch.data.synthetic import render_sphere_image

    fx, fy, cx, cy = intr
    jj, ii = np.meshgrid(np.arange(H) + 0.5, np.arange(W) + 0.5, indexing="ij")
    d = np.stack([(ii - cx) / fx, -(jj - cy) / fy, -np.ones_like(ii)], axis=-1) @ pose[:3, :3].T
    o = pose[:3, 3].astype(np.float64)
    a, b = np.sum(d * d, -1), np.sum(d * o, -1)
    disc = b * b - a * (o @ o - 0.25)
    t_obj = (-b - np.sqrt(np.maximum(disc, 0.0))) / a       # along d, whose camera z is -1
    obj = (disc > 0) & (t_obj > 0)
    with np.errstate(divide="ignore"):
        t_wall = np.min(np.maximum((COLMAP_ROOM - o) / d, (-COLMAP_ROOM - o) / d), axis=-1)
    p = o + d * t_wall[..., None]
    wall = np.stack([0.55 + 0.3 * np.sin(1.9 * p[..., 0] + 2.3 * k) * np.cos(1.3 * p[..., 1] - k)
                     * np.cos(1.7 * p[..., 2] + 0.5 * k) for k in range(3)], -1)
    img = render_sphere_image(pose.astype(np.float32), np.asarray(intr, np.float32), H, W)
    rgb = np.where(obj[..., None], img[..., :3], wall)
    return np.clip(rgb, 0.0, 1.0), np.where(obj, t_obj, t_wall), obj


def write_colmap_scene(root: Path, hw=None, n_views=None, n_points=None) -> dict:
    """A COLMAP workspace of a capture under root: the analytic sphere in a
    cube room (room_view), 24 views orbiting it, in a world moved by a
    similarity.  sparse/0 holds the binary model: a PINHOLE camera, the
    views in a shuffled id order, points (three quarters on the sphere,
    10% of all moved off it, a quarter on the walls) with tracks into the
    views that see them (the sphere's facing side, the walls where the
    sphere does not hide them), 0.3 px noise on the 2-D positions, errors
    in [0.2, 1.5], 10% untracked keypoints; images/*.jpg (write_jpeg) and
    depths/*.npy (0.4 z + 0.7 of the true z-depth).  Returns the truth in
    COLMAP's world: OpenGL cam2world poses, names, points, errors, each
    view's keypoints, the z-depth maps, the sphere's centre and radius."""
    import numpy as np

    from mirres_restir_nerf_mesh_torch.data.synthetic import orbit_pose

    rng = np.random.RandomState(0)
    H, W = hw or COLMAP_HW
    n_views, n_points = n_views or COLMAP_VIEWS, n_points or COLMAP_POINTS
    intr = np.array(COLMAP_PINHOLE, np.float64) * (W / 320)
    R0 = _axis_angle(*COLMAP_WORLD_AXIS_ANGLE)
    s0, t0 = COLMAP_WORLD_SCALE, np.asarray(COLMAP_WORLD_SHIFT)
    n_wall = n_points // 4
    n_obj = n_points - n_wall
    n_out = int(round(COLMAP_OUTLIER_SHARE * n_points))
    nrm = rng.normal(size=(n_obj, 3))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    k = np.ones(n_obj)
    k[:n_out] = rng.uniform(1.5, 3.0, n_out)
    face = rng.randint(0, 6, n_wall)
    wall = rng.uniform(-COLMAP_ROOM, COLMAP_ROOM, (n_wall, 3))
    wall[np.arange(n_wall), face // 2] = np.where(face % 2, COLMAP_ROOM, -COLMAP_ROOM)
    pts_scene = np.concatenate([nrm * 0.5 * k[:, None], wall])
    on_sphere = np.concatenate([k == 1, np.zeros(n_wall, bool)])
    nrm = np.concatenate([nrm, np.zeros((n_wall, 3))])
    pts = pts_scene @ (s0 * R0).T + t0
    errs = rng.uniform(*COLMAP_ERR, n_points)
    pids = 7 + 3 * np.arange(n_points)
    (root / "images").mkdir(parents=True, exist_ok=True)
    (root / "depths").mkdir(parents=True, exist_ok=True)
    order = rng.permutation(n_views)
    truth = dict(poses=[], names=[], xy=[], pid=[], zdepth=[], intr=intr, pts=pts, errs=errs,
                 pids=pids, center=t0, radius=0.5 * s0, hw=(H, W))
    images, tracks = [], np.zeros(n_points, np.int64)
    for v in range(n_views):
        theta = np.pi / 3 + (np.pi / 3) * (v % 4) / 4 + rng.uniform(-0.05, 0.05)
        phi = 2 * np.pi * v / n_views + rng.uniform(-0.05, 0.05)
        pose = orbit_pose(theta, phi, 2.0).astype(np.float64)
        name = f"frame_{v:03d}.jpg"
        rgb, z, _ = room_view(pose, intr, H, W)
        write_jpeg(root / "images" / name, np.round(rgb * 255).astype(np.uint8),
                   COLMAP_JPEG_QUALITY)
        a, b = COLMAP_DEPTH_AFFINE
        np.save(root / "depths" / f"frame_{v:03d}.npy", (a * z * s0 + b).astype(np.float32))
        c2w = np.eye(4)
        c2w[:3, :3] = R0 @ pose[:3, :3]
        c2w[:3, 3] = s0 * R0 @ pose[:3, 3] + t0
        cv = c2w.copy()
        cv[:3, 1:3] *= -1
        w2c = np.linalg.inv(cv)
        cam = pts @ w2c[:3, :3].T + w2c[:3, 3]
        uv = np.stack([intr[0] * cam[:, 0] / cam[:, 2] + intr[2],
                       intr[1] * cam[:, 1] / cam[:, 2] + intr[3]], -1)
        # the camera-to-point segment through the sphere (wall points it hides)
        c = pose[:3, 3]
        seg = pts_scene - c
        sa, sb = np.sum(seg * seg, -1), seg @ c
        sd = sb * sb - sa * (c @ c - 0.25)
        t_in = (-sb - np.sqrt(np.maximum(sd, 0.0))) / sa
        hidden = (sd > 0) & (t_in > 0) & (t_in < 1 - 1e-9)
        facing = np.sum(nrm * (c - pts_scene), -1) > 0
        outlier = np.arange(n_points) < n_out
        seen = ((cam[:, 2] > 0) & np.where(on_sphere, facing, ~hidden | outlier)
                & (uv[:, 0] >= 0) & (uv[:, 0] < W) & (uv[:, 1] >= 0) & (uv[:, 1] < H))
        xy = uv[seen] + rng.normal(0, COLMAP_NOISE_PX, (int(seen.sum()), 2))
        pid = pids[seen]
        tracks += seen
        n_un = int(round(COLMAP_UNTRACKED_SHARE * len(pid)))
        xy = np.concatenate([xy, rng.uniform(0, 1, (n_un, 2)) * [W, H]])
        pid = np.concatenate([pid, np.full(n_un, -1)])
        images.append((int(order[v]) + 1, rotmat2qvec(w2c[:3, :3]), w2c[:3, 3], name, xy, pid))
        truth["poses"].append(c2w)
        truth["names"].append(name)
        truth["xy"].append(xy)
        truth["pid"].append(pid)
        truth["zdepth"].append(z * s0)
    write_colmap_model(root / "sparse" / "0", W, H, intr, images,
                       (pids, pts, errs, tracks))
    truth["poses"] = np.stack(truth["poses"])
    return truth


def check_colmap_load(fd, truth, split="train", dense_tol=None):
    """load_colmap's output against the written scene: poses under the
    loader's own centre (the sparse points' mean) and scale (0.75 bound
    over the 90th-percentile camera distance), the sparse tables against
    the written tracks' projections, the aligned dense depth against the
    true z-depth (median relative error within dense_tol, default
    COLMAP_MAX_DENSE_REL_ERR: the keypoints land on whole pixels, so it
    grows with the pixel's size).  Returns the readings; raises on a
    failed gate."""
    import numpy as np

    keep = [i for i in range(len(truth["names"]))
            if (i % COLMAP_TEST_EVERY != 0) == (split == "train")]
    pts32 = truth["pts"].astype(np.float32)
    center = pts32.mean(axis=0).astype(np.float64)
    c = truth["poses"][keep, :3, 3] - center
    scale = 0.75 * COLMAP_BOUND / np.percentile(np.linalg.norm(c, axis=1), 90)
    pose_err = max(float(np.abs(fd.poses[:, :3, :3] - truth["poses"][keep, :3, :3]).max()),
                   float(np.abs(fd.poses[:, :3, 3] - c * scale).max()))
    H, W = truth["hw"]
    err32 = truth["errs"].astype(np.float32)
    mean_err = float(np.mean(err32))
    row = {int(p): j for j, p in enumerate(truth["pids"])}
    coord_bad, depth_rel, weight_rel = 0, 0.0, 0.0
    dense_rel = []
    for j, i in enumerate(keep):
        xy, pid = truth["xy"][i], truth["pid"][i]
        tr = pid >= 0
        rc = np.round(xy[tr][:, ::-1]).astype(np.int64)
        rc[:, 0] = rc[:, 0].clip(0, H - 1)
        rc[:, 1] = rc[:, 1].clip(0, W - 1)
        rows = np.array([row[int(p)] for p in pid[tr]], np.int64)
        c2w = truth["poses"][i]
        z = ((c2w[:3, 3] - truth["pts"][rows]) @ c2w[:3, 2]) * scale
        w = 2.0 * np.exp(-((err32[rows] / mean_err) ** 2))
        m = int(tr.sum())
        if fd.sparse_weight is not None:
            got_w = fd.sparse_weight[j]
            coord_bad += int((fd.sparse_coords[j, :m] != rc).any(axis=1).sum()
                             + (got_w[m:] != 0).sum())
            depth_rel = max(depth_rel, float(np.abs(fd.sparse_depth[j, :m] / z - 1).max()))
            weight_rel = max(weight_rel, float(np.abs(got_w[:m] / w - 1).max()))
        if fd.depths is not None and fd.sparse_weight is not None:      # aligned
            zt = truth["zdepth"][i]
            hit = np.isfinite(zt)
            dense_rel.append(np.abs(fd.depths[j][hit] / (zt[hit] * scale) - 1))
    res = dict(views=len(keep), center=center.tolist(), scale=float(scale),
               pose_max_abs_err=pose_err, sparse_coords_differing=coord_bad,
               sparse_depth_max_rel_err=depth_rel, sparse_weight_max_rel_err=weight_rel,
               sparse_points=int(0 if fd.sparse_weight is None else (fd.sparse_weight > 0).sum()))
    fails = []
    if pose_err > COLMAP_POSE_ATOL:
        fails.append(f"poses {pose_err}")
    if split != "test":
        if coord_bad or depth_rel > 1e-5 or weight_rel > 1e-5:
            fails.append(f"sparse tables: {coord_bad} coordinates differ, depth {depth_rel}, "
                         f"weight {weight_rel}")
        nf = fd.cam_near_far
        sd = np.where(fd.sparse_weight > 0, fd.sparse_depth, np.nan)
        if not np.allclose(nf, np.stack([np.nanmin(sd, 1), np.nanmax(sd, 1)], -1)):
            fails.append("cam_near_far is not the views' depth range")
    if dense_rel:
        res["dense_median_rel_err"] = float(np.median(np.concatenate(dense_rel)))
        if not res["dense_median_rel_err"] <= (dense_tol or COLMAP_MAX_DENSE_REL_ERR):
            fails.append(f"aligned dense depth: median relative error "
                         f"{res['dense_median_rel_err']}")
    if fails:
        raise AssertionError(f"load_colmap ({split}): {fails}")
    res["scene_radius"] = truth["radius"] * scale
    res["scene_center"] = ((truth["center"] - center) * scale).tolist()
    return res


def time_loaders(base: Path) -> dict:
    """The COLMAP readers and load_colmap(with_images=False) at a real
    model's size (LOADER_REAL: views, points, tracked keypoints a view,
    track length), host seconds."""
    import numpy as np

    from mirres_restir_nerf_mesh_torch.data import colmap

    L = LOADER_REAL
    rng = np.random.RandomState(1)
    n, P, K = L["images"], L["points"], L["keypoints"]
    W, H = COLMAP_HW[1] * 3, COLMAP_HW[0] * 3
    images = []
    for v in range(n):
        theta, phi = np.pi / 2 + rng.uniform(-0.3, 0.3), 2 * np.pi * v / n
        c = 5.0 * np.array([np.sin(theta) * np.sin(phi), np.cos(theta),
                            np.sin(theta) * np.cos(phi)])
        f = -c / np.linalg.norm(c)
        r = np.cross(f, [0, 1, 0])
        r /= np.linalg.norm(r)
        R = np.stack([r, np.cross(f, r), f])            # OpenCV rows: right, down, forward
        xy = rng.uniform(0, 1, (K, 2)) * [W, H]
        images.append((v + 1, rotmat2qvec(R), -R @ c, f"img_{v:04d}.jpg", xy,
                       rng.randint(0, P, K).astype(np.int64)))
    pts = rng.normal(size=(P, 3))
    t0 = time.perf_counter()
    write_colmap_model(base / "sparse" / "0", W, H, COLMAP_PINHOLE, images,
                       (np.arange(P), pts, rng.uniform(0.2, 1.5, P), np.full(P, L["track"])))
    res = {"write_s": time.perf_counter() - t0, **L}
    sp = str(base / "sparse" / "0")
    for name, fn in (("read_images_binary_s",
                      lambda: colmap.read_images_binary(sp + "/images.bin")),
                     ("read_points3d_binary_s",
                      lambda: colmap.read_points3d_binary(sp + "/points3D.bin")),
                     ("load_colmap_s", lambda: colmap.load_colmap(str(base), "train",
                                                                  with_images=False))):
        t0 = time.perf_counter()
        out = fn()
        res[name] = time.perf_counter() - t0
    res["sparse_points_loaded"] = int((out.sparse_weight > 0).sum())
    return res


def time_read_jpeg(base: Path) -> dict:
    """read_jpeg on JPEG_TIMED_HW frames of the room scene (write_jpeg at
    4:2:0): as rendered (smooth, few coefficients a block) and with
    Gaussian noise of 8 counts (about a photograph's bit rate); host seconds a
    megapixel (median of 3) and bits a pixel of each, and the smooth
    frame's decode held to its source within the encoder's loss."""
    import numpy as np

    from mirres_restir_nerf_mesh_torch.data.synthetic import orbit_pose
    from mirres_restir_nerf_mesh_torch.utils.image_io import read_jpeg

    H, W = JPEG_TIMED_HW
    intr = np.array([0.9 * W, 0.9 * W, W / 2, H / 2])
    img, _, _ = room_view(orbit_pose(1.1, 0.4, 2.0).astype(np.float64), intr, H, W)
    rng = np.random.RandomState(2)
    res = {"hw": [H, W]}
    for name, sigma in (("room", 0.0), ("room with noise of 8 counts", 8.0)):
        rgb = np.clip(np.round(img * 255 + rng.normal(0, sigma, img.shape)), 0, 255).astype(
            np.uint8)
        path = base / "timed.jpg"
        write_jpeg(path, rgb, COLMAP_JPEG_QUALITY)
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            got = read_jpeg(str(path))
            times.append(time.perf_counter() - t0)
        res[name] = {"bits_per_pixel": 8 * path.stat().st_size / (H * W),
                     "s": statistics.median(times),
                     "s_per_MP": statistics.median(times) / (H * W / 1e6),
                     "mean_abs_err_counts": float(np.abs(got.astype(np.int64) - rgb).mean())}
        if got.shape != rgb.shape or (sigma == 0 and not res[name]["mean_abs_err_counts"] < 2.0):
            raise AssertionError(f"read_jpeg of the timed frame: {res}")
    return res


def write_png16(path, rgb16) -> None:
    """uint16 [H, W, 3] -> a 16-bit RGB PNG, filter type 0 (zlib)."""
    import struct
    import zlib

    import numpy as np

    H, W, C = rgb16.shape
    rows = np.concatenate([np.zeros((H, 1), np.uint8),
                           rgb16.astype(">u2").view(np.uint8).reshape(H, W * C * 2)], axis=1)

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    Path(path).write_bytes(b"\x89PNG\r\n\x1a\n"
                           + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 16, 2, 0, 0, 0))
                           + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
                           + chunk(b"IEND", b""))


def check_frame_formats(base: Path) -> dict:
    """Frames that PIL reads and the port's readers take since slice 11:
    the progressive-JPEG fixture through read_jpeg (host s a megapixel,
    median of 3; its pixels' sha256 equal to PIL's, from the .json beside
    it) and _load_image (those pixels / 255); a 16-bit RGB PNG of the room
    written here through _load_image, equal to its samples' high byte / 255
    (PIL's RGB mode)."""
    import hashlib

    import numpy as np

    from mirres_restir_nerf_mesh_torch.data.provider import _load_image
    from mirres_restir_nerf_mesh_torch.data.synthetic import orbit_pose
    from mirres_restir_nerf_mesh_torch.utils.image_io import read_jpeg

    meta = json.loads(PROGRESSIVE_FIXTURE.with_suffix(".json").read_text())
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        pix = read_jpeg(str(PROGRESSIVE_FIXTURE))
        times.append(time.perf_counter() - t0)
    H, W = pix.shape[:2]
    res = {"progressive_jpeg": {
        "hw": [H, W], "bits_per_pixel": 8 * PROGRESSIVE_FIXTURE.stat().st_size / (H * W),
        "s": statistics.median(times), "s_per_MP": statistics.median(times) / (H * W / 1e6),
        "pixels_equal_pil": hashlib.sha256(np.ascontiguousarray(pix).tobytes()).hexdigest()
        == meta["sha256_of_pil_pixels"],
        "load_image_equal": bool(np.array_equal(_load_image(str(PROGRESSIVE_FIXTURE)),
                                                pix.astype(np.float32) / 255.0))}}
    Hp, Wp = COLMAP_HW
    intr = np.array([0.9 * Wp, 0.9 * Wp, Wp / 2, Hp / 2])
    img, _, _ = room_view(orbit_pose(1.1, 0.4, 2.0).astype(np.float64), intr, Hp, Wp)
    rgb16 = np.round(np.clip(img, 0.0, 1.0) * 65535).astype(np.uint16)
    path = base / "frame16.png"
    write_png16(path, rgb16)
    res["png16_rgb"] = {"hw": [Hp, Wp], "load_image_equal": bool(np.array_equal(
        _load_image(str(path)), (rgb16 >> 8).astype(np.float32) / 255.0))}
    if not (res["progressive_jpeg"]["pixels_equal_pil"] and res["progressive_jpeg"][
            "load_image_equal"] and res["png16_rgb"]["load_image_equal"]):
        raise AssertionError(f"4i frame formats: {res}")
    return res


def check_dpt(dev, images) -> dict:
    """The port's DPT (random_params at full width) on DPT_FRAMES frames,
    resized to 384^2 as extract_depth does: the card against the port on
    the CPU with TF32 off (atol DPT_ATOL of the CPU map's max), then ms a
    frame on the card in fp32 with TF32 off, and at PyTorch's default (TF32
    convolutions, which extract_depth runs with) (CUDA events, median of 5
    batches of one frame)."""
    import torch
    import torch.nn.functional as F

    from mirres_restir_nerf_mesh_torch.depth import dpt

    t0 = time.perf_counter()
    sd, _ = dpt.random_params(0)
    params_s = time.perf_counter() - t0
    x = torch.as_tensor(images[:DPT_FRAMES]).permute(0, 3, 1, 2).float()
    x = (F.interpolate(x, size=(384, 384), mode="bilinear", align_corners=False) - 0.5) / 0.5
    cpu = dpt.build_dpt(sd, "cpu")
    t0 = time.perf_counter()
    ref = dpt.dpt_depth(cpu, x)
    cpu_s = time.perf_counter() - t0
    del cpu
    card = dpt.build_dpt(sd, dev)
    xd = x.to(dev)
    got = dpt.dpt_depth(card, xd).cpu()
    scale = max(float(ref.abs().max()), 1e-3)
    err = float((got - ref).abs().max()) / scale
    res = {"frames": DPT_FRAMES, "random_params_s": params_s, "cpu_s_per_frame": cpu_s / DPT_FRAMES,
           "max_abs_err_of_max": err, "map_max": scale, "finite": bool(torch.isfinite(got).all())}
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    try:
        for name, mm, conv in (("fp32 (TF32 off)", False, False),
                               ("PyTorch's default: TF32 convolutions, fp32 matmuls", False, True)):
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = mm, conv
            res[f"ms_per_frame {name}"] = cuda_ms(lambda: dpt.dpt_depth(card, xd[:1]), 5)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    if not (res["finite"] and err <= DPT_ATOL):
        raise AssertionError(f"DPT card vs CPU: {res}")
    return res


def check_dtu(base: Path) -> dict:
    """A DTU scene of the sphere (cameras_sphere.npz with world_mat_i = K [R|t]
    in a world shifted by (0.3, 0.1, -0.4), scale_mat_i mapping the scene to
    it; PNG image/ and mask/) through load_dtu: the intrinsics and each
    train view's pose (the scene's own) within 1e-4.  The scale_mat keeps
    scale 1: decompose_projection, the reference's as the port's, drops
    the scale of P from the camera centre (ROADMAP Queue C)."""
    import numpy as np

    from mirres_restir_nerf_mesh_torch.data.dtu import load_dtu
    from mirres_restir_nerf_mesh_torch.data.synthetic import orbit_pose, render_sphere_image
    from mirres_restir_nerf_mesh_torch.utils.image_io import write_png

    H, W = DTU_HW
    K = np.array([[150.0, 0, 81.5], [0, 148.0, 58.5], [0, 0, 1]])
    s, t = 1.0, np.array([0.3, 0.1, -0.4])
    scale_mat = np.eye(4)
    scale_mat[:3, :3] *= s
    scale_mat[:3, 3] = t
    (base / "image").mkdir(parents=True)
    (base / "mask").mkdir()
    cams, poses = {}, []
    for i in range(DTU_VIEWS):
        pose = orbit_pose(1.2, 2 * np.pi * i / DTU_VIEWS, 2.0).astype(np.float64)
        img = render_sphere_image(pose.astype(np.float32),
                                  np.array([K[0, 0], K[1, 1], K[0, 2], K[1, 2]], np.float32), H, W)
        write_png(str(base / "image" / f"{i:03d}.png"),
                  np.round(img[..., :3] * 255).astype(np.uint8))
        write_png(str(base / "mask" / f"{i:03d}.png"), np.round(img[..., 3] * 255).astype(np.uint8))
        cv = pose.copy()
        cv[:3, 1:3] *= -1
        cv[:3, 3] = s * cv[:3, 3] + t                       # the camera in the world
        w2c = np.linalg.inv(cv)
        cams[f"world_mat_{i}"] = np.vstack([K @ w2c[:3], [0, 0, 0, 1]])
        cams[f"scale_mat_{i}"] = scale_mat
        poses.append(pose)
    np.savez(base / "cameras_sphere.npz", **cams)
    t0 = time.perf_counter()
    fd = load_dtu(str(base), "train", bound=1.0, test_every=COLMAP_TEST_EVERY)
    keep = [i for i in range(DTU_VIEWS) if i % COLMAP_TEST_EVERY != 0]
    res = {"views": fd.num_frames, "s": time.perf_counter() - t0,
           "pose_max_abs_err": float(np.abs(fd.poses - np.stack(poses)[keep]).max()),
           "intrinsics": fd.intrinsics.tolist(), "images": list(fd.images.shape)}
    if not (res["pose_max_abs_err"] <= 1e-4 and fd.images.shape == (len(keep), H, W, 4)
            and np.allclose(fd.intrinsics, [K[0, 0], K[1, 1], K[0, 2], K[1, 2]], atol=1e-4)):
        raise AssertionError(f"load_dtu: {res}")
    return res


def colmap_run(dev, counts, out_dir, keep=None):
    """Phase 4i: the repo's "your dataset" recipe on a COLMAP workspace of
    the analytic sphere (write_colmap_scene), the counters zeroed just
    before each run of ``mirres_restir_nerf_mesh_torch.main.main`` and read
    just after:

    1. load_colmap against the written scene (check_colmap_load: poses,
       sparse tables, cam_near_far, the aligned dense depth), the loaders
       at a real size, read_jpeg a megapixel, the port's DPT on the card
       against the CPU, and a DTU scene through load_dtu;
    2. stage 0: ``-O --data_format colmap --bound 2 --stage 0``, 500
       iterations, marching grid 64; gates: val PSNR above 15, a mesh of
       median vertex radius within 20% of the sphere's radius in the
       normalized scene (about its normalized centre), 2 K4 launches a
       step, one closest hit a training view in save_mesh, the sampler's
       sparse-depth branch in 5-15% of the steps;
    3. stage 1: ``--use_brdf --use_restir``, 10 iterations, 1024^2
       textures; gates: loss finite, uncertain_count 0, 3 K4 launches a
       step and the tracer's launches of every frame for the mesh's route;
    4. ``--test``: every test frame's artifacts written and every EXR
       finite, the tracer's launches, no K4.

    With ``keep`` (a list) the scene stays for phase 4k: keep gets {"tmp",
    "images"}, and the caller cleans up."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from mirres_restir_nerf_mesh_torch.data import provider
    from mirres_restir_nerf_mesh_torch.data.colmap import load_colmap
    from mirres_restir_nerf_mesh_torch.export.meshio import read_ply
    from mirres_restir_nerf_mesh_torch.utils.exr import read_exr

    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_colmap_")
    base = Path(tmp.name)
    root, ws = base / "scene", base / "ws"
    res, sparse_draws = {}, []
    orig_draw = provider.RayDataset.draw

    def draw(self, *a, **k):
        d = orig_draw(self, *a, **k)
        if d.use_sparse is not None:
            sparse_draws.append(d.use_sparse)
        return d

    harness, kept = None, None
    try:
        t0 = time.perf_counter()
        truth = write_colmap_scene(root)
        res["scene"] = {"views": len(truth["names"]), "points": len(truth["pts"]),
                        "hw": list(COLMAP_HW), "write_s": time.perf_counter() - t0,
                        "jpeg_bytes": sum(p.stat().st_size for p in (root / "images").iterdir())}
        t0 = time.perf_counter()
        fd = load_colmap(str(root), "train", bound=COLMAP_BOUND)
        res["load_train"] = {"s": time.perf_counter() - t0, **check_colmap_load(fd, truth)}
        res["load_test"] = check_colmap_load(load_colmap(str(root), "test", bound=COLMAP_BOUND),
                                             truth, "test")
        log("colmap loader: " + json.dumps({k: res[k] for k in ("scene", "load_train",
                                                                 "load_test")}))
        res["loaders_real_size"] = time_loaders(base / "real")
        log("colmap readers at a real size: " + json.dumps(res["loaders_real_size"]))
        res["read_jpeg"] = time_read_jpeg(base)
        log("read_jpeg: " + json.dumps(res["read_jpeg"]))
        res["frame_formats"] = check_frame_formats(base)
        log(f"read_jpeg: {res['frame_formats']['progressive_jpeg']['s_per_MP']:.3f} s a "
            f"megapixel progressive, {res['read_jpeg']['room with noise of 8 counts']['s_per_MP']:.3f}"
            f" baseline (photo-like); frame formats: {json.dumps(res['frame_formats'])}")
        res["dpt"] = check_dpt(dev, fd.images)
        log("DPT: " + json.dumps(res["dpt"]))
        res["dtu"] = check_dtu(base / "dtu")
        log("load_dtu: " + json.dumps(res["dtu"]))
        del fd
        torch.cuda.empty_cache()

        common = [str(root), "--workspace", str(ws), "-O", "--data_format", "colmap",
                  "--bound", str(COLMAP_BOUND)]
        argv = {
            "stage0": common + ["--stage", "0", "--iters", str(COLMAP_STAGE0_ITERS),
                                "--mcubes_reso", str(COLMAP_MCUBES_RESO), "--n_eval", "1",
                                "--n_ckpt", "1"],
            "stage1": common + ["--stage", "1", "--use_brdf", "--use_restir", "--iters",
                                str(COLMAP_STAGE1_ITERS), "--texture_size", str(COLMAP_TEXTURE),
                                "--n_eval", "1", "--n_ckpt", "1"],
            "test": common + ["--stage", "1", "--test", "--use_brdf", "--use_restir",
                              "--eval_spp", "0", "--relight_spp", "0", "--texture_size",
                              str(COLMAP_TEXTURE)],
        }
        n_views = len(truth["names"])
        n_eval = len(range(0, n_views, COLMAP_TEST_EVERY))        # val and test views
        n_train = n_views - n_eval
        harness = CliHarness(counts)
        provider.RayDataset.draw = draw

        # ---- stage 0
        r0, tr0, metrics = harness.run(argv["stage0"], ws, dev)
        verts, tris = read_ply(str(ws / "mesh_0.ply"))
        c = np.asarray(res["load_train"]["scene_center"])
        radius = res["load_train"]["scene_radius"]
        logs = [m for m in metrics if "it_per_s" in m]
        val = [m for m in metrics if "val_psnr" in m]
        n_sparse = int(torch.stack(sparse_draws).sum()) if sparse_draws else 0
        r0.update(faces=int(tris.shape[0]), median_vertex_radius=float(
            np.median(np.linalg.norm(verts - c, axis=1))) if len(verts) else 0.0,
            scene_radius=radius, it_per_s=logs[-1]["it_per_s"], loss_last=logs[-1]["loss"],
            num_rays_last=tr0.cfg.num_rays, val_psnr=val[-1]["val_psnr"] if val else None,
            scene_aabb=list(tr0.cfg.scene_aabb or []), sparse_steps=n_sparse,
            sparse_share=n_sparse / max(len(sparse_draws), 1), draws=len(sparse_draws))
        la = r0["launches"]
        r0["culling_route"] = "tile (K1)" if la["queue_trace"] else "dense (K3)"
        res["stage0"] = r0
        log("colmap stage 0: " + json.dumps(r0))
        fails = []
        if not (r0["val_psnr"] or 0.0) > CLI_MIN_VAL_PSNR:
            fails.append(f"val PSNR {r0['val_psnr']}")
        if (tris.shape[0] == 0
                or not abs(r0["median_vertex_radius"] / radius - 1) <= COLMAP_RADIUS_TOL):
            fails.append(f"mesh: {tris.shape[0]} faces, median radius "
                         f"{r0['median_vertex_radius']} (sphere {radius})")
        if la["scatter_add"] != K4_STAGE0_LAUNCHES * COLMAP_STAGE0_ITERS:
            fails.append(f"{la['scatter_add']} K4 launches in {COLMAP_STAGE0_ITERS} steps")
        # at bound 2 save_mesh culls two cascades (mesh_0, mesh_1), each one
        # closest hit a training view
        n_meshes = len(list(ws.glob("mesh_*.ply")))
        r0["meshes"] = n_meshes
        if (la["queue_trace"] + la["dense_hit"] != n_train * n_meshes or la["dense_occluded"]
                or la["grid_trace"]):
            fails.append(f"save_mesh launches {la}, one closest hit a view ({n_train}) and "
                         f"mesh ({n_meshes})")
        if (len(sparse_draws) != COLMAP_STAGE0_ITERS
                or not COLMAP_SPARSE_SHARE[0] <= r0["sparse_share"] <= COLMAP_SPARSE_SHARE[1]):
            fails.append(f"sparse-depth branch in {n_sparse} of {len(sparse_draws)} draws")
        if fails:
            raise AssertionError(f"colmap stage 0 failed: {fails}")

        dense = takes_dense_route(verts, tris, dev)
        route = "dense (K3)" if dense else "tile (K1)"

        # ---- stage 1
        r1, tr1, metrics = harness.run(argv["stage1"], ws, dev)
        last = [m for m in metrics if "it_per_s" in m][-1]
        r1.update(route=route, faces=int(tr1.tris.shape[0]), loss_last=last["loss"],
                  psnr_last=last.get("psnr"), uncertain_count=last.get("uncertain_count"),
                  it_per_s=last["it_per_s"], val=[m for m in metrics if "val_psnr_brdf" in m][-1:])
        res["stage1"] = r1
        log("colmap stage 1: " + json.dumps(r1))
        la = r1["launches"]
        frames1 = COLMAP_STAGE1_ITERS + 2 * n_eval
        fails = []
        if not np.isfinite(r1["loss_last"]):
            fails.append(f"loss {r1['loss_last']}")
        if r1["uncertain_count"] != 0:
            fails.append(f"uncertain_count {r1['uncertain_count']}")
        if la["scatter_add"] != K4_STEP_LAUNCHES * COLMAP_STAGE1_ITERS:
            fails.append(f"{la['scatter_add']} K4 launches in {COLMAP_STAGE1_ITERS} steps")
        if not restir_frame_launches(la, frames1, dense, CLI_SPP) or la["grid_trace"]:
            fails.append(f"tracer launches {la} for {frames1} frames on the {route} route")
        for f in ("mesh_0.obj", "feat0_0.png", "feat1_0.png"):
            if not (ws / f).exists():
                fails.append(f"{f} missing")
        if fails:
            raise AssertionError(f"colmap stage 1 failed: {fails}")

        # ---- the test renders
        rt, _, _ = harness.run(argv["test"], ws, dev)
        results = ws / "results"
        want = {f"ngp_{i:04d}_{a}" for i in range(n_eval) for a in CLI_ARTIFACTS}
        got = {p.name for p in results.iterdir()}
        exr_finite = {p.name: bool(np.isfinite(read_exr(str(p))).all())
                      for p in sorted(results.glob("*.exr"))}
        rt.update(route=route, artifacts_missing=sorted(want - got),
                  exr_finite=all(exr_finite.values()))
        res["test"] = rt
        log("colmap test: " + json.dumps(rt))
        la = rt["launches"]
        if (want - got or not rt["exr_finite"] or la["scatter_add"] or la["grid_trace"]
                or not restir_frame_launches(la, 2 * n_eval, dense, CLI_SPP)):
            raise AssertionError(f"colmap test failed: missing {sorted(want - got)}, EXRs "
                                 f"finite {exr_finite}, launches {la} for {2 * n_eval} frames")
        if out_dir is not None:
            for f in ("log_ngp.txt", "metrics_ngp.jsonl"):
                shutil.copy(ws / f, Path(out_dir) / f"colmap_{f}")
        if keep is not None:
            kept = dict(tmp=tmp, images=root / "images")
        return res
    finally:
        provider.RayDataset.draw = orig_draw
        if harness is not None:
            harness.close()
        if kept is None:
            tmp.cleanup()
        else:
            keep.append(kept)


# phase 4j: data parallelism on the card.  Two gloo ranks share the one
# card (NCCL refuses two ranks on one device): they measure correctness and
# the DP machinery's overhead, not scaling.
DP_RANKS = 2
DP_STAGE0_STEPS = 16                  # the fp32 gate's steps; also the bf16 timing group
DP_STAGE1_STEPS = 3
DP_STAGE0_TOL = (2e-4, 2e-5)          # tests/test_dp_trainer.py's rtol / atol
DP_STAGE1_TOL = (5e-4, 5e-5)          # tests/test_dp_stage1.py's
DP_LOSS_RTOL = 1e-5                   # the stage-1 first step's loss
DP_CLI_ITERS = 300                    # (c): a short stage 0 under torchrun
DP_TIMEOUT_S = 600
# 4j (b)'s readings: gradient entries apart by more than this (relative),
# a ReSTIR pick whose direction moved by more than this is another pick,
# the render outputs compared, the light group's pre-scale and Adam eps
# (train/stage1.py)
DP_GRAD_RTOL = 1e-6
DP_PICK_ATOL = 1e-3
DP_READ_KEYS = ("mask", "depth", "normal", "xyzs", "kd", "ks", "diffuse_light", "specular_light",
                "img_brdf_indirect", "image", "image_brdf")
LIGHT_PRE_SCALE, LIGHT_EPS = 64.0, 1e-8


def dp_collectives(dp) -> dict:
    """Each collective of parallel/mesh.py on this rank's CUDA tensors,
    against values computed here (uneven shards of 7 rows): gather_rows
    forward and gradient, all_reduce_sum's gradient, replicate,
    all_reduce_grads (a None gradient as zeros), all_reduce_scalars,
    all_gather_rows of bools, same_on_all_ranks, barrier."""
    import torch

    from mirres_restir_nerf_mesh_torch.parallel import mesh as pmesh

    dev, R = dp.device, dp.world
    n = 7
    x = (torch.arange(n * 3, dtype=torch.float32, device=dev).reshape(n, 3) - 9.0) * 0.25
    w = torch.cos(torch.arange(n * 3, dtype=torch.float32, device=dev)).reshape(n, 3)
    sh = pmesh.shard_of(n, dp)
    xl = x[sh.lo:sh.hi].clone().requires_grad_(True)
    full = pmesh.gather_rows(xl, dp, sh.counts)
    loss = (full * w).pow(2).sum() + pmesh.all_reduce_sum((xl ** 3).sum(), dp)
    (g,) = torch.autograd.grad(loss / R, xl)
    want = (2 * x * w ** 2 + 3 * x ** 2)[sh.lo:sh.hi]
    rep = pmesh.replicate([torch.full((2,), float(dp.rank), device=dev),
                           torch.tensor(dp.rank + 1, dtype=torch.int32)], dp)
    summed = pmesh.all_reduce_grads([None, torch.ones(3, device=dev) * dp.rank],
                                    [torch.zeros(2, device=dev), torch.zeros(3, device=dev)], dp)
    sc = pmesh.all_reduce_scalars({"a": dp.rank + 1.0}, dp)
    bools = pmesh.all_gather_rows((x[sh.lo:sh.hi, 0] > 0), dp, sh.counts)
    checks = {
        "gather_rows forward": bool(torch.equal(full.detach(), x)),
        "gather_rows / all_reduce_sum gradient": bool(torch.allclose(g, want, rtol=1e-5,
                                                                     atol=1e-5)),
        "replicate": bool((rep[0] == 0).all()) and int(rep[1]) == 1 and rep[0].device == dev,
        "all_reduce_grads": bool((summed[0] == 0).all())
        and bool((summed[1] == sum(range(R))).all()) and summed[1].device == dev,
        "all_reduce_scalars": float(sc["a"]) == R * (R + 1) / 2,
        "all_gather_rows (bool)": bool(torch.equal(bools, x[:, 0] > 0)),
        "same_on_all_ranks": pmesh.same_on_all_ranks([x, rep[0]], dp),
    }
    pmesh.barrier(dp)
    if not all(checks.values()):
        raise AssertionError(f"rank {dp.rank}: collectives on CUDA tensors: {checks}")
    return checks


def dp_stage0(dp, dev, seed, dtype, groups, counts, hold: bool = False) -> tuple:
    """bench.py's stage-0 point (4f's config) from seed: init, one occupancy
    update, then ``groups`` groups of DP_STAGE0_STEPS steps (one sync a
    group), sharded over dp's ranks (dp None: the one-card step), the
    counters zeroed before and read after.  ``hold``: before each step rank
    0 takes the one-card step from the same state with the same draws and
    each step's params and num_points are held to it (dp_stage1 says why:
    K4's atomics alone part two one-card runs after a few steps).
    -> (state, readings)."""
    import torch

    from mirres_restir_nerf_mesh_torch.data.provider import RayDataset
    from mirres_restir_nerf_mesh_torch.data.synthetic import make_synthetic_frames
    from mirres_restir_nerf_mesh_torch.models.nerf import NeRFSpec
    from mirres_restir_nerf_mesh_torch.parallel import mesh as pmesh
    from mirres_restir_nerf_mesh_torch.train import stage0 as s0

    zero_counts, read_counts = counts
    cfg = stage0_bench_config()
    sampler = RayDataset(make_synthetic_frames(n_frames=8, H=256, W=256, bound=cfg.bound),
                         bound=cfg.bound, device=dev)
    spec = NeRFSpec(bound=cfg.bound, compute_dtype=dtype)
    gen = torch.Generator(device=dev).manual_seed(seed)
    state = s0.init_state(gen, cfg, spec, device=dev)
    state = s0.make_occ_update(cfg, spec)(state, gen)
    step_fn = s0.make_train_step(cfg, spec, sampler, dp=dp)
    step_one = s0.make_train_step(cfg, spec, sampler) if hold else None
    torch.cuda.synchronize()
    zero_counts()
    pmesh.all_reduce.bytes = pmesh.all_gather_rows.bytes = 0
    pmesh.all_reduce.seconds = pmesh.all_gather_rows.seconds = 0
    launches = {}
    times, num_points, losses, vs_one = [], [], [], []
    for _ in range(groups):
        torch.cuda.synchronize()
        t_group, t0 = 0.0, time.perf_counter()
        for _ in range(DP_STAGE0_STEPS):
            if hold:
                if dp.rank == 0:
                    g_state = gen.get_state()
                    one, aux_one = step_one(state, gen)
                    gen.set_state(g_state)
                    one = ([x.cpu().numpy() for x in s0.tree_leaves(one.params)],
                           int(aux_one["num_points"]))
                pmesh.barrier(dp)
                torch.cuda.synchronize()
                zero_counts()
                t0 = time.perf_counter()
            state, aux = step_fn(state, gen)
            if hold:
                torch.cuda.synchronize()
                t_group += time.perf_counter() - t0
                for k, n in read_counts().items():
                    launches[k] = launches.get(k, 0) + n
                if dp.rank == 0:
                    vs_one.append({**params_within(
                        [x.cpu().numpy() for x in s0.tree_leaves(state.params)], one[0],
                        DP_STAGE0_TOL), "num_points_equal": int(aux["num_points"]) == one[1]})
            num_points.append(aux["num_points"])
            losses.append(aux["loss"])
        if not hold:
            torch.cuda.synchronize()
            t_group = time.perf_counter() - t0
        times.append(t_group)
    if not hold:
        launches = read_counts()
    steps = groups * DP_STAGE0_STEPS
    stage0_finite(state, aux, "dp stage-0 step")
    return state, {
        "group_s": times, "step_s": statistics.median(times) / DP_STAGE0_STEPS,
        "num_points": [int(v) for v in num_points], "loss_first": float(losses[0]),
        "loss_last": float(losses[-1]), "K4_per_step": launches["scatter_add"] / steps,
        "launches": launches, "params_vs_one_card": vs_one,
        "all_reduce_bytes_per_step": pmesh.all_reduce.bytes / steps,
        "all_gather_bytes_per_step": pmesh.all_gather_rows.bytes / steps,
        "collective_s_per_step": (pmesh.all_reduce.seconds + pmesh.all_gather_rows.seconds)
        / steps}


def dp_stage1(dp, dev, seed, v, f, counts) -> tuple:
    """bench.py's ReSTIR train step (4d's static, 256^2, spp 32, the bench
    mesh, denoise_iters 4) in fp32 from seed: DP_STAGE1_STEPS steps sharded
    over dp's ranks, each between two syncs, the counters zeroed before and
    read after each.  Before each, rank 0 takes the one-card step from the
    same state with the same draws (a copy of the generator's state), so
    every step is held to the one-card step from a common start: the
    renderer's Monte Carlo decisions (reservoir picks, the denoiser's
    weights) follow the params, and an ulp of difference after one step
    (the gradient summed in another order) moves a pick in a later frame,
    as tests/test_torch_stage1_restir.py's step 2 starts from the
    reference's state for the same reason.  -> (state, readings)."""
    import dataclasses

    import torch

    from mirres_restir_nerf_mesh_torch.parallel import mesh as pmesh
    from mirres_restir_nerf_mesh_torch.train import stage1 as train1
    from mirres_restir_nerf_mesh_torch.train.losses import build_topology

    zero_counts, read_counts = counts
    vb, fb = torch.as_tensor(v, device=dev), torch.as_tensor(f, device=dev)
    st_one = frame_static(fb, FRAME_HW, FRAME_HW, FRAME_SPP, torch.float32, **BUDGET, **RESTIR)
    st = dataclasses.replace(st_one, dp=dp)
    cfg = train_config(FRAME_SPP, use_restir=True)
    cam = camera(FRAME_HW, FRAME_HW, dev)
    params = make_params(v.shape[0], seed, dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 7)
    state = train1.init_state(gen, cfg, st, params.nerf, v.shape[0], device=dev)
    state = state._replace(params=state.params._replace(env=torch.as_tensor(sky_env(),
                                                                            device=dev)))
    topo = build_topology(f, v.shape[0])
    step = train1.make_train_step(cfg, st, vb, topo)
    step_one = train1.make_train_step(cfg, st_one, vb, topo)

    def leaves(s):
        return [x for g in train1.GROUPS for x in train1.group_leaves(s.params)[g]]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pmesh.all_reduce.bytes = pmesh.all_gather_rows.bytes = 0
    pmesh.all_reduce.seconds = pmesh.all_gather_rows.seconds = 0
    launches = {}
    times, times_one, losses, losses_one, uncertain, vs_one = [], [], [], [], [], []
    one_vs_itself, readings = [], []
    for _ in range(DP_STAGE1_STEPS):
        pre = dp_stage1_readings(dp, state, cam, gen, cfg, st, st_one, vb, topo)
        env_before = state.params.env
        if dp.rank == 0:
            g_state = gen.get_state()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            one, aux_one = step_one(state, cam, generator=gen)
            torch.cuda.synchronize()
            times_one.append(time.perf_counter() - t0)
            gen.set_state(g_state)
            losses_one.append(float(aux_one["loss"]))
            one = [x.cpu().numpy() for x in leaves(one)]
            # the one-card step again from the same state: its own spread (K4's
            # atomics sum in another order), printed beside the gate
            again, _ = step_one(state, cam, generator=gen)
            gen.set_state(g_state)
            one_vs_itself.append(params_within([x.cpu().numpy() for x in leaves(again)], one,
                                               DP_STAGE1_TOL))
            del again
        pmesh.barrier(dp)
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        state, aux = step(state, cam, generator=gen)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        for k, n in read_counts().items():
            launches[k] = launches.get(k, 0) + n
        losses.append(float(aux["loss"]))
        uncertain.append(float(aux["uncertain_count"]))
        if dp.rank == 0:
            vs_one.append(params_within([x.cpu().numpy() for x in leaves(state)], one,
                                        DP_STAGE1_TOL))
            read, g_one, g_dp, parts = pre
            read["env_texels"] = env_texel_readings(
                env_before, torch.as_tensor(one[-1], device=dev), state.params.env, g_one, g_dp,
                parts)
            readings.append(read)
            log(f"4j (b) step {len(readings)}: gate {json.dumps(vs_one[-1])}; readings "
                f"{json.dumps(read)}")
            del one, pre
    check_state(state, aux)
    n = DP_STAGE1_STEPS
    return state, {
        "step_s": times, "one_card_step_s": times_one, "loss": losses, "loss_one_card": losses_one,
        "params_vs_one_card": vs_one, "one_card_vs_itself": one_vs_itself,
        "readings": readings, "uncertain_count": uncertain,
        "K1_per_step": launches["queue_trace"] / n, "K4_per_step": launches["scatter_add"] / n,
        "launches": launches, "max_memory_allocated_GB": torch.cuda.max_memory_allocated() / 1e9,
        "all_reduce_bytes_per_step": pmesh.all_reduce.bytes / n,
        "all_gather_bytes_per_step": pmesh.all_gather_rows.bytes / n,
        "all_reduce_s_per_step": pmesh.all_reduce.seconds / n,
        "all_gather_s_per_step": pmesh.all_gather_rows.seconds / n}


def record_stage1(run):
    """run() with the ReSTIR final pick of every live pixel and spp
    (spatial_resampling's reservoir: [pixel, direction, valid] rows, one
    tensor a spp) and render_stage1's DP_READ_KEYS outputs recorded ->
    (run's value, picks, outputs)."""
    import torch

    from mirres_restir_nerf_mesh_torch.render import restir as restir_mod
    from mirres_restir_nerf_mesh_torch.train import stage1 as train1

    orig_sp, orig_render = restir_mod.spatial_resampling, train1.render_stage1
    picks, outs = [], {}

    def spatial(*a, **kw):
        out = orig_sp(*a, **kw)
        res = out[0] if isinstance(out, tuple) else out
        picks.append(torch.cat([kw["pix_idx"][:, None].to(torch.float32), res.dir.detach(),
                                res.valid[:, None].to(torch.float32)], dim=1))
        return out

    def render(*a, **kw):
        out = orig_render(*a, **kw)
        outs.update({k: out[k].detach().reshape(out[k].shape[0], -1).to(torch.float32)
                     for k in DP_READ_KEYS})
        return out

    restir_mod.spatial_resampling, train1.render_stage1 = spatial, render
    try:
        value = run()
    finally:
        restir_mod.spatial_resampling, train1.render_stage1 = orig_sp, orig_render
    return value, picks, outs


def dp_stage1_readings(dp, state, cam, gen, cfg, st, st_one, vb, topo):
    """4j (b)'s readings before a step, from its state and its draws (the
    generator's state restored after each pass): rank 0's one-card pass
    against the sharded pass (every rank), before Adam: the loss; each
    render_stage1 output and the ReSTIR final pick of every pixel and spp,
    pixels not bit-equal; each optimizer group's gradient after the
    all-reduce, max |d| and the share of entries apart by more than
    DP_GRAD_RTOL relative.  -> rank 0: (readings, the env leaf's one-card
    gradient, its summed DP gradient, its band partials [R, ...]); other
    ranks: None."""
    import torch

    from mirres_restir_nerf_mesh_torch.parallel import mesh as pmesh
    from mirres_restir_nerf_mesh_torch.render.stage1 import frame_band
    from mirres_restir_nerf_mesh_torch.train import stage1 as train1

    leaves = train1.group_leaves(state.params)
    names = [g for g in train1.GROUPS for _ in leaves[g]]
    flat_leaves = [x for g in train1.GROUPS for x in leaves[g]]

    def flat(grads):
        return [torch.zeros_like(p) if x is None else x
                for p, x in zip(flat_leaves, (x for g in train1.GROUPS for x in grads[g]))]

    g_state = gen.get_state()
    if dp.rank == 0:
        (loss1, _, g1), picks1, outs1 = record_stage1(
            lambda: train1.loss_and_grads(state.params, st_one, vb, topo, cam, cfg, gen))
        gen.set_state(g_state)
        g1 = flat(g1)
    pmesh.barrier(dp)
    (loss, _, g), picks, outs = record_stage1(
        lambda: train1.loss_and_grads(state.params, st, vb, topo, train1.band_batch(cam, st), cfg,
                                      gen))
    gen.set_state(g_state)
    part = flat(g)
    summed = pmesh.all_reduce_grads(part, flat_leaves, dp)
    env_parts = pmesh.all_gather_rows(part[-1].reshape(1, -1), dp, [1] * dp.world)
    counts = frame_band(st).counts
    outs = {k: pmesh.all_gather_rows(v, dp, counts) for k, v in outs.items()}
    picks = [pmesh.all_gather_rows(p, dp) for p in picks]
    if dp.rank != 0:
        return None

    def apart(a, b):
        """Pixels (rows) not bit-equal; NaN rows (no record) equal NaN rows."""
        same = (a == b) | (torch.isnan(a) & torch.isnan(b))
        return int((~same.all(dim=1)).sum())

    P = cam["rays_o"].shape[0]

    def by_pixel(p):
        full = torch.full((P, 4), float("nan"), device=p.device)
        full[p[:, 0].long()] = p[:, 1:]
        return full

    pick_bits, pick_moved = [], []
    for a, b in zip(picks, picks1):
        fa, fb = by_pixel(a), by_pixel(b)
        pick_bits.append(apart(fa, fb))
        d = torch.nan_to_num((fa - fb).abs(), nan=0.0).amax(dim=1)
        live_diff = torch.isnan(fa[:, 0]) != torch.isnan(fb[:, 0])
        pick_moved.append(int(((d > DP_PICK_ATOL) | live_diff).sum()))
    grads = {}
    for name in train1.GROUPS:
        pairs = [(a, b) for n, a, b in zip(names, summed, g1) if n == name]
        d = torch.cat([(a - b).abs().reshape(-1) for a, b in pairs])
        ref = torch.cat([b.abs().reshape(-1) for _, b in pairs])
        grads[name] = {"max_abs": float(d.max()),
                       "share_apart": float((d > DP_GRAD_RTOL * ref).to(torch.float32).mean()),
                       "max_abs_grad": float(ref.max())}
    read = {"loss_one_card": float(loss1), "loss_dp": float(loss),
            "loss_rel": abs(float(loss) - float(loss1)) / abs(float(loss1)),
            "outputs_pixels_apart": {k: apart(outs[k], outs1[k]) for k in DP_READ_KEYS},
            "picks_pixels_apart": pick_bits, "picks_moved": pick_moved,
            "picks_spp": len(picks1), "grads": grads}
    return read, g1[-1], summed[-1], env_parts


def env_texel_readings(env_before, env_one, env_dp, g_one, g_dp, parts) -> dict:
    """The envmap texels (entries) that a DP step left outside DP_STAGE1_TOL
    of the one-card step from the same state: their gradients x the light
    group's pre-scale against Adam's eps, sign flips, and the cancellation
    ratio sum_r |g_r| / |sum_r g_r| of the ranks' band partials (a lower
    bound of the ratio over all contributions)."""
    import torch

    rtol, atol = DP_STAGE1_TOL
    d = (env_dp - env_one).abs()
    bad = (d > atol + rtol * env_one.abs()).reshape(-1)
    out = {"entries": int(bad.numel()), "outside": int(bad.sum()),
           "max_abs_diff": float(d.max()),
           "max_step": float((env_one - env_before).abs().max())}
    if out["outside"] == 0:
        return out
    a1 = (g_one.reshape(-1)[bad] * LIGHT_PRE_SCALE).abs()
    ad = (g_dp.reshape(-1)[bad] * LIGHT_PRE_SCALE).abs()
    p = parts.reshape(parts.shape[0], -1)[:, bad]
    ratio = p.abs().sum(dim=0) / p.sum(dim=0).abs().clamp_min(1e-30)
    rel = (g_dp.reshape(-1)[bad] - g_one.reshape(-1)[bad]).abs() / g_one.reshape(-1)[bad].abs(
    ).clamp_min(1e-30)

    def q(x):
        x = x.double().cpu()
        return {"min": float(x.min()), "median": float(x.median()), "max": float(x.max())}

    out.update({"g_x64_one_card": q(a1), "g_x64_dp": q(ad), "adam_eps": LIGHT_EPS,
                "below_10_eps": int((a1 < 10 * LIGHT_EPS).sum()),
                "sign_flips": int((torch.sign(g_one.reshape(-1)[bad]) !=
                                   torch.sign(g_dp.reshape(-1)[bad])).sum()),
                "grad_rel_diff": q(rel), "cancellation_ratio": q(ratio)})
    return out


def dp_collective_ms(dp, dev, leaves, band_rows: int) -> dict:
    """Host ms (synchronized, median of 5) of the gradient all-reduce over
    ``leaves``' shapes, and of one gather_rows forward + backward of a
    17-channel band of ``band_rows`` pixels (the denoiser's gather)."""
    import torch

    from mirres_restir_nerf_mesh_torch.parallel import mesh as pmesh

    grads = [torch.ones_like(x) for x in leaves]
    counts = [band_rows] * dp.world

    def reduce():
        pmesh.all_reduce_grads(grads, leaves, dp)

    def gather():
        x = torch.ones((band_rows, 17), device=dev, requires_grad=True)
        torch.autograd.grad(pmesh.gather_rows(x, dp, counts).sum(), x)

    out = {}
    for name, fn in (("grad_all_reduce_ms", reduce), ("gather_rows_fwd_bwd_ms", gather)):
        ts = []
        for _ in range(6):
            pmesh.barrier(dp)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
        out[name] = statistics.median(ts[1:])
    out["grad_bytes"] = sum(x.numel() * x.element_size() for x in leaves)
    return out


def dp_rank(dp, seed, v, f):
    """Phase 4j's work on one rank: the collectives, stage 0 (the fp32 gate
    run, then bf16 timing), the collectives' times, stage 1 (the fp32 gate
    run) -> readings, rank 0's params after each gate run, and whether
    every rank holds the same state."""
    import torch

    from mirres_restir_nerf_mesh_torch.parallel import mesh as pmesh
    from mirres_restir_nerf_mesh_torch.train import stage1 as train1
    from mirres_restir_nerf_mesh_torch.train.stage0 import tree_leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = dp.device
    counts = make_counters()
    out = {"collectives": dp_collectives(dp)}
    state, out["stage0_fp32"] = dp_stage0(dp, dev, seed, torch.float32, 1, counts, hold=True)
    out["stage0_same"] = pmesh.same_on_all_ranks(
        tree_leaves(state.params) + [state.occ.density_grid, state.occ.occ], dp)
    out["stage0_params"] = ([x.cpu().numpy() for x in tree_leaves(state.params)]
                            if dp.rank == 0 else None)
    out["stage0_collective"] = dp_collective_ms(dp, dev, tree_leaves(state.params), 1)
    del state
    torch.cuda.empty_cache()
    state, out["stage0_bf16"] = dp_stage0(dp, dev, seed, torch.bfloat16, 3, counts)
    del state
    torch.cuda.empty_cache()
    state, out["stage1_fp32"] = dp_stage1(dp, dev, seed, v, f, counts)
    leaves = [x for g in train1.GROUPS for x in train1.group_leaves(state.params)[g]]
    out["stage1_same"] = pmesh.same_on_all_ranks(leaves, dp)
    out["stage1_collective"] = dp_collective_ms(dp, dev, leaves,
                                                FRAME_HW * FRAME_HW // dp.world)
    return out


def dp_stage1_rank(dp, seed, v, f, runs: int):
    """4j (b) alone, ``runs`` times from the same seed on one rank -> each
    run's readings (dp_stage1)."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = []
    for _ in range(runs):
        state, r = dp_stage1(dp, dp.device, seed, v, f, make_counters())
        out.append(r)
        del state
        torch.cuda.empty_cache()
    return out


def dp_stage1_repeat(dev, v, f, seed, runs: int) -> int:
    """``--dp-stage1 N``: phase 4j (b) N times in one pair of ranks, each
    run gated as in phase 4j; every run's gate and readings printed -> 0
    if every run passed."""
    import torch

    from mirres_restir_nerf_mesh_torch.parallel import mesh as pmesh

    rank_dev = torch.device(dev.type, torch.cuda.current_device())
    ranks = pmesh.launch(dp_stage1_rank, DP_RANKS, backend="gloo",
                         device_of_rank=lambda r: rank_dev, args=(seed, v, f, runs),
                         timeout=DP_TIMEOUT_S * runs)
    failed = 0
    for i in range(runs):
        s1 = ranks[0][i]
        fails = dp_stage1_fails(s1, [r[i] for r in ranks])
        failed += bool(fails)
        log(f"4j (b) run {i}: {'FAILED ' + '; '.join(fails) if fails else 'passed'}; "
            + json.dumps({k: s1[k] for k in ("params_vs_one_card", "one_card_vs_itself",
                                             "loss", "loss_one_card", "step_s",
                                             "one_card_step_s")}))
    log(f"4j (b): {runs - failed} of {runs} runs passed")
    return 1 if failed else 0


def dp_stage1_fails(s1, per_rank) -> list:
    """4j (b)'s gates on rank 0's readings and every rank's -> failures."""
    fails = []
    for k, r in enumerate(per_rank):
        if any(u != 0 for u in r["uncertain_count"]):
            fails.append(f"rank {k}: stage-1 uncertain_count {r['uncertain_count']}")
        if r["K1_per_step"] != 1 + 2 * 2 + FRAME_SPP or r["K4_per_step"] != K4_STEP_LAUNCHES:
            fails.append(f"rank {k}: {r['K1_per_step']} K1 / {r['K4_per_step']} K4 "
                         "launches a stage-1 step")
    if not all(c["ok"] for c in s1["params_vs_one_card"]):
        fails.append(f"stage-1 params vs the one-card step: {s1['params_vs_one_card']}")
    # the sharded forward is the one-card forward on the band's rows: every
    # render output and ReSTIR pick bit-equal before Adam (the gradients
    # differ by the all-reduce's order only)
    apart = [(r["outputs_pixels_apart"], r["picks_pixels_apart"]) for r in s1["readings"]]
    if any(any(o.values()) or any(p) for o, p in apart):
        fails.append(f"stage-1 sharded forward not bit-equal to the one-card forward: {apart}")
    loss_rel = abs(s1["loss"][0] - s1["loss_one_card"][0]) / abs(s1["loss_one_card"][0])
    if not loss_rel <= DP_LOSS_RTOL:
        fails.append(f"stage-1 first-step loss: relative difference {loss_rel}")
    return fails


def params_within(got, ref, tol) -> dict:
    """Each leaf within (rtol, atol) of the reference -> the worst leaf's
    share of entries outside, its largest |difference| and the verdict."""
    import numpy as np

    rtol, atol = tol
    worst = {"ok": True, "max_abs_diff": 0.0, "share_outside": 0.0, "leaf": None}
    for i, (a, b) in enumerate(zip(got, ref)):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        bad = np.abs(a - b) > atol + rtol * np.abs(b)
        worst["max_abs_diff"] = max(worst["max_abs_diff"], float(np.abs(a - b).max()))
        if bad.mean() > worst["share_outside"]:
            worst["share_outside"], worst["leaf"] = float(bad.mean()), i
        worst["ok"] = worst["ok"] and not bool(bad.any())
    worst["ok"] = worst["ok"] and len(got) == len(ref)
    return worst


def dp_cli(out_dir) -> dict:
    """Phase 4j (c): ``torchrun --nproc_per_node 1 -m
    mirres_restir_nerf_mesh_torch.main`` (NCCL) on 4h's blender scene, a
    short stage 0 with -O; rank 0 writes the workspace (mesh_0.ply only
    where the field reached the density threshold: recorded, not gated)."""
    import tempfile

    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_dp_")
    base = Path(tmp.name)
    root, ws = base / "scene", base / "ws"
    try:
        write_blender_scene(root)
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc_per_node", "1", "-m", "mirres_restir_nerf_mesh_torch.main", str(root),
               "--workspace", str(ws), "--bound", "1", "--scale", "1.0", "-O", "--iters",
               str(DP_CLI_ITERS), "--mcubes_reso", str(CLI_MCUBES_RESO)]
        t0 = time.perf_counter()
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=DP_TIMEOUT_S,
                             cwd=str(Path(__file__).resolve().parent))
        secs = time.perf_counter() - t0
        if out_dir is not None:
            (out_dir / "dp_torchrun.log").write_text(res.stdout + res.stderr)
        log_path = ws / "log_ngp.txt"
        text = log_path.read_text() if log_path.exists() else ""
        got = {"s": secs, "returncode": res.returncode,
               "joined_nccl": "[dp] data-parallel over 1 ranks (nccl)" in text,
               "mesh": (ws / "mesh_0.ply").exists(),
               "checkpoints": len(list((ws / "checkpoints").glob("*.pkl")))
               if (ws / "checkpoints").exists() else 0,
               "metrics": (ws / "metrics_ngp.jsonl").exists()}
    finally:
        tmp.cleanup()
    if not (got["returncode"] == 0 and got["joined_nccl"] and got["checkpoints"]
            and got["metrics"]):
        raise AssertionError(f"4j (c) torchrun: {got}\n{res.stdout[-3000:]}\n{res.stderr[-3000:]}")
    return got


def dp_run(dev, counts, v, f, seed, out_dir) -> dict:
    """Phase 4j: (a) stage 0 and (b) stage 1 on DP_RANKS gloo ranks on this
    card (spawned through parallel.mesh.launch), each step held to the
    one-card step rank 0 takes from the same state (dp_stage0, dp_stage1);
    stage 0 also chained at 1 rank (this process) beside 2; (c) the user's
    command under torchrun (NCCL)."""
    import torch

    from mirres_restir_nerf_mesh_torch.parallel import mesh as pmesh
    from mirres_restir_nerf_mesh_torch.train.stage0 import tree_leaves

    t_start = time.perf_counter()
    one = {}
    state, one["stage0_fp32"] = dp_stage0(None, dev, seed, torch.float32, 1, counts)
    ref0 = [x.cpu().numpy() for x in tree_leaves(state.params)]
    # the same run again: how far two one-card runs from one seed part
    state, _ = dp_stage0(None, dev, seed, torch.float32, 1, counts)
    s0_self = params_within([x.cpu().numpy() for x in tree_leaves(state.params)], ref0,
                            DP_STAGE0_TOL)
    del state
    torch.cuda.empty_cache()
    state, one["stage0_bf16"] = dp_stage0(None, dev, seed, torch.bfloat16, 3, counts)
    del state
    torch.cuda.empty_cache()
    t_one = time.perf_counter() - t_start

    t0 = time.perf_counter()
    # every rank on this card (an explicit index: cuda alone would mean cuda:rank)
    rank_dev = torch.device(dev.type, torch.cuda.current_device()) if dev.type == "cuda" else dev
    ranks = pmesh.launch(dp_rank, DP_RANKS, backend="gloo", device_of_rank=lambda r: rank_dev,
                         args=(seed, v, f), timeout=DP_TIMEOUT_S)
    t_ranks = time.perf_counter() - t0
    r0 = ranks[0]
    # the chained runs (16 steps each, not gated: two one-card runs part too)
    s0_chained = params_within(r0["stage0_params"], ref0, DP_STAGE0_TOL)
    s0_cmp = r0["stage0_fp32"]["params_vs_one_card"]
    s1 = r0["stage1_fp32"]
    loss_rel = abs(s1["loss"][0] - s1["loss_one_card"][0]) / abs(s1["loss_one_card"][0])
    t0 = time.perf_counter()
    cli = dp_cli(out_dir)
    res = {
        "ranks": DP_RANKS, "note": "2 gloo ranks share one card: correctness and overhead, "
                                   "not scaling",
        "one_rank": one,
        "per_rank": [{k: v for k, v in r.items() if not k.endswith("_params")} for r in ranks],
        "stage0_chained_vs_one_rank": s0_chained, "stage0_chained_one_rank_twice": s0_self,
        "stage1_first_loss_rel": loss_rel, "torchrun": cli,
        "s_one_rank": t_one, "s_ranks": t_ranks, "s_torchrun": time.perf_counter() - t0}
    log("dp: " + json.dumps(res))
    fails = dp_stage1_fails(s1, [r["stage1_fp32"] for r in ranks])
    for k, r in enumerate(ranks):
        s0r = r["stage0_fp32"]
        if s0r["num_points"] != one["stage0_fp32"]["num_points"]:
            fails.append(f"rank {k}: stage-0 num_points differ from one rank's")
        if s0r["K4_per_step"] != K4_STAGE0_LAUNCHES or r["stage0_bf16"]["K4_per_step"] != \
                K4_STAGE0_LAUNCHES:
            fails.append(f"rank {k}: {s0r['K4_per_step']} K4 launches a stage-0 step")
        if not (r["stage0_same"] and r["stage1_same"]):
            fails.append(f"rank {k}: state differs from the other ranks'")
    if not all(c["ok"] and c["num_points_equal"] for c in s0_cmp):
        fails.append(f"stage-0 params vs the one-card step: {s0_cmp}")
    if fails:
        raise AssertionError("4j: " + "; ".join(fails))
    res["launches"] = {"dp_stage0_one": one["stage0_fp32"]["launches"],
                       **{f"dp_stage0_rank{k}": r["stage0_fp32"]["launches"]
                          for k, r in enumerate(ranks)},
                       **{f"dp_stage1_rank{k}": r["stage1_fp32"]["launches"]
                          for k, r in enumerate(ranks)}}
    return res


# phase 4k: the last modules.  The lbvh and cluster tracer kinds beside the
# tile kind on both meshes, K3 on a bare mesh (dense_intersect), a frame with
# each kind, the all-texel dump renderer, the exact and alias env samplers
# with a ReSTIR pass on the exact one, and the user's downscale, turntable
# and viewer tools.
KINDS_RAYS = 65_536
KINDS_CPU_RAYS = 4096                  # the cluster kind's CPU run
KINDS_TMAX = (0.05, 1.5)               # the per-ray t_max of the checks that take one
KINDS_MAX_CANDIDATES = 10
KINDS_TIE_RTOL = 1e-6                  # two hits this close in t are a tie: either prim is right
KINDS_T_RTOL = 1e-5
KINDS_TIMED = 2
KINDS_FRAME_HW = 64
KINDS_FRAME_SPP = 2
KINDS_FRAME_MAE = 1e-5
# K3 launches of a lighter small-mesh frame at KINDS_FRAME_SPP (closest,
# any): tile's dense route takes any hits as such, the cluster kind as
# closest hits, the lbvh none
KINDS_FRAME_K3 = {"tile": (3, 2 + 2 * KINDS_FRAME_SPP),
                  "cluster": (3 + 2 + 2 * KINDS_FRAME_SPP, 0), "lbvh": (0, 0)}
DUMP_HW = 128
DUMP_TEXEL_CHUNK = 64
DUMP_CPU_PIXELS = 64                   # the CPU's run covers these pixels of the frame
DUMP_RTOL = 1e-4
DUMP_SHARE = 0.999
# the buffers gated card vs CPU, each within its relative bound on >=
# DUMP_SHARE of the pixels: the image and the diffuse light within
# DUMP_RTOL; the specular light within the rounding its GGX term can
# amplify.  ndf_ggx's D = a^2 / (pi d^2), d = c^2 (a^2 - 1) + 1 (a = alpha,
# c = cos theta_h) has the condition number |dlnD / dlnc| = 4 c^2 (1 - a^2)
# / d, largest at c -> 1: 4 (1 - a^2) / a^2 < 4 / alpha^2; at the dump's
# smallest roughness (alpha = roughness^2 = 0.04) 2,500.  c carries a few
# fp32 roundings (the half vector's sum, norm and division): 4 ulps of
# 2^-24.  A texel's term, and so the sum of positive terms, moves by up to
# 2,500 x 4 x 2^-24 = 6.0e-4 relative (the two devices read 1.4e-4 apart on
# 1 of 128 pixels in PR 10, the image within 1.8e-5)
DUMP_ROUGHNESS = (0.2, 0.8)            # dump_gbuffer's roughness: 0.2 + 0.8 U[0, 1)
DUMP_SPEC_RTOL = 4.0 / DUMP_ROUGHNESS[0] ** 4 * 4 * 2.0 ** -24
DUMP_GATED = {"image_brdf": DUMP_RTOL, "diffuse_light": DUMP_RTOL,
              "specular_light": DUMP_SPEC_RTOL}
SAMPLER_DRAWS = 65_536
SAMPLER_ATOL = 1e-5
SAMPLER_SHARE = 0.999
RESTIR_PASS_HW = 64
RESTIR_PASS_RTOL = 1e-4
TURNTABLE_FRAMES = 4
TURNTABLE_HW = 128
VIEWER_SIZE = 128
VIEWER_TRAIN_ITERS = 50
TOOLS_WIDTH_FLAGS = []                 # flags every tool's run appends (4h's widths: none)


def dump_env():
    """The dump's 16x32 env: bench.py's sky + sun, every 4th texel (the sun
    kept)."""
    return sky_env()[2::4, 2::4].copy()


def kinds_check(name, tracers, ro, rd, any_hit, t_max, incoherent):
    """One trace of the rays with each tracer kind: lbvh (exact) against the
    tile kind: hit / miss equal on every ray, the prims equal wherever the
    two hits are not a tie (t within KINDS_TIE_RTOL), t within KINDS_T_RTOL;
    any hit: the masks equal; tile's uncertain_count 0.  The cluster kind's
    agreement with lbvh is a share (exact only within its K candidates).
    ms: CUDA events around one call, median of KINDS_TIMED after the
    compared one."""
    import torch

    out, res = {}, dict(any_hit=any_hit, rays=int(ro.shape[0]),
                        t_max="per ray" if torch.is_tensor(t_max) else t_max)
    for kind, tr in tracers.items():
        def run(tr=tr):
            if any_hit:
                return tr.occluded(ro, rd, t_max, incoherent=incoherent)
            return tr.intersect(ro, rd, t_max=t_max, incoherent=incoherent)

        out[kind] = run()
        torch.cuda.synchronize()
        res[f"{kind}_ms"] = cuda_ms(run, KINDS_TIMED, warm=False)
    unc = float(tracers["tile"].pop_telemetry())
    for tr in tracers.values():
        tr.pop_traced()
    res["tile_uncertain"] = unc
    if unc != 0:
        raise AssertionError(f"{name}: tile uncertain_count {unc}")
    lb, tl, cl = out["lbvh"], out["tile"], out["cluster"]
    if any_hit:
        if not torch.equal(lb, tl):
            raise AssertionError(f"{name}: lbvh and tile masks differ on "
                                 f"{int((lb != tl).sum())} rays")
        res.update(occluded_share=float(tl.float().mean()),
                   cluster_agree=float((cl == lb).float().mean()))
        return res, out
    hit_l, hit_t = lb.prim >= 0, tl.prim >= 0
    if not torch.equal(hit_l, hit_t):
        raise AssertionError(f"{name}: lbvh and tile hit / miss differ on "
                             f"{int((hit_l != hit_t).sum())} rays")
    both = hit_l & hit_t
    dt = (lb.t - tl.t).abs()
    ties = both & (lb.prim != tl.prim)
    off = ties & (dt > KINDS_TIE_RTOL * tl.t)
    if bool(off.any()):
        raise AssertionError(f"{name}: lbvh and tile prims differ off a tie on {int(off.sum())} "
                             f"rays (of {int(ties.sum())} differing), t apart by up to "
                             f"{float((dt[off] / tl.t[off]).max()):.3g} relative")
    rel = float((dt[both] / tl.t[both]).max()) if bool(both.any()) else 0.0
    if rel > KINDS_T_RTOL:
        raise AssertionError(f"{name}: lbvh t off tile's by {rel:.3g} relative")
    same_c = (cl.prim == lb.prim) | ((cl.prim < 0) & (lb.prim < 0))
    res.update(hit_share=float(hit_t.float().mean()), prim_ties=int(ties.sum()),
               t_max_rel_err=rel, cluster_agree=float(same_c.float().mean()))
    return res, out


def check_tracer_kinds(name, verts, tris, rays, gen):
    """Phase 4k (a) on one mesh: the LBVH build, then each ray set (name ->
    (origins, dirs, incoherent)) traced by the three kinds, closest hit and
    any hit, at t_max 1e9 and per ray; the cluster kind on the card against
    its own CPU run on the first KINDS_CPU_RAYS rays."""
    import torch

    from mirres_restir_nerf_mesh_torch.ops import bvh as lbvh
    from mirres_restir_nerf_mesh_torch.ops import tracer as trc
    from mirres_restir_nerf_mesh_torch.ops.cluster_bvh import build_clusters

    # the tile kind at budgets that drop nothing (every cluster a candidate),
    # so that it is exact as the lbvh is
    C = int(build_clusters(verts, tris).prim.shape[0])
    res = dict(triangles=int(tris.shape[0]), clusters=C,
               build_bvh_ms=cuda_ms(lambda: lbvh.build_bvh(verts, tris), 3),
               build_clusters_ms=cuda_ms(lambda: build_clusters(verts, tris), 3), checks={})
    tracers = {"tile": trc.build_tracer(verts, tris, "tile", k_cap=C, queue_avg=C,
                                        k_cap_incoherent=C, queue_avg_incoherent=C),
               "cluster": trc.build_tracer(verts, tris, "cluster",
                                           max_candidates=KINDS_MAX_CANDIDATES),
               "lbvh": trc.build_tracer(verts, tris, "lbvh")}
    cpu_cluster = trc.build_tracer(verts.cpu(), tris.cpu(), "cluster",
                                   max_candidates=KINDS_MAX_CANDIDATES)
    n = KINDS_CPU_RAYS
    for rname, (ro, rd, incoherent) in rays.items():
        tm = KINDS_TMAX[0] + torch.rand(ro.shape[0], generator=gen, device=ro.device) * (
            KINDS_TMAX[1] - KINDS_TMAX[0])
        for any_hit in (False, True):
            for t_max in (1e9, tm):
                label = (f"{name}, {rname}, {'any' if any_hit else 'closest'} hit, t_max "
                         f"{'per ray' if torch.is_tensor(t_max) else t_max}")
                r, out = kinds_check(label, tracers, ro, rd, any_hit, t_max, incoherent)
                tm_c = t_max[:n].cpu() if torch.is_tensor(t_max) else t_max
                if any_hit:
                    c = cpu_cluster.occluded(ro[:n].cpu(), rd[:n].cpu(), tm_c)
                    ok = torch.equal(c, out["cluster"][:n].cpu())
                else:
                    c = cpu_cluster.intersect(ro[:n].cpu(), rd[:n].cpu(), t_max=tm_c)
                    k = out["cluster"]
                    kp, kt = k.prim[:n].cpu(), k.t[:n].cpu()
                    diff = kp != c.prim
                    dt = (kt - c.t).abs()
                    hit = c.prim >= 0
                    ok = (torch.equal(kp >= 0, hit)
                          and not bool((dt[diff] > KINDS_TIE_RTOL * c.t[diff]).any())
                          and not bool((dt[hit] > KINDS_T_RTOL * c.t[hit]).any()))
                if not ok:
                    raise AssertionError(f"{label}: the cluster kind on the card differs from "
                                         "its CPU run")
                r["cluster_cpu_equal"] = True
                res["checks"][label] = r
                log("4k tracer kinds: " + json.dumps({label: r}))
    return res


def check_dense_intersect(verts, tris, cm, ro, rd, counts):
    """Phase 4k (b): dense_intersect (K3 on the bare mesh) on the primary
    rays, once with the counters zeroed just before and read just after
    (its path); then the kernel's rows equal the plain version's bit for
    bit at the wrapper's split and unsplit; its HitResult against the tile
    tracer's dense route on the cluster table (t equal bit for bit on every
    ray, prims on >= PRIM_AGREE, u, v and the normal equal where the prims
    are); event, device (queued) and host ms, the bound (check_k3's) ->
    (results, launches of the path)."""
    import torch

    from mirres_restir_nerf_mesh_torch.ops import dense_tracer as dt
    from mirres_restir_nerf_mesh_torch.ops import tile_tracer as tt

    zero_counts, read_counts = counts
    torch.cuda.synchronize()
    zero_counts()
    hk = dt.dense_intersect(verts, tris, ro, rd)
    torch.cuda.synchronize()
    la = read_counts()
    if la["dense_hit"] != 1 or sum(la.values()) != 1:
        raise AssertionError(f"dense_intersect on the card: launches {la}, one K3 expected")
    table = dt.pack_tris_cm(verts, tris)
    N, Mcols = ro.shape[0], table.shape[1]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    auto = dt.split_factor(-(-N // dt.THREADS), sms, -(-Mcols // dt.KERNEL_BM))
    p = dt.dense_hit_plain(table, ro, rd)
    splits = [auto] + ([1] if auto != 1 else [])
    for sp in splits:
        k = dt.dense_hit(table, ro, rd, split=sp)
        torch.cuda.synchronize()
        bad = [i for i, (a, b) in enumerate(zip(k, p)) if not same_bits(a, b)]
        if bad:
            raise AssertionError(f"dense_intersect (split {sp}): rows {bad} differ from the "
                                 "plain version's")
    ht = tt.intersect_tiles_t(cm, ro, rd).hit
    torch.cuda.synchronize()
    if not same_bits(hk.t, ht.t):
        raise AssertionError("dense_intersect: t differs from the tile tracer's dense route")
    same = hk.prim == ht.prim
    agree = float(same.float().mean())
    if agree < PRIM_AGREE:
        raise AssertionError(f"dense_intersect: prims agree with the dense route on {agree}")
    for f in ("u", "v", "normal"):
        if not same_bits(getattr(hk, f)[same], getattr(ht, f)[same]):
            raise AssertionError(f"dense_intersect: {f} differs from the dense route")

    def run(split=None):
        return dt.dense_intersect(verts, tris, ro, rd, split=split)

    res = dict(shape=f"{N} rays x {int(tris.shape[0])} triangles ({Mcols} slots), bare mesh",
               any_hit=False, split=auto, splits_checked=splits, rows_equal=True,
               max_abs_err=0.0, prim_agree_dense_route=agree,
               ms=cuda_ms(run, 10), device_ms=queued_ms(run), host_ms=host_ms(run),
               plain_ms=cuda_ms(lambda: dt.dense_hit_plain(table, ro, rd), 2, warm=False))
    if auto != 1:
        res["ms_split_1"] = cuda_ms(lambda: run(1), 10)
        res["device_ms_split_1"] = queued_ms(lambda: run(1))
    res.update(k3_bound(table, ro, rd, torch.full((N,), 1e10, device=ro.device), p, False))
    return res, la


def kinds_frames(vs, fs, params_s, dev, seed, counts):
    """Phase 4k (c): one lighter 64^2 spp-2 fp32 frame of the small mesh with
    each tracer kind from the same FrameRandoms: finite, image within
    KINDS_FRAME_MAE mean absolute of the tile kind's frame, K3 launched as
    KINDS_FRAME_K3 says (the counters zeroed before each frame)."""
    import dataclasses

    import torch

    from mirres_restir_nerf_mesh_torch.render.stage1 import draw_frame_randoms, render_stage1

    zero_counts, read_counts = counts
    H = KINDS_FRAME_HW
    cam_f = camera(H, H, dev)
    st = frame_static(fs, H, H, KINDS_FRAME_SPP, torch.float32)
    rnd = draw_frame_randoms(H * H, st, torch.Generator(device=dev).manual_seed(seed + 7), dev)
    res, outs, launches = {}, {}, {}
    for kind in ("tile", "cluster", "lbvh"):
        st_k = dataclasses.replace(st, tracer=kind)
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        outs[kind] = render_stage1(params_s, st_k, vs, cam_f["rays_o"], cam_f["rays_d"], rand=rnd)
        torch.cuda.synchronize()
        s = time.perf_counter() - t0
        launches[kind] = la = read_counts()
        check_outputs(outs[kind], H * H)
        mae = float((outs[kind]["image"] - outs["tile"]["image"]).abs().mean())
        res[kind] = dict(frame_s=s, image_mae_vs_tile=mae, K3_closest=la["dense_hit"],
                         K3_any=la["dense_occluded"], launches=la,
                         uncertain_count=float(outs[kind]["uncertain_count"]))
        want = KINDS_FRAME_K3[kind]
        if (la["dense_hit"], la["dense_occluded"]) != want or la["queue_trace"] or \
                la["grid_trace"]:
            raise AssertionError(f"4k frame, {kind} kind: launches {la}, K3 {want} expected")
        if mae > KINDS_FRAME_MAE:
            raise AssertionError(f"4k frame, {kind} kind: image {mae} off the tile kind's")
    log("4k frames by kind: " + json.dumps(res))
    total = {k: sum(la[k] for la in launches.values()) for k in launches["tile"]}
    return res, total


def dump_case(name, gb_in, env, dev, visibility, counts, cpu_visibility=None):
    """render_dump of a 128^2 G-buffer on the card (timed, the counters zeroed
    just before and read just after) and on the CPU over DUMP_CPU_PIXELS of
    its pixels (visibility: the card's Tracer / visibility_fn; cpu_visibility
    the CPU's): each DUMP_GATED buffer within its relative bound on >=
    DUMP_SHARE of those pixels, every buffer finite."""
    import torch

    from mirres_restir_nerf_mesh_torch.ops.tracer import Tracer
    from mirres_restir_nerf_mesh_torch.render.dump import render_dump

    zero_counts, read_counts = counts
    args = [gb_in[k] for k in ("position", "normal", "view_dir", "mask", "kd", "roughness",
                               "metallic")]
    kw = ({"tracer": visibility} if isinstance(visibility, Tracer)
          else {"visibility_fn": visibility} if visibility is not None else {})
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    out = render_dump(*args, env, texel_chunk=DUMP_TEXEL_CHUNK, **kw)
    torch.cuda.synchronize()
    s = time.perf_counter() - t0
    la = read_counts()
    unc = float(visibility.pop_telemetry()) if "tracer" in kw else 0.0
    P = args[0].shape[0]
    idx = torch.randperm(P, generator=torch.Generator().manual_seed(P))[:DUMP_CPU_PIXELS]
    kw_c = ({"tracer": cpu_visibility} if isinstance(cpu_visibility, Tracer)
            else {"visibility_fn": cpu_visibility} if cpu_visibility is not None else {})
    t0 = time.perf_counter()
    ref = render_dump(*[a.cpu()[idx] for a in args], env.cpu(), texel_chunk=DUMP_TEXEL_CHUNK,
                      **kw_c)
    cpu_s = time.perf_counter() - t0
    shares, rel = {}, {}
    for k in ("image_brdf", "diffuse_light", "specular_light"):
        if not bool(torch.isfinite(out[k]).all()):
            raise AssertionError(f"4k dump {name}: {k} not finite")
        a, b = out[k].cpu()[idx], ref[k]
        shares[k] = float(((a - b).abs() <= DUMP_GATED[k] * b.abs() + 1e-7).all(dim=1).float(
        ).mean())
        rel[k] = float(((a - b).abs() / (b.abs() + 1e-7)).max())
    res = dict(pixels=P, texels=int(env.shape[0] * env.shape[1]), s=s, cpu_s=cpu_s,
               cpu_pixels=len(idx), share_within=shares, max_rel_err=rel, uncertain_count=unc,
               launches=la, lit_mean=float(out["image_brdf"].mean()))
    log(f"4k dump {name}: " + json.dumps(res))
    if min(shares[k] for k in DUMP_GATED) < DUMP_SHARE or unc != 0:
        raise AssertionError(f"4k dump {name}: card vs CPU within {DUMP_GATED} on {shares} of "
                             f"pixels, uncertain {unc}")
    return res


def dump_gbuffer(verts, tris, cm, dev, seed):
    """A 128^2 G-buffer of a mesh (tile tracer) and per-pixel materials from
    a seed -> render_dump's inputs on the card."""
    import torch

    from mirres_restir_nerf_mesh_torch.ops.tracer import Tracer
    from mirres_restir_nerf_mesh_torch.render.gbuffer import (prepare_shading_normal,
                                                              raycast_gbuffer)

    cam_d = camera(DUMP_HW, DUMP_HW, dev)
    C = int(cm.prim.shape[0])
    gb = raycast_gbuffer(verts, tris, Tracer(cm, k_cap=C, queue_avg=C), cam_d["rays_o"],
                         cam_d["rays_d"])
    P = DUMP_HW * DUMP_HW
    g = torch.Generator().manual_seed(seed)
    return dict(position=gb.position.detach(),
                normal=prepare_shading_normal(gb.view_dir, gb.normal, gb.face_normal).detach(),
                view_dir=gb.view_dir.detach(), mask=gb.mask,
                kd=torch.rand((P, 3), generator=g).to(dev),
                roughness=(DUMP_ROUGHNESS[0] + DUMP_ROUGHNESS[1] * torch.rand(P, generator=g)
                           ).to(dev),
                metallic=(torch.rand(P, generator=g) * (torch.rand(P, generator=g) < 0.5)).to(dev))


def dump_run(meshes, field, dev, seed, counts):
    """Phase 4k (d): render_dump at 128^2 under a 16x32 env on both meshes
    through a Tracer (K1 on the bench mesh, K3 on the small mesh; budgets
    that drop nothing: k_cap and queue_avg at the cluster count), on the
    small mesh's G-buffer through nerf_visibility_fn of 4h's stage-0 field
    (its MLPs in fp32 on both devices: bf16 matmuls round apart between
    them), and with no visibility."""
    import dataclasses

    import torch

    from mirres_restir_nerf_mesh_torch.ops.tracer import build_tracer
    from mirres_restir_nerf_mesh_torch.render.dump import nerf_visibility_fn

    env = torch.as_tensor(dump_env(), device=dev)
    res, gbs = {}, {}
    for name, (verts, tris, cm) in meshes.items():
        gbs[name] = gb = dump_gbuffer(verts, tris, cm, dev, seed)
        C = int(cm.prim.shape[0])
        budget = dict(k_cap=C, queue_avg=C)
        res[f"{name} mesh, tracer"] = dump_case(
            f"{name} mesh, tracer", gb, env, dev, build_tracer(verts, tris, **budget), counts,
            build_tracer(verts.cpu(), tris.cpu(), **budget))
    params, spec = field
    spec = dataclasses.replace(spec, compute_dtype=torch.float32)
    res["small mesh, nerf_visibility_fn"] = dump_case(
        "small mesh, nerf_visibility_fn", gbs["small"], env, dev,
        nerf_visibility_fn(params, spec), counts,
        nerf_visibility_fn({k: tree_to(v, "cpu") for k, v in params.items()}, spec))
    res["small mesh, no visibility"] = dump_case("small mesh, no visibility", gbs["small"], env,
                                                 dev, None, counts)
    chunks = -(-env.shape[0] * env.shape[1] // DUMP_TEXEL_CHUNK)
    want = {"bench mesh, tracer": "queue_trace", "small mesh, tracer": "dense_occluded"}
    for k, kern in want.items():
        la = res[k]["launches"]
        if la[kern] != chunks or sum(la.values()) != chunks:
            raise AssertionError(f"4k dump {k}: launches {la}, {chunks} {kern} expected")
    for k in ("small mesh, nerf_visibility_fn", "small mesh, no visibility"):
        if sum(res[k]["launches"].values()):
            raise AssertionError(f"4k dump {k}: launched {res[k]['launches']}")
    total = {k: sum(r["launches"][k] for r in res.values()) for k in res[next(iter(res))]
             ["launches"]}
    return res, total


def sampler_run(vs, fs, cm_small, dev, seed, counts):
    """Phase 4k (e): build_distribution and build_alias_table of bench.py's
    env on the card and the CPU (the distribution within 1e-5 relative /
    1e-6 absolute, the alias table equal), sample_li (exact), pdf_li and
    sample_li_alias at SAMPLER_DRAWS draws through the CPU's tables on both
    devices: directions within SAMPLER_ATOL on every draw, pdf within 1e-5
    relative on >= SAMPLER_SHARE; then one ReSTIR initial pass with the
    EnvDistribution on a 64^2 G-buffer of the small mesh (visibility
    through K3), card vs CPU: finite, validity equal and W, the direction
    within RESTIR_PASS_RTOL on >= SAMPLER_SHARE of pixels."""
    import torch

    from mirres_restir_nerf_mesh_torch.models import envlight as el
    from mirres_restir_nerf_mesh_torch.ops.tracer import Tracer
    from mirres_restir_nerf_mesh_torch.render import restir as rs
    from mirres_restir_nerf_mesh_torch.render.gbuffer import (prepare_shading_normal,
                                                              raycast_gbuffer)

    zero_counts, read_counts = counts
    env_c = torch.as_tensor(sky_env())
    env = env_c.to(dev)
    res = dict(build_distribution_ms=cuda_ms(lambda: el.build_distribution(env), 5))
    t0 = time.perf_counter()
    alias = el.build_alias_table(env)
    res["build_alias_table_s"] = time.perf_counter() - t0
    dist, dist_c, alias_c = el.build_distribution(env), el.build_distribution(env_c), \
        el.build_alias_table(env_c)
    for f in ("pdf2d", "mpdf"):
        torch.testing.assert_close(getattr(dist, f).cpu(), getattr(dist_c, f), rtol=1e-5, atol=0)
    for f in ("row_cdf", "mcdf"):
        torch.testing.assert_close(getattr(dist, f).cpu(), getattr(dist_c, f), rtol=0, atol=1e-6)
    if not all(torch.equal(getattr(alias, f).cpu(), getattr(alias_c, f)) for f in alias._fields):
        raise AssertionError("alias table: card and CPU differ")
    g = torch.Generator().manual_seed(seed + 11)
    u = torch.rand((SAMPLER_DRAWS, 2), generator=g)
    dist_cd = el.EnvDistribution(*(x.to(dev) for x in dist_c))
    draws = {"sample_li (exact)": (lambda e, t, uu: el.sample_li(e, t, uu), dist_cd, dist_c),
             "sample_li_alias": (el.sample_li_alias, alias, alias_c)}
    for name, (fn, tab, tab_c) in draws.items():
        d_k, le_k, pdf_k = fn(env, tab, u.to(dev))
        d_c, le_c, pdf_c = fn(env_c, tab_c, u)
        err_d = float((d_k.cpu() - d_c).abs().max())
        rel = (pdf_k.cpu() - pdf_c).abs() / pdf_c.abs().clamp_min(1e-30)
        share = float((rel <= 1e-5).float().mean())
        res[name] = dict(dir_max_abs_err=err_d, pdf_share_within_1e_5=share,
                         pdf_max_rel_err=float(rel.max()),
                         ms=cuda_ms(lambda: fn(env, tab, u.to(dev)), 5))
        if err_d > SAMPLER_ATOL or share < SAMPLER_SHARE or not bool(torch.isfinite(le_k).all()):
            raise AssertionError(f"4k {name}: card vs CPU {res[name]}")
    d_c = el.sample_li(env_c, dist_c, u)[0]
    p_k, p_c = el.pdf_li(dist_cd, d_c.to(dev)).cpu(), el.pdf_li(dist_c, d_c)
    rel = (p_k - p_c).abs() / p_c.abs().clamp_min(1e-30)
    res["pdf_li"] = dict(share_within_1e_5=float((rel <= 1e-5).float().mean()),
                         max_rel_err=float(rel.max()))
    if res["pdf_li"]["share_within_1e_5"] < SAMPLER_SHARE:
        raise AssertionError(f"4k pdf_li: card vs CPU {res['pdf_li']}")
    own = el.sample_li(env, dist, u.to(dev))[0].cpu()
    res["sample_li_own_tables_dir_max_abs_err"] = float((own - el.sample_li(
        env_c, dist_c, u)[0]).abs().max())

    # the ReSTIR initial pass on an EnvDistribution
    H = RESTIR_PASS_HW
    P = H * H
    cam_c = camera(H, H, "cpu")
    vc, fc = vs.cpu(), fs.cpu()
    from mirres_restir_nerf_mesh_torch.ops.cluster_bvh import build_clusters

    gb = raycast_gbuffer(vc, fc, Tracer(build_clusters(vc, fc)), cam_c["rays_o"], cam_c["rays_d"])
    ctx_c = rs.PixelCtx(position=gb.position, normal=prepare_shading_normal(
        gb.view_dir, gb.normal, gb.face_normal), view_dir=gb.view_dir,
        kd=torch.rand((P, 3), generator=g), roughness=0.2 + 0.8 * torch.rand(P, generator=g),
        metallic=torch.rand(P, generator=g) * (torch.rand(P, generator=g) < 0.5),
        mask=gb.mask, depth=gb.depth)
    st = RESTIR
    T, S, nl, nb = (st["restir_tiles"], st["restir_tile_size"], st["restir_light_samples"],
                    st["restir_brdf_samples"])
    u_t = torch.rand((T, S, 2), generator=g)
    rand = rs.InitialRandoms(
        tile_id=torch.randint(0, T, (P,), generator=g),
        blk=torch.randint(0, S // nl, (P,), generator=g), us=torch.rand((1 + nb, P), generator=g),
        brdf_us=[(torch.rand(P, generator=g), torch.rand((P, 2), generator=g),
                  torch.rand((P, 2), generator=g)) for _ in range(nb)])

    def to(x):
        return type(x)(*[tree_to(v, dev) if v is not None else None for v in x])

    tiles_c = rs.generate_light_tiles(env_c, dist_c, T, S, u_t)
    ref = rs.initial_resampling(ctx_c, tiles_c, env_c, dist_c, Tracer(build_clusters(vc, fc)),
                                nl, nb, True, rand)
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tiles = rs.generate_light_tiles(env, dist_cd, T, S, u_t.to(dev))
    got = rs.initial_resampling(to(ctx_c), tiles, env, dist_cd, Tracer(cm_small), nl, nb, True,
                                to(rand))
    torch.cuda.synchronize()
    s = time.perf_counter() - t0
    la = read_counts()
    if got.p is not None or not all(bool(torch.isfinite(x).all()) for x in (got.W, got.dir)):
        raise AssertionError("4k ReSTIR pass on an EnvDistribution: p cached or not finite")
    valid_eq = got.valid.cpu() == ref.valid
    d_ok = (got.dir.cpu() - ref.dir).abs().amax(1) <= RESTIR_PASS_RTOL
    w_ok = (got.W.cpu() - ref.W).abs() <= RESTIR_PASS_RTOL * ref.W.abs() + 1e-7
    share = float((valid_eq & d_ok & w_ok).float().mean())
    res["restir_initial"] = dict(pixels=P, s=s, valid_share=float(ref.valid.float().mean()),
                                 share_within=share, launches=la)
    log("4k samplers: " + json.dumps(res))
    if share < SAMPLER_SHARE or la["dense_occluded"] != 1:
        raise AssertionError(f"4k ReSTIR pass on an EnvDistribution: {res['restir_initial']}")
    return res, la


def serve_viewer(argv, dev):
    """live_viewer.main(argv) in a daemon thread -> (thread, port) once it
    listens."""
    import threading

    from mirres_restir_nerf_mesh_torch.tools import live_viewer

    live_viewer._SERVER_FOR_TEST = None
    th = threading.Thread(target=live_viewer.main, args=(argv,), kwargs={"device": dev},
                          daemon=True)
    th.start()
    deadline = time.time() + 300
    while live_viewer._SERVER_FOR_TEST is None:
        if not th.is_alive() or time.time() > deadline:
            raise AssertionError(f"live_viewer {argv}: no server")
        time.sleep(0.05)
    return th, live_viewer._SERVER_FOR_TEST.server_address[1]


def stop_viewer(th):
    from mirres_restir_nerf_mesh_torch.tools import live_viewer

    live_viewer._SERVER_FOR_TEST.shutdown()
    th.join(timeout=60)
    if th.is_alive():
        raise AssertionError("live_viewer did not stop")


def fetch_jpeg(port, path, dst: Path, hw):
    """GET path from the viewer, decode the JPEG with read_jpeg -> s."""
    import urllib.request

    from mirres_restir_nerf_mesh_torch.utils.image_io import read_jpeg

    t0 = time.perf_counter()
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=600) as r:
        dst.write_bytes(r.read())
    s = time.perf_counter() - t0
    img = read_jpeg(str(dst))
    if img.shape != (hw, hw, 3):
        raise AssertionError(f"live_viewer {path}: decoded {img.shape}")
    return s


def tools_run(cli_kept, colmap_kept, dev, counts):
    """Phase 4k (f): downscale 4i's JPEG frames by 2 (each read back by
    read_jpeg at half size); render_turntable, TURNTABLE_FRAMES frames at
    stage 0 and at stage 1 from 4h's workspace (finite PNGs, the stage-1
    frames' tracer launches); live_viewer on a free port in a thread: the
    page and one /render at stage 0 and at stage 1 from 4h's workspace,
    each decoded by read_jpeg, then --train on the synthetic scene for
    VIEWER_TRAIN_ITERS steps, where the Trainer's step must advance between
    two renders."""
    import tempfile
    import urllib.request

    import numpy as np
    import torch

    from mirres_restir_nerf_mesh_torch.tools import downscale, live_viewer, render_turntable
    from mirres_restir_nerf_mesh_torch.utils.image_io import read_jpeg, read_png

    zero_counts, read_counts = counts
    res = {}
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_tools_")
    base = Path(tmp.name)
    try:
        images = colmap_kept["images"]
        t0 = time.perf_counter()
        downscale.main([str(images), "--scale", "2", "--out", str(base / "half")])
        files = sorted(images.glob("*.jpg"))
        for f in files:
            full, half = read_jpeg(str(f)), read_jpeg(str(base / "half" / f.name))
            if half.shape != (full.shape[0] // 2, full.shape[1] // 2, 3):
                raise AssertionError(f"downscale {f.name}: {half.shape} from {full.shape}")
        res["downscale"] = dict(files=len(files), s=time.perf_counter() - t0)

        ws, scene = cli_kept["ws"], cli_kept["scene"]
        hw = str(TURNTABLE_HW)
        extra = {0: ["--bound", "1", "--scale", "1.0", *TOOLS_WIDTH_FLAGS],
                 1: ["--bound", "1", "--scale", "1.0", "--use_brdf", "--use_restir",
                     "--eval_spp", "0", *TOOLS_WIDTH_FLAGS]}
        for stage in (0, 1):
            torch.cuda.synchronize()
            zero_counts()
            t0 = time.perf_counter()
            render_turntable.main([str(scene), "--workspace", str(ws), "--stage", str(stage),
                                   "--frames", str(TURNTABLE_FRAMES), "--H", hw, "--W", hw,
                                   "--extra", *extra[stage]], device=dev)
            torch.cuda.synchronize()
            s = time.perf_counter() - t0
            la = read_counts()
            frames = [read_png(str(ws / "turntable" / f"frame_{i:04d}.png"))
                      for i in range(TURNTABLE_FRAMES)]
            ok = all(f.shape == (TURNTABLE_HW, TURNTABLE_HW, 3) and f.std() > 0 for f in frames)
            res[f"turntable_stage{stage}"] = dict(frames=len(frames), s=s, launches=la)
            traced = la["queue_trace"] + la["dense_hit"] + la["dense_occluded"]
            if not ok or (stage == 1 and traced == 0) or (stage == 0 and traced):
                raise AssertionError(f"render_turntable stage {stage}: frames ok {ok}, "
                                     f"launches {la}")

        views = {0: TOOLS_WIDTH_FLAGS, 1: ["--use_brdf", "--use_restir", "--spp", "2",
                                          *TOOLS_WIDTH_FLAGS]}
        for stage in (0, 1):
            t0 = time.perf_counter()
            th, port = serve_viewer(["--workspace", str(ws), "--stage", str(stage), "--size",
                                     str(VIEWER_SIZE), "--port", "0", *views[stage]], dev)
            try:
                with urllib.request.urlopen(f"http://127.0.0.1:{port}/", timeout=60) as r:
                    if b"live viewer" not in r.read():
                        raise AssertionError("live_viewer: no page")
                render_s = fetch_jpeg(port, "/render?theta=1.1&phi=0.4&radius=2.2",
                                      base / f"view{stage}.jpg", VIEWER_SIZE)
            finally:
                stop_viewer(th)
            res[f"viewer_stage{stage}"] = dict(s=time.perf_counter() - t0, render_s=render_s)

        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        th, port = serve_viewer(["--workspace", str(base / "ws_train"), "--stage", "0", "--train",
                                 "--iters", str(VIEWER_TRAIN_ITERS), "--size", str(VIEWER_SIZE),
                                 "--port", "0", *TOOLS_WIDTH_FLAGS], dev)
        try:
            tr = live_viewer._TRAINER_FOR_TEST
            fetch_jpeg(port, "/render?theta=1.0&phi=0.2&radius=2.5", base / "train0.jpg",
                       VIEWER_SIZE)
            step_first = tr.global_step
            deadline = time.time() + 600
            while tr.global_step < VIEWER_TRAIN_ITERS and time.time() < deadline:
                time.sleep(0.1)
            fetch_jpeg(port, "/render?theta=1.0&phi=0.2&radius=2.5", base / "train1.jpg",
                       VIEWER_SIZE)
            step_last = tr.global_step
        finally:
            stop_viewer(th)
        torch.cuda.synchronize()
        la = read_counts()
        res["viewer_train"] = dict(s=time.perf_counter() - t0, step_first_render=step_first,
                                   step_second_render=step_last, launches=la)
        if not step_first < step_last == VIEWER_TRAIN_ITERS:
            raise AssertionError(f"live_viewer --train: steps {step_first} -> {step_last}")
        if la["scatter_add"] < K4_STAGE0_LAUNCHES * VIEWER_TRAIN_ITERS:
            raise AssertionError(f"live_viewer --train: launches {la}")
    finally:
        tmp.cleanup()
    log("4k tools: " + json.dumps(res))
    total = {k: sum(r.get("launches", {}).get(k, 0) for r in res.values()) for k in
             read_counts()}
    return res, total


def last_modules_alone(dev, seed, out_dir) -> None:
    """``--last-modules``: 4h and 4i for their workspaces, then 4k."""
    import torch

    from mirres_restir_nerf_mesh_torch.ops.cluster_bvh import build_clusters

    counts = make_counters()
    meshes = {}
    for name, faces in (("bench", BENCH_FACES), ("small", SMALL_FACES)):
        v, f = bench_mesh(faces)
        v, f = torch.as_tensor(v, device=dev), torch.as_tensor(f, device=dev)
        meshes[name] = (v, f, build_clusters(v, f))
    cli_keep, colmap_keep = [], []
    try:
        cli_run(dev, counts, out_dir, keep=cli_keep)
        colmap_run(dev, counts, out_dir, keep=colmap_keep)
        t0 = time.perf_counter()
        res = last_modules_run(dev, counts, meshes, camera(FRAME_HW, FRAME_HW, dev),
                               make_params(meshes["small"][0].shape[0], seed, dev),
                               cli_keep[0], colmap_keep[0], seed)
        log(f"phase 4k: {time.perf_counter() - t0:.1f} s")
        log("4k launches: " + json.dumps(res["launches"]))
        if out_dir is not None:
            (out_dir / "last_modules.json").write_text(json.dumps(res, indent=1))
    finally:
        for k in cli_keep + colmap_keep:
            k["tmp"].cleanup()


def last_modules_run(dev, counts, meshes, cam, params_s, cli_kept, colmap_kept, seed):
    """Phase 4k: (a) the tracer kinds on both meshes; (b) dense_intersect;
    (c) a frame with each kind; (d) render_dump; (e) the samplers and a
    ReSTIR pass on the exact one; (f) the tools.  The counters are zeroed
    before each part's run and read after -> (results, launches by part)."""
    import torch

    zero_counts, read_counts = counts
    gen = torch.Generator(device=dev).manual_seed(seed + 13)
    res, paths = {}, {}
    d_prim = (cam["rays_d"] / cam["rays_d"].norm(dim=-1, keepdim=True)).contiguous()
    ro_prim = cam["rays_o"].contiguous()
    t0 = time.perf_counter()
    for name in ("bench", "small"):
        verts, tris, _ = meshes[name]
        bo, bd = bounce_rays(verts, tris, KINDS_RAYS, gen)
        rays = {"primary": (ro_prim, d_prim, False), "bounce": (bo, bd, True)}
        zero_counts()
        res[f"kinds_{name}"] = check_tracer_kinds(f"{name} mesh", verts, tris, rays, gen)
        paths[f"4k_kinds_{name}"] = read_counts()
    la_s = paths["4k_kinds_small"]
    if la_s["dense_hit"] == 0 or la_s["queue_trace"] or paths["4k_kinds_bench"]["dense_hit"]:
        raise AssertionError(f"4k tracer kinds: launches {paths}: the small mesh's dense pass "
                             "(tile and cluster kinds) must run K3, the bench mesh K1")
    res["kinds_s"] = time.perf_counter() - t0

    vs, fs, cm_small = meshes["small"]
    di, paths["4k_dense_intersect"] = check_dense_intersect(vs, fs, cm_small, ro_prim, d_prim,
                                                            counts)
    res["dense_intersect"] = di
    log("4k dense_intersect: " + json.dumps(di))

    t0 = time.perf_counter()
    res["frames"], paths["4k_frames"] = kinds_frames(vs, fs, params_s, dev, seed, counts)
    res["frames_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    res["dump"], paths["4k_dump"] = dump_run(meshes, cli_kept["field"], dev, seed, counts)
    res["dump_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    res["samplers"], paths["4k_samplers"] = sampler_run(vs, fs, cm_small, dev, seed, counts)
    res["samplers_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    res["tools"], paths["4k_tools"] = tools_run(cli_kept, colmap_kept, dev, counts)
    res["tools_s"] = time.perf_counter() - t0
    res["launches"] = paths
    return res


def check_stage0_reference(seed, dev):
    """Phase 5d: one stage-0 step of a small fp32 field (8 levels of 2^15,
    hidden 32, grid 32, 1024 rays, max_steps 128, 32 samples, compaction to
    8192 points, TV on) on the card against the same step on the CPU, from
    the same state with the same Stage0Randoms (no Monte Carlo decision
    is left once the draws are fixed): loss within 1e-4 relative, each
    gradient leaf (the encoder table included) within 1e-3 relative L2;
    then one occupancy update with the same draws: grid and occupancy equal
    on >= 99.9% of cells."""
    import torch

    from mirres_restir_nerf_mesh_torch.config import Config, finalize
    from mirres_restir_nerf_mesh_torch.data.provider import RayDataset
    from mirres_restir_nerf_mesh_torch.data.synthetic import make_synthetic_frames
    from mirres_restir_nerf_mesh_torch.models.nerf import NeRFSpec
    from mirres_restir_nerf_mesh_torch.ops.occupancy import draw_occupancy
    from mirres_restir_nerf_mesh_torch.train import stage0 as s0

    cfg = finalize(Config(bound=1.0, num_rays=1024, max_steps=128, samples_per_ray=32,
                          grid_size=32, adaptive_num_rays=True, num_points=8192,
                          lambda_tv=1e-8))
    spec = NeRFSpec(bound=1.0, hidden_dim=32, hidden_dim_color=32,
                    grid_levels=STAGE0_CHECK_LEVELS,
                    grid_log2_hashmap_size=15, grid_desired_resolution=128)
    data = make_synthetic_frames(n_frames=8, H=64, W=64, bound=1.0)
    s_cpu, s_gpu = RayDataset(data, 1.0, device="cpu"), RayDataset(data, 1.0, device=dev)
    g = torch.Generator().manual_seed(seed + 4)
    st_c = s0.init_state(g, cfg, spec, device="cpu")
    st_c = s0.make_occ_update(cfg, spec)(st_c, g)
    st_g = s0.TrainState(tree_to(st_c.params, dev), st_c.opt_state, tree_to(st_c.params, dev),
                         type(st_c.occ)(*(x.to(dev) for x in st_c.occ)), st_c.step)
    n_march = s0.march_candidates_for(cfg, s_cpu)
    rnd = s0.draw_stage0_randoms(s_cpu, cfg, n_march, g)
    out = {}
    for name, st, smp, r in (("cpu", st_c, s_cpu, rnd), ("card", st_g, s_gpu, rnd.to(dev))):
        out[name] = s0.loss_and_grads(st.params, st.occ.occ, smp.sample(r.sample), r, cfg, spec,
                                      0, n_march)
    lc, lg = float(out["cpu"][0]), float(out["card"][0])
    grad_rel = [float((a.cpu().double() - b.double()).norm() / max(float(b.double().norm()),
                                                                    1e-300))
                for a, b in zip(out["card"][2], out["cpu"][2])]
    draws = draw_occupancy(st_c.occ, cfg.bound, cfg.stochastic_interp, g)
    occ_c = s0.make_occ_update(cfg, spec)(st_c, draws=draws).occ
    occ_g = s0.make_occ_update(cfg, spec)(st_g, draws=type(draws)(
        *(None if x is None else x.to(dev) for x in draws))).occ
    grid_equal = float((occ_g.density_grid.cpu() == occ_c.density_grid).float().mean())
    grid_close = float(torch.isclose(occ_g.density_grid.cpu(), occ_c.density_grid, rtol=1e-4,
                                     atol=1e-6).float().mean())
    occ_equal = float((occ_g.occ.cpu() == occ_c.occ).float().mean())
    names = [k if isinstance(v, torch.Tensor) else f"{k}.{i}"
             for k, v in sorted(st_c.params.items())
             for i in range(1 if isinstance(v, torch.Tensor) else len(v))]
    res = {"loss_cpu": lc, "loss_card": lg, "loss_rel": abs(lg - lc) / abs(lc),
           "grad_rel_l2": dict(zip(names, grad_rel)),
           "occ_grid_equal_share": grid_equal, "occ_grid_close_share": grid_close,
           "occ_mask_equal_share": occ_equal,
           "occ_mask_cells_differing": int((occ_g.occ.cpu() != occ_c.occ).sum())}
    log("stage-0 reference check (card vs CPU, fp32): " + json.dumps(res))
    fails = ["loss"] if res["loss_rel"] > 1e-4 else []
    fails += [f"grad:{k}" for k, v in res["grad_rel_l2"].items() if not v <= 1e-3]
    fails += ["occupancy grid"] if grid_close < 0.999 else []
    fails += ["occupancy mask"] if occ_equal < 0.999 else []
    if fails:
        raise AssertionError(f"stage-0 reference check failed for {fails}")
    return res


def plant_k4_fault(kind: str, drop):
    """Wrap K4's launch: 'scale' multiplies every update by 1.01, 'drop'
    skips the launches for which drop(idx) holds.  -> a function that
    removes the fault."""
    from mirres_restir_nerf_mesh_torch.ops import scatter

    orig = scatter.scatter_add_into

    def faulty(out, idx, upd):
        if kind == "scale":
            orig(out, idx, upd * 1.01)
        elif not drop(idx):
            orig(out, idx, upd)

    scatter.scatter_add_into = faulty
    return lambda: setattr(scatter, "scatter_add_into", orig)


def every_third():
    """drop rule of phase 5b: the first of every three launches (one
    encode's backward a stage-1 step)."""
    calls = [0]

    def drop(idx):
        calls[0] += 1
        return calls[0] % 3 == 1

    return drop


def planted_fault_run(kind: str, seed: int, dev) -> int:
    """``--plant-k4-fault``: phases 5b and 5d with the fault planted (in
    5d, 'drop' skips the stochastic encode's backward, [P, L] row ids, and
    keeps the TV loss's, whose weight of 1e-8 would hide it).  Exit 0 only
    if 5d fails; 5b's verdict is printed (it passes a 1.01 scale)."""
    import torch

    v_small, f_small = bench_mesh(SMALL_FACES)
    caught = {}
    for phase, drop, run in (
            ("5b", every_third(), lambda: check_train_reference(
                v_small, f_small, torch.as_tensor(v_small, device=dev), seed, dev)),
            ("5d", lambda idx: idx.dim() == 2 and idx.shape[1] == STAGE0_CHECK_LEVELS,
             lambda: check_stage0_reference(seed, dev))):
        undo = plant_k4_fault(kind, drop)
        try:
            run()
            caught[phase] = False
        except AssertionError as e:
            caught[phase] = True
            log(f"planted K4 fault '{kind}' caught by phase {phase}: {e}")
        finally:
            undo()
        if not caught[phase]:
            log(f"planted K4 fault '{kind}' passed phase {phase}")
    return 0 if caught["5d"] else 1


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
                    help="run phases 5b and 5d alone with a fault planted in K4 (updates x "
                         "1.01, or an encode's launch dropped); exit 0 only if 5d fails")
    ap.add_argument("--dp", action="store_true",
                    help="run phase 4j (data parallelism) alone after the build and exit (no "
                         "result line)")
    ap.add_argument("--dp-stage1", type=int, default=0, metavar="N",
                    help="run phase 4j (b) alone N times in one pair of ranks after the build, "
                         "each run gated and its readings printed, and exit (no result line)")
    ap.add_argument("--last-modules", action="store_true",
                    help="run phases 4h and 4i (whose workspaces 4k uses), then 4k alone after "
                         "the build, and exit (no result line)")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs an NVIDIA card",
              file=sys.stderr)
        return 2
    from mirres_restir_nerf_mesh_torch import cuda_build
    from mirres_restir_nerf_mesh_torch.models import envlight
    from mirres_restir_nerf_mesh_torch.ops import scatter, tile_tracer
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
        return planted_fault_run(args.plant_k4_fault, args.seed, dev)
    if args.dp:
        v_big, f_big = bench_mesh(BENCH_FACES)
        dp_run(dev, make_counters(), v_big, f_big, args.seed, out_dir)
        return 0
    if args.dp_stage1:
        return dp_stage1_repeat(dev, *bench_mesh(BENCH_FACES), args.seed, args.dp_stage1)
    if args.last_modules:
        last_modules_alone(dev, args.seed, out_dir)
        return 0

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

    marks = {"t": time.perf_counter()}

    def phase_done(name):
        """Print the seconds since the previous phase ended."""
        now = time.perf_counter()
        log(f"phase {name}: {now - marks['t']:.1f} s")
        marks["t"] = now

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
    zero_counts, read_counts = make_counters()

    # the K2 path: the queue=False entry points, one launch on each batch
    k2_checks = [check_grid("K2 closest, primary", cm_big, cam["rays_o"], d_prim, False, False,
                            640, 256, (zero_counts, read_counts)),
                 check_grid("K2 any, direct shadow", cm_big, so, sd, True, "morton", 640, 64,
                            (zero_counts, read_counts), t_max=st_max)]
    launches_grid = {k: sum(c["path_launches"][k] for c in k2_checks)
                     for k in k2_checks[0]["path_launches"]}
    static = frame_static(f_big, H, W, FRAME_SPP, torch.bfloat16, **BUDGET)
    static_r = frame_static(f_big, H, W, FRAME_SPP, torch.bfloat16, **BUDGET, **RESTIR)
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

    counts = (zero_counts, read_counts)

    def frames_of(st, name, n=TIMED_FRAMES, prm=None, verts=None):
        """bench.time_frames: one warm frame, then n counted and timed ->
        (times, last out, readings, launches)."""
        return time_frames(params if prm is None else prm, st, vb if verts is None else verts,
                           cam, gen, n, counts, name, log)

    def steps_of(st, cfg, name, n=TIMED_STEPS):
        """bench.time_steps: a fresh state, one warm step, then n counted
        and timed -> (times, state, aux, readings, launches, peak GB)."""
        return time_steps(cfg, st, params, vb, topo, cam, gen, n, counts, name, log)

    phase_done("3")
    # ---- 4. the main path: counters zeroed, frames rendered, counters read
    static_s = frame_static(f_small, H, W, FRAME_SPP, torch.bfloat16)
    times, outs, _, launches = frames_of(static, "frame")
    k1_frame = launches["queue_trace"]
    # the small mesh's lighter frame: the dense route, K3 alone
    times_s, out_s, _, launches_s = frames_of(static_s, "small-mesh frame", prm=params_s, verts=vs)
    frame_s = float(statistics.median(times))
    nominal = P * (1 + FRAME_SPP * 6)
    frame = {
        "H": H, "W": W, "spp": FRAME_SPP, "bounces": 2, "triangles": int(f_big.shape[0]),
        "frame_s": frame_s, "frame_s_all": times,
        "nominal_rays_per_frame": nominal,
        "nominal_Mrays_per_s": nominal / frame_s / 1e6,
        "traced_rays_per_frame": float(outs["traced_rays"]),
        "coverage": float(outs["mask"].float().mean()),
        "uncertain_count": float(outs["uncertain_count"]),
        "K1_launches_per_frame": k1_frame / TIMED_FRAMES,
        "launches": launches,
    }
    log("frame: " + json.dumps(frame))
    small = {
        "triangles": int(f_small.shape[0]), "frame_s": float(statistics.median(times_s)),
        "frame_s_all": times_s, "coverage": float(out_s["mask"].float().mean()),
        "uncertain_count": float(out_s["uncertain_count"]),
        "K3_closest_per_frame": launches_s["dense_hit"] / TIMED_FRAMES,
        "K3_any_per_frame": launches_s["dense_occluded"] / TIMED_FRAMES,
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

    phase_done("4")
    # ---- 4b. the lighter train step: counters zeroed, steps taken, counters read
    cfg = train_config(FRAME_SPP)
    topo = build_topology(f_big, v_big.shape[0])
    step_times, state, aux, _, launches_train, peak = steps_of(static, cfg, "train step")
    step_s = float(statistics.median(step_times))
    train = {
        "config": "bench.py train step, use_restir=False, denoise_iters=0",
        "step_s": step_s, "step_s_all": step_times,
        "nominal_Mrays_per_s": nominal / step_s / 1e6,
        "loss": float(aux["loss"]), "psnr": float(aux["psnr"]),
        "psnr_brdf": float(aux["psnr_brdf"]),
        "uncertain_count": float(aux["uncertain_count"]),
        "max_memory_allocated_GB": peak,
        "K4_launches_per_step": launches_train["scatter_add"] / TIMED_STEPS,
        "K1_launches_per_step": launches_train["queue_trace"] / TIMED_STEPS,
        "launches": launches_train,
    }
    log("train step: " + json.dumps(train))
    if args.profile:
        prof_train = profile_train_phases(state, static, vb, topo, cam, cfg, gen, out_dir)
        log("train step profile: " + json.dumps(prof_train))
    if launches_train["scatter_add"] != K4_STEP_LAUNCHES * TIMED_STEPS or \
            launches_train["queue_trace"] <= 0:
        raise AssertionError(f"train step launches: {launches_train} "
                             f"({K4_STEP_LAUNCHES} K4 launches a step expected)")
    del state, aux
    torch.cuda.empty_cache()

    phase_done("4b")
    # ---- 4c. bench.py's own frame: ReSTIR + denoiser, at the bench's count
    size = bench_size()
    nominal_r = P * (1 + FRAME_SPP * RESTIR_RAYS_PER_SPP)
    torch.cuda.reset_peak_memory_stats()
    times_r, out_r, read_rf, launches_rf = frames_of(static_r, "restir frame", size.frames)
    frame_r_s = float(statistics.median(times_r))
    frame_r = {
        "config": "bench.py frame: use_restir=True, denoise_iters=4",
        "frame_s": frame_r_s, "frame_s_all": times_r,
        "nominal_rays_per_frame": nominal_r,
        "nominal_Mrays_per_s": nominal_r / frame_r_s / 1e6,
        "traced_rays_per_frame": float(out_r["traced_rays"]),
        "coverage": float(out_r["mask"].float().mean()),
        "uncertain_count": max(read_rf["uncertain"]),
        "max_memory_allocated_GB": torch.cuda.max_memory_allocated() / 1e9,
        "K1_launches_per_frame": launches_rf["queue_trace"] / size.frames,
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

    phase_done("4c")
    # ---- 4d. bench.py's own train step, at the bench's count
    cfg_r = train_config(FRAME_SPP, use_restir=True)
    step_times_r, state, aux, read_rt, launches_rt, peak_r = steps_of(
        static_r, cfg_r, "restir train step", size.trainsteps)
    step_r_s = float(statistics.median(step_times_r))
    train_r = {
        "config": "bench.py train step: use_restir=True, denoise_iters=4",
        "step_s": step_r_s, "step_s_all": step_times_r,
        "nominal_Mrays_per_s": nominal_r / step_r_s / 1e6,
        "loss": float(aux["loss"]), "psnr": float(aux["psnr"]),
        "psnr_brdf": float(aux["psnr_brdf"]),
        "uncertain_count": float(aux["uncertain_count"]),
        "max_memory_allocated_GB": peak_r,
        "K4_launches_per_step": launches_rt["scatter_add"] / size.trainsteps,
        "K1_launches_per_step": launches_rt["queue_trace"] / size.trainsteps,
        "launches": launches_rt,
    }
    log("restir train step: " + json.dumps(train_r))
    if args.profile:
        prof_rt = profile_train_phases(state, static_r, vb, topo, cam, cfg_r, gen, out_dir,
                                       prefix="restir_train")
        log("restir train step profile: " + json.dumps(prof_rt))
    if launches_rt["scatter_add"] != K4_STEP_LAUNCHES * size.trainsteps or \
            train_r["K1_launches_per_step"] != k1_expected:
        raise AssertionError(f"restir train step launches: {launches_rt} ({K4_STEP_LAUNCHES} "
                             f"K4 and {k1_expected} K1 launches a step expected)")
    del state, aux
    torch.cuda.empty_cache()

    phase_done("4d")
    # ---- 4e. bench.py's ReSTIR frame on the small mesh: the dense route
    times_rs, out_rs, _, launches_rs = frames_of(static_rs, "small-mesh restir frame",
                                                 prm=params_s, verts=vs)
    small_r = {
        "config": "bench.py frame (use_restir=True, denoise_iters=4) on the small mesh",
        "frame_s": float(statistics.median(times_rs)), "frame_s_all": times_rs,
        "coverage": float(out_rs["mask"].float().mean()),
        "uncertain_count": float(out_rs["uncertain_count"]),
        "K3_closest_per_frame": launches_rs["dense_hit"] / TIMED_FRAMES,
        "K3_any_per_frame": launches_rs["dense_occluded"] / TIMED_FRAMES,
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
    torch.cuda.empty_cache()

    phase_done("4e")
    # ---- 4f. bench.py's stage-0 point; then K4 at its step's own launches;
    # then the bench's line from 4c, 4d and 4f
    stage0, k4_calls, s0_levels = stage0_bench(dev, gen, counts, out_dir, args.profile)
    launches_s0 = stage0["launches"]
    k4_stage0 = check_scatter_stage0(k4_calls, s0_levels)
    del k4_calls
    for c in k4_stage0:
        log("K4 scatter_add, stage 0: " + json.dumps(c))
    bench = result_line(card, size, (times_r, read_rf), (step_times_r, read_rt, launches_rt,
                                                         peak_r), stage0)
    log("bench: " + json.dumps(bench))
    fails = check_line(bench, True, FRAME_SPP)
    if fails:
        raise AssertionError("bench: " + "; ".join(fails))
    torch.cuda.empty_cache()
    phase_done("4f")

    # ---- 4g. stage 0 as a user runs it: training, eval render, mesh export
    learn = stage0_learn(dev, gen, (zero_counts, read_counts), out_dir)
    torch.cuda.empty_cache()

    phase_done("4g")
    # ---- 4h. the CLI as a user runs it: stage 0, stage 1, test, albedo_eval
    cli_keep, colmap_keep = [], []
    cli = cli_run(dev, (zero_counts, read_counts), out_dir, keep=cli_keep)
    torch.cuda.empty_cache()
    log(f"stage-0 it/s: {cli['stage0']['it_per_s']:.2f} under the Trainer (4h: -O, "
        f"{cli['stage0']['num_rays_last']} rays at the end, an occupancy update every 16 "
        f"steps), {stage0['it_per_s']:.2f} for the bare step at bench.py's point (4f: 8192 "
        f"rays); stage 1 under the Trainer: {statistics.median(cli['stage1']['stage1_step_s']):.3f}"
        f" s a step (median), route {cli['stage1']['route']}, uncertain_count "
        f"{cli['stage1']['uncertain_count']:.0f}")

    phase_done("4h")
    # ---- 4i. the "your dataset" recipe: a COLMAP workspace through the CLI
    colmap = colmap_run(dev, (zero_counts, read_counts), out_dir, keep=colmap_keep)
    torch.cuda.empty_cache()
    log(f"colmap: stage 0 {colmap['stage0']['it_per_s']:.2f} it/s under the Trainer, val PSNR "
        f"{colmap['stage0']['val_psnr']:.2f}, sparse-depth branch in "
        f"{colmap['stage0']['sparse_steps']} of {colmap['stage0']['draws']} steps; stage 1 "
        f"{statistics.median(colmap['stage1']['stage1_step_s']):.3f} s a step (median), route "
        f"{colmap['stage1']['route']}; read_jpeg "
        f"{colmap['read_jpeg']['room with noise of 8 counts']['s_per_MP']:.3f} s a megapixel "
        f"(photo-like); DPT {colmap['dpt']['ms_per_frame fp32 (TF32 off)']:.1f} ms a frame")

    phase_done("4i")
    # ---- 4j. data parallelism: one rank against two on this card; torchrun
    dp = dp_run(dev, (zero_counts, read_counts), v_big, f_big, args.seed, out_dir)
    torch.cuda.empty_cache()

    phase_done("4j")
    # ---- 4k. the last modules: tracer kinds, dense_intersect, a frame with
    # each kind, render_dump, the exact and alias samplers, the tools
    try:
        last = last_modules_run(dev, (zero_counts, read_counts),
                                {"bench": (vb, fb, cm_big), "small": (vs, fs, cm_small)}, cam,
                                params_s, cli_keep[0], colmap_keep[0], args.seed)
    finally:
        for k in cli_keep + colmap_keep:
            k["tmp"].cleanup()
        del cli_keep, colmap_keep
    torch.cuda.empty_cache()

    phase_done("4k")
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

    phase_done("5")
    # ---- 5b. reference check: one train step, card vs CPU
    agree_train = check_train_reference(v_small, f_small, vs, args.seed, dev)

    phase_done("5b")
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

    phase_done("5c")
    # ---- 5d. reference check: one stage-0 step and occupancy update
    agree_stage0 = check_stage0_reference(args.seed, dev)

    phase_done("5d")
    # ---- 6. results.  K1's headline is the direct-shadow batch, the shape of
    # 64 of the 69 launches of the lighter frame (the spatial cross-visibility
    # check is 32 of the ReSTIR frame's 37); K2's is the primary rays.
    k1, k2 = k1_checks[3], k2_checks[0]
    paths = {"frame": launches, "small_frame": launches_s, "train_step": launches_train,
             "restir_frame": launches_rf, "restir_train_step": launches_rt,
             "small_restir_frame": launches_rs, "grid_trace_path": launches_grid,
             "stage0_step": launches_s0, "stage0_learning": learn["launches"],
             "stage0_export": learn["export"]["launches"],
             "cli_stage0": cli["stage0"]["launches"], "cli_stage1": cli["stage1"]["launches"],
             "cli_test": cli["test"]["launches"], "colmap_stage0": colmap["stage0"]["launches"],
             "colmap_stage1": colmap["stage1"]["launches"],
             "colmap_test": colmap["test"]["launches"], **dp["launches"], **last["launches"]}
    # K3's headlines: the primary rays (closest), the direct-shadow batch
    # (any hit: 64 of the lighter small-mesh frame's 66 any-hit launches)
    k3c, k3a = k3_checks[0], k3_checks[3]
    di = last["dense_intersect"]
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
        dict(name="dense_hit (K3, closest hit) on a bare mesh: dense_intersect", route="cuda",
             source="mirres_restir_nerf_mesh_torch/csrc/dense_hit.cu",
             replaces="mirres_restir_nerf_mesh_tpu/ops/pallas_tracer.py:40",
             launches=paths["4k_dense_intersect"]["dense_hit"],
             launches_by_path={"4k_dense_intersect": paths["4k_dense_intersect"]["dense_hit"]},
             max_abs_err=0.0, ms=di["ms"], device_ms=di["device_ms"], split=di["split"],
             plain_ms=di["plain_ms"], bound_ms=di["bound_ms"], bound_by=di["bound_by"],
             issue_floor_ms=di["issue_floor_ms"], library_ms=None, checks=[di]),
        dict(name="scatter_add (K4)", route="cuda",
             source="mirres_restir_nerf_mesh_torch/csrc/scatter_add.cu",
             replaces="mirres_restir_nerf_mesh_tpu/ops/pallas_scatter.py:37",
             **by_path("scatter_add"), max_abs_err=k4["max_abs_err"],
             ms=k4["ms"], device_ms=k4["device_ms"], plain_ms=k4["plain_ms"],
             bound_ms=k4["bound_ms"], bound_by=k4["bound_by"], library_ms=k4["library_ms"],
             library_device_ms=k4["library_device_ms"], checks=[k4]),
    ]
    # K4's stage-0 rows: each shape is one of the K4_STAGE0_LAUNCHES launches
    # of every step of phase 4f
    for c in k4_stage0:
        kernels.append(dict(
            name=f"scatter_add (K4), stage-0 {c['what']}", route="cuda",
            source="mirres_restir_nerf_mesh_torch/csrc/scatter_add.cu",
            replaces="mirres_restir_nerf_mesh_tpu/ops/pallas_scatter.py:37",
            launches=launches_s0["scatter_add"] // K4_STAGE0_LAUNCHES,
            launches_by_path={"stage0_step": launches_s0["scatter_add"] // K4_STAGE0_LAUNCHES},
            max_abs_err=c["max_abs_err"], ms=c["ms"], device_ms=c["device_ms"],
            plain_ms=c["plain_ms"], bound_ms=c["bound_ms"], bound_by=c["bound_by"],
            library_ms=c["library_ms"], library_device_ms=c["library_device_ms"], checks=[c]))
    if out_dir is not None:
        (out_dir / "chip_smoke.json").write_text(json.dumps(
            {"card": card, "build_s": build_s, "kernels": kernels, "frame": frame,
             "small_frame": small, "small_restir_frame": small_r, "train_step": train, "restir_frame": frame_r, "restir_train_step": train_r,
             "reference_check": agree,
             "train_reference_check": agree_train, "restir_reference_check": agree_restir,
             "stage0_step": stage0, "stage0_learning": learn, "cli": cli, "colmap": colmap,
             "dp": dp, "last_modules": last,
             "stage0_reference_check": agree_stage0},
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
