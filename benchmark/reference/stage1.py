"""The reference's stage-1 training: the first steps of the cell from the
seed, as the program's Trainer takes them (its generator seeded with the
run's seed draws the radiance field, then the material field, then each
step's frame randoms; the views cycle; the initial environment map and
the tracer budgets are the configuration's), in the frozen copy, with the
program's tracer answers replayed and judged."""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch

from .flags import reference_config
from .frozen.data.provider import FrameData, RayDataset, compute_mvps
from .frozen.models.material import MaterialSpec
from .frozen.models.nerf import NeRFSpec, init_nerf
from .frozen.ops.tracer import replaying
from .frozen.precision import lowered
from .frozen.render.stage1 import Stage1Static, draw_frame_randoms
from .frozen.train import stage1 as s1
from .frozen.train.losses import build_topology
from .replay import Replay

B1 = 0.9


def norms(leaves: List[torch.Tensor]) -> List[float]:
    return [float(torch.linalg.vector_norm(x.detach().double())) for x in leaves]


def nerf_spec(cfg) -> NeRFSpec:
    return NeRFSpec(bound=cfg.bound, sdf=cfg.sdf,
                    compute_dtype=torch.bfloat16 if cfg.fp16 else torch.float32,
                    grid_levels=cfg.hash_levels, grid_log2_hashmap_size=cfg.hash_log2_size,
                    grid_desired_resolution=cfg.hash_max_res)


def frames(scene: Dict, cfg) -> FrameData:
    return FrameData(images=scene["images"], poses=scene["poses"],
                     intrinsics=scene["intrinsics"], H=scene["H"], W=scene["W"],
                     mvps=compute_mvps(scene["poses"], scene["intrinsics"], scene["H"],
                                       scene["W"], cfg.bound))


def static_of(cfg, tris: torch.Tensor, H: int, W: int, budgets: Dict) -> Stage1Static:
    """The Trainer's stage-1 static (its ``_init_stage1``), with the
    configuration's tracer budgets."""
    ssaa = max(int(cfg.ssaa), 1)
    mat_spec = MaterialSpec(bound=cfg.bound, min_vals=tuple(cfg.kd_min[:3]) + tuple(cfg.ks_min),
                            max_vals=tuple(cfg.kd_max[:3]) + tuple(cfg.ks_max),
                            compute_dtype=torch.bfloat16 if cfg.fp16 else torch.float32)
    st = Stage1Static(
        tris=tris, nerf_spec=nerf_spec(cfg), mat_spec=mat_spec, spp=cfg.spp,
        bounces=cfg.pt_bounces, use_restir=cfg.use_restir, H=H * ssaa, W=W * ssaa,
        restir_tiles=cfg.restir_light_tile_count, restir_tile_size=cfg.restir_light_tile_size,
        restir_light_samples=cfg.restir_initial_light_samples,
        restir_brdf_samples=cfg.restir_initial_brdf_samples,
        restir_neighbors=cfg.restir_spatial_neighbors, restir_radius=cfg.restir_spatial_radius,
        restir_offsets=cfg.restir_neighbor_offset_count,
        restir_history=float(cfg.restir_max_history_length),
        denoise_iters=4 if cfg.use_restir else 0, denoise_bilateral=cfg.use_bi_de,
        enable_offset_nerf_grad=cfg.enable_offset_nerf_grad,
        compute_normal_ao=cfg.use_brdf and cfg.lambda_extra_kd > 0, ssaa=ssaa,
        compact_chunks=cfg.compact_chunks)
    return dataclasses.replace(st, **budgets) if budgets else st


def run(config: Dict, scene: Dict, records: List[Dict], seed: int, steps: int, device,
        fp8: bool = False, sample: int = 128) -> Dict:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    cfg = reference_config(config, seed)
    if int(cfg.stage1_rows) != 0:
        raise ValueError("the reference follows whole frames (stage1_rows 0)")
    g = torch.Generator(device=dev).manual_seed(cfg.seed)
    sampler = RayDataset(frames(scene, cfg), bound=cfg.bound, background=cfg.background,
                         device=dev)
    base = np.asarray(scene["verts"], np.float32)
    tris_np = np.asarray(scene["tris"], np.int32)
    topo = build_topology(tris_np, base.shape[0])
    base_t, tris_t = torch.as_tensor(base, device=dev), torch.as_tensor(tris_np, device=dev)
    static = static_of(cfg, tris_t, scene["H"], scene["W"], config.get("tracer_budgets", {}))
    nerf = init_nerf(g, static.nerf_spec, device=dev)
    state = s1.init_state(g, cfg, static, nerf, base.shape[0], device=dev)
    state = state._replace(params=state.params._replace(
        env=torch.as_tensor(scene["env"], device=dev)))
    step = s1.make_train_step(cfg, static, base_t, topo)
    leaves0 = {k: [x.clone() for x in v] for k, v in s1.group_leaves(state.params).items()}
    replay = Replay(records, seed, sample)
    losses, out = [], {}
    n_frames = sampler.data.num_frames
    with replaying(replay), lowered(fp8):
        for k in range(steps):
            f = sampler.frame_rays(k % n_frames, ssaa=static.ssaa)
            batch = {key: f[key] for key in ("rays_o", "rays_d", "pixels", "alpha")}
            rand = draw_frame_randoms(batch["rays_o"].shape[0], static, g, dev)
            state, aux = step(state, batch, rand=rand)
            losses.append(float(aux["loss"]))
            if k == 0:
                out["grad_norms"] = {k2: norms([mu / (1 - B1) for mu in st.mu])
                                     for k2, st in state.opt_state.items()}
    if not replay.done():
        raise RuntimeError(f"the program made {len(records)} tracer calls, the reference "
                           f"{replay.pos}")
    after = s1.group_leaves(state.params)
    out["change_norms"] = {k: norms([a - b for a, b in zip(after[k], leaves0[k])]) for k in after}
    out["losses"] = losses
    out["hits_wrong_share"] = replay.wrong_share("intersect")
    out["occlusions_wrong_share"] = replay.wrong_share("occluded")
    out["tracer_checked"] = dict(replay.checked)
    out["tracer_uncertain_share"] = {k: replay.uncertain_share(k) for k in replay.live}
    out["tracer_uncertain_sampled"] = replay.uncertain_tally()
    return out
