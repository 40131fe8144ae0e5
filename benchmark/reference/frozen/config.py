"""Typed configuration (a copy of the port's ``config.py``, cut to the
fields the reference reads: the flags of the benchmark's configurations,
the training and rendering options the one-card steps take, and what
:func:`finalize` derives).  Preset expansion (`-O`, `--sdf`, `--contract`,
`--wo_smooth`) is performed by :func:`finalize`, with the upstream
project's defaults.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass
class Config:
    O: bool = False  # noqa: E741 - recommended-settings preset flag, kept for CLI parity
    seed: int = 0
    stage: int = 0
    fp16: bool = False            # on TPU this means bfloat16 compute
    sdf: bool = False
    progressive_level: bool = False
    preload: bool = False
    random_image_batch: bool = False
    bound: float = 2.0
    scale: float = -1.0
    min_near: float = 0.05
    enable_sparse_depth: bool = False

    # --- training options ---
    iters: int = 7500
    lr: float = 1e-2
    lr_vert: float = 1e-4
    # stage-1 pixel-chunked training: train on a band of this many image rows
    # per step instead of the full frame (0 = full frame).  Keeps the
    # image-space ReSTIR/denoise/antialias passes intact within the band;
    # bands cycle across steps.  Memory fallback for 800^2 x spp 32 frames.
    stage1_rows: int = 0
    max_steps: int = 1024
    update_extra_interval: int = 16
    grid_size: int = 128
    # hash-encoder size knobs (reference tcnn config is fixed at 16L/2^19,
    # gridencoder/grid.py; exposed here for small-scale runs and tests)
    hash_levels: int = 16
    hash_log2_size: int = 19
    hash_max_res: int = 0         # 0 -> 2048 * bound
    mark_untrained: bool = False
    dt_gamma: float = 1.0 / 256.0
    density_thresh: float = 10.0
    background: str = "white"     # white | random
    enable_offset_nerf_grad: bool = False

    # batch size related
    num_rays: int = 4096
    adaptive_num_rays: bool = False
    num_points: int = 2 ** 18

    # TPU-specific static-shape knobs (no reference equivalent: fixed-capacity
    # replacement for CUDA dynamic point allocation, SURVEY.md §7 hard-part 1)
    samples_per_ray: int = 64     # K: compacted samples per ray (train)
    samples_per_ray_infer: int = 96
    # unbiased one-corner hash-grid estimator on the training path (8x fewer
    # memory transactions on TPU; eval always uses exact trilinear)
    stochastic_interp: bool = True

    lambda_entropy: float = 0.0
    lambda_tv: float = 1e-8
    lambda_depth: float = 0.1
    lambda_eikonal: float = 0.1
    lambda_rgb: float = 1.0
    lambda_mask: float = 0.1

    # --- stage 1 regularizations ---
    wo_smooth: bool = False
    lambda_lpips: float = 0.0
    lambda_offsets: float = 0.1
    lambda_lap: float = 0.001
    lambda_normal: float = 0.0
    lambda_edgelen: float = 0.0

    # --- brdf / restir part ---
    use_brdf: bool = False
    use_restir: bool = False
    use_bi_de: bool = False
    learning_rate_mat: float = 0.03
    learning_rate_lgt: float = 0.09
    lambda_rgb_brdf: float = 0.02
    lambda_brdf_diffuse: float = 0.0015
    lambda_brdf_specular: float = 0.000025
    lambda_kd: float = 0.005
    lambda_ks: float = 0.0025
    lambda_nrm: float = 0.00025
    lambda_chroma: float = 0.0
    spp: int = 32
    roughness_min: float = 0.08
    me_max: float = 0.0
    env_h: int = 256
    env_w: int = 512
    lambda_extra_kd: float = 0.0

    # misc
    contract: bool = False
    mesh_visibility_culling: bool = False

    # stage 1 raster / refine
    ssaa: int = 2
    refine: bool = False
    refine_steps_ratio: Tuple[float, ...] = (0.1, 0.2, 0.3, 0.4, 0.5, 0.7)
    refine_size: float = 0.01
    refine_decimate_ratio: float = 0.1

    # --- ReSTIR kernel configuration (reference renderer_restir.py:151-181) ---
    restir_light_tile_count: int = 128
    restir_light_tile_size: int = 1024
    restir_initial_light_samples: int = 32
    restir_initial_brdf_samples: int = 1
    restir_spatial_neighbors: int = 5
    restir_spatial_radius: float = 30.0
    restir_neighbor_offset_count: int = 8192
    restir_max_history_length: int = 20
    pt_bounces: int = 2           # indirect bounces (reference FinalShading.slang:7)
    compact_chunks: int = 4       # live-lane compaction chunks for stage-1
                                  # per-pixel passes (utils/compact.py); 1 = off

    # scene AABB override (e.g. from COLMAP sparse points,
    # reference main.py:279-280 model.update_aabb); None = [-bound, bound]^3
    scene_aabb: Optional[Tuple[float, ...]] = None

    # derived (filled by finalize)
    kd_min: Tuple[float, ...] = (0.0, 0.0, 0.0, 0.0)
    kd_max: Tuple[float, ...] = (1.0, 1.0, 1.0, 1.0)
    ks_min: Tuple[float, ...] = (0.0, 0.08, 0.0)
    ks_max: Tuple[float, ...] = (0.0, 1.0, 0.0)
    light_probe_res_hw: Tuple[int, int] = (256, 512)
    refine_steps: Tuple[int, ...] = ()
    real_bound: float = 2.0
    cascade: int = 1


def finalize(cfg: Config) -> Config:
    """Expand presets and derived fields (reference main.py:159-227)."""
    cfg = dataclasses.replace(cfg)

    cfg.kd_min = (0.0, 0.0, 0.0, 0.0)
    cfg.kd_max = (1.0, 1.0, 1.0, 1.0)
    cfg.ks_min = (0.0, cfg.roughness_min, 0.0)
    cfg.ks_max = (0.0, 1.0, cfg.me_max)
    cfg.light_probe_res_hw = (cfg.env_h, cfg.env_w)

    if cfg.O:
        cfg.fp16 = True
        cfg.preload = True
        cfg.mark_untrained = True
        cfg.random_image_batch = True
        cfg.mesh_visibility_culling = True
        cfg.adaptive_num_rays = True
        cfg.refine = False

    if cfg.sdf:
        cfg.density_thresh = 0.001
        if cfg.stage == 0:
            cfg.progressive_level = True
        if cfg.bound > 1:
            cfg.contract = True
        cfg.enable_offset_nerf_grad = True
        cfg.refine_decimate_ratio = 0.0
        cfg.refine_size = 0.0

    if cfg.contract:
        cfg.mark_untrained = False

    if cfg.wo_smooth:
        cfg.lambda_offsets = 0.0
        cfg.lambda_lap = 0.0
        cfg.lambda_normal = 0.0

    if cfg.enable_sparse_depth:
        cfg.random_image_batch = False

    cfg.refine_steps = tuple(int(round(x * cfg.iters)) for x in cfg.refine_steps_ratio)

    # scene cascades: bound>1 uses 1 + ceil(log2(bound)) mip levels
    # (reference renderer.py:97)
    import math

    cfg.real_bound = cfg.bound
    if cfg.contract:
        cfg.bound = 2.0
    cfg.cascade = 1 + max(0, math.ceil(math.log2(cfg.real_bound))) if cfg.real_bound > 1 else 1

    return cfg
