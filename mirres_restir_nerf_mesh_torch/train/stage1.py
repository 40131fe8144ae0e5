"""Stage-1 trainer: joint mesh / material / environment optimization
(counterpart of mirres_restir_nerf_mesh_tpu/train/stage1.py).

- Five Adam groups, as the reference's optax.multi_transform:

  | group   | params            | lr                 | eps   | gradient pre-scale |
  |---------|-------------------|--------------------|-------|--------------------|
  | net     | NeRF              | lr * sched         | 1e-15 | -                  |
  | vert    | vertex offsets    | lr_vert * sched    | 1e-15 | -                  |
  | mat     | material MLP      | 0.03 * falloff     | 1e-8  | -                  |
  | mat_enc | material encoder  | 0.03 * falloff     | 1e-8  | x 1/8              |
  | light   | envmap            | 0.09 * falloff     | 1e-8  | x 64               |

  The pre-scale multiplies the gradient before Adam (it matters only
  because eps is fixed).  As optax, the lr is taken at the group's count
  before the increment while the bias corrections use count + 1, every
  leaf steps (a leaf without a gradient takes a zero one), and the update
  is functional: a step returns new tensors and leaves its input state as
  it was.  The envmap is clamped to >= 0.01 after each update.
- Loss: NeRF-rgb MSE + BRDF L1 + mask (+ LPIPS on the full frame, for
  both images) + monochrome shading + material
  smoothness (+ AO-weighted albedo smoothness, + chroma) + Laplacian /
  normal-consistency / edge / offsets
  regularizers; per-face error sums for the refine hook.
- Data parallelism (``static.dp``): each rank renders its band of whole
  rows (``render.stage1.frame_band``) from the whole frame's randoms; the
  loss is the one-device loss on every rank (pixel means over the frame
  through ``parallel.mesh.global_mean``, LPIPS on the gathered frame, the
  mesh regularizers whole), each rank back-propagates 1/R of it and the
  gradients are summed over the ranks; face_err / face_cnt and
  uncertain_count are summed too.

Optimizer state layout: ``{group: AdamState(count, mu, nu)}`` where mu and
nu list the group's leaves in ``group_leaves`` order, which is the order of
the reference's ``jax.tree.leaves`` over that group.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import functools

import torch

from ..config import Config
from ..device import resolve_device
from ..models import envlight
from ..models import material as material_mod
from ..parallel import mesh as pmesh
from ..render.stage1 import (FrameRandoms, Stage1Params, Stage1Static, frame_band, full_frame,
                             render_stage1)
from ..utils.profiling import count, span
from . import losses as L
from .stage0 import AdamState, adam_init, adam_update, lr_schedule, tree_leaves, tree_unflatten

GROUPS = ("net", "vert", "mat", "mat_enc", "light")


class Stage1State(NamedTuple):
    params: Stage1Params
    opt_state: Dict[str, AdamState]
    step: torch.Tensor           # int32 scalar


def group_leaves(params: Stage1Params) -> Dict[str, List[torch.Tensor]]:
    return {"net": tree_leaves(params.nerf), "vert": [params.offsets],
            "mat": tree_leaves(params.mat["net"]), "mat_enc": [params.mat["encoder"]],
            "light": [params.env]}


def params_from_groups(like: Stage1Params, groups: Dict[str, List[torch.Tensor]]) -> Stage1Params:
    (offsets,), (enc,), (env,) = groups["vert"], groups["mat_enc"], groups["light"]
    mat_net = tree_unflatten(like.mat["net"], iter(groups["mat"]))
    return Stage1Params(nerf=tree_unflatten(like.nerf, iter(groups["net"])), offsets=offsets,
                        mat={**like.mat, "encoder": enc, "net": mat_net}, env=env)


def brdf_lr_falloff(step) -> torch.Tensor:
    """10^(-2e-4 * step): 1.0 -> 0.1 over 5k steps (float32)."""
    s = torch.as_tensor(step, dtype=torch.int32)
    return torch.clamp_min(10.0 ** (-s * 2e-4), 0.0)


class GroupSpec(NamedTuple):
    lr: Callable[[torch.Tensor], torch.Tensor]
    eps: float
    pre_scale: float


class Stage1Optimizer:
    """The five Adam groups; ``init(params)`` -> state, ``step(params, grads,
    state)`` -> (params, state), grads as ``group_leaves`` gives them."""

    def __init__(self, cfg: Config):
        sched = lr_schedule(cfg)
        mat_lr = lambda s: cfg.learning_rate_mat * brdf_lr_falloff(s)  # noqa: E731
        self.groups = {
            "net": GroupSpec(lambda s: cfg.lr * sched(s), 1e-15, 1.0),
            "vert": GroupSpec(lambda s: cfg.lr_vert * sched(s), 1e-15, 1.0),
            "mat": GroupSpec(mat_lr, 1e-8, 1.0),
            "mat_enc": GroupSpec(mat_lr, 1e-8, 1.0 / 8.0),
            "light": GroupSpec(lambda s: cfg.learning_rate_lgt * brdf_lr_falloff(s), 1e-8, 64.0),
        }

    def init(self, params: Stage1Params) -> Dict[str, AdamState]:
        return {g: adam_init(leaves) for g, leaves in group_leaves(params).items()}

    def step(self, params: Stage1Params, grads: Dict[str, List[Optional[torch.Tensor]]],
             state: Dict[str, AdamState]) -> Tuple[Stage1Params, Dict[str, AdamState]]:
        new_leaves, new_state = {}, {}
        for g, leaves in group_leaves(params).items():
            spec = self.groups[g]
            new_leaves[g], new_state[g] = adam_update(leaves, grads[g], state[g], spec.lr,
                                                      spec.eps, spec.pre_scale)
        return params_from_groups(params, new_leaves), new_state


def make_optimizer(cfg: Config) -> Stage1Optimizer:
    return Stage1Optimizer(cfg)


def init_state(generator: Optional[torch.Generator], cfg: Config, static: Stage1Static,
               nerf_params: Any, num_verts: int, device="cuda") -> Stage1State:
    """Zero offsets, a fresh material field (from ``generator``), the
    constant envmap, zeroed Adam state."""
    params = Stage1Params(
        nerf=nerf_params,
        offsets=torch.zeros((num_verts, 3), dtype=torch.float32, device=resolve_device(device)),
        mat=material_mod.init_material(generator, static.mat_spec, device=device),
        env=envlight.init_envlight(cfg.env_h, cfg.env_w, device=device),
    )
    return Stage1State(params, make_optimizer(cfg).init(params), torch.zeros((), dtype=torch.int32))


def _psnr(a: torch.Tensor, b: torch.Tensor, mean=torch.mean) -> torch.Tensor:
    return -10.0 * torch.log10(torch.clamp_min(mean((a - b) ** 2), 1e-12))


def stage1_loss(params: Stage1Params, static: Stage1Static, base_verts: torch.Tensor,
                topo: L.MeshTopology, batch: Dict[str, torch.Tensor], cfg: Config,
                generator: Optional[torch.Generator] = None,
                rand: Optional[FrameRandoms] = None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """-> (loss, aux); aux holds detached values.  With ``static.dp`` the
    batch is this rank's band (``band_batch``), rand the whole frame's, and
    the loss and aux are the whole frame's, equal on every rank."""
    out = render_stage1(params, static, base_verts, batch["rays_o"], batch["rays_d"],
                        generator=generator, rand=rand)
    band = frame_band(static, gt=True)
    mean = functools.partial(pmesh.global_mean, shard=band)

    # SSAA: render_stage1 ran at (H, W) = ssaa x the GT size; box-downsample
    s = static.ssaa if static.ssaa > 1 and static.H > 0 else 1
    Ws = static.W // s if s > 1 else 0
    Hs = out["image"].shape[0] // (s * static.W) if s > 1 else 0     # the frame's or band's rows
    if s > 1:
        def down(x):
            return x.reshape(Hs, s, Ws, s, -1).mean(dim=(1, 3)).reshape(Hs * Ws, -1)

        for k in ("image", "image_brdf", "diffuse_light", "specular_light", "img_brdf_indirect"):
            out[k] = down(out[k])
        out["weights_sum"] = down(out["weights_sum"][:, None])[:, 0]

    gt = batch["pixels"]
    gt_linear = batch.get("pixels_linear", gt)
    loss = cfg.lambda_rgb * mean((out["image"] - gt) ** 2)
    if cfg.use_brdf:
        loss = loss + cfg.lambda_rgb_brdf * mean(torch.abs(out["image_brdf"] - gt))
    if cfg.lambda_mask > 0 and "alpha" in batch:
        loss = loss + cfg.lambda_mask * mean((out["weights_sum"] - batch["alpha"]) ** 2)
    if cfg.lambda_lpips > 0 and static.H > 0:
        # perceptual loss on the full frame, for the NeRF and the BRDF image
        from .lpips import default_params, lpips_distance

        lp_params, _ = default_params(cfg.lpips_weights, gt.device)
        Hg, Wg = static.H // s, static.W // s
        img_f, brdf_f, gt_f = full_frame(band, out["image"], out["image_brdf"], gt)
        gt_img = gt_f.reshape(Hg, Wg, 3)
        loss = loss + cfg.lambda_lpips * lpips_distance(lp_params, img_f.reshape(Hg, Wg, 3),
                                                        gt_img)
        if cfg.use_brdf:
            loss = loss + cfg.lambda_lpips * lpips_distance(
                lp_params, brdf_f.reshape(Hg, Wg, 3), gt_img)
    if cfg.use_brdf:
        loss = loss + L.shading_loss(out["diffuse_light"], out["specular_light"],
                                     gt_linear - out["img_brdf_indirect"],
                                     cfg.lambda_brdf_diffuse, cfg.lambda_brdf_specular, mean)
        loss = loss + L.material_smoothness_grad(out["kd_grad"], out["ks_grad"],
                                                 out["normal_grad"], cfg.lambda_kd,
                                                 cfg.lambda_ks, cfg.lambda_nrm, mean)
        if cfg.lambda_extra_kd > 0 and "normal_ao" in out:
            # AO-weighted albedo smoothness
            kd_luma = torch.mean(out["kd_grad"], dim=-1)
            loss = loss + cfg.lambda_extra_kd * mean(kd_luma * out["normal_ao"])
        if cfg.lambda_chroma > 0:
            loss = loss + L.chroma_loss(out["kd"], gt, cfg.lambda_chroma, mean)

    verts = base_verts + params.offsets
    if cfg.lambda_lap > 0:
        loss = loss + cfg.lambda_lap * L.laplacian_smooth_loss(verts, topo)
    if cfg.lambda_normal > 0:
        loss = loss + cfg.lambda_normal * L.normal_consistency_loss(verts, static.tris, topo)
    if cfg.lambda_edgelen > 0:
        loss = loss + cfg.lambda_edgelen * L.edge_length_loss(verts, topo)
    if cfg.lambda_offsets > 0:
        loss = loss + cfg.lambda_offsets * L.offsets_loss(params.offsets)

    # per-face error sums for the refine hook (misses go to a dropped slot)
    with torch.no_grad():
        n_faces = int(static.tris.shape[0])
        pix_err = torch.mean(torch.abs(out["image"] - gt), dim=-1)
        if s > 1:   # back onto the supersampled lattice where face ids live
            pix_err = pix_err.reshape(Hs, Ws).repeat_interleave(s, 0).repeat_interleave(s, 1)
            pix_err = pix_err.reshape(-1)
        mask = out["mask"]
        fid = torch.where(mask, out["face_id"], n_faces).long()
        zeros = torch.zeros((n_faces + 1,), dtype=torch.float32, device=mask.device)
        face_err = zeros.index_add(0, fid, torch.where(mask, pix_err, 0.0))[:n_faces]
        face_cnt = zeros.index_add(0, fid, mask.to(torch.float32))[:n_faces]
        uncertain = out["uncertain_count"]
        if band is not None:
            face_err, face_cnt = pmesh.all_reduce(face_err, band.dp), pmesh.all_reduce(face_cnt,
                                                                                      band.dp)
            uncertain = pmesh.all_reduce(torch.as_tensor(uncertain, dtype=torch.float32),
                                         band.dp)
        aux = {"loss": loss.detach(), "uncertain_count": uncertain,
               "psnr": _psnr(out["image"], gt, mean), "psnr_brdf": _psnr(out["image_brdf"], gt,
                                                                         mean),
               "face_err": face_err, "face_cnt": face_cnt}
    return loss, aux


def loss_and_grads(params: Stage1Params, static: Stage1Static, base_verts: torch.Tensor,
                   topo: L.MeshTopology, batch: Dict[str, torch.Tensor], cfg: Config,
                   generator: Optional[torch.Generator] = None,
                   rand: Optional[FrameRandoms] = None):
    """-> (loss, aux, grads): ``stage1_loss`` and its gradient with respect to
    every leaf, as ``{group: [grad or None]}`` in ``group_leaves`` order
    (None: the loss does not depend on the leaf).  With ``static.dp``: this
    rank's part of the gradient (1/R of the loss back-propagated), to be
    summed over the ranks."""
    groups = {g: [x.detach().requires_grad_(True) for x in leaves]
              for g, leaves in group_leaves(params).items()}
    with span("forward"):
        loss, aux = stage1_loss(params_from_groups(params, groups), static, base_verts, topo,
                                batch, cfg, generator, rand)
    scaled = loss if static.dp is None else loss / static.dp.world
    with span("backward"):
        got = iter(torch.autograd.grad(scaled, [x for g in GROUPS for x in groups[g]],
                                       allow_unused=True))
    return loss.detach(), aux, {g: [next(got) for _ in groups[g]] for g in GROUPS}


def band_batch(batch: Dict[str, torch.Tensor], static: Stage1Static) -> Dict[str, torch.Tensor]:
    """This rank's band of a whole-frame batch: the rays at the render size,
    the GT pixels (pixels, pixels_linear, alpha) at the GT size."""
    rb, gb = frame_band(static), frame_band(static, gt=True)
    return {k: v[rb.lo:rb.hi] if k.startswith("rays") else v[gb.lo:gb.hi]
            for k, v in batch.items()}


def make_train_step(cfg: Config, static: Stage1Static, base_verts, topo: L.MeshTopology):
    """-> ``train_step(state, batch, generator=None, rand=None) -> (state, aux)``:
    loss and gradients of every leaf, the five Adam groups, the envmap clamp.
    With ``static.dp``: batch and rand are the whole frame's; the rank
    renders its band and the gradients are summed over the ranks."""
    opt = make_optimizer(cfg)

    def train_step(state: Stage1State, batch: Dict[str, torch.Tensor],
                   generator: Optional[torch.Generator] = None,
                   rand: Optional[FrameRandoms] = None) -> Tuple[Stage1State, Dict[str, Any]]:
        count("steps.stage1")
        bv = torch.as_tensor(base_verts, device=batch["rays_o"].device)
        if static.dp is not None:
            batch = band_batch(batch, static)
        _, aux, grads = loss_and_grads(state.params, static, bv, topo, batch, cfg, generator,
                                       rand)
        if static.dp is not None:
            with span("allreduce"):
                leaves = group_leaves(state.params)
                flat = pmesh.all_reduce_grads([x for g in GROUPS for x in grads[g]],
                                              [x for g in GROUPS for x in leaves[g]], static.dp)
                it = iter(flat)
                grads = {g: [next(it) for _ in leaves[g]] for g in GROUPS}
        with span("optimizer"):
            new_params, opt_state = opt.step(state.params, grads, state.opt_state)
            new_params = new_params._replace(env=torch.clamp_min(new_params.env, 0.01))
        return Stage1State(new_params, opt_state, state.step + 1), aux

    return train_step
