"""Stage-0 trainer: radiance-field optimization (counterpart of
mirres_restir_nerf_mesh_tpu/train/stage0.py).

Adam (b1 0.9, b2 0.999, eps 1e-15 outside the root, bias-corrected as
optax's ``scale_by_adam``) times -lr * ``lr_schedule`` of the count before
the step, over every leaf of the NeRF params; EMA 0.95 of the params after
each step; rgb MSE + mask + entropy + eikonal + depth + hash-grid TV
losses; the occupancy grid's EMA update every ``update_extra_interval``
steps (``make_occ_update``).  The randoms of a step (the batch's draws, the
march perturbation, the one-corner encode's uniforms) come in as
``Stage0Randoms``, drawn from a generator or passed in; those of an
occupancy update as ``ops.occupancy.OccupancyDraws``.

Data parallelism (``make_train_step(..., dp=...)``): every rank draws the
whole step's randoms and takes its contiguous rows of the rays
(``shard_stage0_randoms``); the loss is the one-device loss on every rank
(its means over the whole batch through ``parallel.mesh.global_mean``, the
TV term on the batch's first ``TV_POINTS`` points, gathered), each rank
back-propagates 1/R of it and the gradients are summed over the ranks, so
Adam and the EMA run on the same numbers everywhere.

Optimizer state: one ``AdamState(count, mu, nu)`` with mu and nu in
``tree_leaves`` order (sorted keys: color_net, encoder, sigma_net,
variance), the order of the reference's ``jax.tree.leaves``.
"""

from __future__ import annotations

import functools
import math
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config import Config
from ..models import nerf as nerf_model
from ..ops.hashgrid import hashgrid_tv_loss
from ..ops.occupancy import (OccupancyDraws, OccupancyState, draw_occupancy, init_occupancy,
                             update_occupancy)
from ..parallel.mesh import (DataParallel, Shard, all_gather_rows, all_reduce_grads,
                             all_reduce_scalars, global_mean, shard_of, shard_rows)
from ..render.volume import field_points, render_rays
from ..utils.profiling import count, count_sync, count_upload, span

B1, B2 = 0.9, 0.999
TV_POINTS = 4096             # hashgrid_tv_loss's points: the batch's first marched samples


def lr_schedule(cfg: Config):
    """Warmup to step 500, then exponential decay to 0.1x at cfg.iters; the
    step is an int, the factor a float32 scalar tensor (as the reference
    evaluates it)."""
    iters = cfg.iters

    def fn(step) -> torch.Tensor:
        s = torch.as_tensor(step, dtype=torch.float32)
        warm = 0.01 + 0.99 * (s / 500.0)
        decay = 0.1 ** ((s - 500.0) / max(iters - 500.0, 1.0))
        return torch.where(s <= 500, warm, decay)

    return fn


def tree_leaves(tree) -> List[torch.Tensor]:
    """Leaves of nested dicts / lists in jax.tree.leaves order (sorted keys)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_unflatten(tree, leaves) -> Any:
    """Same structure as ``tree`` with ``leaves`` (an iterator) in its slots."""
    if isinstance(tree, dict):
        return {k: tree_unflatten(tree[k], leaves) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [tree_unflatten(v, leaves) for v in tree]
    return next(leaves)


class AdamState(NamedTuple):
    count: torch.Tensor          # int32 scalar on the CPU: steps taken
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]


def adam_init(leaves: List[torch.Tensor]) -> AdamState:
    return AdamState(count=torch.zeros((), dtype=torch.int32),
                     mu=[torch.zeros_like(x) for x in leaves],
                     nu=[torch.zeros_like(x) for x in leaves])


@torch.no_grad()
def adam_update(leaves: List[torch.Tensor], grads: List[Optional[torch.Tensor]], st: AdamState,
                lr: Callable[[torch.Tensor], torch.Tensor], eps: float,
                pre_scale: float = 1.0) -> Tuple[List[torch.Tensor], AdamState]:
    """One Adam step of a group of leaves, as optax computes it: the lr at
    the count before the step, the bias corrections at count + 1 (float32
    scalars); a leaf without a gradient takes a zero one; new tensors out,
    the inputs untouched."""
    count = st.count.cpu()
    neg_lr = -float(lr(count))
    count_inc = count + 1
    bc1 = float(1.0 - torch.tensor(B1, dtype=torch.float32) ** count_inc)
    bc2 = float(1.0 - torch.tensor(B2, dtype=torch.float32) ** count_inc)
    outs, mus, nus = [], [], []
    for p, g, mu, nu in zip(leaves, grads, st.mu, st.nu):
        g = torch.zeros_like(p) if g is None else g
        if pre_scale != 1.0:
            g = pre_scale * g
        mu = (1 - B1) * g + B1 * mu
        nu = (1 - B2) * (g ** 2) + B2 * nu
        outs.append(p + neg_lr * ((mu / bc1) / (torch.sqrt(nu / bc2) + eps)))
        mus.append(mu)
        nus.append(nu)
    return outs, AdamState(count=count_inc.to(torch.int32), mu=mus, nu=nus)


class Stage0Optimizer:
    """Adam(eps 1e-15) x -lr * lr_schedule over every leaf; ``init(params)``
    -> AdamState, ``step(params, grads, state)`` -> (params, state), grads
    in ``tree_leaves`` order."""

    def __init__(self, cfg: Config):
        sched = lr_schedule(cfg)
        self.lr = lambda s: cfg.lr * sched(s)  # noqa: E731

    def init(self, params) -> AdamState:
        return adam_init(tree_leaves(params))

    def step(self, params, grads, state: AdamState):
        leaves, state = adam_update(tree_leaves(params), grads, state, self.lr, 1e-15)
        return tree_unflatten(params, iter(leaves)), state


def make_optimizer(cfg: Config) -> Stage0Optimizer:
    return Stage0Optimizer(cfg)


class TrainState(NamedTuple):
    params: Any
    opt_state: AdamState
    ema_params: Any
    occ: OccupancyState
    step: torch.Tensor           # int32 scalar on the CPU


class Stage0Randoms(NamedTuple):
    """The randoms of one train step: the batch's draws, the march
    perturbation [N] in [0, 1), the one-corner encode's uniforms [P, 3]
    (``render.volume.field_points``; None with cfg.stochastic_interp off)."""
    sample: Any                  # data.provider.SampleDraws
    noise: torch.Tensor
    stochastic_u: Optional[torch.Tensor] = None

    def to(self, device) -> "Stage0Randoms":
        return Stage0Randoms(self.sample.to(device), self.noise.to(device),
                             None if self.stochastic_u is None else self.stochastic_u.to(device))


def _samples_per_ray(cfg: Config, march_candidates: Optional[int]) -> int:
    S = cfg.max_steps if march_candidates is None else min(march_candidates, cfg.max_steps)
    return min(cfg.samples_per_ray, S)


def draw_stage0_randoms(sampler, cfg: Config, march_candidates: Optional[int],
                        generator: Optional[torch.Generator] = None) -> Stage0Randoms:
    """Stage0Randoms of one step from ``generator``, on the sampler's device."""
    sample = sampler.draw(cfg.num_rays, generator)
    N, dev = sample.pix_idx.shape[0], sampler.device
    noise = torch.rand((N,), generator=generator, device=dev)
    su = None
    if cfg.stochastic_interp and not cfg.sdf:
        P = field_points(N, _samples_per_ray(cfg, march_candidates),
                         cfg.num_points if cfg.adaptive_num_rays else None)
        su = torch.rand((P, 3), generator=generator, device=dev)
    return Stage0Randoms(sample, noise, su)


def shard_stage0_randoms(rand: Stage0Randoms, shard: Shard) -> Stage0Randoms:
    """The shard's rows of the batch's draws and perturbation; the stochastic
    encode's uniforms stay whole (render_rays takes them by global slot)."""
    lo, hi = shard.lo, shard.hi
    s = rand.sample
    sample = s._replace(**{f: getattr(s, f)[lo:hi] for f in ("img_idx", "pix_idx", "bg",
                                                             "sparse_m")
                           if getattr(s, f) is not None})
    return Stage0Randoms(sample, rand.noise[lo:hi], rand.stochastic_u)


def _tv_points(xyzs: torch.Tensor, shard: Optional[Shard]) -> torch.Tensor:
    """The batch's first TV_POINTS marched samples (xyzs [N, K, 3]; with a
    shard, every rank's part of them gathered)."""
    pts = xyzs.reshape(-1, 3).detach()
    if shard is None:
        return pts
    K = xyzs.shape[1]
    counts = [min(max(TV_POINTS - lo * K, 0), (hi - lo) * K)
              for lo, hi in (shard_rows(shard.n, r, shard.dp.world)
                             for r in range(shard.dp.world))]
    return all_gather_rows(pts[:counts[shard.dp.rank]], shard.dp, counts)


def init_state(generator: Optional[torch.Generator], cfg: Config, spec: nerf_model.NeRFSpec,
               device="cuda") -> TrainState:
    params = nerf_model.init_nerf(generator, spec, device=device)
    return TrainState(params=params, opt_state=make_optimizer(cfg).init(params),
                      ema_params=params,
                      occ=init_occupancy(cfg.cascade, cfg.grid_size, device=device),
                      step=torch.zeros((), dtype=torch.int32))


def _aabb(cfg: Config, device) -> torch.Tensor:
    b = cfg.bound
    box = cfg.scene_aabb if cfg.scene_aabb is not None else (-b, -b, -b, b, b, b)
    count_upload("aabb", device)
    return torch.tensor(box, dtype=torch.float32, device=device)


def march_candidates_for(cfg: Config, sampler) -> Optional[int]:
    """The exact span-adaptive candidate-lattice length: the largest
    [near, far) span over every training ray bounds the live lattice slots,
    so S = ceil((span + dt_max) / dt_min) + 1 (dt_max covers the perturb
    shift) loses nothing.  None when that does not cut below max_steps."""
    data = getattr(sampler, "data", None)
    if data is None:
        return None
    b = cfg.bound
    aabb = np.asarray(cfg.scene_aabb if cfg.scene_aabb is not None else [-b, -b, -b, b, b, b],
                      np.float32)
    dt_min = 2.0 * math.sqrt(3.0) / cfg.max_steps
    span = 0.0
    for i in range(data.num_frames):
        f = sampler.frame_rays(i)
        count_sync("march_candidates", f["rays_o"].is_cuda, 2)
        ro = f["rays_o"].cpu().numpy().astype(np.float32)
        rd = f["rays_d"].cpu().numpy().astype(np.float32)
        inv = 1.0 / np.where(np.abs(rd) < 1e-15, 1e-15, rd)
        t0 = (aabb[None, 0:3] - ro) * inv
        t1 = (aabb[None, 3:6] - ro) * inv
        tmin = np.minimum(t0, t1).max(axis=-1)
        tmax = np.maximum(t0, t1).min(axis=-1)
        near = np.maximum(tmin, cfg.min_near)
        hit = (tmax >= tmin) & (tmax >= cfg.min_near)
        if hit.any():
            span = max(span, float((tmax - near)[hit].max()))
    if span <= 0.0:
        return None
    dt_max = 2.0 * math.sqrt(3.0) * cfg.bound / cfg.grid_size
    s = int(math.ceil((span + dt_max) / dt_min)) + 1
    return s if s < cfg.max_steps else None


def stage0_loss(params: Any, occ: torch.Tensor, batch: Dict[str, torch.Tensor],
                rand: Stage0Randoms, cfg: Config, spec: nerf_model.NeRFSpec, step,
                march_candidates: Optional[int] = None,
                shard: Optional[Shard] = None) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """-> (loss, aux); aux holds detached values.  With ``shard`` the batch
    and rand are the shard's rows (``shard_stage0_randoms``) and the loss
    and aux are the whole batch's, equal on every rank."""
    mean = functools.partial(global_mean, shard=shard)
    s = torch.as_tensor(step, dtype=torch.float32)
    max_level = None
    if cfg.progressive_level:
        ratio = torch.clamp_max(s / (0.5 * cfg.iters), 1.0)
        max_level = 4 + (12.0 * ratio).to(torch.int32)
    cos_anneal = float(torch.clamp_max(s / (0.5 * cfg.iters), 1.0)) if cfg.sdf else 1.0
    out = render_rays(
        params, occ, batch["rays_o"], batch["rays_d"], spec, _aabb(cfg, batch["rays_o"].device),
        K=cfg.samples_per_ray, max_steps=cfg.max_steps, dt_gamma=cfg.dt_gamma,
        min_near=cfg.min_near, bg_color=batch["bg_color"], noise=rand.noise,
        contract=cfg.contract, max_level=max_level, cos_anneal_ratio=cos_anneal,
        cam_near_far=batch.get("cam_near_far"), march_candidates=march_candidates,
        stochastic_u=rand.stochastic_u if cfg.stochastic_interp else None,
        compact_points=cfg.num_points if cfg.adaptive_num_rays else None, shard=shard)

    pred, gt = out["image"], batch["pixels"]
    mse = mean((pred - gt) ** 2)
    loss = cfg.lambda_rgb * mse
    if cfg.lambda_mask > 0:
        loss = loss + cfg.lambda_mask * mean((out["weights_sum"] - batch["alpha"]) ** 2)
    if cfg.lambda_entropy > 0:
        def entropy(w):
            w = torch.clamp(w, 1e-5, 1 - 1e-5)
            return -w * torch.log2(w) - (1 - w) * torch.log2(1 - w)

        loss = loss + cfg.lambda_entropy * (mean(entropy(out["weights"]))
                                            + mean(entropy(out["weights_sum"])))
    if cfg.sdf and cfg.lambda_eikonal > 0:
        loss = loss + cfg.lambda_eikonal * mean(
            (torch.linalg.norm(out["normal"], dim=-1) - 1.0) ** 2)
    if "depth" in batch and cfg.lambda_depth > 0:
        lam = cfg.lambda_depth * torch.clamp_max(s / 1000.0, 1.0)
        mask = (batch["depth"] > 0).to(torch.float32)
        w = batch.get("depth_weight", 1.0)
        loss = loss + lam * mean(w * mask * (out["depth"] - batch["depth"]) ** 2)
    if cfg.lambda_tv > 0:
        loss = loss + cfg.lambda_tv * hashgrid_tv_loss(params["encoder"],
                                                       _tv_points(out["xyzs"], shard), spec.grid,
                                                       spec.bound, max_points=TV_POINTS)
    num_points = out["num_points"]
    if shard is not None:
        num_points = all_reduce_scalars({"n": num_points}, shard.dp)["n"].to(num_points.dtype)
    aux = {"loss": loss.detach(),
           "psnr": -10.0 * torch.log10(torch.clamp_min(mse.detach(), 1e-12)),
           "num_points": num_points}
    return loss, aux


def loss_and_grads(params: Any, occ: torch.Tensor, batch: Dict[str, torch.Tensor],
                   rand: Stage0Randoms, cfg: Config, spec: nerf_model.NeRFSpec, step,
                   march_candidates: Optional[int] = None, shard: Optional[Shard] = None):
    """-> (loss, aux, grads): stage0_loss and its gradient with respect to
    every leaf in ``tree_leaves`` order (None: the loss does not use it).
    With ``shard``: this rank's part of the gradient (1/R of the loss
    back-propagated), to be summed over the ranks (``all_reduce_grads``)."""
    leaves = [x.detach().requires_grad_(True) for x in tree_leaves(params)]
    with span("forward"):
        loss, aux = stage0_loss(tree_unflatten(params, iter(leaves)), occ, batch, rand, cfg,
                                spec, step, march_candidates, shard)
    scaled = loss if shard is None else loss / shard.dp.world
    with span("backward"):
        grads = torch.autograd.grad(scaled, leaves, allow_unused=True)
    return loss.detach(), aux, list(grads)


def make_train_step(cfg: Config, spec: nerf_model.NeRFSpec, sampler,
                    dp: Optional[DataParallel] = None):
    """-> ``train_step(state, generator=None, rand=None) -> (state, aux)``:
    a batch from ``sampler`` (a RayDataset), the loss and its gradients,
    Adam, the EMA.  The march lattice length is fixed once here
    (``march_candidates_for``) and kept as ``train_step.march_candidates``.
    With ``dp``, rand is the whole step's (every rank draws the same), the
    rank renders its rows of it and the gradients are summed over the
    ranks."""
    opt = make_optimizer(cfg)
    n_march = march_candidates_for(cfg, sampler)

    def train_step(state: TrainState, generator: Optional[torch.Generator] = None,
                   rand: Optional[Stage0Randoms] = None) -> Tuple[TrainState, Dict[str, Any]]:
        count("steps.stage0")
        if rand is None:
            rand = draw_stage0_randoms(sampler, cfg, n_march, generator)
        shard = None
        if dp is not None:
            shard = shard_of(rand.noise.shape[0], dp)
            rand = shard_stage0_randoms(rand, shard)
        with span("batch"):
            batch = sampler.sample(rand.sample)
        _, aux, grads = loss_and_grads(state.params, state.occ.occ, batch, rand, cfg, spec,
                                       int(state.step), n_march, shard)
        if dp is not None:
            with span("allreduce"):
                grads = all_reduce_grads(grads, tree_leaves(state.params), dp)
        with span("optimizer"):
            params, opt_state = opt.step(state.params, grads, state.opt_state)
            with torch.no_grad():
                ema = tree_unflatten(params, iter([0.95 * e + 0.05 * p for e, p in zip(
                    tree_leaves(state.ema_params), tree_leaves(params))]))
        return TrainState(params, opt_state, ema, state.occ, state.step + 1), aux

    train_step.march_candidates = n_march
    return train_step


def init_double_sphere(params: Any, spec: nerf_model.NeRFSpec,
                       generator: Optional[torch.Generator] = None,
                       points: Optional[torch.Tensor] = None, r1: float = 0.5, r2: float = 1.5,
                       iters: int = 2048, batch_size: int = 8192, lr: float = 1e-3) -> Any:
    """SDF pretraining towards two nested spheres (radii r1 < r2; the cameras
    sit between them): plain Adam (eps 1e-8) on the squared SDF error at
    uniform points in the box, ``points`` [iters, batch_size, 3] or drawn
    from ``generator``."""
    dev = params["encoder"].device
    st = adam_init(tree_leaves(params))
    for i in range(iters):
        if points is not None:
            xyz = points[i]
        else:
            u = torch.rand((batch_size, 3), generator=generator, device=dev)
            xyz = u * (2.0 * spec.bound) - spec.bound
        d = torch.linalg.norm(xyz, dim=-1)
        gt = torch.where(d < (r1 + r2) / 2, d - r1, r2 - d)
        leaves = [x.detach().requires_grad_(True) for x in tree_leaves(params)]
        pred = nerf_model.density(tree_unflatten(params, iter(leaves)), xyz, spec)["sigma"]
        grads = torch.autograd.grad(torch.mean((pred - gt) ** 2), leaves, allow_unused=True)
        new, st = adam_update(leaves, list(grads), st, lambda s: torch.tensor(lr), 1e-8)
        params = tree_unflatten(params, iter(new))
    return params


def make_occ_update(cfg: Config, spec: nerf_model.NeRFSpec):
    """-> ``occ_update(state, generator=None, draws=None) -> state``: the
    density (sdf: the NeuS density sigmoid(-sdf s) s) at jittered cell
    centres, with the one-corner encode when cfg.stochastic_interp."""

    @torch.no_grad()
    def occ_update(state: TrainState, generator: Optional[torch.Generator] = None,
                   draws: Optional[OccupancyDraws] = None) -> TrainState:
        def density_fn(pts, u):
            sig = nerf_model.density(state.params, pts, spec,
                                     stochastic_u=u if cfg.stochastic_interp else None)["sigma"]
            if cfg.sdf:
                inv_s = torch.clamp(torch.exp(state.params["variance"] * 10.0), 1e-6, 1e6)
                sig = torch.sigmoid(-sig * inv_s) * inv_s
            return sig

        with span("occ_update"):
            if draws is None:
                draws = draw_occupancy(state.occ, cfg.bound, cfg.stochastic_interp, generator)
            occ = update_occupancy(state.occ, density_fn, draws, cfg.bound, cfg.density_thresh)
        return state._replace(occ=occ)

    return occ_update


def make_render_fn(cfg: Config, spec: nerf_model.NeRFSpec, use_ema: bool = True):
    """-> ``render_chunk(state, rays_o, rays_d) -> (image, depth,
    weights_sum)``: the eval render (samples_per_ray_infer a ray, exact
    encode, no perturbation, the field in chunks of 65,536 points)."""

    @torch.no_grad()
    def render_chunk(state: TrainState, rays_o, rays_d):
        params = state.ema_params if use_ema else state.params
        out = render_rays(params, state.occ.occ, rays_o, rays_d, spec,
                          _aabb(cfg, rays_o.device), K=cfg.samples_per_ray_infer,
                          max_steps=cfg.max_steps, dt_gamma=cfg.dt_gamma, min_near=cfg.min_near,
                          contract=cfg.contract, field_chunk=65536)
        return out["image"], out["depth"], out["weights_sum"]

    return render_chunk


def render_frame(state: TrainState, render_chunk, rays_o, rays_d, H: int, W: int,
                 chunk: int = 8192):
    """Chunked frame render -> (image [H,W,3], depth [H,W]) as numpy."""
    imgs, deps = [], []
    for s in range(0, rays_o.shape[0], chunk):
        img, dep, _ = render_chunk(state, rays_o[s: s + chunk], rays_d[s: s + chunk])
        imgs.append(img.cpu().numpy())
        deps.append(dep.cpu().numpy())
    return np.concatenate(imgs).reshape(H, W, 3), np.concatenate(deps).reshape(H, W)
