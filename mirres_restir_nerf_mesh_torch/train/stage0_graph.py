"""Stage 0's train step replayed from CUDA graphs between its hand-written
kernels (``GraphedStep``; ``make_train_step`` returns one where
``graphable`` holds).

A step runs in the eager step's order:

1. the randoms, drawn from the generator as the eager step draws them (or
   passed in), copied into graph A's input buffers;
2. graph A, no gradient: the batch (``RayDataset.sample``), the march, the
   stable-sort compaction and the gathers of the field's points and
   directions, the TV loss's rows (``tv_rows``);
3. K5, eager (``OneCornerEncode``): the field's hash-grid features;
4. graph B forward (``_FieldReplay``): from K5's features and the MLP
   weights, the sigma MLP, ``trunc_exp``, the SH encode, the colour MLP,
   the packing back to the samples' slots, the composite, the background
   and the loss terms but the TV one;
5. the TV loss, eager, through ``GatherRows``;
6. ``torch.autograd.grad``: the engine replays graph B's backward and
   launches the two K4 scatter-adds (the encode's and the TV loss's)
   eagerly;
7. graph C: Adam and the EMA in place on every leaf, in ``adam_update``'s
   order of operations; its scalars (-lr, 1 / bc1, 1 / bc2; the reciprocals
   as the eager step's scalar division forms them) are computed on the host
   in float32 and copied each step from a pinned ring into a device buffer.

Graphs are captured once per set of input shapes (and again when they
change), on a side stream after an eager warm-up of A and B; capture reads
the state and the generator and changes neither.  The step owns the
tensors its graphs read and write: the parameters, Adam's mu and nu, the
EMA parameters and the occupancy bitfield.  A state whose tensors are not
these is copied in; the state handed back holds them, updated in place, so
an older ``TrainState`` object that shares them sees them change.  The aux
values handed back are fresh tensors.  Registry counts: ``graph.capture``
for each capture, ``graph.stage0_step`` for each step whose compute ran as
replays.
"""

from __future__ import annotations

import functools
import gc
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import Config
from ..data.provider import SampleDraws
from ..models import nerf as nerf_model
from ..ops.hashgrid import tv_loss_of_rows, tv_rows
from ..render.volume import compact_index, march_points, shade, spread_field
from ..utils.profiling import count, span
from .stage0 import (ADAM_EPS, B1, B2, EMA_DECAY, TV_POINTS, AdamState, Stage0Randoms,
                     TrainState, _aabb, adam_scalars, draw_stage0_randoms, make_optimizer,
                     psnr_of, render_loss, tree_leaves, tree_unflatten)

RING = 8                     # pinned slots of Adam's scalars: steps the host may run ahead


def graphable(cfg: Config, sampler) -> bool:
    """Whether the step's shapes are static and nothing it computes reads
    a host value that changes from step to step: on a card, the batch's
    points compacted to a fixed budget (``adaptive_num_rays``), the
    one-corner encode, no SDF, no progressive levels and no depth term."""
    depth = cfg.lambda_depth > 0 and (sampler.depths is not None
                                      or sampler.sparse_coords is not None)
    return (sampler.device.type == "cuda" and cfg.adaptive_num_rays and cfg.stochastic_interp
            and not cfg.sdf and not cfg.progressive_level and not depth)


@torch.no_grad()
def adam_ema_(params: List[torch.Tensor], grads: List[torch.Tensor], mu: List[torch.Tensor],
              nu: List[torch.Tensor], ema: List[torch.Tensor], scalars: torch.Tensor) -> None:
    """One Adam step and the EMA, in place: ``adam_update``'s operations in
    its order, then the EMA, ``EMA_DECAY e + (1 - EMA_DECAY) p``.  scalars [3] float32 on the
    card: -lr, 1 / bc1 and 1 / bc2 (the eager step divides by a host
    scalar as a product with its float32 reciprocal)."""
    neg_lr, inv_bc1, inv_bc2 = scalars[0], scalars[1], scalars[2]
    t = torch._foreach_mul(grads, 1 - B1)
    torch._foreach_mul_(mu, B1)
    torch._foreach_add_(mu, t)
    t = torch._foreach_mul(grads, grads)
    torch._foreach_mul_(t, 1 - B2)
    torch._foreach_mul_(nu, B2)
    torch._foreach_add_(nu, t)
    step = torch._foreach_mul(mu, inv_bc1)
    den = torch._foreach_mul(nu, inv_bc2)
    torch._foreach_sqrt_(den)
    torch._foreach_add_(den, ADAM_EPS)
    torch._foreach_div_(step, den)
    torch._foreach_mul_(step, neg_lr)
    torch._foreach_add_(params, step)
    t = torch._foreach_mul(params, 1 - EMA_DECAY)
    torch._foreach_mul_(ema, EMA_DECAY)
    torch._foreach_add_(ema, t)


@functools.lru_cache(maxsize=None)
def _side_stream(device: torch.device) -> torch.cuda.Stream:
    """The stream every capture on ``device`` runs on (one, so that what its
    warm-ups leave in the allocator's cache serves the next capture)."""
    return torch.cuda.Stream(device)


def _captured(fn: Callable[[], Any], pool) -> Tuple[torch.cuda.CUDAGraph, Any]:
    """Capture ``fn()`` on the current (side) stream into a graph drawing
    on ``pool`` -> (graph, fn's outputs, static); no cyclic garbage
    collection while capturing."""
    graph = torch.cuda.CUDAGraph()
    gc.disable()
    try:
        graph.capture_begin(pool=pool)
        try:
            out = fn()
        finally:
            graph.capture_end()
    finally:
        gc.enable()
    return graph, out


class _ScalarRing:
    """Adam's scalars from the host to a device buffer without a
    synchronization: a pinned slot a step, reused only once the copy it
    last fed has run."""

    def __init__(self):
        self.host = torch.zeros((RING, 3), dtype=torch.float32, pin_memory=True)
        self.rows = self.host.numpy()
        self.events = [torch.cuda.Event() for _ in range(RING)]
        self.used = [False] * RING
        self.k = 0

    def put(self, dst: torch.Tensor, values: Tuple[float, float, float]) -> None:
        j = self.k % RING
        self.k += 1
        if self.used[j]:
            self.events[j].synchronize()
        self.rows[j] = values
        dst.copy_(self.host[j], non_blocking=True)
        self.events[j].record()
        self.used[j] = True


class _Graphs:
    """One capture: graphs A, B forward, B backward and C, and the tensors
    they read and write."""

    key: tuple
    march: torch.cuda.CUDAGraph
    field_fwd: torch.cuda.CUDAGraph
    field_bwd: torch.cuda.CUDAGraph
    optimizer: torch.cuda.CUDAGraph
    params: List[torch.Tensor]       # the state's leaves, tree_leaves order
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]
    ema: List[torch.Tensor]
    occ: torch.Tensor
    draws: List[Optional[torch.Tensor]]   # SampleDraws' fields
    noise: torch.Tensor
    leaves: List[torch.Tensor]       # params' storage, requiring grad
    enc: int                         # the encoder's position among the leaves
    mlp: List[torch.Tensor]          # the other leaves: the MLP weights
    a: Dict[str, Any]                # graph A's outputs
    feats: torch.Tensor              # graph B's input: K5's features
    loss: torch.Tensor               # graph B's outputs
    psnr: torch.Tensor
    grad_loss: torch.Tensor          # graph B backward's input
    grads_out: Tuple[torch.Tensor, ...]   # its outputs: features, then MLP leaves
    grads: List[torch.Tensor]        # graph C's gradients, one a leaf
    scalars: torch.Tensor            # graph C's [3] scalars


class _FieldReplay(torch.autograd.Function):
    """Graph B as one autograd node: (graphs, K5's features, *MLP leaves)
    -> (the loss without its TV term, psnr); the backward replays graph B's
    backward and hands back its gradient buffers."""

    @staticmethod
    def forward(ctx, g: _Graphs, feats: torch.Tensor, *weights: torch.Tensor):
        if feats.data_ptr() != g.feats.data_ptr():
            g.feats.copy_(feats)
        g.field_fwd.replay()
        ctx.g = g
        psnr = g.psnr.detach()
        ctx.mark_non_differentiable(psnr)
        return g.loss.detach(), psnr

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad_loss: torch.Tensor, _grad_psnr):
        g = ctx.g
        g.grad_loss.copy_(grad_loss)
        g.field_bwd.replay()
        return (None,) + tuple(x.detach() for x in g.grads_out)


class GraphedStep:
    """``train_step(state, generator=None, rand=None) -> (state, aux)`` as
    ``make_train_step``'s eager step computes it, replayed from graphs
    (module docstring)."""

    def __init__(self, cfg: Config, spec: nerf_model.NeRFSpec, sampler,
                 march_candidates: Optional[int]):
        self.cfg, self.spec, self.sampler = cfg, spec, sampler
        self.march_candidates = march_candidates
        self.lr = make_optimizer(cfg).lr
        self.graphs: Optional[_Graphs] = None
        self.ring = _ScalarRing()

    def __call__(self, state: TrainState, generator: Optional[torch.Generator] = None,
                 rand: Optional[Stage0Randoms] = None) -> Tuple[TrainState, Dict[str, Any]]:
        count("steps.stage0")
        if rand is None:
            rand = draw_stage0_randoms(self.sampler, self.cfg, self.march_candidates, generator)
        key = _key(rand)
        if self.graphs is None or self.graphs.key != key:
            self.graphs = None
            self.graphs = self._capture(state, rand, key)
            count("graph.capture")
        count("graph.stage0_step")
        return self._step(state, rand)

    # ---------------------------------------------------------------- step
    def _step(self, state: TrainState, rand: Stage0Randoms):
        g, cfg, spec = self.graphs, self.cfg, self.spec
        with span("batch"):
            _bind(g, state)
            for dst, src in zip(g.draws, rand.sample):
                if dst is not None:
                    dst.copy_(src)
            g.noise.copy_(rand.noise)
        with span("forward"):
            with span("march"):
                g.march.replay()
            with span("field"):
                feats = nerf_model.hashgrid_encode(g.leaves[g.enc], g.a["pts"], spec.grid,
                                                   bound=spec.bound,
                                                   stochastic_u=rand.stochastic_u)
                loss, psnr = _FieldReplay.apply(g, feats, *g.mlp)
            if cfg.lambda_tv > 0:
                loss = loss + cfg.lambda_tv * tv_loss_of_rows(g.leaves[g.enc], g.a["tv"],
                                                              spec.grid)
        with span("backward"):
            grads = torch.autograd.grad(loss, g.leaves, allow_unused=True)
        with span("optimizer"):
            for dst, src in zip(g.grads, grads):
                if src is None:
                    dst.zero_()
                elif src.data_ptr() != dst.data_ptr():
                    dst.copy_(src)
            neg_lr, bc1, bc2, count_inc = adam_scalars(state.opt_state.count, self.lr)
            one = np.float32(1.0)
            self.ring.put(g.scalars, (neg_lr, one / np.float32(bc1), one / np.float32(bc2)))
            g.optimizer.replay()
        aux = {"loss": loss.detach() if cfg.lambda_tv > 0 else loss.detach().clone(),
               "psnr": psnr.clone(), "num_points": g.a["num_points"].clone()}
        new = TrainState(params=tree_unflatten(state.params, iter(g.params)),
                         opt_state=AdamState(count=count_inc, mu=list(g.mu), nu=list(g.nu)),
                         ema_params=tree_unflatten(state.ema_params, iter(g.ema)),
                         occ=state.occ._replace(occ=g.occ), step=state.step + 1)
        return new, aux

    # ------------------------------------------------------------- capture
    def _capture(self, state: TrainState, rand: Stage0Randoms, key: tuple) -> _Graphs:
        cfg, spec, sampler = self.cfg, self.spec, self.sampler
        dev = sampler.device
        g = _Graphs()
        g.key = key
        g.params = [x.detach().clone() for x in tree_leaves(state.params)]
        g.mu = [x.clone() for x in state.opt_state.mu]
        g.nu = [x.clone() for x in state.opt_state.nu]
        g.ema = [x.detach().clone() for x in tree_leaves(state.ema_params)]
        g.occ = state.occ.occ.clone()
        g.draws = [None if x is None else x.clone() for x in rand.sample]
        g.noise = rand.noise.clone()
        g.leaves = [x.detach().requires_grad_(True) for x in g.params]
        g.enc = enc = _leaf_index(state.params, "encoder")
        g.mlp = [x for i, x in enumerate(g.leaves) if i != enc]
        mlp_tree = {k: v for k, v in state.params.items() if k != "encoder"}
        M = cfg.num_points

        def march():
            with torch.no_grad():
                batch = sampler.sample(SampleDraws(*g.draws))
                m, pts, dirs = march_points(
                    g.occ, batch["rays_o"], batch["rays_d"], spec, _aabb(cfg, dev),
                    K=cfg.samples_per_ray, max_steps=cfg.max_steps, dt_gamma=cfg.dt_gamma,
                    min_near=cfg.min_near, noise=g.noise, contract=cfg.contract,
                    cam_near_far=batch.get("cam_near_far"),
                    march_candidates=self.march_candidates)
                N, Kk = m.ts.shape
                valid_flat = m.valid.reshape(-1)
                out = {"batch": batch, "m": m, "valid_flat": valid_flat, "idx": None,
                       "num_points": m.valid.sum(), "tv": None}
                if M < N * Kk:
                    idx = compact_index(valid_flat, M)
                    out.update(idx=idx, pts=pts[idx], dirs=dirs[idx])
                else:
                    out.update(pts=pts, dirs=dirs)
                if cfg.lambda_tv > 0:
                    out["tv"] = tv_rows(m.xyzs.reshape(-1, 3)[:TV_POINTS], spec.grid, spec.bound)
                return out

        def field(feats: torch.Tensor, *weights: torch.Tensor):
            a = g.a
            m = a["m"]
            N, Kk = m.ts.shape
            params = tree_unflatten(mlp_tree, iter(weights))
            sig, rgb = nerf_model.forward_from_features(params, feats, a["dirs"], spec)
            if a["idx"] is not None:
                sig, rgb = spread_field(sig, rgb, a["valid_flat"], a["idx"], N * Kk)
            out = shade(m, sig.reshape(N, Kk), rgb, a["batch"]["bg_color"], T_thresh=1e-4,
                        alpha_mode=False)
            loss, mse = render_loss(out, a["batch"], cfg, None, torch.mean)
            return loss, psnr_of(mse)

        pool = torch.cuda.graph_pool_handle()
        side = _side_stream(dev)
        # the capture's work, and what it allocates on the side stream, come
        # after all the card was given before (an earlier capture's replays)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            march()                                            # warm-up
            g.march, g.a = _captured(march, pool)
            g.march.replay()
            g.feats = torch.zeros((g.a["pts"].shape[0], spec.grid.output_dim),
                                  device=dev, requires_grad=True)
            inputs = (g.feats, *g.mlp)
            loss, _ = field(*inputs)                           # warm-up, forward and backward
            torch.autograd.grad(loss, inputs, torch.ones_like(loss))
            del loss
            g.field_fwd, (g.loss, g.psnr) = _captured(functools.partial(field, *inputs), pool)
            g.grad_loss = torch.empty_like(g.loss)
            g.field_bwd, g.grads_out = _captured(
                functools.partial(torch.autograd.grad, g.loss, inputs, g.grad_loss), pool)
            # the captured autograd graph goes: its nodes (the MLP leaves'
            # gradient accumulators among them) belong to the side stream
            g.loss = g.loss.detach()
            mlp_grads = iter(g.grads_out[1:])
            g.grads = [torch.zeros_like(x) if i == enc else next(mlp_grads)
                       for i, x in enumerate(g.params)]
            g.scalars = torch.zeros((3,), device=dev)
            adam_ema_(*([x.clone() for x in xs] for xs in (g.params, g.grads, g.mu, g.nu, g.ema)),
                      g.scalars)                               # warm-up on copies
            g.optimizer, _ = _captured(functools.partial(
                adam_ema_, g.params, g.grads, g.mu, g.nu, g.ema, g.scalars), pool)
        torch.cuda.current_stream(dev).wait_stream(side)
        return g


def _leaf_index(params: Dict[str, Any], name: str) -> int:
    """The position of the leaf ``params[name]`` in ``tree_leaves`` order."""
    marked = tree_unflatten(params, iter(range(len(tree_leaves(params)))))
    return marked[name]


def _key(rand: Stage0Randoms) -> tuple:
    """What a capture is made for: the shapes and dtypes of the randoms."""
    def sig(x):
        return None if x is None else (tuple(x.shape), x.dtype)

    return tuple(sig(x) for x in (*rand.sample, rand.noise, rand.stochastic_u))


def _bind(g: _Graphs, state: TrainState) -> None:
    """Copy into the graphs' tensors each part of ``state`` held elsewhere."""
    pairs = [(g.params, tree_leaves(state.params)), (g.mu, state.opt_state.mu),
             (g.nu, state.opt_state.nu), (g.ema, tree_leaves(state.ema_params)),
             ([g.occ], [state.occ.occ])]
    with torch.no_grad():
        for dsts, srcs in pairs:
            for dst, src in zip(dsts, srcs):
                if src.data_ptr() != dst.data_ptr():
                    dst.copy_(src)
