"""Rank functions and fixtures of the data-parallel tests
(tests/test_torch_parallel.py, tests/test_torch_parallel_stage1.py).

``parallel.mesh.launch`` spawns the ranks, which unpickle their function
by import path, so the functions live here, in an importable module that
imports neither JAX nor a test file at its top.  States and randoms travel
to the ranks as ``torch.save`` bytes; the ranks return numpy.
"""

from __future__ import annotations

import dataclasses
import io

import numpy as np
import torch


def to_bytes(obj) -> bytes:
    buf = io.BytesIO()
    torch.save(obj, buf)
    return buf.getvalue()


def from_bytes(b: bytes):
    return torch.load(io.BytesIO(b), weights_only=False)


def leaves_np(tree):
    from mirres_restir_nerf_mesh_torch.train.checkpoint import numpy_leaves

    return numpy_leaves(tree)


def _same_on_all_ranks(state, dp) -> bool:
    from mirres_restir_nerf_mesh_torch.parallel import mesh as pmesh
    from mirres_restir_nerf_mesh_torch.train.checkpoint import flatten_with_path

    return pmesh.same_on_all_ranks([v for _, v in flatten_with_path(state)
                                    if isinstance(v, torch.Tensor)], dp)


# ------------------------------------------------------------ collectives
def collectives_rank(dp, n):
    """shard_rows / gather_rows / all_reduce_sum / replicate / all_reduce_grads
    on this rank's rows of a seeded [n, 3] tensor."""
    from mirres_restir_nerf_mesh_torch.parallel import mesh as pmesh

    torch.set_num_threads(1)
    x = torch.from_numpy(np.random.RandomState(0).normal(size=(n, 3)).astype(np.float32))
    w = torch.from_numpy(np.random.RandomState(1).normal(size=(n, 3)).astype(np.float32))
    sh = pmesh.shard_of(n, dp)
    xl = x[sh.lo:sh.hi].clone().requires_grad_(True)
    full = pmesh.gather_rows(xl, dp, sh.counts)
    # every rank computes the same loss of the whole tensor, back-propagates 1/R
    loss = (full * w).pow(2).sum() + pmesh.all_reduce_sum((xl ** 3).sum(), dp)
    (g,) = torch.autograd.grad(loss / dp.world, xl)
    rep = pmesh.replicate([torch.full((2,), float(dp.rank)), torch.tensor(dp.rank + 1)], dp)
    summed = pmesh.all_reduce_grads([None, torch.ones(3) * dp.rank], [torch.zeros(2),
                                                                      torch.zeros(3)], dp)
    return dict(lo=sh.lo, hi=sh.hi, counts=sh.counts, full=full.detach().numpy(),
                loss=float(loss), grad=g.numpy(), rep=[r.numpy() for r in rep],
                summed=[s.numpy() for s in summed])


def failing_rank(dp):
    """Rank 1 raises; the others wait for it in a collective."""
    from mirres_restir_nerf_mesh_torch.parallel import mesh as pmesh

    if dp.rank == 1:
        raise ValueError("a planted failure on rank 1")
    pmesh.barrier(dp)


# ----------------------------------------------------------------- stage 0
def stage0_step_rank(dp, case: bytes):
    """One data-parallel stage-0 step on this rank's rows -> (loss, aux,
    summed gradients, the state after, whether every rank holds its bits)."""
    from mirres_restir_nerf_mesh_torch.parallel import mesh as pmesh
    from mirres_restir_nerf_mesh_torch.train import stage0 as ts0

    torch.set_num_threads(1)
    c = from_bytes(case)
    cfg, spec, sampler, state, rand = c["cfg"], c["spec"], c["sampler"], c["state"], c["rand"]
    step = ts0.make_train_step(cfg, spec, sampler, dp=dp)
    shard = pmesh.shard_of(rand.noise.shape[0], dp)
    local = ts0.shard_stage0_randoms(rand, shard)
    loss, aux, grads = ts0.loss_and_grads(state.params, state.occ.occ, sampler.sample(local.sample),
                                          local, cfg, spec, int(state.step),
                                          step.march_candidates, shard)
    grads = pmesh.all_reduce_grads(grads, ts0.tree_leaves(state.params), dp)
    new, _ = step(state, rand=rand)
    from mirres_restir_nerf_mesh_torch.convert import stage0_state_to_numpy

    return dict(loss=float(loss), num_points=int(aux["num_points"]),
                grads=[g.numpy() for g in grads], state=stage0_state_to_numpy(new),
                same=_same_on_all_ranks(new, dp))


def trainer_rank(dp, case: bytes):
    """The tests/test_dp_trainer.py run through the port's Trainer on the
    JAX Trainer's draws (test_torch_trainer.FedTrainer) -> the params after
    and whether every rank holds the same state."""
    from mirres_restir_nerf_mesh_tpu.data.provider import RayDataset as JRayDataset
    from mirres_restir_nerf_mesh_torch.convert import stage0_state_to_numpy
    from test_torch_trainer import FedTrainer

    torch.set_num_threads(1)
    c = from_bytes(case)
    cfg = c["cfg"]
    jsampler = JRayDataset(c["jdata"], bound=cfg.bound, background=cfg.background)
    tr = FedTrainer("ngp", cfg, c["data"], nerf_spec=c["spec"], device="cpu", dp=dp,
                    jsampler=jsampler, skip=1)
    from mirres_restir_nerf_mesh_torch.train.checkpoint import replicate_state

    tr.state = replicate_state(c["state"], dp)
    tr.train(max_steps=c["steps"])
    return dict(state=stage0_state_to_numpy(tr.state), same=_same_on_all_ranks(tr.state, dp),
                num_rays=cfg.num_rays)


# ----------------------------------------------------------------- stage 1
S1_H = 24                # the GT frame's side; rendered at ssaa 2
S1_SSAA = 2
S1_STATIC = dict(spp=1, bounces=1, use_restir=True, restir_tiles=4, restir_tile_size=32,
                 restir_light_samples=8, restir_brdf_samples=1, restir_neighbors=5,
                 restir_radius=6.0, restir_offsets=64, denoise_iters=2, compute_normal_ao=True,
                 antialias=True, compact_chunks=4)
S1_TRAIN = dict(bound=1.0, stage=1, use_brdf=True, pt_bounces=1, env_h=16, env_w=32,
                lambda_tv=0.0, lambda_normal=0.01, lambda_edgelen=0.01, lambda_lap=0.01,
                lambda_extra_kd=0.5, lambda_lpips=0.1, use_restir=True, spp=1, ssaa=S1_SSAA)


def balls_mesh(res=32, faces=600):
    """Four overlapping balls (tests/test_torch_pathtracer.py's fixture)."""
    from mirres_restir_nerf_mesh_torch.export.meshops import decimate, marching_tets

    ax = np.linspace(-1, 1, res, dtype=np.float32)
    X, Y, Z = np.meshgrid(ax, ax, ax, indexing="ij")
    centers = [(-0.42, -0.2, 0.0), (0.42, -0.2, 0.0), (0.0, 0.45, -0.1), (0.0, -0.1, 0.5)]
    field = np.max([0.36 - np.sqrt((X - a) ** 2 + (Y - b) ** 2 + (Z - c) ** 2)
                    for a, b, c in centers], axis=0)
    v, tr = marching_tets(field, 0.0, origin=(-1, -1, -1), spacing=(2 / (res - 1),) * 3)
    return decimate(v, tr, faces)


def stage1_case(rows=None, seed=0):
    """The tiny stage-1 ReSTIR step's inputs (all from seeds): mesh, params,
    static, config, the frame's batch (GT rows ``rows`` = (r0, r1) of the
    frame: a stage1_rows band) and the frame's randoms."""
    from mirres_restir_nerf_mesh_torch.config import Config, finalize
    from mirres_restir_nerf_mesh_torch.data.provider import RayDataset
    from mirres_restir_nerf_mesh_torch.data.synthetic import make_synthetic_frames
    from mirres_restir_nerf_mesh_torch.models.material import MaterialSpec, init_material
    from mirres_restir_nerf_mesh_torch.models.nerf import NeRFSpec, init_nerf
    from mirres_restir_nerf_mesh_torch.render.stage1 import (Stage1Params, Stage1Static,
                                                             draw_frame_randoms)
    from mirres_restir_nerf_mesh_torch.train.losses import build_topology

    v, tr = balls_mesh()
    s, H = S1_SSAA, S1_H
    f = RayDataset(make_synthetic_frames(n_frames=1, H=H, W=H, bound=1.0), bound=1.0,
                   device="cpu").frame_rays(0, ssaa=s)
    batch = {k: f[k] for k in ("rays_o", "rays_d", "pixels", "alpha")}
    r0, r1 = rows if rows is not None else (0, H)
    Wr = H * s
    batch = {k: x[r0 * s * Wr:r1 * s * Wr] if k.startswith("rays") else x[r0 * H:r1 * H]
             for k, x in batch.items()}
    g = torch.Generator().manual_seed(seed)
    spec = NeRFSpec(bound=1.0, hidden_dim=16, hidden_dim_color=16, grid_levels=4,
                    grid_log2_hashmap_size=12, grid_desired_resolution=32)
    mspec = MaterialSpec(bound=1.0)
    mat = init_material(g, mspec, device="cpu")
    mat = {**mat, "encoder": mat["encoder"] * 1e3}
    rs = np.random.RandomState(seed + 2)
    env = (0.1 + rs.rand(16, 32, 3)).astype(np.float32)
    env[2:4, 8:12] = 40.0                                   # a sun
    params = Stage1Params(nerf=init_nerf(g, spec, device="cpu"),
                          offsets=torch.from_numpy(rs.normal(size=v.shape).astype(np.float32)
                                                   * 1e-3),
                          mat=mat, env=torch.from_numpy(env))
    static = Stage1Static(tris=torch.from_numpy(tr), nerf_spec=spec, mat_spec=mspec,
                          H=(r1 - r0) * s, W=Wr, ssaa=s, **S1_STATIC)
    rand = draw_frame_randoms(static.H * static.W, static,
                              torch.Generator().manual_seed(seed + 1), "cpu")
    cfg = finalize(Config(**S1_TRAIN))
    return dict(v=v, topo=build_topology(tr, v.shape[0]), params=params, static=static,
                cfg=cfg, batch=batch, rand=rand)


def _local_rows(x, dp, counts):
    """A planted fault: the whole frame with only this rank's rows (the
    other ranks' rows zero) in place of gather_rows."""
    lo = sum(counts[:dp.rank])
    return torch.cat([x.new_zeros((lo,) + x.shape[1:]), x,
                      x.new_zeros((sum(counts) - lo - x.shape[0],) + x.shape[1:])])


def stage1_grads(dp, rows=None, plant=False):
    """The stage-1 step's loss and gradients (summed over the ranks under
    ``dp``; ``plant``: gather_rows replaced by the rank's own rows) ->
    {loss, grads by group, uncertain_count, face_cnt, band}."""
    from mirres_restir_nerf_mesh_torch.parallel import mesh as pmesh
    from mirres_restir_nerf_mesh_torch.render.stage1 import frame_band
    from mirres_restir_nerf_mesh_torch.train import stage1 as ts1

    torch.set_num_threads(1)
    c = stage1_case(rows)
    static = dataclasses.replace(c["static"], dp=dp)
    batch = c["batch"] if dp is None else ts1.band_batch(c["batch"], static)
    if plant:
        pmesh.gather_rows = _local_rows
    loss, aux, grads = ts1.loss_and_grads(c["params"], static, torch.from_numpy(c["v"]),
                                          c["topo"], batch, c["cfg"], rand=c["rand"])
    leaves = ts1.group_leaves(c["params"])
    if dp is not None:
        flat = pmesh.all_reduce_grads([x for g in ts1.GROUPS for x in grads[g]],
                                      [x for g in ts1.GROUPS for x in leaves[g]], dp)
        it = iter(flat)
        grads = {g: [next(it) for _ in leaves[g]] for g in ts1.GROUPS}
    band = frame_band(static)
    return dict(loss=float(loss), uncertain=float(aux["uncertain_count"]),
                face_cnt=aux["face_cnt"].numpy(),
                grads={g: [np.zeros(tuple(p.shape), np.float32) if x is None else x.numpy()
                           for x, p in zip(grads[g], leaves[g])] for g in ts1.GROUPS},
                band=None if band is None else (band.lo, band.hi))
