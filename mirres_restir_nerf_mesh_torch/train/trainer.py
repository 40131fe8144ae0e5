"""The Trainer (counterpart of mirres_restir_nerf_mesh_tpu/train/trainer.py):
the training loop, evaluation, test renders with relighting, the stage-0
mesh and stage-1 textured-mesh exports and the checkpoints, around the
port's stage-0 and stage-1 steps.

Public surface: train / evaluate / test / save_mesh / export_stage1 /
save_checkpoint.

Everything runs on the one device the Trainer is given (``device``,
default "cuda"; tests pass "cpu").  Its randomness comes from one
``torch.Generator`` on that device, seeded from ``cfg.seed``, through three
methods: ``_stage0_randoms`` (a stage-0 step's draws),
``_occupancy_draws`` (an occupancy update's) and ``_frame_randoms`` (a
stage-1 frame's, in training and eval); a subclass may return other draws.

Data parallelism (``dp``, a ``parallel.mesh.DataParallel``; ``main.py``
makes one a rank): every rank builds the same Trainer from the same seed,
the state is replicated from rank 0 after init and after a resume, and
each step shards the batch over the ranks (stage 0: the rays, ``num_rays``
rounded up to a multiple of R; stage 1: bands of image rows).  Every
decision that changes a static or the loop reads numbers summed over the
ranks (num_points, uncertain_count, face_err / face_cnt, the eval metric),
so the ranks take the same path.  Every rank evaluates (its draws keep the
generators in step); rank 0 alone writes logs, metrics, checkpoints,
meshes, exports and test renders, while the others wait at a barrier.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..config import Config
from ..data.provider import FrameData, RayDataset
from ..device import resolve_device
from ..models import nerf as nerf_model
from ..models.material import MaterialSpec, sample_material
from ..models.nerf import NeRFSpec
from ..ops.occupancy import OccupancyDraws, draw_occupancy
from ..parallel import mesh as pmesh
from ..render.stage1 import FrameRandoms, Stage1Static, draw_frame_randoms, render_stage1
from ..utils.profiling import MetricsWriter
from . import checkpoint as ckpt
from . import stage0, stage1
from .losses import build_topology
from .metrics import psnr as psnr_fn
from .metrics import ssim as ssim_fn


class Trainer:
    def __init__(self, name: str, cfg: Config, train_data: FrameData,
                 workspace: Optional[str] = None, nerf_spec: Optional[NeRFSpec] = None,
                 device="cuda", dp: Optional[pmesh.DataParallel] = None):
        self.dp = dp
        self.is_main = dp is None or dp.rank == 0
        self.device = resolve_device(device) if dp is None else dp.device
        self.name = name
        self.cfg = cfg
        self.workspace = workspace or cfg.workspace
        os.makedirs(self.workspace, exist_ok=True)
        self.log_path = os.path.join(self.workspace, f"log_{name}.txt")
        self.metrics_writer = MetricsWriter(os.path.join(self.workspace, f"metrics_{name}.jsonl"))

        compute_dtype = torch.bfloat16 if cfg.fp16 else torch.float32
        self.nerf_spec = nerf_spec or NeRFSpec(
            bound=cfg.bound, sdf=cfg.sdf, compute_dtype=compute_dtype,
            grid_levels=cfg.hash_levels, grid_log2_hashmap_size=cfg.hash_log2_size,
            grid_desired_resolution=cfg.hash_max_res)
        self.sampler = RayDataset(train_data, bound=cfg.bound, background=cfg.background,
                                  device=self.device)
        self.train_data = train_data
        self.generator = torch.Generator(device=self.device).manual_seed(cfg.seed)
        self.global_step = 0
        self.best_metric = -1e9
        # consecutive logged checks with uncertain_count > 0 (tracer-budget
        # auto-escalation, _escalate_tracer_budget)
        self._uncertain_strikes = 0

        if dp is not None:
            R = dp.world
            if cfg.stage == 0 and cfg.num_rays % R != 0:
                cfg.num_rays = ((cfg.num_rays + R - 1) // R) * R
            self.log(f"[dp] data-parallel over {R} ranks ({dp.backend})")

        # colmap sparse points give a tighter scene AABB
        pts = getattr(train_data, "pts3d", None)
        if cfg.stage == 0 and pts is not None and len(pts) > 0 and cfg.scene_aabb is None:
            lo = np.clip(np.percentile(pts, 0.5, axis=0), -cfg.bound, cfg.bound)
            hi = np.clip(np.percentile(pts, 99.5, axis=0), -cfg.bound, cfg.bound)
            cfg.scene_aabb = tuple(np.concatenate([lo, hi]).tolist())
            self.log(f"[aabb] from sparse points: {cfg.scene_aabb}")

        if cfg.stage == 0:
            self.state = stage0.init_state(self.generator, cfg, self.nerf_spec,
                                           device=self.device)
            self.train_step = stage0.make_train_step(cfg, self.nerf_spec, self.sampler, dp=dp)
            self.occ_update = stage0.make_occ_update(cfg, self.nerf_spec)
            self.render_fn = stage0.make_render_fn(cfg, self.nerf_spec)
            if cfg.mark_untrained:
                # frustum-cull never-seen grid cells (-O preset)
                from ..ops.occupancy import mark_untrained_grid

                occ = mark_untrained_grid(
                    self.state.occ, torch.as_tensor(train_data.poses, device=self.device),
                    train_data.intrinsics, train_data.W, train_data.H, cfg.bound)
                self.state = self.state._replace(occ=occ)
                n_marked = int((occ.density_grid < 0).sum())
                self.log(f"[mark_untrained] {n_marked} cells outside all frustums")
            if cfg.ckpt != "scratch":
                self._try_resume(stage=0)
        else:
            self._init_stage1()
        if dp is not None:
            self.state = ckpt.replicate_state(self.state, dp)

    # ------------------------------------------------------------------ utils
    def log(self, msg: str) -> None:
        if not self.is_main:
            return
        print(msg)
        with open(self.log_path, "a") as f:
            f.write(msg + "\n")

    def _on_main(self, fn):
        """fn() on rank 0 alone (its result there, None elsewhere); every
        rank waits for it."""
        out = fn() if self.is_main else None
        if self.dp is not None:
            pmesh.barrier(self.dp)
        return out

    def _stage0_randoms(self) -> stage0.Stage0Randoms:
        """The draws of one stage-0 step."""
        return stage0.draw_stage0_randoms(self.sampler, self.cfg, self.train_step.march_candidates,
                                          self.generator)

    def _occupancy_draws(self) -> OccupancyDraws:
        """The draws of one occupancy update."""
        return draw_occupancy(self.state.occ, self.cfg.bound, self.cfg.stochastic_interp,
                              self.generator)

    def _frame_randoms(self, P: int, static: Stage1Static) -> FrameRandoms:
        """The draws of one stage-1 frame of P pixels."""
        return draw_frame_randoms(P, static, self.generator, self.device)

    # ------------------------------------------------------------- stage 1 init
    def _init_stage1(self) -> None:
        cfg = self.cfg
        from ..export.meshio import read_ply

        mesh_path = cfg.mesh or os.path.join(self.workspace, "mesh_0.ply")
        upd = os.path.join(self.workspace, "mesh_0_updated.ply")
        if os.path.exists(upd):
            mesh_path = upd  # a refined mesh reloads first
        verts, tris = read_ply(mesh_path)
        self._set_mesh(verts, tris)

        mat_spec = MaterialSpec(
            bound=cfg.bound,
            min_vals=tuple(cfg.kd_min[:3]) + tuple(cfg.ks_min),
            max_vals=tuple(cfg.kd_max[:3]) + tuple(cfg.ks_max),
            compute_dtype=torch.bfloat16 if cfg.fp16 else torch.float32)
        ssaa = max(int(cfg.ssaa), 1)
        H, W = self.train_data.H * ssaa, self.train_data.W * ssaa
        # pixel-chunked fallback: the train step renders a row band
        self.stage1_rows = int(cfg.stage1_rows)
        if self.stage1_rows > 0:
            if self.train_data.H % self.stage1_rows:
                raise ValueError(f"stage1_rows ({self.stage1_rows}) must divide the image "
                                 f"height ({self.train_data.H})")
            H = self.stage1_rows * ssaa
        self.static = Stage1Static(
            tris=self._tris_t, nerf_spec=self.nerf_spec, mat_spec=mat_spec,
            spp=cfg.spp, bounces=cfg.pt_bounces, use_restir=cfg.use_restir, H=H, W=W,
            restir_tiles=cfg.restir_light_tile_count,
            restir_tile_size=cfg.restir_light_tile_size,
            restir_light_samples=cfg.restir_initial_light_samples,
            restir_brdf_samples=cfg.restir_initial_brdf_samples,
            restir_neighbors=cfg.restir_spatial_neighbors,
            restir_radius=cfg.restir_spatial_radius,
            restir_offsets=cfg.restir_neighbor_offset_count,
            restir_history=float(cfg.restir_max_history_length),
            denoise_iters=4 if cfg.use_restir else 0, denoise_bilateral=cfg.use_bi_de,
            enable_offset_nerf_grad=cfg.enable_offset_nerf_grad,
            compute_normal_ao=cfg.use_brdf and cfg.lambda_extra_kd > 0,
            ssaa=ssaa, compact_chunks=cfg.compact_chunks, dp=self.dp)

        # stage 1 bootstraps from the stage-0 best (else latest) EMA field
        nerf_params = nerf_model.init_nerf(self.generator, self.nerf_spec, device=self.device)
        p = (ckpt.find_checkpoint(self.workspace, self.name, 0, "best")
             or ckpt.find_checkpoint(self.workspace, self.name, 0, "latest"))
        if p:
            nerf_params, _, _ = ckpt.load_checkpoint(p, nerf_params, prefix=".ema_params")
            self.log(f"[stage1] loaded stage-0 field from {p}")

        self.state = stage1.init_state(self.generator, cfg, self.static, nerf_params,
                                       verts.shape[0], device=self.device)
        self.train_step = stage1.make_train_step(cfg, self.static, self._base_verts_t, self.topo)
        self._face_err_acc = np.zeros(tris.shape[0], np.float64)
        self._face_cnt_acc = np.zeros(tris.shape[0], np.float64)
        if cfg.ckpt != "scratch":
            self._try_resume(stage=1)

    def _set_mesh(self, verts: np.ndarray, tris: np.ndarray) -> None:
        self.base_verts = np.asarray(verts, np.float32)
        self.tris = np.asarray(tris, np.int32)
        self.topo = build_topology(self.tris, self.base_verts.shape[0])
        self._base_verts_t = torch.as_tensor(self.base_verts, device=self.device)
        self._tris_t = torch.as_tensor(self.tris, device=self.device)

    def _current_verts(self) -> np.ndarray:
        return (self._base_verts_t + self.state.params.offsets).detach().cpu().numpy()

    def _refine_mesh(self) -> None:
        """Error-driven subdivide / decimate, then a new static, zeroed
        offsets and a fresh optimizer."""
        from ..export.meshio import write_ply
        from ..export.refine import refine_and_decimate

        cfg = self.cfg
        errs = np.where(self._face_cnt_acc > 0,
                        self._face_err_acc / np.maximum(self._face_cnt_acc, 1), 0.0)
        v2, t2 = refine_and_decimate(self._current_verts(), self.tris, errs,
                                     decimate_ratio=cfg.refine_decimate_ratio,
                                     min_edge_len=cfg.refine_size)
        self.log(f"[refine] mesh {self.tris.shape[0]} -> {t2.shape[0]} faces")
        if self.is_main:
            write_ply(os.path.join(self.workspace, "mesh_0_updated.ply"), v2, t2)

        self._set_mesh(v2, t2)
        self.static = dataclasses.replace(self.static, tris=self._tris_t)
        params = self.state.params._replace(
            offsets=torch.zeros((v2.shape[0], 3), dtype=torch.float32, device=self.device))
        self.state = stage1.Stage1State(params=params,
                                        opt_state=stage1.make_optimizer(cfg).init(params),
                                        step=self.state.step)
        self.train_step = stage1.make_train_step(cfg, self.static, self._base_verts_t, self.topo)
        self._face_err_acc = np.zeros(t2.shape[0], np.float64)
        self._face_cnt_acc = np.zeros(t2.shape[0], np.float64)

    def _try_resume(self, stage: int) -> None:
        which = "best" if self.cfg.ckpt == "best" else "latest"
        p = self.cfg.ckpt if os.path.exists(str(self.cfg.ckpt)) else ckpt.find_checkpoint(
            self.workspace, self.name, stage, which)
        if not p:
            return
        self.state, step, extra = ckpt.load_checkpoint(p, self.state)
        self.global_step = step
        self.log(f"[ckpt] resumed from {p} at step {step}")
        # escalated tracer budgets survive a resume
        budgets = extra.get("tracer_budgets")
        if stage == 1 and budgets and budgets != self._tracer_budgets():
            grown = {k: max(int(v), getattr(self.static, k)) for k, v in budgets.items()}
            self.static = dataclasses.replace(self.static, **grown)
            self.train_step = stage1.make_train_step(self.cfg, self.static, self._base_verts_t,
                                                     self.topo)
            self.log(f"[ckpt] restored escalated tracer budgets {grown}")

    # ------------------------------------------------------------------ train
    def train(self, max_steps: Optional[int] = None, valid_data: Optional[FrameData] = None,
              eval_max_frames: int = 8) -> None:
        """The training loop; with ``valid_data``, evaluate() on the val split
        every eval interval keys the best checkpoint (else the train batch's
        PSNR does)."""
        cfg = self.cfg
        steps = max_steps or cfg.iters
        eval_every = max(steps // max(cfg.n_eval, 1), 1)
        save_every = max(steps // max(cfg.n_ckpt, 1), 1)
        t0 = time.time()
        last: Dict[str, float] = {}

        start = self.global_step
        for i in range(start, steps):
            if cfg.stage == 0:
                rand = self._stage0_randoms()
                if i % cfg.update_extra_interval == 0:
                    self.state = self.occ_update(self.state, draws=self._occupancy_draws())
                self.state, aux = self.train_step(self.state, rand=rand)
            else:
                batch = self._stage1_batch(i)
                rand = self._frame_randoms(batch["rays_o"].shape[0], self.static)
                self.state, aux = self.train_step(self.state, batch, rand=rand)
                if cfg.refine:
                    self._face_err_acc += aux["face_err"].cpu().numpy()
                    self._face_cnt_acc += aux["face_cnt"].cpu().numpy()
                    if (i + 1) in cfg.refine_steps:
                        self._refine_mesh()
            self.global_step = i + 1

            if (i + 1) % 100 == 0 or i == steps - 1:
                last = {k: float(v) for k, v in aux.items() if getattr(v, "ndim", 0) == 0}
                if cfg.stage == 0 and cfg.adaptive_num_rays:
                    self._adapt_num_rays(last.get("num_points", 0.0))
                if last.get("uncertain_count", 0.0) > 0:
                    # tile-tracer budget truncation: results may miss hits.
                    # Persisting across checks, the budgets escalate to the
                    # next bucket (grow-only)
                    self._uncertain_strikes += 1
                    self.log(f"[tracer] WARNING: {last['uncertain_count']:.0f} rays exceeded the "
                             f"candidate budget this step (strike {self._uncertain_strikes})")
                    if (self._uncertain_strikes >= 2 and cfg.stage == 1
                            and not self._escalate_tracer_budget()):
                        self.log("[tracer] budgets at cap — results may remain approximate on "
                                 "this geometry")
                else:
                    self._uncertain_strikes = 0
                rate = (i + 1 - start) / max(time.time() - t0, 1e-9)
                self.log(f"[train] step {i+1}/{steps} loss={last.get('loss', 0):.5f} "
                         f"psnr={last.get('psnr', 0):.2f} it/s={rate:.2f}")
                if self.is_main:
                    self.metrics_writer.write(i + 1, it_per_s=rate, **last)
            if (i + 1) % save_every == 0 or i == steps - 1:
                self.save_checkpoint()
            if (i + 1) % eval_every == 0:
                if valid_data is not None:
                    ev = self.evaluate(valid_data, max_frames=eval_max_frames)
                    metric = ev.get("psnr_brdf", ev.get("psnr", 0.0))
                    if self.is_main:
                        self.metrics_writer.write(i + 1, **{f"val_{k}": v for k, v in ev.items()})
                else:
                    metric = last.get("psnr_brdf", last.get("psnr", 0.0))
                if self.dp is not None:     # rank 0's reading keys the best checkpoint
                    metric = float(pmesh.all_reduce_scalars(
                        {"m": metric if self.is_main else 0.0}, self.dp)["m"])
                if metric > self.best_metric:
                    self.best_metric = metric
                    self.save_checkpoint(best=True)

    def _escalate_tracer_budget(self, cap: int = 4096) -> bool:
        """Grow the candidate budgets to the next power-of-two bucket and
        rebuild the stage-1 train step; False when already at the cap.
        Staged: the incoherent budgets grow first (they truncate first);
        every second strike, or once the incoherent pair is at the cap, the
        coherent pair grows too.  The work-queue budget grows in lockstep
        with k_cap (it truncates before k_cap does)."""
        st = self.static
        if (st.k_cap >= cap and st.k_cap_incoherent >= cap
                and st.queue_avg >= cap and st.queue_avg_incoherent >= cap):
            return False
        n_prior = getattr(self, "_n_escalations", 0)
        self._n_escalations = n_prior + 1
        grow_coherent = (n_prior % 2 == 1) or (
            st.k_cap_incoherent >= cap and st.queue_avg_incoherent >= cap)
        self.static = dataclasses.replace(
            st,
            k_cap=min(st.k_cap * 2, cap) if grow_coherent else st.k_cap,
            k_cap_incoherent=min(st.k_cap_incoherent * 2, cap),
            queue_avg=min(st.queue_avg * 2, cap) if grow_coherent else st.queue_avg,
            queue_avg_incoherent=min(st.queue_avg_incoherent * 2, cap))
        self.log(
            f"[tracer] escalating candidate budgets: k_cap {st.k_cap} -> "
            f"{self.static.k_cap}, k_cap_incoherent {st.k_cap_incoherent} -> "
            f"{self.static.k_cap_incoherent}, queue_avg "
            f"{st.queue_avg}/{st.queue_avg_incoherent} -> "
            f"{self.static.queue_avg}/{self.static.queue_avg_incoherent} "
            "(rebuilding train step)")
        self.train_step = stage1.make_train_step(self.cfg, self.static, self._base_verts_t,
                                                 self.topo)
        self._uncertain_strikes = 0
        return True

    def _tracer_budgets(self) -> dict:
        st = self.static
        return {"k_cap": st.k_cap, "k_cap_incoherent": st.k_cap_incoherent,
                "queue_avg": st.queue_avg, "queue_avg_incoherent": st.queue_avg_incoherent}

    def _adapt_num_rays(self, num_points: float) -> bool:
        """-O's adaptive_num_rays: grow the ray batch so a step fills the
        num_points sample budget once the occupancy thins the samples a ray;
        power-of-two multiples of the starting count, grow-only, capped at
        max(start, 2^14).  A grown batch rebuilds the step (and its march
        lattice length)."""
        cfg = self.cfg
        if num_points <= 0:
            return False
        cap = max(cfg.num_rays, 2 ** 14)
        desired = cfg.num_rays * cfg.num_points / num_points
        grew = False
        while cfg.num_rays * 2 <= min(desired, cap):
            cfg.num_rays *= 2
            grew = True
        if grew:
            self.log(f"[adaptive] num_points {num_points:.0f}/{cfg.num_points} -> "
                     f"num_rays {cfg.num_rays} (rebuilding train step)")
            self.train_step = stage0.make_train_step(cfg, self.nerf_spec, self.sampler, dp=self.dp)
        return grew

    def _stage1_batch(self, i: int) -> Dict[str, torch.Tensor]:
        ssaa = max(int(self.cfg.ssaa), 1)
        f = self.sampler.frame_rays(i % self.train_data.num_frames, ssaa=ssaa)
        batch = {k: f[k] for k in ("rays_o", "rays_d", "pixels", "alpha")}
        if self.stage1_rows > 0:
            # a contiguous band of rows (image-space passes stay valid inside
            # it); bands cycle across steps
            Hb, Wb = self.train_data.H, self.train_data.W
            b = (i // max(self.train_data.num_frames, 1)) % (Hb // self.stage1_rows)
            r0 = b * self.stage1_rows
            hi = slice(r0 * ssaa * Wb * ssaa, (r0 + self.stage1_rows) * ssaa * Wb * ssaa)
            lo = slice(r0 * Wb, (r0 + self.stage1_rows) * Wb)
            batch = {"rays_o": batch["rays_o"][hi], "rays_d": batch["rays_d"][hi],
                     "pixels": batch["pixels"][lo], "alpha": batch["alpha"][lo]}
        return batch

    # ----------------------------------------------------------------- eval
    def evaluate(self, data: Optional[FrameData] = None,
                 max_frames: Optional[int] = None) -> Dict[str, float]:
        """Twin meters: the NeRF image and the BRDF image of one render a
        frame; with cfg.eval_use_gt_mask the GT alpha masks both."""
        sampler = (RayDataset(data, bound=self.cfg.bound, device=self.device)
                   if data is not None else self.sampler)
        n = sampler.data.num_frames if max_frames is None else min(sampler.data.num_frames,
                                                                    max_frames)
        lp = self._lpips()
        acc: Dict[str, List[float]] = {}

        def put(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=self.device)

        for i in range(n):
            outs, gt = self._render_eval_outputs(sampler, i)
            img = outs["image"]
            brdf = outs.get("image_brdf")
            if self.cfg.eval_use_gt_mask and sampler.data.images.shape[-1] == 4:
                m = np.asarray(sampler.data.images[i, ..., 3:4]) > 0.5
                img = np.where(m, img, 1.0)
                gt = np.where(m, gt, 1.0)
                if brdf is not None:
                    brdf = np.where(m, brdf, 1.0)
            gt_t = put(gt)
            acc.setdefault("psnr", []).append(float(psnr_fn(put(img), gt_t)))
            acc.setdefault("ssim", []).append(float(ssim_fn(put(img), gt_t)))
            if lp is not None:
                acc.setdefault("lpips", []).append(lp(img, gt))
            if brdf is not None:
                acc.setdefault("psnr_brdf", []).append(float(psnr_fn(put(brdf), gt_t)))
                acc.setdefault("ssim_brdf", []).append(float(ssim_fn(put(brdf), gt_t)))
                if lp is not None:
                    acc.setdefault("lpips_brdf", []).append(lp(brdf, gt))
        res = {k: float(np.mean(v)) for k, v in acc.items()}
        self.log(f"[eval] {res}")
        return res

    def _lpips(self):
        if not hasattr(self, "_lpips_cache"):
            from .metrics import lpips_fn

            self._lpips_cache = lpips_fn(self.cfg.lpips_weights, device=self.device)
            kind = getattr(self._lpips_cache, "kind", "?")
            if kind != "vgg":
                self.log(f"[lpips] using '{kind}' fallback (no VGG weights given)")
        return self._lpips_cache

    @staticmethod
    def _downsample(x: np.ndarray, H: int, W: int, ssaa: int) -> np.ndarray:
        x = np.asarray(x, np.float32)
        c = x.shape[-1] if x.ndim > 1 else 1
        x = x.reshape(H * ssaa, W * ssaa, -1)
        if ssaa > 1:
            x = x.reshape(H, ssaa, W, ssaa, -1).mean(axis=(1, 3))
        return x if c > 1 else x[..., 0]

    @torch.no_grad()
    def _render_eval_outputs(self, sampler: RayDataset, idx: int):
        """Render one frame -> ({name: [H, W(, C)] numpy}, gt [H, W, 3])."""
        ssaa = max(int(self.cfg.ssaa), 1) if self.cfg.stage == 1 else 1
        f = sampler.frame_rays(idx, ssaa=ssaa)
        H, W = sampler.H, sampler.W
        gt = f["pixels"].cpu().numpy().reshape(H, W, 3)
        if self.cfg.stage == 0:
            img, depth = stage0.render_frame(self.state, self.render_fn, f["rays_o"], f["rays_d"],
                                             H, W)
            return {"image": np.clip(img, 0, 1), "depth": depth}, gt

        # relighting: another envmap, scaled albedo, exposure
        relight_env = albedo_scale = exposure = None
        if self.cfg.test and self.cfg.envmap_path != "None":
            relight_env = self._relight_env()
            albedo_scale = torch.tensor([self.cfg.albedo_scale_x, self.cfg.albedo_scale_y,
                                         self.cfg.albedo_scale_z], device=self.device)
        if self.cfg.use_hdr:
            exposure = torch.tensor(2.0 ** self.cfg.exposure, device=self.device)

        static = dataclasses.replace(self.static, dp=None)    # whole frames on each rank
        if getattr(self, "stage1_rows", 0) > 0:
            # eval renders full frames even when training is row-banded
            static = dataclasses.replace(static, H=sampler.H * ssaa)
        # test-mode spp: converged NVS eval (eval_spp), relighting (relight_spp)
        if self.cfg.test:
            spp = self.cfg.relight_spp if relight_env is not None else self.cfg.eval_spp
            if spp > 0 and spp != static.spp:
                static = dataclasses.replace(static, spp=spp)
        P = f["rays_o"].shape[0]
        out = render_stage1(self.state.params, static, self._base_verts_t, f["rays_o"],
                            f["rays_d"], rand=self._frame_randoms(P, static),
                            relight_env=relight_env, albedo_scale=albedo_scale,
                            exposure_scale=exposure)

        def ds(k):
            return self._downsample(out[k].float().cpu().numpy(), H, W, ssaa)

        outs = {"image": np.clip(ds("image"), 0, 1), "depth": ds("depth")}
        if self.cfg.use_brdf:
            outs["image_brdf"] = np.clip(ds("image_brdf"), 0, 1)
            for k in ("kd", "ks", "normal", "diffuse_light", "specular_light"):
                outs[k] = ds(k)
        return outs, gt

    def _relight_env(self) -> torch.Tensor:
        if not hasattr(self, "_relight_env_cache"):
            from ..utils.image_io import load_hdr

            env = load_hdr(self.cfg.envmap_path)
            self._relight_env_cache = torch.as_tensor(env, device=self.device)
            self.log(f"[relight] loaded {self.cfg.envmap_path} {env.shape}")
        return self._relight_env_cache

    def test(self, data: Optional[FrameData] = None, out_dir: Optional[str] = None) -> None:
        """Render the test frames and write rgb / depth / brdf PNGs and the
        kd / ks / normal / diffuse / specular EXRs of each, and the trained
        envmap's EXR once (the inputs of albedo_eval); on rank 0."""
        self._on_main(lambda: self._test(data, out_dir))

    def _test(self, data: Optional[FrameData], out_dir: Optional[str]) -> None:
        from ..utils.image_io import save_exr, save_png

        sampler = (RayDataset(data, bound=self.cfg.bound, device=self.device)
                   if data is not None else self.sampler)
        out_dir = out_dir or os.path.join(self.workspace, "results")
        os.makedirs(out_dir, exist_ok=True)
        exr_keys = {"kd": "kd", "ks": "ks", "normal": "normal",
                    "diffuse_light": "diffuse", "specular_light": "specular"}
        for i in range(sampler.data.num_frames):
            outs, _ = self._render_eval_outputs(sampler, i)
            base = os.path.join(out_dir, f"{self.name}_{i:04d}")
            save_png(base + "_rgb.png", outs["image"])
            d = outs["depth"]
            save_png(base + "_depth.png", d / max(float(d.max()), 1e-8))
            if "image_brdf" in outs:
                save_png(base + "_brdf.png", outs["image_brdf"])
                for src, dst in exr_keys.items():
                    save_exr(f"{base}_{dst}.exr", outs[src])
        if self.cfg.stage == 1 and self.cfg.use_brdf:
            save_exr(os.path.join(out_dir, f"{self.name}_env_map.exr"),
                     self.state.params.env.detach().cpu().numpy())
        self.log(f"[test] wrote {sampler.data.num_frames} frames to {out_dir}")

    # ----------------------------------------------------------------- export
    def save_mesh(self, resolution: Optional[int] = None,
                  decimate_target: Optional[float] = None):
        """The stage-0 mesh from the EMA field (mesh_{cascade}.ply); on rank 0."""
        return self._on_main(lambda: self._save_mesh(resolution, decimate_target))

    def _save_mesh(self, resolution: Optional[int], decimate_target: Optional[float]):
        from ..export.stage0_export import export_stage0_mesh

        cfg = self.cfg
        params = self.state.ema_params

        def density_fn(pts):
            return nerf_model.density(params, pts, self.nerf_spec)["sigma"]

        return export_stage0_mesh(
            density_fn, self.workspace, bound=cfg.bound, cascade=cfg.cascade,
            resolution=resolution or cfg.mcubes_reso, density_thresh=cfg.density_thresh,
            decimate_target=decimate_target if decimate_target is not None
            else cfg.decimate_target,
            clean_min_f=cfg.clean_min_f, clean_min_d=cfg.clean_min_d, sdf=cfg.sdf,
            dataset=self.train_data if cfg.mesh_visibility_culling else None,
            visibility_culling=cfg.mesh_visibility_culling, env_reso=cfg.env_reso,
            device=self.device)

    def export_stage1(self, texture_size: Optional[int] = None) -> Optional[str]:
        """The textured mesh (rank 0's path; None on the other ranks)."""
        return self._on_main(lambda: self._export_stage1(texture_size))

    def _export_stage1(self, texture_size: Optional[int]) -> str:
        from ..export.stage1_export import export_stage1_mesh

        params = self.state.params

        def material_fn(pts):
            return sample_material(params.mat, pts, self.static.mat_spec)

        return export_stage1_mesh(self._current_verts(), self.tris, material_fn, self.workspace,
                                  texture_size=texture_size or self.cfg.texture_size,
                                  device=self.device)

    # ------------------------------------------------------------- checkpoints
    def save_checkpoint(self, best: bool = False) -> None:
        if not self.is_main:
            return
        extra = {}
        if self.cfg.stage == 1:
            # (possibly escalated) tracer budgets beside the state
            extra["tracer_budgets"] = self._tracer_budgets()
        ckpt.save_checkpoint(self.workspace, self.name, self.cfg.stage, self.global_step,
                             self.state, extra=extra, best=best)
