"""The traffic kinds: how a window drives the program.  A traffic file
names its ``kind`` and the parameters the kind reads; a new mix of an
existing kind is a new file only.

- ``stage1_train``: the Trainer's stage-1 loop body as ``Trainer.train``
  runs it (``_stage1_batch(i)``, ``_frame_randoms``, ``train_step``), the
  views cycling, no evaluation, checkpoint or log inside the window.
- ``stage0_train``: the Trainer's stage-0 loop body (``_stage0_randoms``,
  ``occ_update`` every ``update_extra_interval`` steps, ``train_step``,
  ``_adapt_num_rays`` every 100 steps).

Set-up builds the kernels (cached in ``build/torch_kernels`` inside the
checkout), makes the scene, builds the Trainer and drives its first
``follow_steps`` steps through the window's own call while the benchmark
records what it compares (``program``: losses, the first gradient as the
optimizer got it, the parameters' change) and what the reference needs
(``records``: the program's tracer answers in stage 1).  A stage-0 set-up
then runs on to ``settle_steps``, so that ``_adapt_num_rays`` has grown
the batch to the window's, copies its state to ``records`` and follows as
many steps again.  The window runs whole steps until ``--seconds`` have
passed.

Before each step a driver adds that step's model FLOPs, counted from the
shapes it runs at (``work_per_step``, ``counts/flops.py``; host integers
only), to ``flops``; the window reports those of its own steps.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..counts import flops as F
from . import counting
from .scene import make_scene

B1 = 0.9


def write_ply(path: str, verts: np.ndarray, tris: np.ndarray) -> None:
    """A binary little-endian triangle PLY."""
    header = ("ply\nformat binary_little_endian 1.0\n"
              f"element vertex {len(verts)}\n"
              "property float x\nproperty float y\nproperty float z\n"
              f"element face {len(tris)}\n"
              "property list uchar int vertex_indices\nend_header\n")
    faces = np.empty((len(tris),), dtype=np.dtype([("n", "u1"), ("idx", "<i4", (3,))]))
    faces["n"] = 3
    faces["idx"] = tris
    with open(path, "wb") as f:
        f.write(header.encode())
        f.write(np.ascontiguousarray(verts, "<f4").tobytes())
        f.write(faces.tobytes())


def program_config(config: Dict, seed: int, workspace: str, mesh_path: Optional[str]):
    """The program's Config from the configuration's published flags, through
    the program's own command line, with the file's ``set`` keys and the
    run's seed, workspace and mesh."""
    from mirres_restir_nerf_mesh_torch.main import config_from_args

    argv = ["scene", *config["flags"], "--workspace", workspace, "--seed", str(seed),
            "--ckpt", "scratch"]
    for k, v in config.get("set", {}).items():
        argv += [f"--{k}", str(v)]
    if mesh_path:
        argv += ["--mesh", mesh_path]
    return config_from_args(argv)


def norms(leaves: List[torch.Tensor]) -> List[float]:
    return [float(torch.linalg.vector_norm(x.detach().double())) for x in leaves]


class Driver:
    """The common set-up: the kernels, the scene, the Trainer."""

    def __init__(self, cell: str, config: Dict, traffic: Dict, seed: int, device, workdir: str):
        self.cell, self.config, self.traffic = cell, config, traffic
        self.seed, self.device, self.workdir = int(seed), torch.device(device), workdir
        self.i = 0                   # the next step's index
        self.losses: List[torch.Tensor] = []
        self.program: Dict = {}      # readings the reference is compared with
        self.records: List[Dict] = []
        self.spans = counting.Spans(False)
        self.flops: Optional[int] = 0    # model FLOPs of the steps taken (None: not counted)
        self.log = lambda msg: None

    def build_kernels(self) -> None:
        if self.device.type == "cuda":
            from mirres_restir_nerf_mesh_torch import cuda_build

            cuda_build.build()

    def make_trainer(self, with_mesh: bool):
        from mirres_restir_nerf_mesh_torch.data.provider import FrameData, compute_mvps
        from mirres_restir_nerf_mesh_torch.train.trainer import Trainer

        os.makedirs(self.workdir, exist_ok=True)
        self.scene = make_scene(self.config["scene"], self.device)
        sc = self.scene
        self.log("scene made")
        mesh_path = None
        if with_mesh:
            mesh_path = os.path.join(self.workdir, "mesh.ply")
            write_ply(mesh_path, sc["verts"], sc["tris"])
        self.cfg = program_config(self.config, self.seed, self.workdir, mesh_path)
        data = FrameData(images=sc["images"], poses=sc["poses"], intrinsics=sc["intrinsics"],
                         H=sc["H"], W=sc["W"],
                         mvps=compute_mvps(sc["poses"], sc["intrinsics"], sc["H"], sc["W"],
                                           self.cfg.bound))
        self.trainer = Trainer(self.cell, self.cfg, data, workspace=self.workdir,
                               device=self.device)
        self.log("Trainer built")

    def tally(self) -> None:
        """Add the model FLOPs of the step about to run."""
        f = self.work_per_step().get("flops")
        self.flops = None if f is None or self.flops is None else self.flops + f

    def work_per_step(self) -> Dict:
        """The step about to run, from its shapes: ``flops``, its model FLOPs
        (left out where the kind cannot count them)."""
        return {}

    def window(self, seconds: float) -> Dict:
        """Whole steps until ``seconds`` have passed -> steps, seconds, the
        steps' model FLOPs (None: not counted) and each step's host seconds
        (unsynchronized: a diagnostic)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        f0 = self.flops
        t0 = time.perf_counter()
        marks = [t0]
        while len(marks) == 1 or marks[-1] - t0 < seconds:
            self.step()
            marks.append(time.perf_counter())
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        return {"steps": len(marks) - 1, "seconds": time.perf_counter() - t0,
                "flops": None if self.flops is None else self.flops - f0,
                "step_s": [b - a for a, b in zip(marks, marks[1:])]}

    def state_note(self) -> str:
        """A line on the program's state for the run's log."""
        return ""

    def failed_steps(self) -> int:
        if not self.losses:
            return 0
        return int((~torch.isfinite(torch.stack([x.float() for x in self.losses]))).sum())

    def free(self) -> None:
        del self.trainer
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()


class Stage1Train(Driver):
    """The stage-1 training loop (traffic kind ``stage1_train``)."""

    def setup(self) -> None:
        from mirres_restir_nerf_mesh_torch.train import stage1

        self.build_kernels()
        self.make_trainer(with_mesh=True)
        t = self.trainer
        params = t.state.params._replace(env=torch.as_tensor(self.scene["env"], device=self.device))
        t.state = t.state._replace(params=params)
        budgets = self.config.get("tracer_budgets")
        if budgets:     # as a resume restores escalated budgets
            t.static = dataclasses.replace(t.static, **budgets)
            t.train_step = stage1.make_train_step(self.cfg, t.static, t._base_verts_t, t.topo)
        self.follow()

    def follow(self) -> None:
        from mirres_restir_nerf_mesh_torch.train import stage1

        t = self.trainer
        leaves0 = {g: [x.detach().clone() for x in v]
                   for g, v in stage1.group_leaves(t.state.params).items()}
        losses, uncertain = [], []
        n = int(self.traffic["follow_steps"])
        with counting.recording_tracer(self.records):
            for k in range(n):
                aux = self.step()
                losses.append(float(aux["loss"]))
                uncertain.append(float(aux["uncertain_count"]))
                self.log(f"followed step {k}: loss {losses[-1]}, uncertain {uncertain[-1]}")
                if k == 0:
                    grads = {g: [mu / (1 - B1) for mu in st.mu]
                             for g, st in t.state.opt_state.items()}
                    self.program["grad_norms"] = {g: norms(v) for g, v in grads.items()}
        after = stage1.group_leaves(t.state.params)
        self.program["change_norms"] = {g: norms([a - b for a, b in zip(after[g], leaves0[g])])
                                        for g in after}
        self.program["losses"] = losses
        self.program["uncertain"] = sum(uncertain)
        self.losses.clear()

    def step(self):
        t = self.trainer
        self.tally()
        batch = t._stage1_batch(self.i)
        rand = t._frame_randoms(batch["rays_o"].shape[0], t.static)
        t.state, aux = t.train_step(t.state, batch, rand=rand)
        t.global_step = self.i + 1
        self.i += 1
        self.losses.append(aux["loss"])
        return aux

    def work_per_step(self) -> Dict:
        return {"flops": F.stage1_step_flops(self.trainer.static)}


def host_tree(x):
    """A copy on the host of a state tree (named tuples as dicts with their
    type's name; each tensor with whether it lived on the device)."""
    if isinstance(x, torch.Tensor):
        return {"tensor": x.detach().cpu().clone(), "on_device": x.device.type != "cpu"}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return {"type": type(x).__name__, "fields": {f: host_tree(getattr(x, f))
                                                     for f in x._fields}}
    if isinstance(x, dict):
        return {k: host_tree(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(host_tree(v) for v in x)
    return x


class Stage0Train(Driver):
    """The stage-0 training loop (traffic kind ``stage0_train``).  Set-up
    follows the first steps from the seed, runs on to ``settle_steps`` (the
    batch grows to the window's), then copies the state to the host and
    follows as many steps again at the window's batch: the reference starts
    those from that copy."""

    def setup(self) -> None:
        self.build_kernels()
        self.make_trainer(with_mesh=False)
        self.program = self.follow()
        self.program["uncertain"] = 0.0
        while self.i < int(self.traffic["settle_steps"]):
            self.step()
        t = self.trainer
        self.records.append({"state": host_tree(t.state), "num_rays": int(t.cfg.num_rays),
                             "generator": t.generator.get_state(), "step": self.i})
        self.program["settled"] = self.follow()
        self.losses.clear()

    def follow(self) -> Dict:
        """Take ``follow_steps`` steps through the window's own call ->
        their losses, the first step's gradient as Adam got it ((mu after
        - b1 mu before) / (1 - b1)), the density grid after the first
        occupancy update among them, and the parameters' change."""
        from mirres_restir_nerf_mesh_torch.train.stage0 import tree_leaves

        t = self.trainer
        leaves0 = [x.detach().clone() for x in tree_leaves(t.state.params)]
        mu0 = [m.detach().clone() for m in t.state.opt_state.mu]
        out: Dict = {}
        self.grid, self.keep_grid = None, True
        losses = []
        for k in range(int(self.traffic["follow_steps"])):
            aux = self.step()
            losses.append(float(aux["loss"]))
            if k == 0:
                out["grad_norms"] = {"net": norms(
                    [(mu - B1 * m0) / (1 - B1) for mu, m0 in zip(t.state.opt_state.mu, mu0)])}
        self.keep_grid = False
        if self.grid is not None:
            out["density_grid"] = self.grid
        out["change_norms"] = {"net": norms(
            [a - b for a, b in zip(tree_leaves(t.state.params), leaves0)])}
        out["losses"] = losses
        return out

    def step(self):
        t = self.trainer
        i = self.i
        self.tally()
        rand = t._stage0_randoms()
        if i % t.cfg.update_extra_interval == 0:
            with self.spans.span("occ_update"):
                t.state = t.occ_update(t.state, draws=t._occupancy_draws())
            if self.keep_grid and self.grid is None:
                self.grid = t.state.occ.density_grid.detach().cpu()
        t.state, aux = t.train_step(t.state, rand=rand)
        if (i + 1) % 100 == 0 and t.cfg.adaptive_num_rays:
            t._adapt_num_rays(float(aux["num_points"]))
        t.global_step = i + 1
        self.i += 1
        self.losses.append(aux["loss"])
        self.last_aux = aux
        return aux

    def work_per_step(self) -> Dict:
        """The field on the batch's compacted rows at the current batch size
        and march lattice (``_adapt_num_rays`` may have grown both), and an
        occupancy update where the step makes one; sdf mode's field is not
        counted."""
        t = self.trainer
        cfg, spec = t.cfg, t.nerf_spec
        if cfg.sdf:
            return {}
        lattice = t.train_step.march_candidates or cfg.max_steps
        rows = F.field_rows(cfg.num_rays, min(cfg.samples_per_ray, lattice, cfg.max_steps),
                            cfg.num_points if cfg.adaptive_num_rays else None)
        flops = F.stage0_step_flops(spec, rows, cfg.stochastic_interp)
        if self.i % cfg.update_extra_interval == 0:
            flops += F.occupancy_update_flops(spec, cfg.cascade, cfg.grid_size,
                                              cfg.stochastic_interp)
        return {"flops": flops}

    def state_note(self) -> str:
        return (f"num_rays {self.trainer.cfg.num_rays}, num_points of the last step "
                f"{float(self.last_aux['num_points']):.0f}")


KINDS = {"stage1_train": Stage1Train, "stage0_train": Stage0Train}


def make(cell: str, config: Dict, traffic: Dict, seed: int, device, workdir: str) -> Driver:
    kind = traffic["kind"]
    if kind not in KINDS:
        raise ValueError(f"traffic kind {kind!r} is not one of {sorted(KINDS)}")
    return KINDS[kind](cell, config, traffic, seed, device, workdir)
