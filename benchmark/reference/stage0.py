"""The reference's stage-0 training, in the frozen copy.

- From the seed: the cell's first steps as the program's Trainer takes
  them (its generator seeded with the run's seed draws the radiance field;
  ``-O`` marks the cells no view sees; each step draws its batch, then on
  every ``update_extra_interval``-th step the occupancy update's draws and
  the update, then the step).
- Settled: as many steps at the window's batch, from the program's state
  after its settle steps (its parameters, optimizer state, occupancy grid,
  step count, batch size and generator state, copied to the host by the
  set-up): the reference cannot follow the hundreds of steps before them.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from .flags import reference_config
from .frozen.data.provider import RayDataset
from .frozen.ops.occupancy import OccupancyState, draw_occupancy, mark_untrained_grid
from .frozen.precision import lowered
from .frozen.train import stage0 as s0
from .stage1 import frames, nerf_spec, norms

B1 = 0.9
TYPES = {"TrainState": s0.TrainState, "AdamState": s0.AdamState,
         "OccupancyState": OccupancyState}


def device_tree(x, dev):
    """The state tree that the set-up copied to the host, rebuilt in the
    frozen copy's types on ``dev`` (tensors that lived on the host stay)."""
    if isinstance(x, dict) and "tensor" in x and "on_device" in x:
        return x["tensor"].to(dev) if x["on_device"] else x["tensor"].clone()
    if isinstance(x, dict) and "type" in x and "fields" in x:
        return TYPES[x["type"]](**{k: device_tree(v, dev) for k, v in x["fields"].items()})
    if isinstance(x, dict):
        return {k: device_tree(v, dev) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(device_tree(v, dev) for v in x)
    return x


def follow(cfg, spec, sampler, state, g, first: int, steps: int, fp8: bool) -> Dict:
    """Take ``steps`` steps from ``state``, the first of index ``first`` ->
    the readings the program's set-up takes of its own steps."""
    step = s0.make_train_step(cfg, spec, sampler)
    occ_update = s0.make_occ_update(cfg, spec)
    leaves0 = [x.clone() for x in s0.tree_leaves(state.params)]
    mu0 = [m.clone() for m in state.opt_state.mu]
    losses: List[float] = []
    out: Dict = {}
    with lowered(fp8):
        for k in range(steps):
            rand = s0.draw_stage0_randoms(sampler, cfg, step.march_candidates, g)
            if (first + k) % cfg.update_extra_interval == 0:
                state = occ_update(state, draws=draw_occupancy(state.occ, cfg.bound,
                                                               cfg.stochastic_interp, g))
                if "density_grid" not in out:
                    out["density_grid"] = state.occ.density_grid.detach().cpu()
            state, aux = step(state, rand=rand)
            losses.append(float(aux["loss"]))
            if k == 0:
                out["grad_norms"] = {"net": norms([(mu - B1 * m0) / (1 - B1) for mu, m0
                                                   in zip(state.opt_state.mu, mu0)])}
    out["change_norms"] = {"net": norms([a - b for a, b in zip(s0.tree_leaves(state.params),
                                                                leaves0)])}
    out["losses"] = losses
    return out


def run(config: Dict, scene: Dict, records, seed: int, steps: int, device,
        fp8: bool = False, sample: int = 0) -> Dict:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    cfg = reference_config(config, seed)
    g = torch.Generator(device=dev).manual_seed(cfg.seed)
    data = frames(scene, cfg)
    sampler = RayDataset(data, bound=cfg.bound, background=cfg.background, device=dev)
    spec = nerf_spec(cfg)
    state = s0.init_state(g, cfg, spec, device=dev)
    if cfg.mark_untrained:
        occ = mark_untrained_grid(state.occ, torch.as_tensor(data.poses, device=dev),
                                  data.intrinsics, data.W, data.H, cfg.bound)
        state = state._replace(occ=occ)
    out = follow(cfg, spec, sampler, state, g, 0, steps, fp8)
    if records:
        snap = records[0]
        cfg.num_rays = int(snap["num_rays"])
        g.set_state(snap["generator"])
        out["settled"] = follow(cfg, spec, sampler, device_tree(snap["state"], dev), g,
                                int(snap["step"]), steps, fp8)
    return out
