"""Weights carried across from the JAX package.

``params_from_jax`` takes the leaves of the reference's ``Stage1Params`` as
numpy arrays (the same nested dicts and lists: ``nerf = {"encoder",
"sigma_net": [...], "color_net": [...]}``, ``mat = {"encoder", "net": [...]}``,
``env`` [H,W,3], ``offsets`` [V,3]) and returns the port's params on the
device, so both packages compute the same frame.  ``params_to_numpy`` is its
inverse.

``state_from_jax`` carries a whole stage-1 training state across: the
reference's ``Stage1State`` (params, the optax ``multi_transform`` state and
the step), read by duck typing with ``numpy.asarray`` on its leaves, becomes
the port's ``train.stage1.Stage1State`` with each group's Adam ``count``,
``mu`` and ``nu``.  A JAX checkpoint can so resume in the port.
``state_to_numpy`` is its inverse in numpy.

``stage0_state_from_jax`` / ``stage0_state_to_numpy`` do the same for the
reference's stage-0 ``TrainState``: the NeRF params (with ``variance`` in
sdf mode), the ``scale_by_adam`` count / mu / nu inside its optax chain,
the EMA params, the ``OccupancyState`` and the step.

``bvh_from_jax``, ``env_distribution_from_jax`` and ``alias_table_from_jax``
carry the reference's LBVH, exact env distribution and alias table over
(fields by name, integers as int64), so the port's traversal and samplers
can run on the reference's own structures.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .device import resolve_device
from .models.envlight import AliasTable, EnvDistribution
from .ops.bvh import BVH
from .ops.occupancy import OccupancyState
from .render.stage1 import Stage1Params
from .train import stage0
from .train.stage0 import AdamState
from .train.stage1 import GROUPS, Stage1State


def _to_torch(x: Any, dev: torch.device):
    if isinstance(x, dict):
        return {k: _to_torch(v, dev) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_to_torch(v, dev) for v in x]
    return torch.tensor(np.asarray(x, dtype=np.float32), device=dev)


def _to_numpy(x: Any):
    if isinstance(x, dict):
        return {k: _to_numpy(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_to_numpy(v) for v in x]
    return x.detach().cpu().numpy()


def params_from_jax(nerf, mat, env, offsets, device="cuda") -> Stage1Params:
    dev = resolve_device(device)
    return Stage1Params(nerf=_to_torch(nerf, dev), offsets=_to_torch(offsets, dev),
                        mat=_to_torch(mat, dev), env=_to_torch(env, dev))


def params_to_numpy(params: Stage1Params):
    """(nerf, mat, env, offsets) as numpy leaves, the layout params_from_jax takes."""
    return (_to_numpy(params.nerf), _to_numpy(params.mat), _to_numpy(params.env),
            _to_numpy(params.offsets))


def _jax_leaves(x) -> list:
    """jax.tree.leaves without JAX: dicts by sorted key, tuples (NamedTuples
    included; optax's empty MaskedNode / EmptyState add nothing) and lists
    in order, anything with a shape is a leaf."""
    if isinstance(x, dict):
        return [y for k in sorted(x) for y in _jax_leaves(x[k])]
    if isinstance(x, (list, tuple)):
        return [y for v in x for y in _jax_leaves(v)]
    if x is None:
        return []
    return [x]


def _adam_from_jax(inner, dev) -> AdamState:
    """The ScaleByAdamState (count, mu, nu) inside an optax chain state."""
    chain = getattr(inner, "inner_state", inner)
    (adam,) = [st for st in chain if hasattr(st, "mu") and hasattr(st, "nu")]
    return AdamState(count=torch.tensor(int(np.asarray(adam.count)), dtype=torch.int32),
                     mu=[_to_torch(x, dev) for x in _jax_leaves(adam.mu)],
                     nu=[_to_torch(x, dev) for x in _jax_leaves(adam.nu)])


def state_from_jax(jstate, device="cuda") -> Stage1State:
    """The reference's stage-1 ``Stage1State`` -> the port's, on the device.
    Each optimizer group's state is the ``ScaleByAdamState`` (count, mu, nu)
    inside ``opt_state.inner_states[group]``."""
    dev = resolve_device(device)
    p = jstate.params
    params = params_from_jax(p.nerf, p.mat, p.env, p.offsets, device=dev)
    opt = {g: _adam_from_jax(jstate.opt_state.inner_states[g], dev) for g in GROUPS}
    return Stage1State(params, opt, torch.tensor(int(np.asarray(jstate.step)), dtype=torch.int32))


def state_to_numpy(state: Stage1State):
    """-> (params as params_to_numpy gives them, {group: {"count", "mu",
    "nu"}} with mu / nu lists of arrays in the reference's leaf order, step)."""
    opt = {g: {"count": int(st.count), "mu": _to_numpy(st.mu), "nu": _to_numpy(st.nu)}
           for g, st in state.opt_state.items()}
    return params_to_numpy(state.params), opt, int(state.step)


def stage0_state_from_jax(jstate, device="cuda") -> stage0.TrainState:
    """The reference's stage-0 ``TrainState`` -> the port's, on the device."""
    dev = resolve_device(device)
    occ = jstate.occ
    return stage0.TrainState(
        params=_to_torch(jstate.params, dev), opt_state=_adam_from_jax(jstate.opt_state, dev),
        ema_params=_to_torch(jstate.ema_params, dev),
        occ=OccupancyState(density_grid=_to_torch(occ.density_grid, dev),
                           occ=torch.tensor(np.asarray(occ.occ, dtype=np.uint8), device=dev),
                           mean_density=_to_torch(occ.mean_density, dev)),
        step=torch.tensor(int(np.asarray(jstate.step)), dtype=torch.int32))


def stage0_state_to_numpy(state: stage0.TrainState):
    """-> {"params", "opt": {"count", "mu", "nu"}, "ema_params", "occ":
    {"density_grid", "occ", "mean_density"}, "step"} in numpy; mu / nu in
    the reference's leaf order."""
    st = state.opt_state
    return {"params": _to_numpy(state.params),
            "opt": {"count": int(st.count), "mu": _to_numpy(st.mu), "nu": _to_numpy(st.nu)},
            "ema_params": _to_numpy(state.ema_params),
            "occ": {k: _to_numpy(v) for k, v in state.occ._asdict().items()},
            "step": int(state.step)}


def _fields_from_jax(cls, src, dev):
    """A NamedTuple of the port from the same-named fields of the reference's:
    floats as float32, integers as int64."""
    def conv(x):
        a = np.asarray(x)
        return torch.tensor(a.astype(np.int64 if a.dtype.kind in "iu" else np.float32), device=dev)

    return cls(**{f: conv(getattr(src, f)) for f in cls._fields})


def bvh_from_jax(jbvh, device="cuda") -> BVH:
    """The reference's ``ops/bvh.py`` BVH -> the port's, on the device."""
    return _fields_from_jax(BVH, jbvh, resolve_device(device))


def env_distribution_from_jax(jdist, device="cuda") -> EnvDistribution:
    """The reference's ``EnvDistribution`` -> the port's, on the device."""
    return _fields_from_jax(EnvDistribution, jdist, resolve_device(device))


def alias_table_from_jax(jtable, device="cuda") -> AliasTable:
    """The reference's ``AliasTable`` -> the port's, on the device."""
    return _fields_from_jax(AliasTable, jtable, resolve_device(device))
