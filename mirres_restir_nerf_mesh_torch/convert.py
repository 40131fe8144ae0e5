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
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .device import resolve_device
from .render.stage1 import Stage1Params
from .train.stage1 import GROUPS, AdamState, Stage1State


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


def state_from_jax(jstate, device="cuda") -> Stage1State:
    """The reference's stage-1 ``Stage1State`` -> the port's, on the device.
    Each optimizer group's state is the ``ScaleByAdamState`` (count, mu, nu)
    inside ``opt_state.inner_states[group]``."""
    dev = resolve_device(device)
    p = jstate.params
    params = params_from_jax(p.nerf, p.mat, p.env, p.offsets, device=dev)
    opt = {}
    for g in GROUPS:
        inner = jstate.opt_state.inner_states[g]
        chain = getattr(inner, "inner_state", inner)
        (adam,) = [st for st in chain if hasattr(st, "mu") and hasattr(st, "nu")]
        opt[g] = AdamState(count=torch.tensor(int(np.asarray(adam.count)), dtype=torch.int32),
                           mu=[_to_torch(x, dev) for x in _jax_leaves(adam.mu)],
                           nu=[_to_torch(x, dev) for x in _jax_leaves(adam.nu)])
    return Stage1State(params, opt, torch.tensor(int(np.asarray(jstate.step)), dtype=torch.int32))


def state_to_numpy(state: Stage1State):
    """-> (params as params_to_numpy gives them, {group: {"count", "mu",
    "nu"}} with mu / nu lists of arrays in the reference's leaf order, step)."""
    opt = {g: {"count": int(st.count), "mu": _to_numpy(st.mu), "nu": _to_numpy(st.nu)}
           for g, st in state.opt_state.items()}
    return params_to_numpy(state.params), opt, int(state.step)
