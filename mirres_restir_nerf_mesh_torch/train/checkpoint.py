"""Checkpoint save / load (counterpart of
mirres_restir_nerf_mesh_tpu/train/checkpoint.py): a rolling window of the
latest checkpoints, a metric-keyed ``best``, stage-tagged file names
(``{name}_stage{s}_{step:07d}.pkl``, ``{name}_stage{s}_best.pkl`` under
``workspace/checkpoints``) and a tolerant restore.

The payload is a pickle of plain Python and numpy: ``{"state": {path:
array}, "step", "stage", "extra"}``, the state's leaves keyed by their tree
path (``.params['encoder']``, ``.opt_state.mu[0]``, ...), so loading needs
no class from either package.
"""

from __future__ import annotations

import glob
import os
import pickle
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch


def flatten_with_path(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """[(path, leaf)]: NamedTuple fields as ``.name``, dict keys as
    ``['key']`` (sorted), list / tuple items as ``[i]``; None is no leaf."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [kv for f in tree._fields for kv in flatten_with_path(getattr(tree, f),
                                                                      f"{prefix}.{f}")]
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in flatten_with_path(tree[k], f"{prefix}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree) for kv in flatten_with_path(v, f"{prefix}[{i}]")]
    if tree is None:
        return []
    return [(prefix, tree)]


def _replace_leaves(tree: Any, leaves) -> Any:
    """``tree`` with its leaves (flatten_with_path order) from the iterator."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_replace_leaves(getattr(tree, f), leaves) for f in tree._fields))
    if isinstance(tree, dict):
        return {k: _replace_leaves(tree[k], leaves) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_replace_leaves(v, leaves) for v in tree)
    if tree is None:
        return None
    return next(leaves)


def _to_numpy(x: Any) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _np_dtype(x: Any) -> np.dtype:
    if isinstance(x, torch.Tensor):
        return torch.empty((), dtype=x.dtype).numpy().dtype
    return np.asarray(x).dtype


def replicate_state(state: Any, dp) -> Any:
    """Rank 0's state on every rank (``parallel.mesh.replicate``): data
    parallelism replicates the state after init and after a resume."""
    from ..parallel.mesh import replicate

    leaves = [v for _, v in flatten_with_path(state)]
    return _replace_leaves(state, iter(replicate(leaves, dp)))


def numpy_leaves(state: Any) -> Dict[str, np.ndarray]:
    """{path: numpy leaf} of a state."""
    return {k: _to_numpy(v) for k, v in flatten_with_path(state)}


def save_checkpoint(workspace: str, name: str, stage: int, step: int, state: Any,
                    extra: Optional[dict] = None, max_keep: int = 2, best: bool = False) -> str:
    ckpt_dir = os.path.join(workspace, "checkpoints")
    os.makedirs(ckpt_dir, exist_ok=True)
    payload = {"state": numpy_leaves(state), "step": int(step), "stage": stage,
               "extra": extra or {}}
    if best:
        path = os.path.join(ckpt_dir, f"{name}_stage{stage}_best.pkl")
    else:
        path = os.path.join(ckpt_dir, f"{name}_stage{stage}_{step:07d}.pkl")
    with open(path, "wb") as f:
        pickle.dump(payload, f)
    if not best:
        olds = sorted(glob.glob(os.path.join(ckpt_dir, f"{name}_stage{stage}_[0-9]*.pkl")))
        for p in olds[:-max_keep]:
            os.remove(p)
    return path


def find_checkpoint(workspace: str, name: str, stage: int, which: str = "latest") -> Optional[str]:
    ckpt_dir = os.path.join(workspace, "checkpoints")
    if which == "best":
        p = os.path.join(ckpt_dir, f"{name}_stage{stage}_best.pkl")
        return p if os.path.exists(p) else None
    cands = sorted(glob.glob(os.path.join(ckpt_dir, f"{name}_stage{stage}_[0-9]*.pkl")))
    return cands[-1] if cands else None


def restore_like(saved: Dict[str, np.ndarray], template: Any, prefix: str = "",
                 what: str = "") -> Any:
    """``template`` with each leaf taken from ``saved[prefix + path]`` where
    its shape and dtype agree (as a tensor on the template leaf's device);
    a missing or mismatched leaf keeps the template's and is reported (as
    after a refine, whose vertex count differs)."""
    out, skipped, missing = [], [], []
    for ks, tleaf in flatten_with_path(template):
        sleaf = saved.get(prefix + ks)
        if sleaf is None:
            missing.append(ks)
            out.append(tleaf)
            continue
        sarr = np.asarray(sleaf)
        tshape = tuple(tleaf.shape) if hasattr(tleaf, "shape") else np.shape(tleaf)
        if sarr.shape != tshape or sarr.dtype != _np_dtype(tleaf):
            skipped.append(f"{ks} {sarr.shape}/{sarr.dtype} != {tshape}/{_np_dtype(tleaf)}")
            out.append(tleaf)
        elif isinstance(tleaf, torch.Tensor):
            out.append(torch.from_numpy(sarr.copy()).to(tleaf.device))
        else:
            out.append(sarr)
    if skipped or missing:
        print(f"[checkpoint] tolerant restore of {what or 'checkpoint'}: "
              f"{len(skipped)} shape/dtype mismatches kept from template {skipped[:4]}, "
              f"{len(missing)} leaves missing {missing[:4]}")
    return _replace_leaves(template, iter(out))


def load_checkpoint(path: str, template: Any = None, prefix: str = "") -> Tuple[Any, int, dict]:
    """-> (state, step, extra).  Without a template the state is the saved
    {path: array}; with one, ``restore_like(saved, template, prefix)``."""
    with open(path, "rb") as f:
        payload = pickle.load(f)
    state = payload["state"]
    if template is not None:
        state = restore_like(state, template, prefix, what=path)
    return state, payload["step"], payload.get("extra", {})
