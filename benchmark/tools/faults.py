"""Faults planted in the program, to show that a run then reads
``correct`` false.  Each ``plant_<name>(patch, kind)`` breaks the program
through ``patch(obj, attr, value)`` (pytest's ``monkeypatch.setattr``, or
``Patches.set``, which can undo itself) for a cell of traffic ``kind``:

- ``unchanged``: the train step returns the state it was given;
- ``half``: the loss's means take the first half of the batch only;
- ``altered``: an answer altered where it is produced: stage 1, every
  fourth closest hit of the tracer turned into a miss and every fourth
  occlusion answer flipped; stage 0, every fourth row of K4's scatter-add
  zeroed.
"""

from __future__ import annotations

import torch

NAMES = ("unchanged", "half", "altered")


class Patches:
    def __init__(self):
        self.undo = []

    def set(self, obj, attr, value):
        self.undo.append((obj, attr, getattr(obj, attr)))
        setattr(obj, attr, value)

    def restore(self):
        while self.undo:
            obj, attr, old = self.undo.pop()
            setattr(obj, attr, old)


def _train_module(kind):
    from mirres_restir_nerf_mesh_torch.train import stage0, stage1

    return stage1 if kind == "stage1_train" else stage0


def plant_unchanged(patch, kind):
    m = _train_module(kind)
    orig = m.make_train_step

    def make(*a, **k):
        step = orig(*a, **k)

        def unchanged(state, *b, **kk):
            _, aux = step(state, *b, **kk)
            return state, aux

        unchanged.march_candidates = getattr(step, "march_candidates", None)
        return unchanged

    patch(m, "make_train_step", make)


def _half_mean(x, shard=None):
    return torch.mean(x[:max(x.shape[0] // 2, 1)])


def plant_half(patch, kind):
    if kind == "stage1_train":
        from mirres_restir_nerf_mesh_torch.parallel import mesh

        patch(mesh, "global_mean", _half_mean)
    else:
        patch(_train_module(kind), "global_mean", _half_mean)


def plant_altered(patch, kind):
    if kind == "stage1_train":
        from mirres_restir_nerf_mesh_torch.ops import tracer

        orig_hit, orig_occ = tracer.Tracer.intersect, tracer.Tracer.occluded

        def every_fourth(x):
            m = torch.zeros_like(x, dtype=torch.bool)
            m[::4] = True
            return m

        def intersect(self, *a, **k):
            hit = orig_hit(self, *a, **k)
            drop = every_fourth(hit.prim)
            return hit._replace(prim=torch.where(drop, -1, hit.prim),
                                t=torch.where(drop, float("inf"), hit.t))

        def occluded(self, *a, **k):
            occ = orig_occ(self, *a, **k)
            return occ ^ every_fourth(occ)

        patch(tracer.Tracer, "intersect", intersect)
        patch(tracer.Tracer, "occluded", occluded)
    else:
        from mirres_restir_nerf_mesh_torch.ops import hashgrid

        orig = hashgrid.scatter_add

        def scatter_add(idx, upd, table_rows):
            out = orig(idx, upd, table_rows)
            out[::4] = 0.0
            return out

        patch(hashgrid, "scatter_add", scatter_add)


def plant(name: str, patch, kind: str) -> None:
    {"unchanged": plant_unchanged, "half": plant_half, "altered": plant_altered}[name](patch, kind)
