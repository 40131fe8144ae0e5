"""What the benchmark counts around the program's calls, in its own
wrappers (nothing inside the program changes):

- ``recording_tracer``: every answer of the program's ray tracer
  (``ops/tracer.Tracer.intersect`` / ``occluded``), copied to the host, for
  the reference to replay;
- ``counting_work``: the model FLOPs of each field evaluation (the
  radiance field's MLPs and hash-grid encodes, the material field), the
  witness that the shape counts of ``counts/flops.py`` are held to, and the
  shape of each K4 launch (updates, channels, table rows) with its bytes;
- ``timed_span``: a span of the benchmark's own, synchronized at both edges.

They run in set-up (the recording) and in a traced run's profiled stretch
(the counting), never in a measured window.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, List

import torch

from ..counts import flops as F

HIT_FIELDS = ("t", "prim", "u", "v", "normal")


@contextlib.contextmanager
def patched(obj, name: str, fn):
    old = getattr(obj, name)
    setattr(obj, name, fn)
    try:
        yield old
    finally:
        setattr(obj, name, old)


@contextlib.contextmanager
def recording_tracer(records: List[Dict]):
    """Append {kind, n, answers, uncertain} on the host for each tracer
    call; ``uncertain`` is the tile tracer's own per-ray mask of answers
    that may lie in a candidate its budgets dropped (all False on the dense
    route)."""
    from mirres_restir_nerf_mesh_torch.ops import tile_tracer
    from mirres_restir_nerf_mesh_torch.ops import tracer as T

    oi, oo = T.Tracer.intersect, T.Tracer.occluded
    oit, oot = tile_tracer.intersect_tiles_t, tile_tracer.occluded_tiles_t
    last: Dict = {}

    def intersect_tiles_t(*a, **k):
        out = oit(*a, **k)
        last["uncertain"] = out.uncertain
        return out

    def occluded_tiles_t(*a, **k):
        occ, unc = oot(*a, **k)
        last["uncertain"] = unc
        return occ, unc

    def uncertain(n):
        unc = last.pop("uncertain", None)
        return torch.zeros((n,), dtype=torch.bool) if unc is None else unc.detach().cpu()

    def intersect(self, rays_o, *a, **k):
        hit = oi(self, rays_o, *a, **k)
        n = int(rays_o.shape[0])
        records.append({"kind": "intersect", "n": n, "uncertain": uncertain(n),
                        **{f: getattr(hit, f).detach().cpu() for f in HIT_FIELDS}})
        return hit

    def occluded(self, rays_o, *a, **k):
        occ = oo(self, rays_o, *a, **k)
        n = int(rays_o.shape[0])
        records.append({"kind": "occluded", "n": n, "uncertain": uncertain(n),
                        "occ": occ.detach().cpu()})
        return occ

    with patched(T.Tracer, "intersect", intersect), patched(T.Tracer, "occluded", occluded), \
            patched(tile_tracer, "intersect_tiles_t", intersect_tiles_t), \
            patched(tile_tracer, "occluded_tiles_t", occluded_tiles_t):
        yield records


class WorkCounts:
    def __init__(self):
        self.flops = 0
        self.k4: List[Dict[str, int]] = []

    @property
    def k4_bytes(self) -> int:
        return sum(F.k4_bytes(**x) for x in self.k4)


def _differentiated(x, params) -> bool:
    if not torch.is_grad_enabled():
        return False
    ts = [x] + [p for p in params if isinstance(p, torch.Tensor)]
    return any(t.requires_grad for t in ts)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


@contextlib.contextmanager
def counting_work(counts: WorkCounts):
    from mirres_restir_nerf_mesh_torch.models import material, nerf
    from mirres_restir_nerf_mesh_torch.ops import hashgrid

    old_mlp, old_enc = nerf._mlp, nerf.hashgrid_encode
    old_mat, old_scatter = material.sample_material, hashgrid.scatter_add

    def mlp(ws, h, dtype):
        f = F.mlp_flops(h.shape[0], [tuple(w.shape) for w in ws])
        counts.flops += f * F.step_factor(_differentiated(h, ws))
        return old_mlp(ws, h, dtype)

    def encode(emb, x, spec, bound=1.0, stochastic_u=None, max_level=None):
        f = F.hashgrid_flops(x.shape[0], spec.num_levels, spec.level_dim, stochastic_u is not None)
        counts.flops += f * F.step_factor(_differentiated(x, [emb]))
        return old_enc(emb, x, spec, bound=bound, stochastic_u=stochastic_u, max_level=max_level)

    def sample_material(params, x, spec, stochastic_u=None):
        g = spec.grid
        f = (F.hashgrid_flops(x.shape[0], g.num_levels, g.level_dim, stochastic_u is not None)
             + F.mlp_flops(x.shape[0], [tuple(w.shape) for w in params["net"]]))
        counts.flops += f * F.step_factor(_differentiated(x, _leaves(params)))
        return old_mat(params, x, spec, stochastic_u=stochastic_u)

    def scatter_add(idx, upd, table_rows):
        counts.k4.append({"updates": int(idx.numel()), "channels": int(upd.shape[-1]),
                          "table_rows": int(table_rows)})
        return old_scatter(idx, upd, table_rows)

    with patched(nerf, "_mlp", mlp), patched(nerf, "hashgrid_encode", encode), \
            patched(material, "sample_material", sample_material), \
            patched(hashgrid, "scatter_add", scatter_add):
        yield counts


class Spans:
    """Durations of the benchmark's own synchronized spans, by name."""

    def __init__(self, on: bool):
        self.on = on
        self.seconds: Dict[str, List[float]] = defaultdict(list)

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.on:
            yield
            return
        cuda = torch.cuda.is_available()
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        yield
        if cuda:
            torch.cuda.synchronize()
        self.seconds[name].append(time.perf_counter() - t0)
