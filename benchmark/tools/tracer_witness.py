"""A second witness of the tile tracer's answers, on the card at a cell's
own size:

    python3 -m benchmark.tools.tracer_witness --workload train1-restir-800 \
        --seeds 1,2,3 [--sample 64] [--out f.json]

For each seed the program's set-up runs as a run takes it (the Trainer and
its followed steps).  Around each tracer call, a sample drawn from the seed
among the live rays the tile tracer marked uncertain, and one among the
rest, are traced again by the program's exact tracer on the same mesh
(``build_tracer(kind="lbvh")``: the Karras LBVH and its stack traversal)
and judged by the benchmark's float64 brute force.  Prints, per call kind
and group, the sampled rays, how many of the tile tracer's and of the
LBVH's answers the brute force contradicts, and how many the two tracers
disagree on; one JSON line a seed, all of them to ``--out``.
"""

from __future__ import annotations

import argparse
import contextlib
import inspect
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path

import torch

GROUPS = ("uncertain", "certain")


def _tally():
    return {k: {g: {"sampled": 0, "tile_wrong": 0, "lbvh_wrong": 0, "disagree": 0}
                for g in GROUPS} for k in ("intersect", "occluded")}


@contextlib.contextmanager
def witnessing(tally, seed: int, sample: int):
    """Patch the program's tracer so that each call is witnessed."""
    from mirres_restir_nerf_mesh_torch.ops import tile_tracer
    from mirres_restir_nerf_mesh_torch.ops import tracer as T
    from mirres_restir_nerf_mesh_torch.render import stage1 as r1

    from benchmark.harness.counting import patched
    from benchmark.reference.brute import closest_t, judge_hits, judge_occlusion

    ob, oi, oo = r1.build_tracer, T.Tracer.intersect, T.Tracer.occluded
    oit, oot = tile_tracer.intersect_tiles_t, tile_tracer.occluded_tiles_t
    sig_i, sig_o = inspect.signature(oi), inspect.signature(oo)
    last, calls = {}, [0]

    def build_tracer(verts, tris, *a, **k):
        tr = ob(verts, tris, *a, **k)
        tr.witness_mesh = (verts.detach(), tris)
        return tr

    def intersect_tiles_t(*a, **k):
        out = oit(*a, **k)
        last["uncertain"] = out.uncertain
        return out

    def occluded_tiles_t(*a, **k):
        occ, unc = oot(*a, **k)
        last["uncertain"] = unc
        return occ, unc

    @torch.no_grad()
    def witness(kind, tr, b, answer):
        unc = last.pop("uncertain", None)
        if unc is None or not hasattr(tr, "witness_mesh"):
            return
        verts, tris = tr.witness_mesh
        if not hasattr(tr, "witness_lbvh"):
            tr.witness_lbvh = ob(verts, tris, kind="lbvh")
        o, d = b["rays_o"].detach(), b["rays_d"].detach()
        t_min = float(b["t_min"])
        tmax = torch.broadcast_to(torch.as_tensor(b["t_max"], dtype=torch.float32,
                                                  device=o.device), (o.shape[0],))
        alive = tmax > t_min
        calls[0] += 1
        for gi, (group, mask) in enumerate((("uncertain", unc & alive),
                                            ("certain", ~unc & alive))):
            ids = torch.nonzero(mask).reshape(-1)
            if ids.numel() == 0:
                continue
            g = torch.Generator().manual_seed(seed * 100003 + 2 * calls[0] + gi)
            pick = torch.randperm(ids.numel(), generator=g)[:sample]
            idx = ids[pick.to(ids.device)]
            t_ref = closest_t(verts, tris, o[idx], d[idx], t_min, tmax[idx])
            if kind == "intersect":
                lh = tr.witness_lbvh.intersect(o[idx], d[idx], t_min=t_min, t_max=tmax[idx])
                tile_bad = judge_hits(answer.t[idx], answer.prim[idx], t_ref)
                lbvh_bad = judge_hits(lh.t, lh.prim, t_ref)
                t_l = torch.where(lh.prim >= 0, lh.t.double(), float("inf"))
                disagree = judge_hits(answer.t[idx], answer.prim[idx], t_l)
            else:
                lo = tr.witness_lbvh.occluded(o[idx], d[idx], tmax[idx], t_min)
                tile_bad = judge_occlusion(answer[idx], t_ref)
                lbvh_bad = judge_occlusion(lo, t_ref)
                disagree = answer[idx].bool() != lo.bool()
            row = tally[kind][group]
            row["sampled"] += int(idx.numel())
            row["tile_wrong"] += int(tile_bad.sum())
            row["lbvh_wrong"] += int(lbvh_bad.sum())
            row["disagree"] += int(disagree.sum())

    def intersect(self, *a, **k):
        hit = oi(self, *a, **k)
        b = sig_i.bind(self, *a, **k)
        b.apply_defaults()
        witness("intersect", self, b.arguments, hit)
        return hit

    def occluded(self, *a, **k):
        occ = oo(self, *a, **k)
        b = sig_o.bind(self, *a, **k)
        b.apply_defaults()
        witness("occluded", self, b.arguments, occ)
        return occ

    with patched(r1, "build_tracer", build_tracer), patched(T.Tracer, "intersect", intersect), \
            patched(T.Tracer, "occluded", occluded), \
            patched(tile_tracer, "intersect_tiles_t", intersect_tiles_t), \
            patched(tile_tracer, "occluded_tiles_t", occluded_tiles_t):
        yield tally


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--sample", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent.parent.parent))
    ap.add_argument("--out", default="")
    a = ap.parse_args(argv)

    from benchmark.harness import drivers, spec

    root = Path(a.root)
    bench = spec.with_waiting(root)
    cell = spec.cell(bench, a.workload)
    config = spec.config(bench, cell["config"], root)
    traffic = spec.traffic(cell["traffic"], root / "benchmark")
    tmp = Path(tempfile.gettempdir()) / "mirres-witness"
    out = []
    for seed in [int(x) for x in a.seeds.split(",") if x]:
        t0 = time.time()
        shutil.rmtree(tmp, ignore_errors=True)
        tmp.mkdir(parents=True)
        drv = drivers.make(cell["name"], config, traffic, seed, a.device, str(tmp))
        with witnessing(_tally(), seed, a.sample) as tally:
            drv.setup()
        drv.free()
        rec = {"seed": seed, "tally": tally, "uncertain": drv.program.get("uncertain"),
               "seconds": time.time() - t0}
        out.append(rec)
        print(json.dumps(rec), flush=True)
    if a.out:
        Path(a.out).parent.mkdir(parents=True, exist_ok=True)
        Path(a.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
