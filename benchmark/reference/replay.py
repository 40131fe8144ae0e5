"""The program's tracer answers replayed to the reference, in call order,
with a sample of each call's live rays judged by the brute force.  The
sample is drawn among all live rays, those the program's tracer itself
marked uncertain (an answer that may lie in a candidate its budgets
dropped) included; how many of the sampled rays were uncertain, and how
many of those the brute force contradicts, is counted apart."""

from __future__ import annotations

from typing import Dict, List

import torch

from .brute import closest_t, judge_hits, judge_occlusion
from .frozen.ops.tracer import ReplayMismatch

KINDS = ("intersect", "occluded")


class Replay:
    def __init__(self, records: List[Dict], seed: int, sample: int = 128):
        self.records, self.seed, self.sample = records, int(seed), int(sample)
        self.pos = 0
        self.checked = dict.fromkeys(KINDS, 0)
        self.live = dict.fromkeys(KINDS, 0)
        self.uncertain = dict.fromkeys(KINDS, 0)
        self.wrong = dict.fromkeys(KINDS, 0)             # device tensors once judged
        self.checked_uncertain = dict.fromkeys(KINDS, 0)
        self.wrong_uncertain = dict.fromkeys(KINDS, 0)

    def next(self, kind: str, n: int) -> Dict:
        if self.pos >= len(self.records):
            raise ReplayMismatch(f"the reference made a tracer call ({kind}, {n} rays) "
                                 f"beyond the program's {len(self.records)}")
        rec = self.records[self.pos]
        if rec["kind"] != kind or rec["n"] != n:
            raise ReplayMismatch(f"tracer call {self.pos}: the reference asks {kind} of {n} "
                                 f"rays, the program asked {rec['kind']} of {rec['n']}")
        self.pos += 1
        return rec

    def done(self) -> bool:
        return self.pos == len(self.records)

    @torch.no_grad()
    def check(self, verts, tris, rays_o, rays_d, t_min, t_max, hit=None, occ=None,
              uncertain=None) -> None:
        N, dev = rays_o.shape[0], rays_o.device
        kind = "intersect" if hit is not None else "occluded"
        tmax = torch.broadcast_to(torch.as_tensor(t_max, dtype=torch.float32, device=dev), (N,))
        alive = tmax > t_min
        unc = torch.zeros_like(alive) if uncertain is None else uncertain.to(dev) & alive
        self.live[kind] += int(alive.sum())
        self.uncertain[kind] += int(unc.sum())
        live = torch.nonzero(alive).reshape(-1)
        if live.numel() == 0:
            return
        g = torch.Generator().manual_seed(self.seed * 100003 + self.pos)
        pick = torch.randint(0, live.numel(), (min(self.sample, live.numel()),), generator=g)
        idx = live[pick.to(dev)]
        t_ref = closest_t(verts.detach(), tris, rays_o[idx].detach(), rays_d[idx].detach(),
                          float(t_min), tmax[idx])
        if hit is not None:
            bad = judge_hits(hit.t[idx], hit.prim[idx], t_ref)
        else:
            bad = judge_occlusion(occ[idx], t_ref)
        u = unc[idx]
        self.wrong[kind] = self.wrong[kind] + bad.sum()
        self.checked[kind] += int(idx.numel())
        self.wrong_uncertain[kind] = self.wrong_uncertain[kind] + (bad & u).sum()
        self.checked_uncertain[kind] += int(u.sum())

    def wrong_share(self, kind: str) -> float:
        """The share of the sampled answers of one call kind that the brute
        force contradicts."""
        n = self.checked[kind]
        return float(self.wrong[kind]) / n if n else 0.0

    def uncertain_share(self, kind: str) -> float:
        """The share of the live rays of one call kind that the program's
        tracer marked uncertain."""
        n = self.live[kind]
        return self.uncertain[kind] / n if n else 0.0

    def uncertain_tally(self) -> Dict[str, Dict[str, int]]:
        """Of each call kind: the sampled rays the tracer marked uncertain,
        and how many of them the brute force contradicts."""
        return {k: {"sampled": self.checked_uncertain[k],
                    "wrong": int(self.wrong_uncertain[k])} for k in KINDS}
