"""The reference's tracer: the program's answers replayed, a sample judged.

``replaying(replay)`` makes ``build_tracer`` hand out tracers that answer
each ``intersect`` / ``occluded`` call with the next record of the
program's own calls in the same step (``benchmark.reference.replay``), and
check a sample of the rays, drawn from the replay's seed among those the
program did not mark uncertain, against the brute-force test of every
triangle on the reference's own rays and mesh.
A call whose kind or ray count differs from the record raises
``ReplayMismatch``: the program then took another path than this copy.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch

_ACTIVE = {"replay": None}


class HitResult(NamedTuple):
    t: torch.Tensor        # [R] hit distance (inf if miss)
    prim: torch.Tensor     # [R] int64 original primitive id (-1 if miss)
    u: torch.Tensor        # [R] barycentric u
    v: torch.Tensor        # [R] barycentric v
    normal: torch.Tensor   # [R, 3] geometric normal (unnormalized cross)


class ReplayMismatch(RuntimeError):
    pass


@contextlib.contextmanager
def replaying(replay):
    old = _ACTIVE["replay"]
    _ACTIVE["replay"] = replay
    try:
        yield replay
    finally:
        _ACTIVE["replay"] = old


class Tracer:
    def __init__(self, replay, verts: torch.Tensor, tris: torch.Tensor):
        self.replay, self.verts, self.tris = replay, verts, tris
        self.device = verts.device

    def _zero(self) -> torch.Tensor:
        return torch.zeros((), dtype=torch.float32, device=self.device)

    def pop_telemetry(self) -> torch.Tensor:
        return self._zero()

    def pop_traced(self) -> torch.Tensor:
        return self._zero()

    def intersect(self, rays_o, rays_d, t_min: float = 1e-4, t_max=1e10,
                  incoherent: bool = False, sort=None) -> HitResult:
        rec = self.replay.next("intersect", rays_o.shape[0])
        hit = HitResult(*(rec[k].to(self.device) for k in HitResult._fields))
        self.replay.check(self.verts, self.tris, rays_o, rays_d, t_min, t_max, hit=hit,
                          uncertain=rec.get("uncertain"))
        return hit

    def occluded(self, rays_o, rays_d, t_max, t_min: float = 1e-4,
                 incoherent: bool = False, sort=None) -> torch.Tensor:
        rec = self.replay.next("occluded", rays_o.shape[0])
        occ = rec["occ"].to(self.device)
        self.replay.check(self.verts, self.tris, rays_o, rays_d, t_min, t_max, occ=occ,
                          uncertain=rec.get("uncertain"))
        return occ


def build_tracer(verts: torch.Tensor, tris: torch.Tensor, kind: str = "auto", **_budgets) -> Tracer:
    replay = _ACTIVE["replay"]
    if replay is None:
        raise ReplayMismatch("the reference traces only inside replaying(...)")
    return Tracer(replay, verts, tris)
