"""Ray-tracer interface over the three acceleration backends (counterpart
of mirres_restir_nerf_mesh_tpu/ops/tracer.py).

- ``tile``: tile-coherent candidate streaming (ops/tile_tracer.py, kernel
  K1; meshes of at most ``dense_threshold`` slots take the dense pass, K3).
  ``auto`` selects it.
- ``cluster``: a per-ray candidate loop over the K nearest cluster boxes
  (ops/cluster_bvh.py); its dense pass for small meshes is K3.
- ``lbvh``: the Karras LBVH and a stack traversal (ops/bvh.py), the
  structural mirror of the upstream project's LBVH.

Telemetry: every kind records the live lanes (t_max > t_min) of each
launch; only ``tile`` records uncertain counts (the other kinds have no
work budget to drop candidates from).
"""

from __future__ import annotations

import torch

from . import bvh as lbvh_mod
from . import cluster_bvh as cluster_mod
from . import tile_tracer
from .bvh import HitResult

KINDS = ("tile", "cluster", "lbvh")


class Tracer:
    def __init__(self, accel, kind: str = "tile", max_candidates: int = 10,
                 dense_threshold: int = 8192, k_cap: int = 128, k_cap_incoherent: int = 512,
                 tile: int = 512, queue_avg: int = 64, queue_avg_incoherent: int = 64):
        if kind not in KINDS:
            raise ValueError(f"tracer kind {kind!r} is not one of {KINDS}")
        self.accel = accel
        self.kind = kind
        self.max_candidates = max_candidates
        self.dense_threshold = dense_threshold
        self.k_cap = k_cap
        # budgets for direction-incoherent batches (bounce and shadow rays),
        # whose tiles overlap many more clusters
        self.k_cap_incoherent = k_cap_incoherent
        self.tile = tile
        self.queue_avg = queue_avg
        self.queue_avg_incoherent = queue_avg_incoherent
        # exactness telemetry: per-launch counts of rays whose result may lie
        # in a budget-dropped candidate; workload telemetry: live lanes
        # (t_max > t_min) entering each launch.  Renderers pop and sum them.
        self.telemetry = []
        self.traced = []

    def _device(self) -> torch.device:
        return (self.accel.node_min if self.kind == "lbvh" else self.accel.geom_cm).device

    def _pop(self, name: str) -> torch.Tensor:
        vals = getattr(self, name)
        setattr(self, name, [])
        total = torch.zeros((), dtype=torch.float32, device=self._device())
        for v in vals:
            total = total + v
        return total

    def pop_telemetry(self) -> torch.Tensor:
        """Sum (and clear) uncertain-ray counts recorded since the last pop."""
        return self._pop("telemetry")

    def pop_traced(self) -> torch.Tensor:
        """Sum (and clear) live-lane launch counts since the last pop."""
        return self._pop("traced")

    def _record_traced(self, rays_o, t_max, t_min):
        t_arr = tile_tracer._t_max_array(t_max, rays_o.shape[0], rays_o.device)
        self.traced.append((t_arr > t_min).sum().to(torch.float32))

    def _budget(self, incoherent: bool, sort):
        # sort None: incoherent batches get the global (octant,
        # origin-morton) reorder, coherent ones keep their order;
        # "morton_dir2" suits direction-concentrated incoherent batches
        if sort is None:
            sort = "morton" if incoherent else False
        return dict(
            k_cap=self.k_cap_incoherent if incoherent else self.k_cap,
            tile=self.tile, dense_threshold=self.dense_threshold, sort_octants=sort,
            queue_avg=self.queue_avg_incoherent if incoherent else self.queue_avg,
        )

    def intersect(self, rays_o, rays_d, t_min: float = 1e-4, t_max=1e10,
                  incoherent: bool = False, sort=None) -> HitResult:
        """Closest hit.  sort (tile kind): the ray-reorder key, None for the
        policy default."""
        self._record_traced(rays_o, t_max, t_min)
        if self.kind == "tile":
            out = tile_tracer.intersect_tiles_t(self.accel, rays_o, rays_d, t_min=t_min,
                                                t_max=t_max, **self._budget(incoherent, sort))
            self.telemetry.append(out.uncertain.sum().to(torch.float32))
            return out.hit
        if self.kind == "cluster":
            return cluster_mod.intersect_clusters(
                self.accel, rays_o, rays_d, t_min=t_min, t_max=t_max,
                max_candidates=self.max_candidates, dense_threshold=self.dense_threshold)
        return lbvh_mod.intersect_bvh(self.accel, rays_o, rays_d, t_min=t_min, t_max=t_max)

    def occluded(self, rays_o, rays_d, t_max, t_min: float = 1e-4,
                 incoherent: bool = False, sort=None) -> torch.Tensor:
        """[N] bool: some hit with t_min < t < t_max."""
        self._record_traced(rays_o, t_max, t_min)
        if self.kind == "tile":
            occ, unc = tile_tracer.occluded_tiles_t(self.accel, rays_o, rays_d, t_max,
                                                    t_min=t_min, **self._budget(incoherent, sort))
            self.telemetry.append(unc.sum().to(torch.float32))
            return occ
        if self.kind == "cluster":
            return cluster_mod.occluded_clusters(
                self.accel, rays_o, rays_d, t_max, t_min, max_candidates=self.max_candidates,
                dense_threshold=self.dense_threshold)
        return lbvh_mod.occluded(self.accel, rays_o, rays_d, t_max, t_min)


def build_tracer(verts: torch.Tensor, tris: torch.Tensor, kind: str = "auto",
                 cluster_size: int = 128, max_candidates: int = 10, dense_threshold: int = 8192,
                 k_cap: int = 128, k_cap_incoherent: int = 512, tile: int = 512,
                 queue_avg: int = 64, queue_avg_incoherent: int = 64) -> Tracer:
    kind = "tile" if kind == "auto" else kind
    if kind not in KINDS:
        raise ValueError(f"tracer kind {kind!r} is not one of {KINDS}")
    if kind == "lbvh":
        return Tracer(lbvh_mod.build_bvh(verts, tris), kind)
    return Tracer(
        cluster_mod.build_clusters(verts, tris, cluster_size), kind,
        max_candidates=max_candidates, dense_threshold=dense_threshold, k_cap=k_cap,
        k_cap_incoherent=k_cap_incoherent, tile=tile, queue_avg=queue_avg,
        queue_avg_incoherent=queue_avg_incoherent,
    )
