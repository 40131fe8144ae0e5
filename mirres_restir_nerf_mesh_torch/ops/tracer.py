"""Ray-tracer interface (counterpart of mirres_restir_nerf_mesh_tpu/ops/tracer.py).

Only the ``tile`` backend is ported (with its dense pass for small meshes);
``cluster`` and ``lbvh`` come later, and ``auto`` selects ``tile``.
"""

from __future__ import annotations

import torch

from . import tile_tracer
from .bvh import HitResult
from .cluster_bvh import build_clusters


class Tracer:
    def __init__(self, accel, kind: str = "tile", dense_threshold: int = 8192,
                 k_cap: int = 128, k_cap_incoherent: int = 512, tile: int = 512,
                 queue_avg: int = 64, queue_avg_incoherent: int = 64):
        if kind != "tile":
            raise NotImplementedError(f"tracer kind {kind!r} is not ported; use 'tile'")
        self.accel = accel
        self.kind = kind
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

    def _pop(self, name: str) -> torch.Tensor:
        vals = getattr(self, name)
        setattr(self, name, [])
        total = torch.zeros((), dtype=torch.float32, device=self.accel.geom_cm.device)
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

    def _budget(self, incoherent: bool):
        # incoherent batches get the global (octant, origin-morton) reorder;
        # coherent ones keep their order
        return dict(
            k_cap=self.k_cap_incoherent if incoherent else self.k_cap,
            tile=self.tile, dense_threshold=self.dense_threshold,
            sort_octants="morton" if incoherent else False,
            queue_avg=self.queue_avg_incoherent if incoherent else self.queue_avg,
        )

    def intersect(self, rays_o, rays_d, t_min: float = 1e-4, t_max=1e10,
                  incoherent: bool = False) -> HitResult:
        self._record_traced(rays_o, t_max, t_min)
        out = tile_tracer.intersect_tiles_t(self.accel, rays_o, rays_d, t_min=t_min, t_max=t_max,
                                            **self._budget(incoherent))
        self.telemetry.append(out.uncertain.sum().to(torch.float32))
        return out.hit

    def occluded(self, rays_o, rays_d, t_max, t_min: float = 1e-4,
                 incoherent: bool = False) -> torch.Tensor:
        self._record_traced(rays_o, t_max, t_min)
        occ, unc = tile_tracer.occluded_tiles_t(self.accel, rays_o, rays_d, t_max, t_min=t_min,
                                                **self._budget(incoherent))
        self.telemetry.append(unc.sum().to(torch.float32))
        return occ


def build_tracer(verts: torch.Tensor, tris: torch.Tensor, kind: str = "auto",
                 cluster_size: int = 128, dense_threshold: int = 8192, k_cap: int = 128,
                 k_cap_incoherent: int = 512, tile: int = 512, queue_avg: int = 64,
                 queue_avg_incoherent: int = 64) -> Tracer:
    return Tracer(
        build_clusters(verts, tris, cluster_size), "tile" if kind == "auto" else kind,
        dense_threshold=dense_threshold, k_cap=k_cap, k_cap_incoherent=k_cap_incoherent,
        tile=tile, queue_avg=queue_avg, queue_avg_incoherent=queue_avg_incoherent,
    )
