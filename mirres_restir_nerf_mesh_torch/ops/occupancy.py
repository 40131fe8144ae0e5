"""Occupancy (density) grid (counterpart of mirres_restir_nerf_mesh_tpu/ops/occupancy.py).

State: ``density_grid`` [cascade, H, H, H] float32 (EMA of the max density,
-1 = outside every training view), ``occ`` [cascade, H, H, H] uint8 (the
thresholded occupancy the marcher reads) and ``mean_density``.  The update
queries the density at jittered cell centres of each cascade; the jitter
and the density function's own randoms come in as arguments
(``OccupancyDraws``), drawn from a generator or passed in.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from ..device import resolve_device
from ..utils.profiling import count_upload


class OccupancyState(NamedTuple):
    density_grid: torch.Tensor  # [C, H, H, H] float32
    occ: torch.Tensor           # [C, H, H, H] uint8
    mean_density: torch.Tensor  # [] float32


class OccupancyDraws(NamedTuple):
    """The randoms of one update: the world-space jitter of every cell
    centre, [C, H^3, 3] uniform in [-half_cell, half_cell) of its cascade
    (the reference's ``uniform(fold_in(key, cas), ...)``), and the density
    function's stochastic-encode uniforms [H^3, 3] (None: exact encode),
    shared by the cascades as the reference's ``fold_in(key, 777)`` is."""
    jitter: torch.Tensor
    stochastic_u: Optional[torch.Tensor] = None


def init_occupancy(cascade: int, grid_size: int = 128, device="cuda") -> OccupancyState:
    dev = resolve_device(device)
    shape = (cascade, grid_size, grid_size, grid_size)
    return OccupancyState(density_grid=torch.zeros(shape, device=dev),
                          occ=torch.ones(shape, dtype=torch.uint8, device=dev),
                          mean_density=torch.zeros((), device=dev))


def grid_cell_centers(grid_size: int, device="cpu") -> torch.Tensor:
    """Cell centres in [-1, 1]^3, [H, H, H, 3] (2 c / (H - 1) - 1)."""
    ax = torch.arange(grid_size, dtype=torch.float32, device=device)
    coords = torch.stack(torch.meshgrid(ax, ax, ax, indexing="ij"), dim=-1)
    return 2.0 * coords / (grid_size - 1) - 1.0


def _half_cells(C: int, H: int, bound: float):
    return [min(2.0 ** cas, bound) / H for cas in range(C)]


def draw_occupancy(state: OccupancyState, bound: float, stochastic: bool,
                   generator: Optional[torch.Generator]) -> OccupancyDraws:
    """OccupancyDraws of one update from ``generator``."""
    C, H = state.density_grid.shape[0], state.density_grid.shape[1]
    dev = state.density_grid.device
    count_upload("occ_half_cells", dev)
    half = torch.tensor(_half_cells(C, H, bound), device=dev)[:, None, None]
    u = torch.rand((C, H ** 3, 3), generator=generator, device=dev)
    su = torch.rand((H ** 3, 3), generator=generator, device=dev) if stochastic else None
    return OccupancyDraws(jitter=u * (2.0 * half) - half, stochastic_u=su)


def update_occupancy(state: OccupancyState, density_fn: Callable, draws: OccupancyDraws,
                     bound: float, density_thresh: float, decay: float = 0.95) -> OccupancyState:
    """EMA-max update and re-threshold: ``density_fn(pts, stochastic_u)``
    at the jittered cell centres of each cascade; ``max(old * decay, new)``
    where both are >= 0 (cells at -1 stay -1); occupied where the grid
    exceeds min(mean density, density_thresh)."""
    C, H = state.density_grid.shape[0], state.density_grid.shape[1]
    xyzs = grid_cell_centers(H, state.density_grid.device).reshape(-1, 3)
    new = []
    for cas, half in enumerate(_half_cells(C, H, bound)):
        pts = xyzs * (min(2.0 ** cas, bound) - half)
        new.append(density_fn(pts + draws.jitter[cas], draws.stochastic_u).reshape(-1))
    tmp = torch.stack(new).reshape(state.density_grid.shape)
    old = state.density_grid
    grid = torch.where((old >= 0) & (tmp >= 0), torch.maximum(old * decay, tmp), old)
    mean_density = torch.mean(torch.clamp_min(grid, 0.0))
    occ = (grid > torch.clamp_max(mean_density, density_thresh)).to(torch.uint8)
    return OccupancyState(density_grid=grid, occ=occ, mean_density=mean_density)


def mark_untrained_grid(state: OccupancyState, poses: torch.Tensor, intrinsics, W: int,
                        H_img: int, bound: float) -> OccupancyState:
    """Mark cells whose centre projects into no training camera (with a
    half-cell tolerance, in front of the camera) as -1.  poses [M, 4, 4]
    cam2world (OpenGL: the camera looks down -z, y up)."""
    C, H = state.density_grid.shape[0], state.density_grid.shape[1]
    fx, fy, cx, cy = (float(v) for v in intrinsics)
    xyzs = grid_cell_centers(H, state.density_grid.device).reshape(-1, 3)
    R, t = poses[:, :3, :3], poses[:, :3, 3]
    grids = []
    for cas, half in enumerate(_half_cells(C, H, bound)):
        pts = xyzs * (min(2.0 ** cas, bound) - half)
        rel = pts[None, :, :] - t[:, None, :]                            # [M,N,3]
        cam = torch.einsum("mij,mnj->mni", R.transpose(1, 2), rel)
        z = -cam[..., 2]
        zc = torch.clamp_min(z, 1e-8)
        u = cam[..., 0] / zc * fx + cx
        v = -cam[..., 1] / zc * fy + cy
        tol_u, tol_v = half * fx / zc, half * fy / zc
        seen = (z > 0) & (u >= -tol_u) & (u < W + tol_u) & (v >= -tol_v) & (v < H_img + tol_v)
        grids.append(torch.where(seen.any(dim=0), state.density_grid[cas].reshape(-1), -1.0))
    grid = torch.stack(grids).reshape(state.density_grid.shape)
    return OccupancyState(density_grid=grid, occ=state.occ, mean_density=state.mean_density)


def packbits(occ: torch.Tensor) -> torch.Tensor:
    """uint8 occupancy volume -> bitfield, 8 cells a byte, cell k of a group
    at bit k."""
    flat = (occ.reshape(-1, 8) > 0).to(torch.uint8)
    weights = (2 ** torch.arange(8, device=occ.device)).to(torch.uint8)
    return torch.sum(flat * weights[None], dim=1, dtype=torch.uint8)


def unpackbits(bits: torch.Tensor, shape) -> torch.Tensor:
    """Inverse of packbits -> uint8 0/1 volume of ``shape``."""
    b = bits[:, None] >> torch.arange(8, dtype=torch.uint8, device=bits.device)[None]
    return (b & 1).to(torch.uint8).reshape(shape)
