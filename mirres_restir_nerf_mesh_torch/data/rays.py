"""Camera rays (counterpart of mirres_restir_nerf_mesh_tpu/data/rays.py ``get_rays``).

OpenGL convention: pixel (i, j) at (col + 0.5, row + 0.5), camera looks down
-z, y flipped; directions are not normalized.  Ported: the rays of all
pixels (random pixel and patch sampling come with the data slice).
"""

from __future__ import annotations

from typing import Dict

import torch


def pixel_dirs(i: torch.Tensor, j: torch.Tensor, intrinsics) -> torch.Tensor:
    """i: pixel column + 0.5, j: pixel row + 0.5 -> camera-space dirs [N,3]."""
    fx, fy, cx, cy = (float(v) for v in intrinsics)
    return torch.stack([(i - cx) / fx, -(j - cy) / fy, -torch.ones_like(i)], dim=-1)


def get_rays(poses: torch.Tensor, intrinsics, H: int, W: int) -> Dict[str, torch.Tensor]:
    """poses [1,4,4] cam2world -> the rays of all H*W pixels, row-major."""
    inds = torch.arange(H * W, device=poses.device)
    i = (inds % W).to(torch.float32) + 0.5
    j = (inds // W).to(torch.float32) + 0.5
    directions = pixel_dirs(i, j, intrinsics)
    n = directions.shape[0]
    R = torch.broadcast_to(poses[:, :3, :3], (n, 3, 3))
    rays_d = torch.einsum("nij,nj->ni", R, directions)
    return {"rays_o": torch.broadcast_to(poses[:, :3, 3], rays_d.shape), "rays_d": rays_d,
            "i": i, "j": j}
