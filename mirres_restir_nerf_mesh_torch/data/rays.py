"""Camera rays (counterpart of mirres_restir_nerf_mesh_tpu/data/rays.py ``get_rays``).

OpenGL convention: pixel (i, j) at (col + 0.5, row + 0.5), camera looks down
-z, y flipped; directions are not normalized.  ``get_rays`` gives the rays
of all pixels; random pixel and patch sampling live in data/provider.py
``RayDataset``.  The pose and projection helpers are numpy, as in the
reference.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
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


def nerf_matrix_to_ngp(pose: np.ndarray, scale: float = 0.33, offset=(0, 0, 0)) -> np.ndarray:
    """Scale and offset a camera centre into the scene box."""
    pose = np.array(pose, dtype=np.float32)
    pose[:3, 3] = pose[:3, 3] * scale + np.asarray(offset, dtype=np.float32)
    return pose


def perspective_matrix(fovy_rad: float, aspect: float, near: float, far: float) -> np.ndarray:
    """OpenGL projection matrix."""
    y = np.tan(fovy_rad / 2.0)
    return np.array([[1.0 / (y * aspect), 0, 0, 0],
                     [0, -1.0 / y, 0, 0],
                     [0, 0, -(far + near) / (far - near), -(2 * far * near) / (far - near)],
                     [0, 0, -1, 0]], dtype=np.float32)


def create_dodecahedron_cameras(radius: float = 2.5, center=(0, 0, 0)) -> np.ndarray:
    """20 cam2world poses at the vertices of a dodecahedron, looking at the
    centre (test trajectories of datasets without a test split)."""
    phi = (1 + np.sqrt(5)) / 2
    verts = [[s1, s2, s3] for s1 in (-1, 1) for s2 in (-1, 1) for s3 in (-1, 1)]
    for s1 in (-1, 1):
        for s2 in (-1, 1):
            verts += [[0, s1 / phi, s2 * phi], [s1 / phi, s2 * phi, 0], [s1 * phi, 0, s2 / phi]]
    verts = np.unique(np.array(verts, np.float32), axis=0)
    verts = verts / np.linalg.norm(verts, axis=1, keepdims=True) * radius
    c = np.asarray(center, np.float32)
    verts = verts + c
    poses = []
    for v in verts:
        forward = -(v - c)
        forward = forward / (np.linalg.norm(forward) + 1e-9)
        up = np.array([0, 1, 0], np.float32)
        if abs(np.dot(forward, up)) > 0.99:
            up = np.array([1, 0, 0], np.float32)
        right = np.cross(forward, up)
        right /= np.linalg.norm(right) + 1e-9
        up = np.cross(right, forward)
        pose = np.eye(4, dtype=np.float32)
        pose[:3, 0], pose[:3, 1], pose[:3, 2], pose[:3, 3] = right, up, -forward, v
        poses.append(pose)
    return np.stack(poses)
