"""Orbit cameras of the procedural test scene (counterpart of the camera part
of mirres_restir_nerf_mesh_tpu/data/synthetic.py).  The frames' analytic
images come with the data slice."""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from .rays import get_rays


def orbit_pose(theta: float, phi: float, radius: float) -> np.ndarray:
    """cam2world look-at pose orbiting the origin (OpenGL: -z forward)."""
    center = np.array([radius * np.sin(theta) * np.sin(phi), radius * np.cos(theta),
                       radius * np.sin(theta) * np.cos(phi)], dtype=np.float32)
    forward = -center / np.linalg.norm(center)
    up = np.array([0, 1, 0], dtype=np.float32)
    right = np.cross(forward, up)
    right /= np.linalg.norm(right) + 1e-9
    up = np.cross(right, forward)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 0] = right
    pose[:3, 1] = up
    pose[:3, 2] = -forward
    pose[:3, 3] = center
    return pose


def synthetic_cameras(n_frames: int = 16, H: int = 64, W: int = 64, radius: float = 2.0,
                      seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """(poses [n,4,4], intrinsics [4]) of the reference's make_synthetic_dataset
    (same seed -> same cameras)."""
    rng = np.random.RandomState(seed)
    fx = fy = 0.8 * W
    intrinsics = np.array([fx, fy, W / 2.0, H / 2.0], dtype=np.float32)
    poses = []
    for k in range(n_frames):
        theta = np.pi / 3 + (np.pi / 3) * (k % 4) / 4 + rng.uniform(-0.05, 0.05)
        phi = 2 * np.pi * k / n_frames + rng.uniform(-0.05, 0.05)
        poses.append(orbit_pose(theta, phi, radius))
    return np.stack(poses), intrinsics


def frame_rays(pose: np.ndarray, intrinsics: np.ndarray, H: int, W: int,
               device) -> Dict[str, torch.Tensor]:
    """All rays of one frame (the reference's RayDataset.frame_rays)."""
    res = get_rays(torch.as_tensor(pose, device=device)[None], intrinsics, H, W)
    return {"rays_o": res["rays_o"].contiguous(), "rays_d": res["rays_d"]}
