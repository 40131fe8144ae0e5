"""Procedural test scene (counterpart of mirres_restir_nerf_mesh_tpu/data/synthetic.py):
orbit cameras around an analytically ray-traced lambertian sphere, the
whole-frame batch that the stage-1 train step takes (the reference's
``RayDataset.frame_rays``), and the same frames as ``FrameData`` for
stage 0's ``RayDataset`` (``make_synthetic_frames``)."""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from .provider import FrameData, compute_mvps
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


def render_sphere_image(pose: np.ndarray, intrinsics: np.ndarray, H: int, W: int,
                        sphere_center=(0.0, 0.0, 0.0), sphere_radius: float = 0.5,
                        albedo=(0.8, 0.3, 0.2), light_dir=(0.5, 0.8, 0.3)) -> np.ndarray:
    """Analytic lambertian sphere on white background -> [H, W, 4] RGBA."""
    fx, fy, cx, cy = intrinsics
    jj, ii = np.meshgrid(np.arange(H) + 0.5, np.arange(W) + 0.5, indexing="ij")
    dirs = np.stack([(ii - cx) / fx, -(jj - cy) / fy, -np.ones_like(ii)], axis=-1) @ pose[:3, :3].T
    dirs = dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)
    o = pose[:3, 3]
    c = np.asarray(sphere_center, dtype=np.float32)
    oc = o - c
    b = np.sum(dirs * oc, axis=-1)
    disc = b * b - (np.sum(oc * oc) - sphere_radius ** 2)
    t = -b - np.sqrt(np.maximum(disc, 0.0))
    hit = (disc > 0) & (t > 0)
    n = (o + dirs * t[..., None] - c) / sphere_radius
    l = np.asarray(light_dir, dtype=np.float32)
    l = l / np.linalg.norm(l)
    lambert = np.clip(np.sum(n * l, axis=-1), 0.0, 1.0) * 0.8 + 0.2
    img = np.ones((H, W, 4), dtype=np.float32)
    rgb = np.asarray(albedo, dtype=np.float32)[None, None, :] * lambert[..., None]
    img[..., :3] = np.where(hit[..., None], rgb, 1.0)
    img[..., 3] = hit.astype(np.float32)
    return img


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


def make_synthetic_dataset(n_frames: int = 16, H: int = 64, W: int = 64, radius: float = 2.0,
                           seed: int = 0) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(poses [n,4,4], intrinsics [4], images [n,H,W,4] RGBA) of the
    reference's make_synthetic_dataset (same seed -> same frames)."""
    poses, intrinsics = synthetic_cameras(n_frames, H, W, radius, seed)
    return poses, intrinsics, np.stack([render_sphere_image(p, intrinsics, H, W) for p in poses])


def make_synthetic_frames(n_frames: int = 16, H: int = 64, W: int = 64, radius: float = 2.0,
                          bound: float = 1.0, seed: int = 0) -> FrameData:
    """The frames of make_synthetic_dataset as FrameData (the reference's
    make_synthetic_dataset)."""
    poses, intrinsics, images = make_synthetic_dataset(n_frames, H, W, radius, seed)
    return FrameData(images=images, poses=poses, intrinsics=intrinsics, H=H, W=W,
                     mvps=compute_mvps(poses, intrinsics, H, W, bound))


def frame_batch(pose: np.ndarray, intrinsics: np.ndarray, image: np.ndarray, device,
                ssaa: int = 1) -> Dict[str, torch.Tensor]:
    """The stage-1 batch of one frame: its rays (supersampled on an
    (H*ssaa, W*ssaa) grid when ssaa > 1), and at the RGBA image's resolution
    the pixels composited on white and the alpha (the reference's
    RayDataset.frame_rays)."""
    H, W = image.shape[0], image.shape[1]
    out = frame_rays(pose, np.asarray(intrinsics) * ssaa, H * ssaa, W * ssaa, device)
    rgba = torch.as_tensor(image.reshape(H * W, 4), device=out["rays_o"].device)
    out["pixels"] = rgba[:, :3] * rgba[:, 3:4] + (1.0 - rgba[:, 3:4])
    out["alpha"] = rgba[:, 3].contiguous()
    return out


def frame_rays(pose: np.ndarray, intrinsics: np.ndarray, H: int, W: int,
               device) -> Dict[str, torch.Tensor]:
    """All rays of one frame (the reference's RayDataset.frame_rays)."""
    res = get_rays(torch.as_tensor(pose, device=device)[None], intrinsics, H, W)
    return {"rays_o": res["rays_o"].contiguous(), "rays_d": res["rays_d"]}
