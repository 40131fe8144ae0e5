"""The inputs of a cell, made from its configuration's ``scene`` block:
the mesh handed to stage 1, the training views (NeRF-synthetic's camera
on an orbit of the upper hemisphere) with their target images, and the
initial environment map.  Everything here is fixed by the configuration;
the seed changes only the weights and the draws, so every seed runs the
same sizes.

The orbit pose and the analytic sphere images are copies of
``mirres_restir_nerf_mesh_torch/data/synthetic.py`` (``orbit_pose``,
``render_sphere_image``), the sky + sun environment of
``mirres_restir_nerf_mesh_torch/bench.py`` (``sky_env``) at any size, and
the bumpy blob of its ``bench_mesh`` built here on a subdivided
icosahedron instead of marching tetrahedra and a decimation.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch


def icosphere(level: int) -> Tuple[np.ndarray, np.ndarray]:
    """Unit icosphere after ``level`` 4:1 subdivisions -> (verts [V, 3]
    float64, tris [20 * 4^level, 3] int64), faces wound outward."""
    p = (1.0 + math.sqrt(5.0)) / 2.0
    v = np.array([[-1, p, 0], [1, p, 0], [-1, -p, 0], [1, -p, 0], [0, -1, p], [0, 1, p],
                  [0, -1, -p], [0, 1, -p], [p, 0, -1], [p, 0, 1], [-p, 0, -1], [-p, 0, 1]],
                 np.float64)
    f = np.array([[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11], [1, 5, 9],
                  [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8], [3, 9, 4], [3, 4, 2],
                  [3, 2, 6], [3, 6, 8], [3, 8, 9], [4, 9, 5], [2, 4, 11], [6, 2, 10],
                  [8, 6, 7], [9, 8, 1]], np.int64)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    for _ in range(level):
        e = np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]])      # [3F, 2]
        key = np.minimum(e[:, 0], e[:, 1]) * len(v) + np.maximum(e[:, 0], e[:, 1])
        uniq, inv = np.unique(key, return_inverse=True)
        a, b = uniq // len(v), uniq % len(v)
        mid = v[a] + v[b]
        mid /= np.linalg.norm(mid, axis=1, keepdims=True)
        m = (inv + len(v)).reshape(3, -1).T                                 # [F, 3]: m01 m12 m20
        v = np.concatenate([v, mid])
        f = np.concatenate([np.stack([f[:, 0], m[:, 0], m[:, 2]], 1),
                            np.stack([f[:, 1], m[:, 1], m[:, 0]], 1),
                            np.stack([f[:, 2], m[:, 2], m[:, 1]], 1),
                            m])
    return v, f


def blob_mesh(level: int, radius: float) -> Tuple[np.ndarray, np.ndarray]:
    """bench.py's bumpy blob, the zero set of 0.55 + 0.06 sin 9x sin 7y cos 5z
    - |x| (found along each vertex direction of the icosphere by a fixed
    point), scaled so that its mean radius 0.55 becomes ``radius`` ->
    (verts [V, 3] float32, tris [F, 3] int32)."""
    u, f = icosphere(level)
    r = np.full(len(u), 0.55)
    for _ in range(12):
        x = u * r[:, None]
        r = 0.55 + 0.06 * np.sin(9 * x[:, 0]) * np.sin(7 * x[:, 1]) * np.cos(5 * x[:, 2])
    verts = u * (r * (radius / 0.55))[:, None]
    return verts.astype(np.float32), f.astype(np.int32)


def orbit_pose(theta: float, phi: float, radius: float) -> np.ndarray:
    """cam2world look-at pose orbiting the origin (OpenGL: -z forward, y up)."""
    center = np.array([radius * np.sin(theta) * np.sin(phi), radius * np.cos(theta),
                       radius * np.sin(theta) * np.cos(phi)], dtype=np.float32)
    forward = -center / np.linalg.norm(center)
    up = np.array([0, 1, 0], dtype=np.float32)
    right = np.cross(forward, up)
    right /= np.linalg.norm(right) + 1e-9
    up = np.cross(right, forward)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 0], pose[:3, 1], pose[:3, 2], pose[:3, 3] = right, up, -forward, center
    return pose


def views(n: int, hw: int, camera_angle_x: float, radius: float,
          first: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """(poses [n, 4, 4], intrinsics [4]) of n views of hw x hw pixels on the
    upper hemisphere at ``radius`` (a golden-angle spiral from 15 to 75
    degrees of elevation; ``first`` starts further along it, for held-out
    views), with NeRF-synthetic's focal length 0.5 hw / tan(angle / 2)."""
    focal = 0.5 * hw / math.tan(0.5 * camera_angle_x)
    intr = np.array([focal, focal, hw / 2.0, hw / 2.0], np.float32)
    poses = []
    for k in range(first, first + n):
        frac = (k * 0.6180339887498949) % 1.0
        elev = math.radians(15.0 + 60.0 * frac)
        poses.append(orbit_pose(math.pi / 2 - elev, k * 2.399963229728653, radius))
    return np.stack(poses), intr


def sphere_images(poses: np.ndarray, intr: np.ndarray, hw: int, sphere_radius: float,
                  device) -> np.ndarray:
    """The analytic lambertian sphere of ``render_sphere_image`` (albedo
    (0.8, 0.3, 0.2), light (0.5, 0.8, 0.3)) on white -> [n, hw, hw, 4]
    float32 RGBA, computed on ``device``."""
    fx, fy, cx, cy = (float(x) for x in intr)
    jj, ii = torch.meshgrid(torch.arange(hw, device=device, dtype=torch.float64) + 0.5,
                            torch.arange(hw, device=device, dtype=torch.float64) + 0.5,
                            indexing="ij")
    cam = torch.stack([(ii - cx) / fx, -(jj - cy) / fy, -torch.ones_like(ii)], dim=-1)
    light = torch.tensor([0.5, 0.8, 0.3], dtype=torch.float64, device=device)
    light = light / light.norm()
    albedo = torch.tensor([0.8, 0.3, 0.2], dtype=torch.float64, device=device)
    out = []
    for pose in poses:
        R = torch.as_tensor(pose[:3, :3], dtype=torch.float64, device=device)
        o = torch.as_tensor(pose[:3, 3], dtype=torch.float64, device=device)
        d = cam @ R.T
        d = d / d.norm(dim=-1, keepdim=True)
        b = d @ o
        disc = b * b - (o @ o - sphere_radius ** 2)
        t = -b - torch.sqrt(torch.clamp_min(disc, 0.0))
        hit = (disc > 0) & (t > 0)
        n = (o + d * t[..., None]) / sphere_radius
        lam = torch.clamp(n @ light, 0.0, 1.0) * 0.8 + 0.2
        rgb = torch.where(hit[..., None], albedo * lam[..., None], 1.0)
        out.append(torch.cat([rgb, hit[..., None].to(torch.float64)], -1).to(torch.float32))
    return torch.stack(out).cpu().numpy()


def sky_env(h: int, w: int) -> np.ndarray:
    """bench.py's sky + sun HDR environment at [h, w, 3] (its 64 x 128 layout
    scaled: the sun at rows 6-8 / 64 and columns 30-33 / 128)."""
    theta = (np.arange(h) + 0.5) / h * np.pi
    sky = np.clip(np.cos(theta), 0, None)[:, None] ** 1.5
    env = np.tile((0.08 + 0.5 * sky)[:, :, None], (1, w, 3)).astype(np.float32)
    sy, sx = h / 64.0, w / 128.0
    env[int(6 * sy):int(9 * sy), int(30 * sx):int(34 * sx)] = [60.0, 55.0, 45.0]
    env[h - int(10 * sy):] *= np.array([1.15, 0.9, 0.7], np.float32)
    return env


def make_scene(scene: Dict, device) -> Dict[str, np.ndarray]:
    """The cell's inputs from the configuration's ``scene`` block -> verts,
    tris (stage 1), poses, intrinsics, images, env (numpy)."""
    hw = int(scene["hw"])
    radius = float(scene["orbit_radius"]) * float(scene["scale"])
    poses, intr = views(int(scene["views"]), hw, float(scene["camera_angle_x"]), radius)
    out = {"poses": poses, "intrinsics": intr, "H": hw, "W": hw,
           "images": sphere_images(poses, intr, hw, float(scene["target_radius"]), device)}
    mesh = scene.get("mesh")
    if mesh:
        out["verts"], out["tris"] = blob_mesh(int(mesh["level"]), float(mesh["radius"]))
    env = scene.get("env")
    if env:
        out["env"] = sky_env(int(env["h"]), int(env["w"]))
    return out
