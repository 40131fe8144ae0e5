"""DTU scenes (counterpart of mirres_restir_nerf_mesh_tpu/data/dtu.py):
``cameras_sphere.npz`` (or ``cameras.npz``) projection matrices
``world_mat_i @ scale_mat_i`` decomposed into intrinsics and OpenGL poses;
``image/`` and ``mask/`` PNG or JPEG files, the mask as the 4th channel.
"""

from __future__ import annotations

import os
from glob import glob
from typing import Tuple

import numpy as np

from .provider import FrameData, _load_image, compute_mvps


def decompose_projection(P: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """P [3, 4] = K [R | t] -> (K [3, 3] with K[2, 2] = 1, c2w [4, 4] in
    OpenGL's convention): RQ of the left 3x3 through a flipped QR, K's
    diagonal made positive, R a rotation."""
    M = P[:3, :3]
    rev = np.flipud(np.eye(3))
    q, r = np.linalg.qr((rev @ M).T)
    K = rev @ r.T @ rev
    R = rev @ q.T
    signs = np.sign(np.diag(K))
    signs[signs == 0] = 1
    K = K @ np.diag(signs)
    R = np.diag(signs) @ R
    if np.linalg.det(R) < 0:
        R, K = -R, -K
    K = K / K[2, 2]
    w2c = np.eye(4)
    w2c[:3, :3] = R
    w2c[:3, 3] = np.linalg.inv(K) @ P[:3, 3]
    c2w = np.linalg.inv(w2c)
    c2w[:3, 1:3] *= -1                # OpenCV -> OpenGL
    return K.astype(np.float32), c2w.astype(np.float32)


def load_dtu(root: str, split: str = "train", downscale: int = 1, bound: float = 1.0,
             test_every: int = 8, with_images: bool = True) -> FrameData:
    """A DTU scene as FrameData: ``train`` drops every ``test_every``-th
    view, ``val`` / ``test`` keep only those; the first camera's
    intrinsics, divided by the downscale; without images (or with
    ``with_images=False``) zeros of 512 // downscale squared."""
    cam_file = os.path.join(root, "cameras_sphere.npz")
    if not os.path.exists(cam_file):
        cam_file = os.path.join(root, "cameras.npz")
    cams = np.load(cam_file)

    def files(sub):
        return sorted(glob(os.path.join(root, sub, "*.png"))
                      + glob(os.path.join(root, sub, "*.jpg")))

    img_paths, mask_paths = files("image"), files("mask")
    poses, Ks = [], []
    for i in range(len(img_paths)):
        scale_mat = cams[f"scale_mat_{i}"] if f"scale_mat_{i}" in cams else np.eye(4)
        K, c2w = decompose_projection((cams[f"world_mat_{i}"] @ scale_mat)[:3, :4])
        poses.append(c2w)
        Ks.append(K)
    poses = np.stack(poses)
    K = Ks[0]

    idx = list(range(len(img_paths)))
    if split == "train":
        idx = [i for i in idx if i % test_every != 0]
    elif split in ("val", "test"):
        idx = [i for i in idx if i % test_every == 0]
    poses = poses[idx]

    if with_images and img_paths:
        imgs = []
        for i in idx:
            img = _load_image(img_paths[i], downscale)
            if mask_paths:
                m = _load_image(mask_paths[i], downscale)
                if m.ndim == 3:
                    m = m[..., 0]
                img = np.concatenate([img[..., :3], m[..., None]], axis=-1)
            imgs.append(img)
        images = np.stack(imgs)
        H, W = images.shape[1:3]
    else:
        H = W = 512 // downscale
        images = np.zeros((len(idx), H, W, 3), np.float32)

    intrinsics = np.array([K[0, 0], K[1, 1], K[0, 2], K[1, 2]], np.float32) / downscale
    return FrameData(images=images, poses=poses, intrinsics=intrinsics, H=H, W=W,
                     mvps=compute_mvps(poses, intrinsics, H, W, bound))
