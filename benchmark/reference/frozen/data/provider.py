"""Dataset state and the stage-0 ray sampler (counterpart of
mirres_restir_nerf_mesh_tpu/data/provider.py: ``FrameData``,
``compute_mvps``, ``RayDataset``).

The images, poses and optional depth fields live on the device; a batch is
gathered there.  The draws of a batch (frames, pixels, the random
background, the sparse-depth branch) come in as ``SampleDraws``, drawn by
``RayDataset.draw`` from a generator or passed in.  (The port's loaders
are left out of this copy: the benchmark makes its scene itself.)
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from ..device import resolve_device
from .rays import get_rays, perspective_matrix, pixel_dirs


@dataclass
class FrameData:
    """Host-side dataset state of one split."""

    images: np.ndarray      # [N, H, W, C] float32 (C = 3 or 4)
    poses: np.ndarray       # [N, 4, 4] cam2world, scene-scaled
    intrinsics: np.ndarray  # [4] fx fy cx cy
    H: int
    W: int
    mvps: np.ndarray        # [N, 4, 4] proj @ world2cam
    depths: Optional[np.ndarray] = None         # [N, H, W] metric depth
    sparse_coords: Optional[np.ndarray] = None  # [N, M, 2] int32 (row, col)
    sparse_depth: Optional[np.ndarray] = None   # [N, M] float32
    sparse_weight: Optional[np.ndarray] = None  # [N, M] float32 (0 = padding)
    cam_near_far: Optional[np.ndarray] = None   # [N, 2] per-view near / far
    pts3d: Optional[np.ndarray] = None          # [P, 3] sparse points (colmap), scene-scaled

    @property
    def num_frames(self) -> int:
        return self.poses.shape[0]


def compute_mvps(poses: np.ndarray, intrinsics: np.ndarray, H: int, W: int,
                 bound: float) -> np.ndarray:
    """Model-view-projection of each frame."""
    fovy = 2.0 * np.arctan(0.5 * H / intrinsics[1])
    proj = perspective_matrix(fovy, W / H, near=0.05, far=2.0 * bound + 0.05)
    return np.stack([proj @ np.linalg.inv(p.astype(np.float64)).astype(np.float32)
                     for p in poses])


class SampleDraws(NamedTuple):
    """The randoms of one batch: frame and pixel of each ray ([N] int64),
    the background colours [N, 3] (None: white), and for datasets with
    sparse depth the batch-wide branch (``use_sparse`` bool scalar, its
    frame ``sparse_frame`` and each ray's point ``sparse_m`` [N])."""
    img_idx: torch.Tensor
    pix_idx: torch.Tensor
    bg: Optional[torch.Tensor] = None
    use_sparse: Optional[torch.Tensor] = None
    sparse_frame: Optional[torch.Tensor] = None
    sparse_m: Optional[torch.Tensor] = None

    def to(self, device) -> "SampleDraws":
        return SampleDraws(*(None if x is None else x.to(device) for x in self))


def patch_pixels(px: torch.Tensor, py: torch.Tensor, p: int, W: int) -> torch.Tensor:
    """Pixel ids of p x p patches whose corner is (row px, column py), patch
    by patch, row-major inside a patch."""
    o = torch.arange(p, device=px.device)
    oi, oj = torch.meshgrid(o, o, indexing="ij")
    return ((px[:, None] + oi.reshape(-1)[None]) * W + (py[:, None] + oj.reshape(-1)[None])).reshape(-1)


class RayDataset:
    """Device-resident ray sampler over a FrameData split: random pixels
    across all frames (or p x p patches), their rays, and the ground truth
    composited on the background."""

    def __init__(self, data: FrameData, bound: float, background: str = "white",
                 patch_size: int = 1, device="cuda"):
        dev = resolve_device(device)
        self.data, self.bound, self.device = data, bound, dev
        self.H, self.W = data.H, data.W
        self.background = background
        self.patch_size = patch_size

        def put(x):
            return None if x is None else torch.as_tensor(np.asarray(x), device=dev)

        self.images = put(data.images)
        self.poses = put(data.poses)
        self.intrinsics = np.asarray(data.intrinsics, np.float32)
        self.mvps = put(data.mvps)
        self.depths = put(data.depths)
        self.sparse_coords = put(data.sparse_coords)
        self.sparse_depth = put(data.sparse_depth)
        self.sparse_weight = put(data.sparse_weight)
        self.cam_near_far = put(data.cam_near_far)

    @property
    def random_background(self) -> bool:
        return self.background == "random" and self.images.shape[-1] == 4

    def draw(self, num_rays: int, generator: Optional[torch.Generator] = None) -> SampleDraws:
        """SampleDraws of one batch from ``generator``."""
        n_frames, dev = self.images.shape[0], self.device

        def randint(hi, shape):
            return torch.randint(0, hi, shape, generator=generator, device=dev)

        if self.patch_size > 1:
            p = self.patch_size
            n_patch = num_rays // (p * p)
            img = randint(n_frames, (n_patch,)).repeat_interleave(p * p)
            pix = patch_pixels(randint(self.H - p, (n_patch,)), randint(self.W - p, (n_patch,)),
                               p, self.W)
            num_rays = pix.shape[0]
        else:
            img, pix = randint(n_frames, (num_rays,)), randint(self.H * self.W, (num_rays,))
        sparse = {}
        if self.sparse_coords is not None and self.patch_size <= 1:
            sparse = dict(
                use_sparse=torch.rand((), generator=generator, device=dev) < 0.1,
                sparse_frame=randint(n_frames, ()),
                sparse_m=randint(self.sparse_coords.shape[1], (num_rays,)))
        bg = (torch.rand((num_rays, 3), generator=generator, device=dev)
              if self.random_background else None)
        return SampleDraws(img_idx=img, pix_idx=pix, bg=bg, **sparse)

    def sample(self, draws: SampleDraws) -> Dict[str, torch.Tensor]:
        """The batch of ``draws``: rays_o, rays_d, pixels, alpha, bg_color,
        index, and depth / depth_weight / cam_near_far where the dataset has
        them.  With sparse depth, when ``use_sparse`` holds the whole batch
        is the sparse-depth points of one frame."""
        n_frames = self.images.shape[0]
        img_idx, pix_idx = draws.img_idx, draws.pix_idx
        num_rays = pix_idx.shape[0]
        dev = self.device
        depth = depth_weight = None
        if self.depths is not None:
            depth = self.depths.reshape(n_frames, -1)[img_idx, pix_idx]
        if self.sparse_coords is not None and self.patch_size <= 1:
            f_id, m, use = draws.sparse_frame, draws.sparse_m, draws.use_sparse
            rc = self.sparse_coords[f_id, m]
            img_idx = torch.where(use, f_id.expand_as(img_idx), img_idx)
            pix_idx = torch.where(use, (rc[:, 0] * self.W + rc[:, 1]).to(pix_idx.dtype), pix_idx)
            depth = torch.where(use, self.sparse_depth[f_id, m],
                                depth if depth is not None else torch.zeros((num_rays,), device=dev))
            depth_weight = torch.where(
                use, self.sparse_weight[f_id, m],
                torch.full((num_rays,), 1.0 if self.depths is not None else 0.0, device=dev))

        rgba = self.images.reshape(n_frames, self.H * self.W, -1)[img_idx, pix_idx]
        if rgba.shape[-1] == 4:
            bg = draws.bg if self.random_background else torch.ones((num_rays, 3), device=dev)
            rgb = rgba[:, :3] * rgba[:, 3:4] + bg * (1.0 - rgba[:, 3:4])
            alpha = rgba[:, 3]
        else:
            bg = torch.ones((num_rays, 3), device=dev)
            rgb, alpha = rgba[:, :3], torch.ones((num_rays,), device=dev)

        i = (pix_idx % self.W).to(torch.float32) + 0.5
        j = (pix_idx // self.W).to(torch.float32) + 0.5
        rays_d = torch.einsum("nij,nj->ni", self.poses[img_idx, :3, :3],
                              pixel_dirs(i, j, self.intrinsics))
        out = {"rays_o": self.poses[img_idx, :3, 3], "rays_d": rays_d, "pixels": rgb,
               "alpha": alpha, "bg_color": bg, "index": img_idx}
        if depth is not None:
            out["depth"] = depth
            if depth_weight is not None:
                out["depth_weight"] = depth_weight
        if self.cam_near_far is not None:
            out["cam_near_far"] = self.cam_near_far[img_idx]
        return out

    def frame_rays(self, idx: int, ssaa: int = 1) -> Dict[str, torch.Tensor]:
        """All rays of one frame, for eval rendering; with ssaa > 1 on an
        (H ssaa, W ssaa) grid (the ground truth stays at the base size)."""
        s = max(ssaa, 1)
        res = get_rays(self.poses[idx: idx + 1], self.intrinsics * s, self.H * s, self.W * s)
        rgba = self.images[idx].reshape(-1, self.images.shape[-1])
        if rgba.shape[-1] == 4:
            rgb, alpha = rgba[:, :3] * rgba[:, 3:4] + (1.0 - rgba[:, 3:4]), rgba[:, 3]
        else:
            rgb, alpha = rgba[:, :3], torch.ones((rgba.shape[0],), device=self.device)
        return {"rays_o": res["rays_o"], "rays_d": res["rays_d"], "pixels": rgb, "alpha": alpha,
                "H": self.H, "W": self.W, "mvp": self.mvps[idx], "pose": self.poses[idx]}
