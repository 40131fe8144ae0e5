"""Port vs reference: ``data/dtu.py``.

- ``decompose_projection``: K and the OpenGL pose equal the reference's
  (1e-6) and recover the written camera (1e-5) on random look-at cameras.
- ``load_dtu`` on a scene written with PIL (cameras_sphere.npz or
  cameras.npz, scale_mat present or absent, PNG and JPEG image/ and mask/
  files, downscale 1 and 2, with_images=False): FrameData equal to the
  reference's (images equal at downscale 1, JPEG included; within 1/255 at
  downscale 2, where PIL rounds the resized image to 8 bits).
"""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from mirres_restir_nerf_mesh_tpu.data import dtu as jdtu
from mirres_restir_nerf_mesh_torch.data import dtu as tdtu

from test_dtu import look_at_w2c
from test_torch_helpers import TORCH_THREADS

torch.set_num_threads(TORCH_THREADS)


def test_decompose_projection_matches_reference():
    rng = np.random.RandomState(0)
    for _ in range(6):
        K = np.array([[rng.uniform(300, 500), 0.3, rng.uniform(20, 40)],
                      [0, rng.uniform(300, 500), rng.uniform(15, 30)], [0, 0, 1.0]])
        eye = rng.normal(size=3)
        eye = eye / np.linalg.norm(eye) * rng.uniform(1.5, 3.0)
        w2c = look_at_w2c(eye, target=rng.normal(scale=0.1, size=3))
        P = K @ w2c[:3, :4]
        (Kt, ct), (Kj, cj) = tdtu.decompose_projection(P), jdtu.decompose_projection(P)
        np.testing.assert_allclose(Kt, Kj, rtol=1e-6)
        np.testing.assert_allclose(ct, cj, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(Kt, K, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(ct[:3, 3], eye, rtol=1e-5, atol=1e-5)


def write_dtu(root, n=5, H=30, W=40, cam_file="cameras_sphere.npz", scale_mat=True, ext="png",
              seed=1):
    rng = np.random.RandomState(seed)
    K = np.array([[60.0, 0, 19.5], [0, 58.0, 15.2], [0, 0, 1.0]])
    os.makedirs(root / "image")
    os.makedirs(root / "mask")
    cams = {}
    yy, xx = np.mgrid[0:H, 0:W]
    for i in range(n):
        eye = rng.uniform(-1, 1, 3)
        cams[f"world_mat_{i}"] = np.vstack([K @ look_at_w2c(eye / np.linalg.norm(eye) * 2.0)[:3],
                                            [0, 0, 0, 1]])
        if scale_mat:
            sm = np.eye(4)
            sm[:3, 3] = rng.normal(scale=0.1, size=3)
            cams[f"scale_mat_{i}"] = sm
        img = np.stack([(xx * 6 + 20 * i) % 256, (yy * 8) % 256, (xx + yy) * 3 % 256], -1)
        mask = ((xx - W / 2) ** 2 + (yy - H / 2) ** 2 < (H / 3) ** 2) * 255
        Image.fromarray(img.astype(np.uint8)).save(root / "image" / f"{i:03d}.{ext}",
                                                   **({"quality": 90} if ext == "jpg" else {}))
        Image.fromarray(mask.astype(np.uint8)).save(root / "mask" / f"{i:03d}.png")
    np.savez(root / cam_file, **cams)


@pytest.mark.parametrize("cam_file,scale_mat,ext,downscale", [
    ("cameras_sphere.npz", True, "png", 1), ("cameras.npz", False, "jpg", 1),
    ("cameras_sphere.npz", True, "jpg", 2)])
@pytest.mark.parametrize("split", ["train", "test"])
def test_load_dtu_matches_reference(tmp_path, cam_file, scale_mat, ext, downscale, split):
    write_dtu(tmp_path, cam_file=cam_file, scale_mat=scale_mat, ext=ext)
    kw = dict(split=split, downscale=downscale, bound=1.0, test_every=3)
    got, ref = tdtu.load_dtu(str(tmp_path), **kw), jdtu.load_dtu(str(tmp_path), **kw)
    assert (got.H, got.W) == (ref.H, ref.W) and got.images.shape == ref.images.shape
    assert got.images.shape[-1] == 4
    np.testing.assert_allclose(got.images, ref.images, rtol=0,
                               atol=0.0 if downscale == 1 else 1 / 255)
    for f in ("poses", "intrinsics", "mvps"):
        np.testing.assert_allclose(getattr(got, f), getattr(ref, f), rtol=1e-6, atol=1e-6,
                                   err_msg=f)
    kw["with_images"] = False
    got, ref = tdtu.load_dtu(str(tmp_path), **kw), jdtu.load_dtu(str(tmp_path), **kw)
    assert got.images.shape == ref.images.shape
    np.testing.assert_allclose(got.mvps, ref.mvps, rtol=1e-6, atol=1e-6)
