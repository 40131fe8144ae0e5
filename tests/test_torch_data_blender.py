"""Port vs reference: ``data.provider.load_blender`` on blender-format scenes
written with PIL.

- transforms_{split}.json with camera_angle_x, RGBA frames; transforms.json
  (no split file) with fl_x / fl_y / cx / cy and RGB frames; a gray frame;
  with_images=False (the json's h, w): poses, intrinsics, mvps, H, W
  equal (rtol 1e-6 on the mvps, inverted in float64 by both), images
  equal.
- downscale 2: the port's antialiased bilinear resize (torch) against
  PIL's BILINEAR, which rounds to 8 bits: images within 1/255, the rest
  as above.  RGBA resizes premultiplied (PIL's rule, mirrored by the
  port): alpha within 1/255, colour within 1/255 where opaque, and the
  premultiplied colour (what compositing reads) within 1.5/255 everywhere:
  PIL rounds it to 8 bits before and after its division by alpha.
"""

import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from mirres_restir_nerf_mesh_tpu.data.provider import load_blender as jload
from mirres_restir_nerf_mesh_torch.data.provider import load_blender as tload

from test_torch_helpers import TORCH_THREADS

torch.set_num_threads(TORCH_THREADS)


def write_scene(root, split_file: bool, mode: str, H=30, W=34, n=3, seed=0, meta_extra=None):
    rng = np.random.RandomState(seed)
    os.makedirs(root / "imgs", exist_ok=True)
    frames = []
    for k in range(n):
        pose = np.eye(4)
        pose[:3, :3] = np.linalg.qr(rng.normal(size=(3, 3)))[0]
        pose[:3, 3] = rng.normal(size=3) * 2.0
        C = {"RGBA": 4, "RGB": 3, "L": 1}[mode]
        img = rng.randint(0, 256, (H, W, C)).astype(np.uint8)
        img[: H // 2] = np.linspace(0, 255, W).astype(np.uint8)[None, :, None]
        if C == 4:
            # a blender render's alpha: an opaque disc, a half-covered rim
            r = np.hypot(*np.meshgrid(np.arange(H) - H / 2, np.arange(W) - W / 2,
                                      indexing="ij"))
            img[..., 3] = np.where(r < 10, 255, np.where(r < 11.5, 128, 0))
        Image.fromarray(img[..., 0] if C == 1 else img, mode).save(root / "imgs" / f"f{k}.png")
        # the second frame names its extension, the others do not
        frames.append({"file_path": f"imgs/f{k}" + (".png" if k == 1 else ""),
                       "transform_matrix": pose.tolist()})
    meta = {"frames": frames, **(meta_extra or {"camera_angle_x": 0.69})}
    name = "transforms_train.json" if split_file else "transforms.json"
    with open(root / name, "w") as f:
        json.dump(meta, f)
    return str(root)


def check(got, ref, images_atol=0.0):
    assert (got.H, got.W) == (ref.H, ref.W)
    np.testing.assert_array_equal(got.poses, ref.poses)
    np.testing.assert_array_equal(got.intrinsics, ref.intrinsics)
    np.testing.assert_allclose(got.mvps, ref.mvps, rtol=1e-6, atol=1e-7)
    assert got.images.shape == ref.images.shape and got.images.dtype == np.float32
    if got.images.shape[-1] == 4 and images_atol > 0:
        # PIL resizes RGBA premultiplied in 8 bits and divides back: where
        # the alpha is partial its colour carries that rounding over alpha
        g, r = got.images, ref.images
        np.testing.assert_allclose(g[..., 3], r[..., 3], rtol=0, atol=images_atol)
        opaque = r[..., 3] == 1.0
        assert opaque.any() and (r[..., 3] == 0).any() and (~opaque & (r[..., 3] > 0)).any()
        np.testing.assert_allclose(g[..., :3][opaque], r[..., :3][opaque], rtol=0,
                                   atol=images_atol)
        # the colour that compositing reads, rgb * alpha: both 8-bit roundings
        np.testing.assert_allclose(g[..., :3] * g[..., 3:], r[..., :3] * r[..., 3:], rtol=0,
                                   atol=1.5 * images_atol)
        return
    np.testing.assert_allclose(got.images, ref.images, rtol=0, atol=images_atol)


@pytest.mark.parametrize("split_file,mode,meta", [
    (True, "RGBA", None),
    (False, "RGB", {"fl_x": 40.0, "fl_y": 41.5, "cx": 16.0, "cy": 14.5}),
    (True, "L", {"fl_x": 40.0, "cx": 17.5}),
])
@pytest.mark.parametrize("downscale", [1, 2])
def test_load_blender_matches_reference(tmp_path, split_file, mode, meta, downscale):
    root = write_scene(tmp_path, split_file, mode, meta_extra=meta)
    kw = dict(split="train", downscale=downscale, scale=0.8, offset=(0.1, -0.2, 0.0), bound=1.5)
    check(tload(root, **kw), jload(root, **kw), images_atol=0.0 if downscale == 1 else 1 / 255)


def test_load_blender_without_images(tmp_path):
    root = write_scene(tmp_path, True, "RGB", meta_extra={"camera_angle_x": 0.8, "h": 60,
                                                          "w": 80})
    kw = dict(split="train", downscale=2, scale=0.33, bound=1.0, with_images=False)
    got, ref = tload(root, **kw), jload(root, **kw)
    check(got, ref)
    assert (got.H, got.W) == (30, 40) and not got.images.any()
