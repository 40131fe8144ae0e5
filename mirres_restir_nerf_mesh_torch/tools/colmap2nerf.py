"""A COLMAP sparse model as a blender-format ``transforms.json``
(counterpart of scripts/colmap2nerf.py), read through the port's COLMAP
readers:

    python3 -m mirres_restir_nerf_mesh_torch.tools.colmap2nerf --colmap_dir <ws> [--out F]

Frames sort by image name; poses go from COLMAP's world-to-camera to
OpenGL camera-to-world, unscaled; the first camera gives fl_x / fl_y / cx /
cy (PINHOLE) or f, cx, cy (the other models, distortion dropped).
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from ..data.colmap import qvec2rotmat, read_cameras_binary, read_images_binary


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--colmap_dir", required=True, help="workspace containing sparse/0 and images/")
    ap.add_argument("--out", default=None)
    ap.add_argument("--images", default="images")
    args = ap.parse_args(argv)

    sparse = os.path.join(args.colmap_dir, "sparse", "0")
    cams = read_cameras_binary(os.path.join(sparse, "cameras.bin"))
    images = read_images_binary(os.path.join(sparse, "images.bin"))

    cam = next(iter(cams.values()))
    p = cam["params"]
    if cam["model"] == 1:
        fx, fy, cx, cy = p[0], p[1], p[2], p[3]
    else:
        fx = fy = p[0]
        cx, cy = p[1], p[2]

    frames = []
    for k in sorted(images.keys(), key=lambda k: images[k]["name"]):
        im = images[k]
        w2c = np.eye(4)
        w2c[:3, :3] = qvec2rotmat(im["qvec"])
        w2c[:3, 3] = im["tvec"]
        c2w = np.linalg.inv(w2c)
        c2w[:3, 1:3] *= -1            # OpenCV -> OpenGL
        frames.append({"file_path": os.path.join(args.images, im["name"]),
                       "transform_matrix": c2w.tolist()})

    out = {"fl_x": float(fx), "fl_y": float(fy), "cx": float(cx), "cy": float(cy),
           "w": int(cam["width"]), "h": int(cam["height"]),
           "camera_angle_x": float(2 * np.arctan(0.5 * cam["width"] / fx)), "frames": frames}
    path = args.out or os.path.join(args.colmap_dir, "transforms.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=2)
    print(f"wrote {path} with {len(frames)} frames")


if __name__ == "__main__":
    main()
