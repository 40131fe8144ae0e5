"""Batch image downscaler (counterpart of scripts/downscale.py) without PIL:
every .png / .jpg / .jpeg of a directory, resized to 1/scale by the port's
Lanczos (PIL's filter, byte for byte) and written under the same name,
PNG or JPEG by extension (JPEG at PIL's default quality 75).

    python3 -m mirres_restir_nerf_mesh_torch.tools.downscale <dir> --scale 2 [--out <dir_2>]
"""

from __future__ import annotations

import argparse
import glob
import os

from ..utils.image_io import read_image, resize_lanczos, write_jpeg, write_png

JPEG_QUALITY = 75     # PIL's default


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("path")
    ap.add_argument("--scale", type=int, default=2)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    out = args.out or (args.path.rstrip("/") + f"_{args.scale}")
    os.makedirs(out, exist_ok=True)
    files = sorted(
        sum((glob.glob(os.path.join(args.path, e)) for e in ("*.png", "*.jpg", "*.jpeg")), [])
    )
    for f in files:
        img = read_image(f)
        h, w = img.shape[0] // args.scale, img.shape[1] // args.scale
        if h <= 0 or w <= 0:
            raise ValueError(f"{f}: {img.shape[1]}x{img.shape[0]} is smaller than the scale")
        img = resize_lanczos(img, w, h)
        dst = os.path.join(out, os.path.basename(f))
        if f.lower().endswith(".png"):
            write_png(dst, img)
        else:
            write_jpeg(dst, img, JPEG_QUALITY)
    print(f"downscaled {len(files)} images -> {out}")


if __name__ == "__main__":
    main()
