"""Background removal for a capture in front of a uniform backdrop
(counterpart of scripts/remove_bg.py without ``rembg``): every .png / .jpg
in a directory gets an alpha from its colour distance to the median border
colour, written beside it as ``<name>_rgba.png``.

    python3 -m mirres_restir_nerf_mesh_torch.tools.remove_bg <dir>

``--rembg`` (the reference's learned matting) needs the ``rembg`` package,
which the port does not use: asking for it raises.
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np

from ..utils.image_io import read_rgb, write_png


def simple_matte(img: np.ndarray, thresh: float = 0.12) -> np.ndarray:
    """float RGB [H, W, 3] -> alpha [H, W] in {0, 1}: 1 where the colour lies
    farther than ``thresh`` from the median border colour."""
    border = np.concatenate([img[0], img[-1], img[:, 0], img[:, -1]])
    bg = np.median(border, axis=0)
    return (np.linalg.norm(img - bg, axis=-1) > thresh).astype(np.float32)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("path")
    ap.add_argument("--rembg", action="store_true", help="not available in the port")
    args = ap.parse_args(argv)
    if args.rembg:
        raise SystemExit("remove_bg: rembg matting is not part of the port; run without --rembg "
                         "(the colour-threshold matte)")
    files = sorted(sum((glob.glob(os.path.join(args.path, e)) for e in ("*.png", "*.jpg")), []))
    for f in files:
        arr = read_rgb(f)
        rgba = np.concatenate([arr, simple_matte(arr)[..., None]], axis=-1)
        write_png(os.path.splitext(f)[0] + "_rgba.png", (rgba * 255).astype(np.uint8))
    print(f"processed {len(files)} images")


if __name__ == "__main__":
    main()
