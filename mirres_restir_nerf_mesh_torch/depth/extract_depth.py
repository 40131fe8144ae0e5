"""Monocular depth maps for dense-depth supervision (counterpart of
depth_tools/extract_depth.py): each image resized to 384x384 (bilinear),
normalized (x - 0.5) / 0.5, run through a depth net, resized back to the
image's size (bicubic) and saved as ``<out>/<name>.npy``, which
``data/colmap.py:load_colmap`` reads from ``<data>/depths/``.

    python3 -m mirres_restir_nerf_mesh_torch.depth.extract_depth <data>/images \\
        (--ckpt omnidata_dpt_depth_v2.ckpt | --model_path net.pt) [--out DIR] [--device cpu]

The net: ``--ckpt``, the omnidata DPT-Hybrid depth checkpoint through the
port's DPT (``dpt.py``); or ``--model_path``, a TorchScript module taking
the normalized [1, 3, 384, 384] batch to [1, 384, 384] (or
[1, 1, 384, 384]).  Without either, copy precomputed ``.npy`` maps into
``<data>/depths/`` yourself.  It runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..utils.image_io import read_rgb

IMAGE_SIZE = 384


def run_model(model, img: np.ndarray, device="cuda") -> np.ndarray:
    """img [H, W, 3] float in [0, 1] -> depth [H, W] float32 (384^2
    bilinear, (x - 0.5) / 0.5, the net, bicubic back)."""
    dev = resolve_device(device)
    H, W = img.shape[:2]
    x = torch.from_numpy(np.ascontiguousarray(img, np.float32)).permute(2, 0, 1)[None].to(dev)
    x = F.interpolate(x, size=(IMAGE_SIZE, IMAGE_SIZE), mode="bilinear", align_corners=False)
    x = (x - 0.5) / 0.5
    with torch.no_grad():
        d = model(x)
    if d.ndim == 3:
        d = d.unsqueeze(1)
    d = F.interpolate(d, size=(H, W), mode="bicubic", align_corners=False)
    return d.squeeze().cpu().numpy()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("path", help="directory of .png / .jpg images")
    ap.add_argument("--ckpt", default=None, help="omnidata DPT-Hybrid depth checkpoint")
    ap.add_argument("--model_path", default=None, help="TorchScript depth net")
    ap.add_argument("--out", default=None, help="default: <path>/../depths")
    ap.add_argument("--device", default="cuda", help="cpu to run on the CPU")
    args = ap.parse_args(argv)

    out = args.out or os.path.join(os.path.dirname(args.path.rstrip("/")), "depths")
    os.makedirs(out, exist_ok=True)
    files = sorted(sum((glob.glob(os.path.join(args.path, e)) for e in ("*.png", "*.jpg")), []))
    if args.model_path is None and args.ckpt is None:
        raise SystemExit("No depth model given. Provide --ckpt <omnidata.ckpt> (the port's DPT), "
                         "--model_path <torchscript.pt>, or place precomputed .npy depth maps "
                         f"directly into {out}/.")
    dev = resolve_device(args.device)
    if args.ckpt is not None:
        from .dpt import load_dpt

        model = load_dpt(args.ckpt, dev)
    else:
        model = torch.jit.load(args.model_path, map_location=dev).eval()
    for f in files:
        d = run_model(model, read_rgb(f), dev)
        np.save(os.path.join(out, os.path.splitext(os.path.basename(f))[0] + ".npy"), d)
        print(f, "->", d.shape)


if __name__ == "__main__":
    main()
