"""Orbit-camera turntable of a trained workspace (counterpart of
scripts/render_turntable.py, the headless analogue of the upstream
project's GUI): N frames orbiting the scene through the Trainer's eval
render, written as PNGs, and as an MP4 where ``imageio`` and
``imageio_ffmpeg`` import.

    python3 -m mirres_restir_nerf_mesh_torch.tools.render_turntable <data_path> \\
        --workspace ws --stage 0 [--frames 60 --radius 2.0 --H 400 --W 400]

Runs on the card; ``main(argv, device="cpu")`` runs it on the CPU.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..data.provider import FrameData, RayDataset, compute_mvps
from ..data.synthetic import orbit_pose
from ..train.trainer import Trainer
from ..utils.image_io import save_png


def main(argv=None, device="cuda") -> None:
    from ..main import config_from_args

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("path")
    ap.add_argument("--workspace", required=True)
    ap.add_argument("--stage", type=int, default=0)
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--radius", type=float, default=2.0)
    ap.add_argument("--elevation", type=float, default=60.0, help="theta in degrees")
    ap.add_argument("--H", type=int, default=400)
    ap.add_argument("--W", type=int, default=400)
    ap.add_argument("--fovy", type=float, default=50.0)
    ap.add_argument("--extra", nargs=argparse.REMAINDER, default=[],
                    help="extra CLI flags forwarded to the trainer config")
    args = ap.parse_args(argv)

    cfg = config_from_args([args.path, "--workspace", args.workspace, "--stage", str(args.stage),
                            "--test"] + list(args.extra))
    H, W = args.H, args.W
    fy = 0.5 * H / np.tan(0.5 * np.radians(args.fovy))
    intrinsics = np.array([fy, fy, W / 2, H / 2], np.float32)
    poses = np.stack([orbit_pose(np.radians(args.elevation), 2 * np.pi * k / args.frames,
                                 args.radius) for k in range(args.frames)])
    data = FrameData(images=np.ones((args.frames, H, W, 3), np.float32), poses=poses,
                     intrinsics=intrinsics, H=H, W=W,
                     mvps=compute_mvps(poses, intrinsics, H, W, cfg.bound))

    trainer = Trainer("ngp", cfg, data, workspace=args.workspace, device=device)
    sampler = RayDataset(data, bound=cfg.bound, device=trainer.device)
    out_dir = os.path.join(args.workspace, "turntable")
    os.makedirs(out_dir, exist_ok=True)
    frames = []
    for i in range(args.frames):
        outs, _ = trainer._render_eval_outputs(sampler, i)
        img = outs["image"]
        save_png(os.path.join(out_dir, f"frame_{i:04d}.png"), img)
        frames.append((img * 255).astype(np.uint8))
        print(f"frame {i + 1}/{args.frames}")

    try:
        import imageio
        import imageio_ffmpeg  # noqa: F401  (imageio's MP4 writer)
    except ImportError as e:
        print(f"[warn] mp4 skipped: {e}")
        return
    imageio.mimwrite(os.path.join(out_dir, "turntable.mp4"), frames, fps=24)
    print(f"wrote {out_dir}/turntable.mp4")


if __name__ == "__main__":
    main()
