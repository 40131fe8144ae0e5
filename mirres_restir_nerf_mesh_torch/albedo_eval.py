"""Albedo evaluation (counterpart of the root albedo_eval.py): PSNR / SSIM
(/ LPIPS) of the predicted albedo against ground truth after a per-channel
scale correction (the median GT / pred ratio over masked pixels; inverse
rendering recovers albedo up to a global scale, the TensoIR protocol).

    python3 -m mirres_restir_nerf_mesh_torch.albedo_eval --pred_dir ws/results --gt_dir <gt>

Pairs of images (pred kd vs GT albedo), sorted by name; .png / .hdr / .exr
/ .npy.  The metrics run on the card unless ``main(argv, device="cpu")``.
"""

from __future__ import annotations

import argparse
import glob
import json
import os

import numpy as np
import torch

from .device import resolve_device


def load_any(path: str) -> np.ndarray:
    if path.endswith(".npy"):
        return np.load(path).astype(np.float32)
    from .utils.image_io import load_hdr, read_png

    if path.endswith((".hdr", ".exr")):
        return load_hdr(path)
    return read_png(path).astype(np.float32) / 255.0


def albedo_scale(pred: np.ndarray, gt: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """Median per-channel GT / pred ratio over masked pixels."""
    scale = np.ones(3, np.float32)
    for c in range(3):
        p = pred[..., c][mask]
        g = gt[..., c][mask]
        ok = p > 1e-4
        if ok.any():
            scale[c] = np.median(g[ok] / p[ok])
    return scale


def evaluate_pair(pred: np.ndarray, gt: np.ndarray, mask: np.ndarray, device="cuda"):
    from .train.metrics import lpips_fn, psnr, ssim

    dev = resolve_device(device)
    scale = albedo_scale(pred, gt, mask)
    pred_s = np.clip(pred * scale, 0, 1)
    gt = np.clip(gt, 0, 1)
    pred_s = np.where(mask[..., None], pred_s, 0.0).astype(np.float32)
    gt_m = np.where(mask[..., None], gt, 0.0).astype(np.float32)
    p, g = torch.as_tensor(pred_s, device=dev), torch.as_tensor(gt_m, device=dev)
    out = {"psnr": float(psnr(p, g)), "ssim": float(ssim(p, g)), "scale": scale.tolist()}
    lp = lpips_fn(device=dev)
    if lp is not None:
        out["lpips"] = lp(pred_s, gt_m)
    return out


def main(argv=None, device="cuda") -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pred_dir", required=True)
    ap.add_argument("--gt_dir", required=True)
    ap.add_argument("--mask_dir", default=None)
    ap.add_argument("--pred_glob", default="*kd*")
    ap.add_argument("--gt_glob", default="*albedo*")
    ap.add_argument("--out", default=None, help="also write the aggregate JSON here")
    args = ap.parse_args(argv)

    preds = sorted(glob.glob(os.path.join(args.pred_dir, args.pred_glob + ".*"))
                   + glob.glob(os.path.join(args.pred_dir, args.pred_glob)))
    gts = sorted(glob.glob(os.path.join(args.gt_dir, args.gt_glob + ".*"))
                 + glob.glob(os.path.join(args.gt_dir, args.gt_glob)))
    if not preds or len(preds) != len(gts):
        raise ValueError(f"{len(preds)} predictions vs {len(gts)} ground-truth images")

    results = []
    for p, g in zip(preds, gts):
        pred = load_any(p)[..., :3]
        gt_img = load_any(g)
        if gt_img.shape[-1] == 4:
            mask = gt_img[..., 3] > 0.5
            gt_img = gt_img[..., :3]
        else:
            mask = np.ones(gt_img.shape[:2], bool)
        if args.mask_dir:
            m = load_any(sorted(glob.glob(os.path.join(args.mask_dir, "*")))[len(results)])
            mask = (m if m.ndim == 2 else m[..., 0]) > 0.5
        results.append(evaluate_pair(pred, gt_img, mask, device=device))
        print(os.path.basename(p), results[-1])

    agg = {k: float(np.mean([r[k] for r in results])) for k in ("psnr", "ssim")}
    if "lpips" in results[0]:
        agg["lpips"] = float(np.mean([r["lpips"] for r in results]))
    print(json.dumps({"albedo_eval": agg}))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(agg, f)
    return agg


if __name__ == "__main__":
    main()
