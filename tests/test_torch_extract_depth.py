"""Port vs reference: the depth-extraction CLI (``depth/extract_depth.py``
against depth_tools/extract_depth.py).

- ``run_model`` (384^2 bilinear, (x - 0.5) / 0.5, the net, bicubic back)
  equals the reference's on the same TorchScript net and image.
- The TorchScript route end to end on PNG, gray PNG and JPEG images: the
  port's CLI writes the .npy maps the reference's script writes, equal.
- The --ckpt route: a Lightning-wrapped checkpoint of random DPT weights
  through the port's DPT: maps at the image's size, finite, equal to
  ``run_model`` on the loaded net.
- Without a net the CLI exits naming both options; on the card by default,
  raising without one.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from mirres_restir_nerf_mesh_torch.depth import dpt
from mirres_restir_nerf_mesh_torch.depth import extract_depth as ted

from test_torch_helpers import TORCH_THREADS

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "depth_tools"))
import extract_depth as jed  # noqa: E402

torch.set_num_threads(TORCH_THREADS)
REPO = str(Path(__file__).resolve().parent.parent)


class Tiny(torch.nn.Module):
    """A stand-in depth net: the channel mean and a vertical ramp."""

    def forward(self, x):
        return x.mean(dim=1) + torch.linspace(0, 1, x.shape[-2])[:, None]


def images(d, H=37, W=45):
    os.makedirs(d, exist_ok=True)
    yy, xx = np.mgrid[0:H, 0:W]
    rgb = np.stack([xx * 5, yy * 6, (xx + yy) * 3], -1) % 256
    Image.fromarray(rgb.astype(np.uint8)).save(os.path.join(d, "a.png"))
    Image.fromarray((yy * 6 % 256).astype(np.uint8)).save(os.path.join(d, "b.png"))
    Image.fromarray(rgb.astype(np.uint8)).save(os.path.join(d, "c.jpg"), quality=90)
    return rgb.astype(np.float32) / 255.0


def test_run_model_matches_reference():
    img = np.random.RandomState(0).rand(53, 71, 3).astype(np.float32)
    got = ted.run_model(Tiny().eval(), img, "cpu")
    ref = jed.run_model(Tiny().eval(), img)
    assert got.shape == (53, 71)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


def test_torchscript_route_matches_reference(tmp_path):
    images(tmp_path / "images")
    net = str(tmp_path / "tiny.pt")
    torch.jit.trace(Tiny().eval(), torch.zeros(1, 3, 384, 384)).save(net)
    ted.main([str(tmp_path / "images"), "--model_path", net, "--out", str(tmp_path / "port"),
              "--device", "cpu"])
    r = subprocess.run([sys.executable, "depth_tools/extract_depth.py", str(tmp_path / "images"),
                        "--model_path", net, "--out", str(tmp_path / "ref")],
                       capture_output=True, text=True, cwd=REPO, timeout=300)
    assert r.returncode == 0, r.stderr
    for name in ("a", "b", "c"):
        got = np.load(tmp_path / "port" / f"{name}.npy")
        ref = np.load(tmp_path / "ref" / f"{name}.npy")
        assert got.shape == ref.shape == (37, 45)
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6, err_msg=name)


def test_ckpt_route_runs_the_ports_dpt(tmp_path):
    rgb = images(tmp_path / "images", H=29, W=33)
    os.remove(tmp_path / "images" / "b.png")
    os.remove(tmp_path / "images" / "c.jpg")
    sd, _ = dpt.random_params(1)
    ckpt = str(tmp_path / "dpt.ckpt")
    torch.save({"state_dict": {f"model.{k}": v for k, v in sd.items()}}, ckpt)
    ted.main([str(tmp_path / "images"), "--ckpt", ckpt, "--device", "cpu"])
    got = np.load(tmp_path / "depths" / "a.npy")         # default out: beside the images
    assert got.shape == (29, 33) and np.isfinite(got).all()
    want = ted.run_model(dpt.build_dpt(sd, "cpu"), rgb, "cpu")
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * float(np.abs(want).max()))


def test_cli_needs_a_net_and_a_card(tmp_path):
    images(tmp_path / "images")
    with pytest.raises(SystemExit, match="--ckpt.*--model_path"):
        ted.main([str(tmp_path / "images"), "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ted.run_model(Tiny(), np.zeros((8, 8, 3), np.float32))
