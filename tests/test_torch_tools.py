"""Port vs reference: the dataset tools (``tools/colmap2nerf.py`` against
scripts/colmap2nerf.py, ``tools/remove_bg.py`` against scripts/remove_bg.py
without rembg).

- colmap2nerf on the COLMAP fixture of tests/test_colmap.py (a
  SIMPLE_PINHOLE model) and on a PINHOLE one: the same transforms.json.
- remove_bg's colour-threshold matte on PNG (RGB, gray, RGBA) and JPEG
  frames: the same <name>_rgba.png bytes' pixels; asking for rembg raises.
"""

import json
import os
import struct
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from mirres_restir_nerf_mesh_torch.tools import colmap2nerf, remove_bg
from mirres_restir_nerf_mesh_torch.utils.image_io import read_png

from test_colmap import make_fixture
from test_torch_helpers import TORCH_THREADS

torch.set_num_threads(TORCH_THREADS)
REPO = str(Path(__file__).resolve().parent.parent)


def run_script(script, args):
    r = subprocess.run([sys.executable, script] + args, capture_output=True, text=True, cwd=REPO,
                       timeout=300)
    assert r.returncode == 0, r.stderr


@pytest.mark.parametrize("pinhole", [False, True])
def test_colmap2nerf_matches_reference(tmp_path, pinhole):
    make_fixture(tmp_path)
    if pinhole:      # the same camera as a PINHOLE model with fx != fy
        (tmp_path / "sparse/0/cameras.bin").write_bytes(
            struct.pack("<QiiQQ", 1, 1, 1, 64, 48) + struct.pack("<4d", 61.0, 59.5, 31.2, 24.9))
    colmap2nerf.main(["--colmap_dir", str(tmp_path), "--out", str(tmp_path / "port.json")])
    run_script("scripts/colmap2nerf.py", ["--colmap_dir", str(tmp_path), "--out",
                                          str(tmp_path / "ref.json")])
    got = json.loads((tmp_path / "port.json").read_text())
    ref = json.loads((tmp_path / "ref.json").read_text())
    assert got == ref and len(got["frames"]) == 4


def test_remove_bg_matches_reference(tmp_path):
    rng = np.random.RandomState(0)
    yy, xx = np.mgrid[0:30, 0:40]
    inside = (yy - 15) ** 2 + (xx - 20) ** 2 < 100
    rgb = np.where(inside[..., None], [200, 40, 30], [245, 245, 240]) + rng.randint(-6, 7, (30, 40, 3))
    rgb = np.clip(rgb, 0, 255).astype(np.uint8)
    for d in ("port", "ref"):
        os.makedirs(tmp_path / d)
        Image.fromarray(rgb).save(tmp_path / d / "a.png")
        Image.fromarray(rgb[..., 0]).save(tmp_path / d / "b.png")
        Image.fromarray(np.concatenate([rgb, np.full((30, 40, 1), 128, np.uint8)], -1)).save(
            tmp_path / d / "c.png")
        Image.fromarray(rgb).save(tmp_path / d / "d.jpg", quality=90)
    remove_bg.main([str(tmp_path / "port")])
    run_script("scripts/remove_bg.py", [str(tmp_path / "ref")])
    for name in ("a", "b", "c", "d"):
        got = read_png(str(tmp_path / "port" / f"{name}_rgba.png"))
        ref = np.asarray(Image.open(tmp_path / "ref" / f"{name}_rgba.png"))
        assert got.shape == ref.shape == (30, 40, 4)
        np.testing.assert_array_equal(got, ref, err_msg=name)
    assert got[15, 20, 3] == 255 and got[0, 0, 3] == 0
    with pytest.raises(SystemExit, match="rembg"):
        remove_bg.main([str(tmp_path / "port"), "--rembg"])
