"""The port's image writer, resampler and the user's viewing tools, on the
CPU: ``utils/image_io.py`` ``resize_lanczos`` / ``write_jpeg`` against PIL,
``tools/downscale.py`` against scripts/downscale.py, and
``tools/render_turntable.py`` / ``tools/live_viewer.py`` on a tiny
stage-0 workspace.

- ``resize_lanczos``: bytes equal to PIL's ``resize(..., LANCZOS)`` on RGB,
  RGBA (PIL resizes premultiplied) and gray, by 2 and by 3.
- ``write_jpeg`` at quality 75 and 90 (RGB, odd sizes, and gray): the
  file's bytes equal PIL's ``save(..., "JPEG")``; the port's decoder
  reads it to the pixels PIL reads; its PSNR against the source within 0.1
  dB of PIL's own encoding.
- ``tools.downscale`` on a folder of PNGs (RGBA, gray) and JPEGs: the
  files scripts/downscale.py writes for the same folder (JPEGs byte for
  byte, PNGs pixel for pixel, since zlib settings differ).
- ``render_turntable``: 2 frames at 16x16 from a workspace trained 3 steps,
  finite PNGs; ``live_viewer``: the page, one stage-0 render decoded by
  ``read_jpeg`` at the requested size, then ``--train`` serving while its
  Trainer's step advances (12 steps of a 16x16 scene).
"""

import importlib.util
import io
import os
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from mirres_restir_nerf_mesh_torch.config import Config, finalize
from mirres_restir_nerf_mesh_torch.data.synthetic import make_synthetic_frames
from mirres_restir_nerf_mesh_torch.tools import downscale, live_viewer, render_turntable
from mirres_restir_nerf_mesh_torch.train.trainer import Trainer
from mirres_restir_nerf_mesh_torch.utils.image_io import (read_image, read_jpeg, read_png,
                                                          resize_lanczos, write_jpeg, write_png)

from test_torch_helpers import TORCH_THREADS

Image = pytest.importorskip("PIL.Image")
torch.set_num_threads(TORCH_THREADS)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ITERS = 12          # live_viewer --train
SMALL = ["--hash_levels", "4", "--hash_log2_size", "12", "--hash_max_res", "64"]


def picture(H, W, C, seed):
    """A smooth gradient with texture and noise (JPEG-like content)."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:H, 0:W]
    base = [xx * 255.0 / max(W - 1, 1), yy * 255.0 / max(H - 1, 1),
            128 + 60 * np.sin(xx / 3.0 + yy / 5.0), 255 * (xx + yy < W)]
    img = np.stack(base[:max(C, 3)], -1)[..., :C] + rng.normal(0, 12, (H, W, C))
    return np.clip(img, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("C", [3, 4, 1])
@pytest.mark.parametrize("factor", [2, 3])
def test_resize_lanczos_equals_pil(C, factor):
    img = picture(61, 47, C, seed=C)
    if C == 4:
        img[:5, :5, 3] = 0
        img[5:9, :5, 3] = 255
    a = img[..., 0] if C == 1 else img
    w, h = 47 // factor, 61 // factor
    ref = np.asarray(Image.fromarray(a).resize((w, h), Image.LANCZOS))
    got = resize_lanczos(a, w, h)
    assert got.shape == ref.shape and got.dtype == np.uint8
    np.testing.assert_array_equal(got, ref)


def psnr(a, b):
    return 10 * np.log10(255.0 ** 2 / np.mean((a.astype(np.float64) - b) ** 2))


@pytest.mark.parametrize("quality", [75, 90])
def test_write_jpeg_equals_pil(tmp_path, quality):
    for H, W, C in ((48, 64, 3), (37, 29, 3), (8, 8, 3), (23, 17, 1)):
        src = picture(H, W, C, seed=H)
        src = src[..., 0] if C == 1 else src
        path = str(tmp_path / f"x_{H}_{W}.jpg")
        write_jpeg(path, src, quality)
        buf = io.BytesIO()
        Image.fromarray(src).save(buf, "JPEG", quality=quality)
        with open(path, "rb") as f:
            ours = f.read()
        assert ours == buf.getvalue(), (H, W, C)
        pil_pixels = np.asarray(Image.open(path))
        np.testing.assert_array_equal(read_jpeg(path), pil_pixels)
        ref_pixels = np.asarray(Image.open(io.BytesIO(buf.getvalue())))
        assert abs(psnr(src, pil_pixels) - psnr(src, ref_pixels)) <= 0.1
        assert psnr(src, pil_pixels) > 20


def load_script(name):
    spec = importlib.util.spec_from_file_location(f"script_{name}",
                                                  os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_downscale_matches_script(tmp_path, monkeypatch):
    src = tmp_path / "imgs"
    src.mkdir()
    write_png(str(src / "a.png"), picture(50, 70, 4, seed=1))
    write_png(str(src / "b.png"), picture(33, 21, 1, seed=2)[..., 0])
    write_jpeg(str(src / "c.jpg"), picture(64, 48, 3, seed=3), 90)
    write_jpeg(str(src / "d.jpeg"), picture(30, 45, 3, seed=4), 95)
    downscale.main([str(src), "--scale", "2", "--out", str(tmp_path / "ours")])
    monkeypatch.setattr(sys, "argv", ["downscale.py", str(src), "--scale", "2", "--out",
                                      str(tmp_path / "ref")])
    load_script("downscale").main()
    names = sorted(os.listdir(tmp_path / "ref"))
    assert names == sorted(os.listdir(tmp_path / "ours")) == ["a.png", "b.png", "c.jpg", "d.jpeg"]
    for name in names:
        ours, ref = str(tmp_path / "ours" / name), str(tmp_path / "ref" / name)
        if name.endswith(".png"):
            np.testing.assert_array_equal(read_png(ours), np.asarray(Image.open(ref)))
        else:
            with open(ours, "rb") as f, open(ref, "rb") as g:
                assert f.read() == g.read(), name
        assert read_image(ours).shape[:2] == tuple(s // 2 for s in read_image(
            str(src / name)).shape[:2])
    downscale.main([str(src), "--scale", "3"])
    assert sorted(os.listdir(str(src) + "_3")) == names


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """A stage-0 workspace of the synthetic sphere trained 3 steps at small
    widths, its checkpoint written."""
    ws = str(tmp_path_factory.mktemp("ws"))
    cfg = finalize(Config(workspace=ws, stage=0, bound=1.0, iters=3, num_rays=256, max_steps=32,
                          grid_size=16, hash_levels=4, hash_log2_size=12, hash_max_res=64,
                          n_eval=1, n_ckpt=1))
    trainer = Trainer("ngp", cfg, make_synthetic_frames(4, 16, 16), device="cpu")
    trainer.train()
    trainer.save_checkpoint()
    return ws


def test_render_turntable(workspace):
    render_turntable.main(["unused", "--workspace", workspace, "--stage", "0", "--frames", "2",
                           "--H", "16", "--W", "16", "--extra", "--bound", "1", "--max_steps",
                           "32", "--grid_size", "16", *SMALL], device="cpu")
    out = os.path.join(workspace, "turntable")
    assert sorted(f for f in os.listdir(out) if f.endswith(".png")) == ["frame_0000.png",
                                                                          "frame_0001.png"]
    for f in ("frame_0000.png", "frame_0001.png"):
        img = read_png(os.path.join(out, f))
        assert img.shape == (16, 16, 3) and img.std() > 0


def fetch(port, path, timeout=120.0):
    deadline = time.time() + timeout
    while True:
        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=timeout) as r:
                return r.read()
        except OSError:
            if time.time() > deadline:
                raise
            time.sleep(0.2)


def serve(argv):
    """Start live_viewer.main in a thread; -> (thread, port) once it listens."""
    live_viewer._SERVER_FOR_TEST = None
    th = threading.Thread(target=live_viewer.main, args=(argv,), kwargs={"device": "cpu"},
                          daemon=True)
    th.start()
    deadline = time.time() + 120
    while live_viewer._SERVER_FOR_TEST is None:
        assert th.is_alive() and time.time() < deadline
        time.sleep(0.1)
    return th, live_viewer._SERVER_FOR_TEST.server_address[1]


def stop(th):
    live_viewer._SERVER_FOR_TEST.shutdown()
    th.join(timeout=30)
    assert not th.is_alive()


def test_live_viewer_serves_checkpoint_and_trains(workspace, tmp_path):
    th, port = serve(["--workspace", workspace, "--stage", "0", "--size", "24", "--port", "0",
                      *SMALL])
    try:
        assert b"live viewer" in fetch(port, "/")
        for mode in ("image", "depth"):
            path = tmp_path / f"{mode}.jpg"
            path.write_bytes(fetch(port, f"/render?theta=1.2&phi=0.5&radius=2.2&mode={mode}"))
            img = read_jpeg(str(path))
            assert img.shape == (24, 24, 3)
        assert live_viewer._TRAINER_FOR_TEST.global_step == 3     # the checkpoint resumed
    finally:
        stop(th)

    th, port = serve(["--workspace", str(tmp_path / "ws_train"), "--stage", "0", "--train",
                      "--iters", str(ITERS), "--size", "16", "--port", "0", *SMALL])
    try:
        tr = live_viewer._TRAINER_FOR_TEST
        path = tmp_path / "train.jpg"
        path.write_bytes(fetch(port, "/render?theta=1.0&phi=0.2&radius=2.5"))
        s_first = tr.global_step
        assert read_jpeg(str(path)).shape == (16, 16, 3)
        deadline = time.time() + 120
        while tr.global_step < ITERS and time.time() < deadline:
            time.sleep(0.2)
        path.write_bytes(fetch(port, "/render?theta=1.0&phi=0.2&radius=2.5"))
        assert read_jpeg(str(path)).shape == (16, 16, 3)
        assert s_first < tr.global_step == ITERS
    finally:
        stop(th)
