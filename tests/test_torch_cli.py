"""The port's command line (mirres_restir_nerf_mesh_torch/main.py) against the
root main.py, on the CPU.

- ``build_parser``: the same option strings, defaults, types and nargs as
  the root main.py's; ``config_from_args`` gives the same Config (every
  field, presets expanded) for a few argument lists.
- ``load_dataset``: blender, colmap and dtu scenes load, the latter two
  with the root main.py's arguments (poses and intrinsics equal, images
  within one count, PIL's 8-bit rounding at downscale 2).
- A CPU smoke on the blender scene of tests/test_cli_e2e.py, with that
  file's fast flags (3 stage-0 steps and a tiny mesh export), then 2
  stage-1 steps with BRDF and the textured export, then a ``--test`` run:
  the workspace holds the files the root main.py writes for the same
  flags (a run of the root main.py takes ~4 minutes on the CPU, most of it
  compiling the stage-1 step, so its file names are listed here: the
  checkpoint names of train/checkpoint.py, ``mesh_0.ply``, the stage-1
  export's OBJ / MTL / two PNGs, and test()'s eight artifacts a frame and
  the envmap EXR), and the stage-1 checkpoint resumes in the test run.
"""

import dataclasses
import os

import numpy as np
import torch

import main as jmain
from mirres_restir_nerf_mesh_torch import main as tmain
from mirres_restir_nerf_mesh_torch.export.meshio import read_ply
from mirres_restir_nerf_mesh_torch.utils.exr import read_exr
from mirres_restir_nerf_mesh_torch.utils.image_io import read_png

from test_cli_e2e import blender_dir  # noqa: F401  (the fixture)
from test_colmap import make_fixture as make_colmap_fixture
from test_torch_dtu import write_dtu
from test_torch_helpers import TORCH_THREADS

torch.set_num_threads(TORCH_THREADS)

STAGE0 = ["--stage", "0", "--scale", "1.0", "--bound", "1", "--iters", "3", "--num_rays", "256",
          "--max_steps", "32", "--samples_per_ray", "8", "--grid_size", "16", "--dt_gamma", "0",
          "--lambda_tv", "0", "--hash_levels", "4", "--hash_log2_size", "12", "--hash_max_res",
          "64", "--mcubes_reso", "24", "--decimate_target", "500", "--density_thresh", "1.0",
          "--clean_min_f", "0", "--clean_min_d", "0", "--n_eval", "1", "--n_ckpt", "1"]
STAGE1 = ["--stage", "1", "--scale", "1.0", "--bound", "1", "--iters", "2", "--use_brdf",
          "--spp", "1", "--pt_bounces", "1", "--env_h", "16", "--env_w", "32", "--texture_size",
          "64", "--n_eval", "1", "--n_ckpt", "1", "--hash_levels", "4", "--hash_log2_size", "12",
          "--hash_max_res", "64", "--ssaa", "1"]
TEST = ["--test", "--eval_spp", "0", "--relight_spp", "0"]

ROOT_FILES_STAGE0 = {"checkpoints", "log_ngp.txt", "mesh_0.ply", "metrics_ngp.jsonl"}
ROOT_FILES_STAGE1 = ROOT_FILES_STAGE0 | {"feat0_0.png", "feat1_0.png", "mesh_0.mtl", "mesh_0.obj"}
ROOT_CKPTS = {"ngp_stage0_0000003.pkl", "ngp_stage0_best.pkl", "ngp_stage1_0000002.pkl",
              "ngp_stage1_best.pkl"}
ROOT_RESULTS = {f"ngp_{i:04d}_{a}" for i in range(2) for a in (
    "rgb.png", "depth.png", "brdf.png", "kd.exr", "ks.exr", "normal.exr", "diffuse.exr",
    "specular.exr")} | {"ngp_env_map.exr"}


def actions(parser):
    return sorted((tuple(a.option_strings), a.dest, repr(a.default), getattr(a.type, "__name__",
                                                                             None), a.nargs)
                  for a in parser._actions)


def test_parser_matches_root_main():
    assert actions(tmain.build_parser()) == actions(jmain.build_parser())
    for argv in (["scene"], ["scene", "-O", "--stage", "1", "--use_brdf", "--sdf", "--bound", "4"],
                 ["scene", "--scale", "0.5", "--offset", "0.1", "-0.2", "0",
                  "--scene_aabb=-1,-1,-1,1,1,1", "--refine_steps_ratio", "0.5", "--wo_smooth"]):
        got = dataclasses.asdict(tmain.config_from_args(argv))
        ref = dataclasses.asdict(jmain.config_from_args(argv))
        assert got == ref


def test_load_dataset_formats(blender_dir, tmp_path):  # noqa: F811
    cfg = tmain.config_from_args([blender_dir, "--scale", "1.0", "--bound", "1"])
    data = tmain.load_dataset(cfg, "val")
    assert data.num_frames == 2 and (data.H, data.W) == (40, 40) and data.images.shape[-1] == 4
    make_colmap_fixture(tmp_path / "colmap")
    write_dtu(tmp_path / "dtu")
    for fmt, argv in (("colmap", ["--bound", "2", "--offset", "0.1", "0", "0"]),
                      ("dtu", ["--bound", "1", "--downscale", "2"])):
        cfg = tmain.config_from_args([str(tmp_path / fmt), "--data_format", fmt] + argv)
        got = tmain.load_dataset(cfg, "train")
        ref = jmain.load_dataset(jmain.config_from_args(
            [str(tmp_path / fmt), "--data_format", fmt] + argv), "train")
        assert got.num_frames == ref.num_frames > 0
        np.testing.assert_allclose(got.poses, ref.poses, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got.intrinsics, ref.intrinsics, rtol=1e-6)
        # one count of PIL's 8-bit rounding at downscale 2 (plus float32's ulp)
        np.testing.assert_allclose(got.images, ref.images, rtol=0, atol=1.0001 / 255)


def test_cli_stage0_stage1_test(blender_dir, tmp_path):  # noqa: F811
    ws = str(tmp_path / "ws")
    common = [blender_dir, "--workspace", ws]
    tmain.main(common + STAGE0, device="cpu")
    assert set(os.listdir(ws)) == ROOT_FILES_STAGE0
    v, t = read_ply(os.path.join(ws, "mesh_0.ply"))
    assert t.shape[0] > 0

    tmain.main(common + STAGE1, device="cpu")
    assert set(os.listdir(ws)) == ROOT_FILES_STAGE1
    assert set(os.listdir(os.path.join(ws, "checkpoints"))) == ROOT_CKPTS
    assert read_png(os.path.join(ws, "feat0_0.png")).shape == (64, 64, 3)
    obj = open(os.path.join(ws, "mesh_0.obj")).read()
    assert obj.count("\nf ") == t.shape[0] and "mtllib mesh_0.mtl" in obj

    tmain.main(common + STAGE1 + TEST, device="cpu")
    assert set(os.listdir(os.path.join(ws, "results"))) == ROOT_RESULTS
    for f in ROOT_RESULTS:
        p = os.path.join(ws, "results", f)
        x = read_exr(p) if f.endswith(".exr") else read_png(p)
        assert np.isfinite(x).all() and x.shape[:2] == ((16, 32) if "env_map" in f else (40, 40))
    log = open(os.path.join(ws, "log_ngp.txt")).read()
    assert "resumed from" in log and "ngp_stage1_0000002.pkl" in log
