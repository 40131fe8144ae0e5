"""The port's command line on a user's own capture, on the CPU: a COLMAP
workspace of the sphere in a room, written by chip_smoke.py's phase-4i
writer at a tiny size (9 views of 36x48 JPEGs, 300 points, dense depth
maps), then the "your dataset" recipe of
configs/general_config_for_your_dataset.txt with tiny widths:
``-O --data_format colmap --bound 2`` stage 0 (3 steps, a mesh export),
stage 1 with BRDF and ReSTIR (2 steps, the textured export), then
``--test``.  The loader is held to the written scene by the phase's own
check first (poses, sparse tables; the aligned dense depth is not gated
at this size); the stage-0 Trainer takes the scene box from the sparse
points; the runs write the root main.py's files.
"""

import os

import numpy as np
import torch

import chip_smoke
from mirres_restir_nerf_mesh_torch import main as tmain
from mirres_restir_nerf_mesh_torch.data.colmap import load_colmap
from mirres_restir_nerf_mesh_torch.export.meshio import read_ply
from mirres_restir_nerf_mesh_torch.utils.exr import read_exr

from test_torch_cli import ROOT_FILES_STAGE0, ROOT_FILES_STAGE1
from test_torch_helpers import TORCH_THREADS

torch.set_num_threads(TORCH_THREADS)

TINY = ["--hash_levels", "4", "--hash_log2_size", "12", "--hash_max_res", "64", "--n_eval", "1",
        "--n_ckpt", "1"]
STAGE0 = ["--stage", "0", "--iters", "3", "--num_rays", "256", "--num_points", "2048",
          "--max_steps", "32",
          "--samples_per_ray", "8", "--grid_size", "16", "--lambda_tv", "0", "--mcubes_reso",
          "24", "--env_reso", "16", "--decimate_target", "500", "--density_thresh", "1.0",
          "--clean_min_f", "0", "--clean_min_d", "0"] + TINY
STAGE1 = ["--stage", "1", "--iters", "2", "--use_brdf", "--use_restir", "--spp", "1",
          "--pt_bounces", "1", "--env_h", "16", "--env_w", "32", "--texture_size", "64",
          "--ssaa", "1", "--restir_light_tile_count", "4", "--restir_light_tile_size", "64",
          "--restir_initial_light_samples", "4", "--restir_neighbor_offset_count", "64"] + TINY


def test_colmap_recipe_on_the_cpu(tmp_path):
    root, ws = tmp_path / "scene", str(tmp_path / "ws")
    truth = chip_smoke.write_colmap_scene(root, hw=(36, 48), n_views=9, n_points=300)
    fd = load_colmap(str(root), "train", bound=2.0)
    # the aligned dense depth goes ungated at this size: with frames 6.7x
    # coarser than the phase's, the keypoints' whole-pixel rounding spreads
    # the true line's residuals past the RANSAC threshold in some views, and
    # a flat line through the sphere's cluster of depths gathers more inliers
    # (test_torch_colmap.py holds the alignment to the reference's, and the
    # phase gates it at 320x240, where every view fits)
    res = chip_smoke.check_colmap_load(fd, truth, dense_tol=np.inf)
    assert res["sparse_points"] > 100 and fd.depths.shape == (7, 36, 48)

    common = [str(root), "--workspace", ws, "-O", "--data_format", "colmap", "--bound", "2"]
    tmain.main(common + STAGE0, device="cpu")
    # at bound 2 the stage-0 export also writes the outer cascade's mesh_1.ply
    assert set(os.listdir(ws)) == ROOT_FILES_STAGE0 | {"mesh_1.ply"}
    log = open(os.path.join(ws, "log_ngp.txt")).read()
    assert "[aabb] from sparse points" in log
    v, t = read_ply(os.path.join(ws, "mesh_0.ply"))
    assert t.shape[0] > 0

    tmain.main(common + STAGE1, device="cpu")
    assert set(os.listdir(ws)) == ROOT_FILES_STAGE1 | {"mesh_1.ply"}
    tmain.main(common + STAGE1 + ["--test", "--eval_spp", "0", "--relight_spp", "0"],
               device="cpu")
    results = os.path.join(ws, "results")
    n_test = len(range(0, 9, 8))
    for i in range(n_test):
        for a in chip_smoke.CLI_ARTIFACTS:
            p = os.path.join(results, f"ngp_{i:04d}_{a}")
            assert os.path.exists(p), p
            if p.endswith(".exr"):
                assert np.isfinite(read_exr(p)).all()
