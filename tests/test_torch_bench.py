"""The port's bench (``mirres_restir_nerf_mesh_torch/bench.py``) on the CPU
at a tiny width (32^2, spp 2, a ~2k-face blob, 2 frames and 2 train steps,
one stage-0 group of 2 steps at 2 levels): it prints one JSON line with
every key of the root bench.py's line and the port's own, no uncertain
ray, ``card`` "cpu"; and its set-up against the root bench.py's: the
nominal rays a frame, the bench mesh (bit for bit against the JAX
package's meshops) and the camera's rays (the JAX package's
make_synthetic_dataset + RayDataset.frame_rays, within 1e-6)."""

from __future__ import annotations

import json

import numpy as np
import torch

import bench as root_bench
from mirres_restir_nerf_mesh_torch import bench

from test_torch_helpers import TORCH_THREADS

torch.set_num_threads(TORCH_THREADS)

TINY = bench.BenchSize(hw=32, spp=2, faces=2000, trainsteps=2, frames=2, restir_tiles=8,
                       restir_tile_size=64, restir_light_samples=8, restir_offsets=256,
                       nerf_levels=2, stage0_groups=1, stage0_steps=2, stage0_rays=256,
                       stage0_points=4096, stage0_grid=32, stage0_hw=32, stage0_frames=2)
# the keys of BENCH_r05.json's line, then the port's own
ROOT_KEYS = ("metric", "value", "unit", "vs_baseline", "coverage", "trainstep_s",
             "trainstep_spread", "trainstep_uncertain", "forward_Mrays_per_s", "forward_frame_s",
             "forward_spread", "nominal_rays_per_frame", "traced_rays_per_frame",
             "traced_Mrays_per_s", "uncertain_per_frame", "stage0_it_per_s",
             "stage0_Msamples_per_s", "stage0_spread", "stage0_occ_update_s")
PORT_KEYS = ("card", "trainstep_n", "forward_n", "stage0_groups", "max_memory_allocated_GB",
             "K1_launches_per_step", "K4_launches_per_step")


def test_bench_prints_one_line_on_the_cpu(capsys):
    bench.main(["--device", "cpu", "--seed", "3"], size=TINY)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(line) == set(ROOT_KEYS + PORT_KEYS)
    assert line["metric"] == "stage1_trainstep_Mrays_per_s"
    assert line["unit"] == "Mrays/s/card" and line["vs_baseline"] is None
    assert line["card"] == "cpu" and line["max_memory_allocated_GB"] is None
    assert line["trainstep_uncertain"] == 0 and line["uncertain_per_frame"] == 0
    assert (line["trainstep_n"], line["forward_n"], line["stage0_groups"]) == (2, 2, 1)
    assert line["nominal_rays_per_frame"] == 32 * 32 * (1 + 2 * 16)
    assert 0.2 < line["coverage"] < 0.8
    for k in ROOT_KEYS[4:] + PORT_KEYS[1:4]:
        assert np.isfinite(line[k]), k


def test_rays_per_frame_is_root_bench_s():
    for args in ((256, 256, 32, 5, 2, True), (32, 48, 2, 3, 1, False), (7, 5, 4, 0, 3, True)):
        assert bench.rays_per_frame(*args) == root_bench.rays_per_frame(*args)
    assert bench.rays_per_frame(256, 256, 32, bench.NEIGHBORS, bench.BOUNCES, True) == 33_619_968


def test_bench_mesh_is_the_reference_s():
    from mirres_restir_nerf_mesh_tpu.export.meshops import decimate, marching_tets

    n = 96      # bench.py:85-91
    ax = np.linspace(-1, 1, n, dtype=np.float32)
    X, Y, Z = np.meshgrid(ax, ax, ax, indexing="ij")
    r = np.sqrt(X ** 2 + Y ** 2 + Z ** 2)
    field = 0.55 + 0.06 * np.sin(9 * X) * np.sin(7 * Y) * np.cos(5 * Z) - r
    verts, tris = marching_tets(field, 0.0, origin=(-1, -1, -1), spacing=(2 / (n - 1),) * 3)
    ref_v, ref_f = decimate(verts, tris, 2000)
    got_v, got_f = bench.bench_mesh(2000)
    assert got_v.dtype == ref_v.dtype and got_f.dtype == ref_f.dtype
    np.testing.assert_array_equal(got_v, ref_v)
    np.testing.assert_array_equal(got_f, ref_f)


def test_camera_is_the_reference_s():
    from mirres_restir_nerf_mesh_tpu.data.provider import RayDataset
    from mirres_restir_nerf_mesh_tpu.data.synthetic import make_synthetic_dataset

    H = W = 24
    ref = RayDataset(make_synthetic_dataset(n_frames=1, H=H, W=W, bound=1.0, radius=1.3),
                     bound=1.0).frame_rays(0)
    got = bench.camera(H, W, "cpu")
    for k in ("rays_o", "rays_d", "pixels", "alpha"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k], np.float32), rtol=0,
                                   atol=1e-6, err_msg=k)
