"""The counting functions against numbers worked out by hand, and a
step's FLOPs from its shapes against the wrappers' count of the same step
on a tiny cell."""

import types

import pytest
import torch

from benchmark.counts import flops as F
from benchmark.harness import counting, drivers, spec

from .tiny import tiny_root


def test_mlp_flops():
    # the radiance field's sigma MLP: 32 -> 64 -> 16, 1000 rows: 2 x 1000 x (2048 + 1024)
    assert F.mlp_flops(1000, [(32, 64), (64, 16)]) == 6_144_000


def test_hashgrid_flops():
    # 16 levels x 8 corners x 2 features x 2 = 512 a row; one corner: 64
    assert F.hashgrid_flops(10, 16, 2, stochastic=False) == 5120
    assert F.hashgrid_flops(10, 16, 2, stochastic=True) == 640


def test_step_factor():
    assert F.step_factor(True) == 3 and F.step_factor(False) == 1


def test_k4_bytes():
    # 1000 updates of 2 channels: 1000 x (8 + 4) read, 1000 rows x 8 written
    assert F.k4_bytes(1000, 2, 6_000_000) == 20_000
    # more updates than rows: every row written once
    assert F.k4_bytes(1000, 2, 10) == 12_000 + 80


def test_field_rows():
    # 8192 rays of 64 samples compact to the 2^18 budget; 4096 fill it exactly
    assert F.field_rows(8192, 64, 1 << 18) == 1 << 18
    assert F.field_rows(4096, 64, 1 << 18) == 1 << 18
    assert F.field_rows(256, 64, 1 << 18) == 16_384
    assert F.field_rows(256, 64, None) == 16_384


def _grid(levels, level_dim=2):
    return types.SimpleNamespace(num_levels=levels, level_dim=level_dim)


NERF = types.SimpleNamespace(grid=_grid(16), hidden_dim=64, num_layers=2, geo_feat_dim=15,
                             sh_degree=4, hidden_dim_color=64, num_layers_color=3)
MAT = types.SimpleNamespace(grid=_grid(16), hidden=32, channels=6)


def test_model_shapes():
    assert F.nerf_shapes(NERF) == ([(32, 64), (64, 16)], [(31, 64), (64, 64), (64, 3)])
    # material: 32 -> 32 -> 6 is 2 x (1024 + 192) a row, the exact encode 512
    assert F.material_flops(1, MAT, False) == 2432 + 512


def test_stage0_flops():
    # a row: one-corner encode 64, sigma 2 x 3072, colour 2 x 6272; x3 trained
    assert F.stage0_step_flops(NERF, 1 << 18, True) == 3 * (64 + 6144 + 12544) << 18
    # an update of one cascade of 128^3 cells: encode and sigma, no gradient
    assert F.occupancy_update_flops(NERF, 1, 128, True) == (64 + 6144) * 128 ** 3


def test_stage1_flops():
    st = types.SimpleNamespace(H=800, W=800, spp=32, bounces=2, mat_spec=MAT, nerf_spec=NERF)
    fields = 3 * (2 * (2432 + 512) + 512 + 6144 + 12544)
    bounces = 32 * 2 * (2432 + 64)
    assert F.stage1_step_flops(st) == (fields + bounces) * 640_000


def test_roofline_share():
    # 3.35 GB at 3.35 TB/s is 1 ms; taking 2 ms is 50%
    assert abs(F.roofline_share(3.35e9, 0.0, 2e-3, 3.35e12, 989e12) - 50.0) < 1e-9
    # bound by the operations when they take longer than the bytes
    assert abs(F.roofline_share(0.0, 989e9, 4e-3, 3.35e12, 989e12) - 25.0) < 1e-9


def _driver(tmp_path, cell, seed=2147483677):
    root = tiny_root(tmp_path / "root")
    bench = spec.benchmark_json(root)
    w = spec.cell(bench, cell)
    traffic = spec.traffic(w["traffic"], root / "benchmark")
    drv = drivers.make(cell, spec.config(bench, w["config"], root), traffic, seed, "cpu",
                       str(tmp_path / "ws"))
    drv.make_trainer(with_mesh=traffic["kind"] == "stage1_train")
    return drv


def _counted(drv, run):
    """-> (the Driver's shape count, the wrappers' count) of ``run()``."""
    work, f0 = counting.WorkCounts(), drv.flops
    with counting.counting_work(work):
        run()
    return drv.flops - f0, work.flops


def test_stage0_shape_count_equals_the_wrappers(tmp_path):
    torch.set_num_threads(4)
    drv = _driver(tmp_path, "train0-800")
    drv.grid, drv.keep_grid = None, False
    t = drv.trainer
    t.cfg.num_points = 1 << 20          # above the batch's samples: no compaction
    steps = []
    for _ in range(2):                  # step 0 updates the occupancy grid, step 1 does not
        steps.append(_counted(drv, drv.step))
    t._adapt_num_rays(1000.0)           # the batch grows, as inside a window
    assert t.cfg.num_rays > 256
    steps.append(_counted(drv, drv.step))
    t.cfg.num_points = 4096             # compacted to the budget
    steps.append(_counted(drv, drv.step))
    for shapes, wrappers in steps:
        assert shapes == wrappers > 0
    assert steps[0][0] > steps[1][0] and steps[2][0] > steps[1][0] > steps[3][0]


@pytest.mark.parametrize("inside", [False, True], ids=["orbit", "every_pixel_covered"])
def test_stage1_shape_count_bounds_the_wrappers(tmp_path, inside):
    """From the orbit the mesh covers part of the view and the nominal count
    is above the wrappers'; from the mesh's centre every pixel is covered
    and they are equal."""
    torch.set_num_threads(4)
    drv = _driver(tmp_path, "train1-restir-800")
    t = drv.trainer
    batch = t._stage1_batch(0)
    if inside:
        batch = {**batch, "rays_o": torch.zeros_like(batch["rays_o"])}
    rand = t._frame_randoms(batch["rays_o"].shape[0], t.static)

    def step():
        drv.tally()
        t.train_step(t.state, batch, rand=rand)

    shapes, wrappers = _counted(drv, step)
    assert shapes == F.stage1_step_flops(t.static)
    assert shapes == wrappers if inside else shapes > wrappers > 0


def test_mfu_reader():
    win = {"steps": 10, "seconds": 2.0, "flops": 4.0e12}
    ctx = types.SimpleNamespace(window=win, peaks={"bf16_flops": 1.0e15})
    assert spec.read_metric("mfu", ctx) == pytest.approx(100.0 * 4.0e12 / 2.0 / 1.0e15)
    ctx.peaks = None
    assert spec.read_metric("mfu", ctx) is None
    ctx.peaks, win["flops"] = {"bf16_flops": 1.0e15}, None     # a kind that counts nothing
    assert spec.read_metric("mfu", ctx) is None
