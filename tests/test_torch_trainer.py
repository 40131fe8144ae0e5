"""Port vs reference: the Trainer (train/trainer.py) against the JAX
package's, at the sizes of tests/test_escalation.py (4 hash levels of
2^12, hidden 16) on the synthetic sphere (4 train and 2 val frames of
16^2).  A subclass of the port's Trainer takes its draws from the JAX
Trainer's own key chain (tests/test_torch_helpers.py: stage0_randoms_jax,
occupancy_draws_jax, frame_randoms_jax), so both take the same steps.

- Stage 0 with -O (mark-untrained, adaptive rays, visibility culling) and
  the exact encode (the reference jitted: its fused CPU code flips a few
  of the stochastic encode's one-corner picks, which
  tests/test_torch_stage0_train.py holds op by op): the marked occupancy
  grid equal; 20 steps with 2 occupancy updates (every 10) and the val
  eval; the state after at that file's tolerances (Adam count and step
  equal; mu / nu within 1e-4 / 2e-4 relative L2 per leaf; params and EMA
  within 1e-5; the density grid within 1e-5 relative, its cells at -1
  equal, the occupancy bits on >= 99.9% of cells); the last logged loss
  within 1e-5 relative.
- ``evaluate()`` from equal states: every metric (psnr, ssim, lpips on the
  reference's random-VGG weights carried over through an .npz) within 1e-4.
- ``save_mesh`` on an analytic density (as tests/test_torch_stage0_export.py
  holds the export: the same grid in both) with the culling of the
  training views: mesh_0.ply bytes equal.
- Stage 1's bootstrap, steps and refine: tests/test_torch_trainer_stage1.py.
- Budget escalation through ``train()`` with a step that always reports
  uncertain rays (tests/test_escalation.py's drive): the same budgets as
  the reference after each escalation, and their restore on resume.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mirres_restir_nerf_mesh_tpu.config import Config as JConfig
from mirres_restir_nerf_mesh_tpu.config import finalize as jfinalize
from mirres_restir_nerf_mesh_tpu.data.synthetic import make_synthetic_dataset
from mirres_restir_nerf_mesh_tpu.models import nerf as jnerf
from mirres_restir_nerf_mesh_tpu.models.nerf import NeRFSpec as JNeRFSpec
from mirres_restir_nerf_mesh_tpu.train.trainer import Trainer as JTrainer
from mirres_restir_nerf_mesh_torch.config import Config, finalize
from mirres_restir_nerf_mesh_torch.convert import stage0_state_from_jax, stage0_state_to_numpy
from mirres_restir_nerf_mesh_torch.data.provider import FrameData
from mirres_restir_nerf_mesh_torch.models import nerf as tnerf
from mirres_restir_nerf_mesh_torch.models.nerf import NeRFSpec
from mirres_restir_nerf_mesh_torch.train.trainer import Trainer

from test_torch_helpers import (TORCH_THREADS, frame_randoms_jax, lpips_weights_npz, n,
                                occupancy_draws_jax, stage0_randoms_jax)
from test_torch_stage0_export import density
from test_torch_train import rel_l2

torch.set_num_threads(TORCH_THREADS)

SPEC = dict(bound=1.0, hidden_dim=16, hidden_dim_color=16, geo_feat_dim=7, grid_levels=4,
            grid_log2_hashmap_size=12, grid_desired_resolution=64)
STAGE0 = dict(bound=1.0, O=True, iters=20, num_rays=256, max_steps=64, samples_per_ray=16,
              samples_per_ray_infer=24, grid_size=16, dt_gamma=0.0, update_extra_interval=10,
              mcubes_reso=24, decimate_target=400, clean_min_f=0, clean_min_d=0, n_eval=1,
              n_ckpt=1, stochastic_interp=False)


class FedTrainer(Trainer):
    """The port's Trainer on the JAX Trainer's key chain: ``skip`` keys taken
    at construction (stage 0: the params' key; stage 1: the NeRF's and the
    state's), then one a step in the reference's order (the step key, then
    the occupancy update's)."""

    def __init__(self, *a, jsampler=None, skip=1, **k):
        key = jax.random.PRNGKey(a[1].seed)
        for _ in range(skip):
            key, _ = jax.random.split(key)
        self.jkey, self.jsampler = key, jsampler
        super().__init__(*a, **k)

    def _next_jkey(self):
        self.jkey, sub = jax.random.split(self.jkey)
        return sub

    def _stage0_randoms(self):
        return stage0_randoms_jax(self._next_jkey(), self.jsampler, self.cfg,
                                  self.train_step.march_candidates)

    def _occupancy_draws(self):
        g = self.state.occ.density_grid
        return occupancy_draws_jax(self._next_jkey(), g.shape[0], g.shape[1], self.cfg.bound,
                                   self.cfg.stochastic_interp)

    def _frame_randoms(self, P, static):
        return frame_randoms_jax(self._next_jkey(), P, static.spp, static.bounces, static.H,
                                 static)


def frame_data(n_frames, seed):
    """The synthetic sphere's frames, the focal length x 2.5 (a narrower view,
    so that -O's mark-untrained finds cells outside every frustum)."""
    jd = make_synthetic_dataset(n_frames=n_frames, H=16, W=16, bound=1.0, seed=seed)
    jd = dataclasses.replace(jd, intrinsics=(jd.intrinsics * np.array([2.5, 2.5, 1, 1],
                                                                       np.float32)))
    return jd, FrameData(images=jd.images, poses=jd.poses, intrinsics=jd.intrinsics, H=jd.H,
                         W=jd.W, mvps=jd.mvps)


def sphere_mesh(faces):
    """A sphere of radius 0.5: marching tetrahedra on a 24^3 grid, decimated
    to ``faces`` triangles (tests/test_escalation.py's fixture)."""
    from mirres_restir_nerf_mesh_torch.export.meshops import decimate, marching_tets

    ax = np.linspace(-1, 1, 24, dtype=np.float32)
    X, Y, Z = np.meshgrid(ax, ax, ax, indexing="ij")
    v, t = marching_tets(0.5 - np.sqrt(X ** 2 + Y ** 2 + Z ** 2), 0.0, origin=(-1, -1, -1),
                         spacing=(2 / 23,) * 3)
    return decimate(v, t, faces)


def leaves_np(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def metrics(ws):
    import json

    recs = [json.loads(x) for x in open(os.path.join(ws, "metrics_ngp.jsonl")).read().splitlines()]
    return [r for r in recs if "it_per_s" in r]


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    base = tmp_path_factory.mktemp("trainer")
    weights = lpips_weights_npz(base / "vgg_random.npz")
    (jd, td), (jv, tv) = frame_data(4, 0), frame_data(2, 1)
    wsj, wst = str(base / "jax"), str(base / "port")
    jcfg = jfinalize(JConfig(**STAGE0, workspace=wsj, data_parallel=False,
                             lpips_weights=weights))
    tcfg = finalize(Config(**STAGE0, workspace=wst, lpips_weights=weights))
    jtr = JTrainer("ngp", jcfg, jd, nerf_spec=JNeRFSpec(**SPEC))
    ttr = FedTrainer("ngp", tcfg, td, nerf_spec=NeRFSpec(**SPEC), device="cpu",
                     jsampler=jtr.sampler, skip=1)
    marked = (np.asarray(jtr.state.occ.density_grid), n(ttr.state.occ.density_grid))
    ttr.state = stage0_state_from_jax(jtr.state, device="cpu")
    jtr.train(valid_data=jv)
    ttr.train(valid_data=tv)
    return dict(weights=weights, jd=jd, td=td, jv=jv, tv=tv, wsj=wsj, wst=wst,
                jtr=jtr, ttr=ttr, marked=marked)


def test_stage0_train_matches_reference(case):
    jm, tm = case["marked"]
    assert (jm < 0).any() and (jm == 0).any()
    np.testing.assert_array_equal(tm, jm)
    jst, got = case["jtr"].state, stage0_state_to_numpy(case["ttr"].state)
    assert got["step"] == int(jst.step) == 20 == case["ttr"].global_step
    jopt = jst.opt_state[0]
    assert got["opt"]["count"] == int(jopt.count)
    for what, mine, ref, tol in (("mu", got["opt"]["mu"], leaves_np(jopt.mu), 1e-4),
                                 ("nu", got["opt"]["nu"], leaves_np(jopt.nu), 2e-4),
                                 ("params", jax.tree.leaves(got["params"]), leaves_np(jst.params),
                                  1e-5),
                                 ("ema", jax.tree.leaves(got["ema_params"]),
                                  leaves_np(jst.ema_params), 1e-5)):
        assert len(mine) == len(ref)
        for i, (a, b) in enumerate(zip(mine, ref)):
            assert rel_l2(a, b) < tol, (what, i, rel_l2(a, b))
    grid, ref_grid = got["occ"]["density_grid"], np.asarray(jst.occ.density_grid)
    np.testing.assert_allclose(grid, ref_grid, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(grid == -1, ref_grid == -1)
    assert (got["occ"]["occ"] == np.asarray(jst.occ.occ)).mean() >= 0.999
    lj, lt = metrics(case["wsj"])[-1], metrics(case["wst"])[-1]
    assert lj["step"] == lt["step"] == 20
    np.testing.assert_allclose(lt["loss"], lj["loss"], rtol=1e-5)
    assert lt["num_points"] == lj["num_points"]
    assert case["ttr"].cfg.num_rays == case["jtr"].cfg.num_rays     # -O's adaptive growth
    assert (sorted(os.listdir(os.path.join(case["wst"], "checkpoints")))
            == sorted(os.listdir(os.path.join(case["wsj"], "checkpoints"))))


def test_stage0_evaluate_and_save_mesh_match_reference(case, monkeypatch):
    jtr, ttr = case["jtr"], case["ttr"]
    ttr.state = stage0_state_from_jax(jtr.state, device="cpu")
    ev_j = jtr.evaluate(case["jv"])
    ev_t = ttr.evaluate(case["tv"])
    assert set(ev_t) == set(ev_j) == {"psnr", "ssim", "lpips"}
    for k in ev_j:
        np.testing.assert_allclose(ev_t[k], ev_j[k], rtol=1e-4, atol=1e-4, err_msg=k)

    monkeypatch.setattr(jnerf, "density", lambda p, x, s, **k: {
        "sigma": jnp.asarray(density(np.asarray(x, np.float64), np).astype(np.float32))})
    monkeypatch.setattr(tnerf, "density", lambda p, x, s, **k: {
        "sigma": torch.from_numpy(density(n(x).astype(np.float64), np).astype(np.float32))})
    with jax.disable_jit():
        jtr.save_mesh()
    (_, t), = ttr.save_mesh()
    ply = "mesh_0.ply"
    assert 50 < t.shape[0] <= STAGE0["decimate_target"]
    assert (open(os.path.join(case["wst"], ply), "rb").read()
            == open(os.path.join(case["wsj"], ply), "rb").read())


def test_escalation_and_restore_match_reference(case, tmp_path):
    from mirres_restir_nerf_mesh_torch.export.meshio import write_ply

    mesh = str(tmp_path / "sphere.ply")
    write_ply(mesh, *sphere_mesh(200))
    kw = dict(stage=1, mesh=mesh, iters=200, bound=1.0, use_brdf=True, use_restir=True, spp=1,
              pt_bounces=1, env_h=16, env_w=32, restir_light_tile_count=4,
              restir_light_tile_size=64, restir_initial_light_samples=8,
              restir_spatial_neighbors=2, restir_spatial_radius=4.0,
              restir_neighbor_offset_count=128, refine=False, n_ckpt=1, n_eval=1, ssaa=1)
    jcfg = jfinalize(JConfig(**kw, workspace=str(tmp_path / "j"), data_parallel=False))
    tcfg = finalize(Config(**kw, workspace=str(tmp_path / "t")))
    jtr = JTrainer("ngp", jcfg, case["jd"], nerf_spec=JNeRFSpec(**SPEC))
    ttr = Trainer("ngp", tcfg, case["td"], nerf_spec=NeRFSpec(**SPEC), device="cpu")
    assert ttr._tracer_budgets() == jtr._tracer_budgets()

    def fake(*a, **k):
        return a[0], {"uncertain_count": torch.tensor(7.0), "loss": torch.tensor(0.0)}

    jtr.train_step = lambda state, batch, key: (state, {"uncertain_count": np.float32(7.0),
                                                        "loss": np.float32(0.0)})
    ttr.train_step = fake
    jtr.train()
    ttr.train()
    assert ttr._tracer_budgets() == jtr._tracer_budgets()
    assert ttr._uncertain_strikes == jtr._uncertain_strikes == 0
    assert "escalating candidate budgets" in open(ttr.log_path).read()
    for _ in range(3):
        assert ttr._escalate_tracer_budget() == jtr._escalate_tracer_budget()
        assert ttr._tracer_budgets() == jtr._tracer_budgets()
    grown = ttr._tracer_budgets()
    ttr.save_checkpoint()
    ttr2 = Trainer("ngp", tcfg, case["td"], nerf_spec=NeRFSpec(**SPEC), device="cpu")
    assert ttr2._tracer_budgets() == grown
    assert "restored escalated tracer budgets" in open(ttr2.log_path).read()
    for _ in range(12):
        a, b = ttr2._escalate_tracer_budget(cap=512), jtr._escalate_tracer_budget(cap=512)
        if not a:
            break
    assert not ttr2._escalate_tracer_budget(cap=512)
    assert ttr2.static.k_cap == ttr2.static.k_cap_incoherent == 512





