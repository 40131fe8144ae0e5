"""Port vs reference: the stage-0 sampler, the march lattice length, one
whole train step, the occupancy update and the SDF pretraining.

Tiny field (8 levels of 2^15, hidden 32), grid 32, 512 rays, max_steps
128, 32 samples a ray, the cross-ray compaction engaged (num_points 4096 <
512 x 32), the stochastic encode on, TV on; the step's randoms are drawn
from the step key as the reference draws them (tests/test_torch_helpers.py
stage0_randoms_jax).  Tolerances:

- sampler: indices and colours equal, rays within 1e-6;
- ``march_candidates_for`` equal;
- step: loss within 1e-5 relative; each gradient leaf within 1e-4 relative
  L2; Adam's first step (params after) over the entries whose gradient
  lies above 1e-3 of the leaf's largest |g| (below that an entry's
  sign is rounding noise and Adam's first step moves it by +-lr either way,
  tests/test_torch_stage1_restir.py) within 1e-5 relative L2, the moments
  mu / nu within 1e-4 / 2e-4 relative L2; EMA the same rule; the step
  count equal.  The reference's step runs under ``jax.disable_jit``:
  jitted, XLA's fused CPU code rounds the encode's ``x * scale + 0.5``
  differently from the op-by-op evaluation (and from PyTorch), which moves
  the one-corner estimator's corner on a few points and the encoder
  gradient by ~0.7% relative L2.  Step 2 starts from the reference's state after step 1
  (``convert.stage0_state_from_jax``); it holds loss, moments (which carry
  the gradient), params over all entries and EMA to the same bounds.
- occupancy update: density grid within 1e-5 relative, occupancy bits and
  the cells at -1 equal, mean density within 1e-5 relative (a mean over
  every cell, summed in another order).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from mirres_restir_nerf_mesh_tpu.config import Config as JConfig
from mirres_restir_nerf_mesh_tpu.config import finalize as jfinalize
from mirres_restir_nerf_mesh_tpu.data.provider import RayDataset as JRayDataset
from mirres_restir_nerf_mesh_tpu.data.synthetic import make_synthetic_dataset
from mirres_restir_nerf_mesh_tpu.models.nerf import NeRFSpec as JNeRFSpec
from mirres_restir_nerf_mesh_tpu.train import stage0 as js0
from mirres_restir_nerf_mesh_torch.config import Config, finalize
from mirres_restir_nerf_mesh_torch.convert import stage0_state_from_jax, stage0_state_to_numpy
from mirres_restir_nerf_mesh_torch.data.provider import FrameData, RayDataset, patch_pixels
from mirres_restir_nerf_mesh_torch.models.nerf import NeRFSpec
from mirres_restir_nerf_mesh_torch.train import stage0 as ts0

from test_torch_helpers import (TORCH_THREADS, n, occupancy_draws_jax, sample_draws_jax,
                                stage0_randoms_jax, stage0_spec_kwargs, t)

torch.set_num_threads(TORCH_THREADS)

CFG = dict(bound=1.0, iters=300, num_rays=512, max_steps=128, samples_per_ray=32,
           samples_per_ray_infer=48, grid_size=32, dt_gamma=0.0, lambda_tv=1e-3,
           lambda_mask=0.1, lambda_entropy=1e-3, density_thresh=10.0, adaptive_num_rays=True,
           num_points=4096)


def frame_data(n_frames=6, H=24, W=24, depth=False):
    jd = make_synthetic_dataset(n_frames=n_frames, H=H, W=W, bound=1.0)
    kw = {}
    if depth:
        rng = np.random.RandomState(5)
        kw = dict(depths=rng.uniform(0.0, 2.0, (n_frames, H, W)).astype(np.float32),
                  sparse_coords=np.stack([rng.randint(0, H, (n_frames, 40)),
                                          rng.randint(0, W, (n_frames, 40))], -1).astype(np.int32),
                  sparse_depth=rng.uniform(1.0, 2.0, (n_frames, 40)).astype(np.float32),
                  sparse_weight=(rng.rand(n_frames, 40) > 0.2).astype(np.float32),
                  cam_near_far=np.tile(np.array([[0.5, 3.0]], np.float32), (n_frames, 1)))
        jd = dataclasses.replace(jd, **kw)
    td = FrameData(images=jd.images, poses=jd.poses, intrinsics=jd.intrinsics, H=H, W=W,
                   mvps=jd.mvps, **kw)
    return jd, td


@pytest.mark.parametrize("background,depth", [("white", False), ("random", False),
                                              ("random", True)])
def test_sample_matches_reference(background, depth):
    jd, td = frame_data(depth=depth)
    js = JRayDataset(jd, bound=1.0, background=background)
    tsm = RayDataset(td, bound=1.0, background=background, device="cpu")
    for seed in range(3):   # with sparse depth, one of these keys takes the sparse branch
        key = jax.random.PRNGKey(seed)
        ref = js.sample(key, 256)
        got = tsm.sample(sample_draws_jax(key, js, 256))
        assert set(got) == set(ref)
        for k in ref:
            if k in ("index",):
                np.testing.assert_array_equal(n(got[k]), np.asarray(ref[k]))
            else:
                np.testing.assert_allclose(n(got[k]), np.asarray(ref[k]), rtol=1e-6, atol=1e-6,
                                           err_msg=k)


def test_patch_sample_and_frame_rays_match_reference():
    jd, td = frame_data()
    js = JRayDataset(jd, bound=1.0, patch_size=4)
    tsm = RayDataset(td, bound=1.0, patch_size=4, device="cpu")
    key = jax.random.PRNGKey(3)
    ref = js.sample(key, 64)
    # the reference's patch draws: k_img per patch, then (px, py) from k_pix
    k_img, k_pix, _ = jax.random.split(key, 3)
    kx, ky = jax.random.split(k_pix)
    img = t(jax.random.randint(k_img, (4,), 0, 6), np.int64).repeat_interleave(16)
    pix = patch_pixels(t(jax.random.randint(kx, (4,), 0, 20), np.int64),
                       t(jax.random.randint(ky, (4,), 0, 20), np.int64), 4, 24)
    from mirres_restir_nerf_mesh_torch.data.provider import SampleDraws

    got = tsm.sample(SampleDraws(img_idx=img, pix_idx=pix))
    for k in ("rays_o", "rays_d", "pixels", "alpha", "index"):
        np.testing.assert_allclose(n(got[k]), np.asarray(ref[k]), rtol=1e-6, atol=1e-7)
    for ssaa in (1, 2):
        fr, fj = tsm.frame_rays(2, ssaa=ssaa), js.frame_rays(2, ssaa=ssaa)
        for k in ("rays_o", "rays_d", "pixels", "alpha", "mvp", "pose"):
            np.testing.assert_allclose(n(fr[k]), np.asarray(fj[k]), rtol=1e-6, atol=1e-7)


def test_march_candidates_for_matches_reference():
    jd, td = frame_data()
    for kw in (dict(max_steps=1024, grid_size=128), dict(max_steps=128, grid_size=32),
               dict(max_steps=16, grid_size=32)):
        cfg, jcfg = finalize(Config(bound=1.0, **kw)), jfinalize(JConfig(bound=1.0, **kw))
        assert ts0.march_candidates_for(cfg, RayDataset(td, bound=1.0, device="cpu")) == \
            js0.march_candidates_for(jcfg, JRayDataset(jd, bound=1.0))


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def leaves_np(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


@pytest.fixture(scope="module")
def step_case():
    cfg, jcfg = finalize(Config(**CFG)), jfinalize(JConfig(**CFG))
    jd, td = frame_data(n_frames=8, H=32, W=32)
    js = JRayDataset(jd, bound=1.0, background="random")
    tsm = RayDataset(td, bound=1.0, background="random", device="cpu")
    kw = stage0_spec_kwargs()
    jspec, tspec = JNeRFSpec(bound=1.0, **kw), NeRFSpec(bound=1.0, **kw)
    key = jax.random.PRNGKey(0)
    jstate = js0.init_state(key, jcfg, jspec)
    # an occupancy grid with free space, as after a few updates
    jocc = js0.make_occ_update(jcfg, jspec)
    jstate = jocc(jstate, jax.random.PRNGKey(9))
    tstate = stage0_state_from_jax(jstate, device="cpu")
    jstep = js0.make_train_step(jcfg, jspec, js)
    tstep = ts0.make_train_step(cfg, tspec, tsm)
    return dict(cfg=cfg, jcfg=jcfg, js=js, tsm=tsm, jspec=jspec, tspec=tspec, jstate=jstate,
                tstate=tstate, jstep=jstep, tstep=tstep)


def check_step(c, jstate, tstate, key, first: bool):
    """One step of both packages from equal states: loss, gradients (step 1:
    the reference's from its first moment, mu = (1 - b1) g), moments,
    params and EMA after, the count."""
    rnd = stage0_randoms_jax(key, c["js"], c["cfg"], c["tstep"].march_candidates)
    assert rnd.stochastic_u.shape[0] == c["cfg"].num_points
    with jax.disable_jit():
        jnew, jaux = c["jstep"](jstate, key)
    batch = c["tsm"].sample(rnd.sample)
    loss, aux, grads = ts0.loss_and_grads(tstate.params, tstate.occ.occ, batch, rnd, c["cfg"],
                                          c["tspec"], int(tstate.step),
                                          c["tstep"].march_candidates)
    np.testing.assert_allclose(float(loss), float(jaux["loss"]), rtol=1e-5)
    assert int(aux["num_points"]) == int(jaux["num_points"])
    jopt = jnew.opt_state[0]
    jmu = leaves_np(jopt.mu)
    assert len(grads) == len(jmu)
    jg = [m.astype(np.float64) / (1.0 - np.float32(0.9)) for m in jmu]
    if first:
        for g, r in zip(grads, jg):
            assert rel_l2(n(g), r) < 1e-4
    tnew, _ = c["tstep"](tstate, rand=rnd)
    assert int(tnew.step) == int(jnew.step) == int(jstate.step) + 1
    got = stage0_state_to_numpy(tnew)
    assert got["opt"]["count"] == int(jopt.count)
    for what, mine, ref, tol in (("mu", got["opt"]["mu"], jmu, 1e-4),
                                 ("nu", got["opt"]["nu"], leaves_np(jopt.nu), 2e-4)):
        for a, b in zip(mine, ref):
            assert rel_l2(a, b) < tol, what
    for what, mine, ref in (("params", jax.tree.leaves(got["params"]), leaves_np(jnew.params)),
                            ("ema", jax.tree.leaves(got["ema_params"]),
                             leaves_np(jnew.ema_params))):
        for a, b, g in zip(mine, ref, jg):
            keep = np.ones(g.shape, bool)
            if first and np.abs(g).max() > 0:
                keep = np.abs(g) > 1e-3 * np.abs(g).max()
            assert rel_l2(np.asarray(a)[keep], b[keep]) < 1e-5, what
    return jnew


def test_train_step_matches_reference(step_case):
    c = step_case
    jnew = check_step(c, c["jstate"], c["tstate"], jax.random.PRNGKey(11), first=True)
    # step 2 from the reference's state after step 1
    check_step(c, jnew, stage0_state_from_jax(jnew, device="cpu"), jax.random.PRNGKey(12),
               first=False)


def test_occ_update_matches_reference(step_case):
    c = step_case
    jstate = c["jstate"]
    # cells at -1 (outside every view) must stay there
    jstate = jstate._replace(occ=jstate.occ._replace(
        density_grid=jstate.occ.density_grid.at[0, :4].set(-1.0)))
    tstate = stage0_state_from_jax(jstate, device="cpu")
    key = jax.random.PRNGKey(21)
    with jax.disable_jit():
        ref = js0.make_occ_update(c["jcfg"], c["jspec"])(jstate, key).occ
    draws = occupancy_draws_jax(key, 1, c["cfg"].grid_size, 1.0, True)
    got = ts0.make_occ_update(c["cfg"], c["tspec"])(tstate, draws=draws).occ
    np.testing.assert_allclose(n(got.density_grid), np.asarray(ref.density_grid), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(n(got.occ), np.asarray(ref.occ))
    np.testing.assert_array_equal(n(got.density_grid) == -1, np.asarray(ref.density_grid) == -1)
    np.testing.assert_allclose(float(got.mean_density), float(ref.mean_density), rtol=1e-5)


def test_init_double_sphere_matches_reference():
    """Three SDF-pretraining steps on the reference's own points: the loss
    falls the same way and the params agree where the gradient is above
    rounding noise (Adam's first steps move every touched entry by ~lr)."""
    kw = stage0_spec_kwargs()
    jspec, tspec = JNeRFSpec(bound=1.0, sdf=True, **kw), NeRFSpec(bound=1.0, sdf=True, **kw)
    from mirres_restir_nerf_mesh_tpu.models.nerf import init_nerf

    p0 = init_nerf(jax.random.PRNGKey(4), jspec)
    key = jax.random.PRNGKey(5)
    ref = js0.init_double_sphere(p0, jspec, key, iters=3, batch_size=512)
    pts, k = [], key
    for _ in range(3):
        k, sub = jax.random.split(k)
        pts.append(np.asarray(jax.random.uniform(sub, (512, 3), minval=-1.0, maxval=1.0)))
    tp = stage0_state_from_jax(js0.init_state(jax.random.PRNGKey(4), jfinalize(JConfig()),
                                              jspec), device="cpu").params
    got = ts0.init_double_sphere(tp, tspec, points=t(np.stack(pts)), iters=3, batch_size=512)
    for a, b, a0 in zip(ts0.tree_leaves(got), leaves_np(ref), leaves_np(p0)):
        moved = np.abs(b - a0) > 1e-4                  # touched by a real gradient
        assert rel_l2(n(a)[moved], b[moved]) < 1e-3
        np.testing.assert_array_equal(n(a)[~moved] == np.asarray(a0)[~moved],
                                      b[~moved] == np.asarray(a0)[~moved])
