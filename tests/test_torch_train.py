"""Port vs reference: the stage-1 optimizer and two whole train steps, and
the state conversion.

- ``make_optimizer`` against optax over 3 steps of random gradients (lrs,
  schedules, pre-scales, eps, count handling): params and moments within
  1e-6 relative (both compute in fp32; pow and the schedule may round an
  ulp apart).
- Two ``train_step``s against ``make_train_step`` of the JAX package on the
  32x32, spp-2 four-ball fixture of tests/test_torch_stage1.py (randoms
  drawn from the step keys as the reference draws them, compact_chunks=1):
  loss and psnr within 1e-5 relative, uncertain equal, face_cnt equal and
  face_err within 1e-5 of its largest entry at step 1, 1e-3 at step 2
  (Adam's first update is +-lr wherever the gradient is not zero, so an
  envmap texel whose gradient is rounding noise moves by up to 2 * 0.09
  apart in the two packages, and a few sun-lit pixels' direct light at
  step 2 differ by ~0.2%: image_brdf's psnr by ~5e-4); per optimizer group and per
  leaf, mu within relative L2 1e-3 (it holds the gradient, whose sums run
  in another order) and nu within 2e-3 (its square), and the update
  (params after minus before) with relative L2 <= 1e-3 and cosine >=
  0.9999 (Adam's first steps are nearly sign(g) * lr, so an entry whose
  gradient is rounding noise can flip; the envmap clamp applies to both).
- ``state_from_jax`` / ``state_to_numpy`` round-trip bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mirres_restir_nerf_mesh_tpu.config import Config as JConfig
from mirres_restir_nerf_mesh_tpu.config import finalize as jfinalize
from mirres_restir_nerf_mesh_tpu.data.provider import RayDataset
from mirres_restir_nerf_mesh_tpu.data.synthetic import make_synthetic_dataset
from mirres_restir_nerf_mesh_tpu.models.material import MaterialSpec as JMatSpec
from mirres_restir_nerf_mesh_tpu.models.material import init_material
from mirres_restir_nerf_mesh_tpu.models.nerf import NeRFSpec as JNeRFSpec
from mirres_restir_nerf_mesh_tpu.models.nerf import init_nerf
from mirres_restir_nerf_mesh_tpu.render import stage1 as js
from mirres_restir_nerf_mesh_tpu.train import losses as jL
from mirres_restir_nerf_mesh_tpu.train import stage1 as jtr
from mirres_restir_nerf_mesh_torch.config import Config, finalize
from mirres_restir_nerf_mesh_torch.convert import state_from_jax, state_to_numpy
from mirres_restir_nerf_mesh_torch.models.material import MaterialSpec
from mirres_restir_nerf_mesh_torch.models.nerf import NeRFSpec
from mirres_restir_nerf_mesh_torch.render import stage1 as ts
from mirres_restir_nerf_mesh_torch.train import losses as tL
from mirres_restir_nerf_mesh_torch.train import stage1 as ttr

from test_torch_helpers import TORCH_THREADS, frame_randoms_jax, n, small_spec_kwargs, t
from test_torch_light import sky_env
from test_torch_pathtracer import balls_mesh

torch.set_num_threads(TORCH_THREADS)

CFG = dict(bound=1.0, stage=1, use_brdf=True, pt_bounces=2, env_h=16, env_w=32, lambda_tv=0.0,
           lambda_normal=0.01, lambda_edgelen=0.01, lambda_chroma=0.01)


def train_case(H=32, spp=2, ssaa=1):
    """Both packages' params, static, config, topology and batch for the
    four-ball fixture; H is the render size (the GT is H // ssaa)."""
    v, tr = balls_mesh(faces=1200)
    data = make_synthetic_dataset(n_frames=1, H=H // ssaa, W=H // ssaa, bound=1.0)
    f = RayDataset(data, bound=1.0).frame_rays(0, ssaa=ssaa)
    kw = small_spec_kwargs()
    key = jax.random.PRNGKey(0)
    mat = init_material(jax.random.fold_in(key, 1), JMatSpec(bound=1.0))
    mat = {**mat, "encoder": mat["encoder"] * 1e3}
    params = js.Stage1Params(nerf=init_nerf(key, JNeRFSpec(bound=1.0, **kw)),
                             offsets=jnp.asarray(np.random.RandomState(2).normal(
                                 size=(v.shape[0], 3)).astype(np.float32) * 1e-3),
                             mat=mat, env=jnp.asarray(sky_env(16, 32, seed=3)))
    common = dict(spp=spp, bounces=2, H=H, W=H, compact_chunks=1, dense_threshold=8192,
                  k_cap=640, k_cap_incoherent=640, queue_avg=256, queue_avg_incoherent=64,
                  ssaa=ssaa)
    jstatic = js.Stage1Static(tris=jnp.asarray(tr), nerf_spec=JNeRFSpec(bound=1.0, **kw),
                              mat_spec=JMatSpec(bound=1.0), tracer="tile", **common)
    tstatic = ts.Stage1Static(tris=t(tr), nerf_spec=NeRFSpec(bound=1.0, **kw),
                              mat_spec=MaterialSpec(bound=1.0), **common)
    # (the chroma term compares the full-size kd with the GT in both
    # packages, so it runs without SSAA only)
    ckw = dict(CFG, spp=spp, ssaa=ssaa, **({"lambda_chroma": 0.0} if ssaa > 1 else {}))
    batch = {k: f[k] for k in ("rays_o", "rays_d", "pixels", "alpha")}
    return dict(
        v=v, tr=tr, params=params, jstatic=jstatic, tstatic=tstatic,
        jcfg=jfinalize(JConfig(**ckw)), tcfg=finalize(Config(**ckw)),
        jtopo=jL.build_topology(tr, v.shape[0]), ttopo=tL.build_topology(tr, v.shape[0]),
        batch=batch, tbatch={k: t(x) for k, x in batch.items()},
        rand=lambda k: frame_randoms_jax(k, H * H, spp, 2, H))


def jax_groups(tree):
    """A Stage1Params-shaped JAX tree -> {group: [leaves]} in the port's order."""
    return {"net": jax.tree.leaves(tree.nerf), "vert": [tree.offsets],
            "mat": jax.tree.leaves(tree.mat["net"]), "mat_enc": [tree.mat["encoder"]],
            "light": [tree.env]}


def rel_l2(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30)


def cosine(a, b):
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return float(a @ b / max(np.linalg.norm(a) * np.linalg.norm(b), 1e-300))


def small_params(seed=0):
    rng = np.random.RandomState(seed)

    def r(*s):
        return jnp.asarray(rng.normal(size=s).astype(np.float32))

    return js.Stage1Params(nerf={"encoder": r(40, 2), "sigma_net": [r(8, 4), r(4, 16)],
                                 "color_net": [r(31, 4), r(4, 3)]},
                           offsets=r(7, 3) * 1e-3, mat={"encoder": r(50, 2), "net": [r(8, 4), r(4, 6)]},
                           env=jnp.abs(r(4, 8, 3)) + 0.02)


def test_optimizer_matches_optax():
    cfg_kw = dict(bound=1.0, stage=1, iters=600, lr=1e-2, lr_vert=1e-4)
    opt_j = jtr.make_optimizer(jfinalize(JConfig(**cfg_kw)))
    opt_t = ttr.make_optimizer(finalize(Config(**cfg_kw)))
    pj = small_params()
    st_j = jtr.Stage1State(pj, opt_j.init(pj), jnp.zeros((), jnp.int32))
    st_t = state_from_jax(st_j, device="cpu")
    pt, ot = st_t.params, st_t.opt_state
    rng = np.random.RandomState(1)
    for step in range(3):
        g = jax.tree.map(lambda x: jnp.asarray(rng.normal(size=x.shape).astype(np.float32)), pj)
        if step == 1:     # a leaf without a gradient still steps, as optax's zero update
            g = g._replace(offsets=jnp.zeros_like(g.offsets))
        up, oj = opt_j.update(g, st_j.opt_state, pj)
        pj = optax.apply_updates(pj, up)
        st_j = st_j._replace(opt_state=oj)
        gt = {k: [t(x) for x in v] for k, v in jax_groups(g).items()}
        if step == 1:
            gt["vert"] = [None]
        pt, ot = opt_t.step(pt, gt, ot)
        got = ttr.group_leaves(pt)
        for grp, leaves in jax_groups(pj).items():
            for a, b in zip(leaves, got[grp]):
                np.testing.assert_allclose(n(b), np.asarray(a), rtol=1e-6, atol=1e-7, err_msg=grp)
    back = state_to_numpy(ttr.Stage1State(pt, ot, st_t.step))[1]
    ref = state_to_numpy(state_from_jax(st_j._replace(params=pj), device="cpu"))[1]
    for grp in ttr.GROUPS:
        assert back[grp]["count"] == ref[grp]["count"] == 3
        for key in ("mu", "nu"):
            for a, b in zip(back[grp][key], ref[grp][key]):
                np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-12, err_msg=f"{grp} {key}")


def test_state_round_trip():
    pj = small_params(3)
    opt = jtr.make_optimizer(jfinalize(JConfig(bound=1.0, stage=1)))
    os_ = opt.init(pj)
    g = jax.tree.map(lambda x: jnp.ones_like(x) * 0.5, pj)
    _, os_ = opt.update(g, os_, pj)
    st = jtr.Stage1State(pj, os_, jnp.asarray(4, jnp.int32))
    params, opt_np, step = state_to_numpy(state_from_jax(st, device="cpu"))
    assert step == 4
    for a, b in zip(jax.tree.leaves((pj.nerf, pj.mat, pj.env, pj.offsets)), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b)
    for grp in ttr.GROUPS:
        adam = os_.inner_states[grp].inner_state
        adam = [s for s in adam if hasattr(s, "mu")][0]
        assert opt_np[grp]["count"] == int(adam.count) == 1
        for a, b in zip(jax.tree.leaves(adam.mu), opt_np[grp]["mu"]):
            np.testing.assert_array_equal(np.asarray(a), b)
        for a, b in zip(jax.tree.leaves(adam.nu), opt_np[grp]["nu"]):
            np.testing.assert_array_equal(np.asarray(a), b)


@pytest.fixture(scope="module")
def two_steps():
    c = train_case()
    step_j = jtr.make_train_step(c["jcfg"], c["jstatic"], c["v"], c["jtopo"])
    opt_j = jtr.make_optimizer(c["jcfg"])
    st_j = jtr.Stage1State(c["params"], opt_j.init(c["params"]), jnp.zeros((), jnp.int32))
    st_t = state_from_jax(st_j, device="cpu")
    step_t = ttr.make_train_step(c["tcfg"], c["tstatic"], t(c["v"]), c["ttopo"])
    out = []
    for i in range(2):
        k = jax.random.PRNGKey(20 + i)
        new_j, aux_j = step_j(st_j, c["batch"], k)
        new_t, aux_t = step_t(st_t, c["tbatch"], rand=c["rand"](k))
        out.append((st_j, new_j, aux_j, st_t, new_t, aux_t))
        st_j, st_t = new_j, new_t
    return out


@pytest.mark.parametrize("i", [0, 1])
def test_train_step_matches_reference(two_steps, i):
    old_j, new_j, aux_j, old_t, new_t, aux_t = two_steps[i]
    assert set(aux_t) == set(aux_j)
    rtol = 1e-5 if i == 0 else 1e-3
    for k in ("loss", "psnr", "psnr_brdf"):
        np.testing.assert_allclose(float(aux_t[k]), float(aux_j[k]), rtol=rtol, err_msg=k)
    assert float(aux_t["uncertain_count"]) == float(aux_j["uncertain_count"]) == 0
    np.testing.assert_array_equal(n(aux_t["face_cnt"]), np.asarray(aux_j["face_cnt"]))
    fe = np.asarray(aux_j["face_err"])
    np.testing.assert_allclose(n(aux_t["face_err"]), fe, rtol=0, atol=rtol * fe.max())
    assert int(new_t.step) == int(new_j.step) == i + 1

    ref_new = state_to_numpy(state_from_jax(new_j, device="cpu"))
    got_new = state_to_numpy(new_t)
    before = ttr.group_leaves(old_t.params)
    after_t = ttr.group_leaves(new_t.params)
    after_j = jax_groups(new_j.params)
    for grp in ttr.GROUPS:
        assert got_new[1][grp]["count"] == ref_new[1][grp]["count"] == i + 1
        for j, (mu_t, mu_j, nu_t, nu_j) in enumerate(zip(
                got_new[1][grp]["mu"], ref_new[1][grp]["mu"],
                got_new[1][grp]["nu"], ref_new[1][grp]["nu"])):
            what = f"{grp}[{j}]"
            if not np.any(mu_j):
                assert not np.any(mu_t), what
                continue
            assert rel_l2(mu_t, mu_j) <= 1e-3, (what, rel_l2(mu_t, mu_j))
            assert rel_l2(nu_t, nu_j) <= 2e-3, (what, rel_l2(nu_t, nu_j))
            d_t = n(after_t[grp][j]) - n(before[grp][j])
            d_j = np.asarray(after_j[grp][j]) - n(before[grp][j])
            assert rel_l2(d_t, d_j) <= 1e-3 and cosine(d_t, d_j) >= 0.9999, (
                what, rel_l2(d_t, d_j), cosine(d_t, d_j))
    assert n(new_t.params.env).min() >= np.float32(0.01)


@pytest.mark.parametrize("ssaa", [1, 2])
def test_frame_batch_matches_reference(ssaa):
    """The synthetic frame's rays, pixels on white and alpha, exact."""
    from mirres_restir_nerf_mesh_torch.data import synthetic as tsyn

    data = make_synthetic_dataset(n_frames=2, H=12, W=16, radius=1.3, bound=1.0)
    ref = RayDataset(data, bound=1.0).frame_rays(1, ssaa=ssaa)
    poses, intr, images = tsyn.make_synthetic_dataset(n_frames=2, H=12, W=16, radius=1.3)
    np.testing.assert_array_equal(images, data.images)
    got = tsyn.frame_batch(poses[1], intr, images[1], "cpu", ssaa=ssaa)
    for k in ("pixels", "alpha"):
        np.testing.assert_array_equal(n(got[k]), np.asarray(ref[k]), err_msg=k)
    for k in ("rays_o", "rays_d"):
        np.testing.assert_allclose(n(got[k]), np.asarray(ref[k]), rtol=1e-6, atol=1e-7, err_msg=k)
    assert got["rays_o"].shape[0] == 12 * 16 * ssaa * ssaa


def test_schedules_match_reference():
    from mirres_restir_nerf_mesh_tpu.train.stage0 import lr_schedule as jsched
    from mirres_restir_nerf_mesh_torch.train.stage0 import lr_schedule as tsched

    cfg_j, cfg_t = jfinalize(JConfig(iters=7500)), finalize(Config(iters=7500))
    for s in (0, 1, 250, 499, 500, 501, 3000, 7500, 9000):
        np.testing.assert_allclose(float(tsched(cfg_t)(s)), float(jsched(cfg_j)(jnp.int32(s))),
                                   rtol=1e-6)
        np.testing.assert_allclose(float(ttr.brdf_lr_falloff(s)),
                                   float(jtr.brdf_lr_falloff(jnp.int32(s))), rtol=1e-6)
