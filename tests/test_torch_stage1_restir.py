"""The slice as a whole with ReSTIR DI and the EAW denoiser: the port's
render_stage1 and train step against the reference's on the same weights,
mesh, rays and random draws.

24x24 pixels, spp 2, 2 bounces, the four-ball mesh on the dense tracer
path, 4 light tiles of 32 (8 light + 1 BRDF candidates, the packed fast
path), 5 neighbours in a 6 px radius, unbiased spatial reuse with
visibility threading, denoise_iters 2, normal-AO.  Both packages run
compact_chunks=1 (the reference's randoms then come from the frame key,
mirrored by the helpers); the port's live-pixel chain (compact_chunks=4) is
held against its own compact_chunks=1 frame.

Tolerances: the frame as tests/test_torch_stage1.py's assert_frames_match
(mask and face_id on >= 99.9% of pixels; 99.5% of every output within
1e-4, all within 1e-2; traced_rays and uncertain_count equal).  The train
steps, with lambda_extra_kd > 0: loss within 1e-5 relative at step 1 and
1e-3 at step 2, psnr within the same or 1e-4 dB (the fixture's sun-lit
image_brdf sits near 0 dB, where a relative bound means nothing),
uncertain_count 0 and face_cnt equal.  Step 2 starts both packages from the
reference's state after step 1, so a step-1 difference does not carry into
it.  Per leaf, over the entries whose reference first moment is at least
1e-4 of the leaf's RMS (below that the gradient is rounding noise next to
Adam's eps = 1e-8, and Adam's first update, nearly sign(g) * lr, can flip):
- step 1 as tests/test_torch_train.py: mu (the gradient) within relative
  L2 1e-3, the update (params after minus before) within 1e-3 and cosine
  >= 0.9999.  Measured: mu 1.3e-4, update 4.4e-4, cosine 0.9999999.
- step 2: mu within 1e-2, the update within 2e-2 and cosine >= 0.9999.
  This step's gradient is ill-conditioned on the fixture: moving every
  reference parameter by 4 ulps of random sign (worst of 8 draws) moves the
  reference's own gradient by 3.0e-3 on the material hash grid, 2.1e-3 on
  the material MLP and 1.5e-3 on the offsets.  Measured: mu 3.8e-3, update
  7.2e-3, cosine 0.99997.
Planted faults read far outside both: with the lambda_extra_kd term
dropped, mu 0.64 / 0.44, update 0.99 / 0.72, cosine 0.27 / 0.70 (steps 1 /
2); with half the pixels' colours detached from the loss, mu 0.77 / 0.69,
update 0.87 / 0.81, cosine 0.62 / 0.67.  `JAX_PLATFORMS=cpu PYTHONPATH=.
python tests/test_torch_stage1_restir.py` prints these readings.
"""

import jax
import jax.numpy as jnp
import numpy as np
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
from mirres_restir_nerf_mesh_torch.convert import params_from_jax, state_from_jax, state_to_numpy
from mirres_restir_nerf_mesh_torch.models.material import MaterialSpec
from mirres_restir_nerf_mesh_torch.models.nerf import NeRFSpec
from mirres_restir_nerf_mesh_torch.render import stage1 as ts
from mirres_restir_nerf_mesh_torch.train import losses as tL
from mirres_restir_nerf_mesh_torch.train import stage1 as ttr

from test_torch_helpers import TORCH_THREADS, frame_randoms_jax, n, small_spec_kwargs, t, tree_np
from test_torch_light import sky_env
from test_torch_pathtracer import balls_mesh
from test_torch_stage1 import assert_frames_match
from test_torch_train import cosine, jax_groups, rel_l2

torch.set_num_threads(TORCH_THREADS)

H = 24
SPP = 2
RESTIR = dict(use_restir=True, restir_tiles=4, restir_tile_size=32, restir_light_samples=8,
              restir_brdf_samples=1, restir_neighbors=5, restir_radius=6.0, restir_offsets=64,
              denoise_iters=2, compute_normal_ao=True)


def restir_case():
    """Both packages' params and statics, the mesh and the frame's batch."""
    v, tr = balls_mesh(faces=1200)
    data = make_synthetic_dataset(n_frames=1, H=H, W=H, bound=1.0)
    f = RayDataset(data, bound=1.0).frame_rays(0)
    kw = small_spec_kwargs()
    key = jax.random.PRNGKey(0)
    mat = init_material(jax.random.fold_in(key, 1), JMatSpec(bound=1.0))
    mat = {**mat, "encoder": mat["encoder"] * 1e3}
    params = js.Stage1Params(nerf=init_nerf(key, JNeRFSpec(bound=1.0, **kw)),
                             offsets=jnp.asarray(np.random.RandomState(2).normal(
                                 size=(v.shape[0], 3)).astype(np.float32) * 1e-3),
                             mat=mat, env=jnp.asarray(sky_env(16, 32, seed=3)))
    common = dict(spp=SPP, bounces=2, H=H, W=H, dense_threshold=8192, k_cap=640,
                  k_cap_incoherent=640, queue_avg=256, queue_avg_incoherent=64, compact_chunks=1,
                  **RESTIR)
    jstatic = js.Stage1Static(tris=jnp.asarray(tr), nerf_spec=JNeRFSpec(bound=1.0, **kw),
                              mat_spec=JMatSpec(bound=1.0), tracer="tile", **common)
    tstatic = ts.Stage1Static(tris=t(tr), nerf_spec=NeRFSpec(bound=1.0, **kw),
                              mat_spec=MaterialSpec(bound=1.0), **common)
    return dict(v=v, tr=tr, f=f, params=params, jstatic=jstatic, tstatic=tstatic,
                rand=lambda k: frame_randoms_jax(k, H * H, SPP, 2, H, tstatic))


@pytest.fixture(scope="module")
def case():
    return restir_case()


def port_params(p):
    return params_from_jax(tree_np(p.nerf), tree_np(p.mat), np.asarray(p.env),
                           np.asarray(p.offsets), device="cpu")


def test_restir_frame_matches_reference(case):
    fk = jax.random.PRNGKey(5)
    f = case["f"]
    ref = js.render_stage1(case["params"], case["jstatic"], jnp.asarray(case["v"]), f["rays_o"],
                           f["rays_d"], fk)
    got = ts.render_stage1(port_params(case["params"]), case["tstatic"], t(case["v"]),
                           t(f["rays_o"]), t(f["rays_d"]), rand=case["rand"](fk))
    assert "normal_ao" in got
    assert_frames_match(ref, got)
    assert float(np.abs(np.asarray(ref["diffuse_light"])).max()) > 1e-3
    assert float(got["uncertain_count"]) == 0


def test_restir_chain_compaction_equivalence(case):
    """The chain on live pixels only (compact_chunks=4) reproduces the chain
    on every pixel (compact_chunks=1) on covered pixels, and traces the same
    rays."""
    rand = case["rand"](jax.random.PRNGKey(7))
    f = case["f"]
    params = port_params(case["params"])
    outs = {}
    for chunks in (1, 4):
        st = ts.Stage1Static(**{**case["tstatic"].__dict__, "compact_chunks": chunks})
        outs[chunks] = ts.render_stage1(params, st, t(case["v"]), t(f["rays_o"]), t(f["rays_d"]),
                                        rand=rand)
    m = n(outs[1]["mask"])
    assert m.any() and (~m).any()
    for k in ("image_brdf", "diffuse_light", "specular_light", "img_brdf_indirect", "normal_ao"):
        np.testing.assert_allclose(n(outs[4][k])[m], n(outs[1][k])[m], atol=1e-6, err_msg=k)
    for k in ("traced_rays", "uncertain_count"):
        assert float(outs[4][k]) == float(outs[1][k]), k


TRAIN_KW = dict(bound=1.0, stage=1, use_brdf=True, pt_bounces=2, env_h=16, env_w=32,
                lambda_tv=0.0, lambda_normal=0.01, lambda_edgelen=0.01, lambda_chroma=0.01,
                lambda_extra_kd=0.5, use_restir=True, spp=SPP)


def reference_setup(case):
    """-> (jitted reference train step, its initial state, the batch)."""
    v, tr, f = case["v"], case["tr"], case["f"]
    jcfg = jfinalize(JConfig(**TRAIN_KW))
    step_j = jtr.make_train_step(jcfg, case["jstatic"], v, jL.build_topology(tr, v.shape[0]))
    st_j = jtr.Stage1State(case["params"], jtr.make_optimizer(jcfg).init(case["params"]),
                           jnp.zeros((), jnp.int32))
    return step_j, st_j, {k: f[k] for k in ("rays_o", "rays_d", "pixels", "alpha")}


def run_two_steps(case, port_cfg=None):
    """Two reference steps and two port steps, step 2 of both from the
    reference's state after step 1 -> [(new_j, aux_j, old_t, new_t, aux_t)].
    port_cfg overrides fields of the port's Config only (a planted fault)."""
    v, tr = case["v"], case["tr"]
    step_j, st_j, batch = reference_setup(case)
    tcfg = finalize(Config(**{**TRAIN_KW, **(port_cfg or {})}))
    step_t = ttr.make_train_step(tcfg, case["tstatic"], t(v), tL.build_topology(tr, v.shape[0]))
    st_t = state_from_jax(st_j, device="cpu")
    out = []
    for i in range(2):
        k = jax.random.PRNGKey(30 + i)
        new_j, aux_j = step_j(st_j, batch, k)
        new_t, aux_t = step_t(st_t, {k_: t(x) for k_, x in batch.items()}, rand=case["rand"](k))
        out.append((new_j, aux_j, st_t, new_t, aux_t))
        st_j, st_t = new_j, state_from_jax(new_j, device="cpu")
    return out


def leaf_moments(step):
    """-> [(leaf, mu_t, mu_j, update_t, update_j)] per optimizer leaf, the
    updates over the entries whose reference mu is at least 1e-4 of the
    leaf's RMS."""
    new_j, _, old_t, new_t, _ = step
    ref_new = state_to_numpy(state_from_jax(new_j, device="cpu"))
    got_new = state_to_numpy(new_t)
    before = ttr.group_leaves(old_t.params)
    after_t, after_j = ttr.group_leaves(new_t.params), jax_groups(new_j.params)
    out = []
    for grp in ttr.GROUPS:
        for j, (mu_t, mu_j) in enumerate(zip(got_new[1][grp]["mu"], ref_new[1][grp]["mu"])):
            keep = np.abs(mu_j) >= 1e-4 * np.sqrt(np.mean(mu_j ** 2))
            d_t = (n(after_t[grp][j]) - n(before[grp][j]))[keep]
            d_j = (np.asarray(after_j[grp][j]) - n(before[grp][j]))[keep]
            out.append((f"{grp}[{j}]", mu_t, mu_j, d_t, d_j))
    return out


@pytest.fixture(scope="module")
def two_steps(case):
    return run_two_steps(case)


@pytest.mark.parametrize("i", [0, 1])
def test_restir_train_step_matches_reference(two_steps, i):
    _, aux_j, _, _, aux_t = two_steps[i]
    rtol = 1e-5 if i == 0 else 1e-3
    np.testing.assert_allclose(float(aux_t["loss"]), float(aux_j["loss"]), rtol=rtol)
    for k in ("psnr", "psnr_brdf"):
        np.testing.assert_allclose(float(aux_t[k]), float(aux_j[k]), rtol=rtol, atol=1e-4,
                                   err_msg=k)
    assert float(aux_t["uncertain_count"]) == float(aux_j["uncertain_count"]) == 0
    np.testing.assert_array_equal(n(aux_t["face_cnt"]), np.asarray(aux_j["face_cnt"]))
    mu_tol, upd_tol = (1e-3, 1e-3) if i == 0 else (1e-2, 2e-2)
    for what, mu_t, mu_j, d_t, d_j in leaf_moments(two_steps[i]):
        if not np.any(mu_j):
            assert not np.any(mu_t), what
            continue
        assert rel_l2(mu_t, mu_j) <= mu_tol, (what, rel_l2(mu_t, mu_j))
        assert rel_l2(d_t, d_j) <= upd_tol and cosine(d_t, d_j) >= 0.9999, (
            what, rel_l2(d_t, d_j), cosine(d_t, d_j))


def print_readings():
    """The readings the docstring quotes: the worst leaf of each step, sound
    and with two planted faults, and the reference's own step-2 gradient
    change when every parameter moves by 4 ulps."""
    case = restir_case()

    def worst(label, steps):
        for i, step in enumerate(steps):
            r = [(rel_l2(mt, mj), rel_l2(dt, dj), cosine(dt, dj))
                 for _, mt, mj, dt, dj in leaf_moments(step) if np.any(mj)]
            print(f"{label}, step {i + 1}: mu {max(x[0] for x in r):.2e}, "
                  f"update {max(x[1] for x in r):.2e}, cosine {min(x[2] for x in r):.6f}")

    worst("sound", run_two_steps(case))
    worst("lambda_extra_kd term dropped", run_two_steps(case, {"lambda_extra_kd": 0.0}))
    render = ttr.render_stage1

    def detach_half(*args, **kw):
        out = render(*args, **kw)
        h = out["image"].shape[0] // 2
        for k in ("image", "image_brdf", "diffuse_light", "specular_light"):
            out[k] = torch.cat([out[k][:h], out[k][h:].detach()])
        return out

    ttr.render_stage1 = detach_half
    worst("half the pixels' colours detached", run_two_steps(case))
    ttr.render_stage1 = render

    step_j, st_j, batch = reference_setup(case)
    params = step_j(st_j, batch, jax.random.PRNGKey(30))[0].params
    jcfg = jfinalize(JConfig(**TRAIN_KW))
    topo = jL.build_topology(case["tr"], case["v"].shape[0])
    grad = jax.jit(lambda p: jax.grad(jtr.stage1_loss, has_aux=True)(
        p, case["jstatic"], jnp.asarray(case["v"]), topo, batch, jax.random.PRNGKey(31), jcfg)[0])
    g0 = jax_groups(grad(params))
    worst_moved = {}
    for seed in range(8):
        sign = np.random.RandomState(seed)
        moved = jax.tree_util.tree_map(lambda a: a * (1 + 4 * 2.0 ** -23 * sign.choice(
            [-1.0, 1.0], a.shape).astype(np.float32)), params)
        g1 = jax_groups(grad(moved))
        for grp in ttr.GROUPS:
            for j, (a, b) in enumerate(zip(g0[grp], g1[grp])):
                if np.any(np.asarray(a)):
                    r = rel_l2(np.asarray(b), np.asarray(a))
                    worst_moved[f"{grp}[{j}]"] = max(worst_moved.get(f"{grp}[{j}]", 0.0), r)
    print("reference step-2 gradient, params moved 4 ulps of random sign (worst of 8 draws): "
          + ", ".join(f"{k} {r:.2e}" for k, r in worst_moved.items()))

if __name__ == "__main__":
    print_readings()
