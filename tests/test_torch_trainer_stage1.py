"""Port vs reference: the stage-1 half of the Trainer (train/trainer.py)
against the JAX package's, at the sizes of tests/test_torch_trainer.py (4
hash levels of 2^12, hidden 16; a 16^2 frame of the synthetic sphere) on
a sphere mesh of marching tetrahedra, with the same subclass on the JAX
Trainer's key chain (``FedTrainer``).

- The bootstrap from the stage-0 checkpoints (written by each package from
  one state): the ``best`` one's EMA field, not the later ``latest`` one's,
  bit for bit.
- Stage 1 (BRDF, spp 2, one bounce, row bands of 8 rows, ssaa 2, one
  training frame so that the two steps take the two bands; the reference
  on its tile tracer, op by op: jitted, its fused code moves the material
  encoder's and the envmap's gradients by ~1.3e-3 relative L2 from its own
  op-by-op values here, through a few Monte Carlo decisions): 2 steps
  through ``train()``, each from the reference's state (the material
  encoder x 1e3, as in tests/test_torch_train.py's fixture; step 2 from the
  reference's state after step 1: Adam's first step moves the entries
  whose gradient is rounding noise by +-lr, lr 0.03 for the material
  field; the port's environment sampler takes the reference's table,
  whose CDF rounds apart at a few quantile ties, see
  tests/test_torch_light.py), at that file's step-1 tolerances (loss, psnr
  and psnr_brdf within 1e-5 relative; mu / nu within 1e-3 / 2e-3 relative
  L2; each update within 1e-3 relative L2, cosine >= 0.9999).
- ``_refine_mesh`` from equal states and face errors: mesh_0_updated.ply
  bytes, the new mesh and the zeroed offsets equal.

The reference's op-by-op step compiles each of its ~1,400 primitives once
in a process (~80 s of this file's ~110 s).
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
from mirres_restir_nerf_mesh_tpu.models import envlight as jenvlight
from mirres_restir_nerf_mesh_tpu.models.nerf import NeRFSpec as JNeRFSpec
from mirres_restir_nerf_mesh_tpu.train import stage1 as jstage1
from mirres_restir_nerf_mesh_tpu.train.trainer import Trainer as JTrainer
from mirres_restir_nerf_mesh_torch.config import Config, finalize
from mirres_restir_nerf_mesh_torch.convert import stage0_state_from_jax, state_from_jax, state_to_numpy
from mirres_restir_nerf_mesh_torch.models import envlight as tenvlight
from mirres_restir_nerf_mesh_torch.models.nerf import NeRFSpec
from mirres_restir_nerf_mesh_torch.train.trainer import Trainer

from test_torch_helpers import TORCH_THREADS, n
from test_torch_train import cosine, rel_l2
from test_torch_trainer import SPEC, FedTrainer, frame_data, leaves_np, metrics, sphere_mesh

torch.set_num_threads(TORCH_THREADS)

STAGE1 = dict(bound=1.0, stage=1, iters=2, use_brdf=True, spp=2, pt_bounces=1, env_h=16,
              env_w=32, stage1_rows=8, compact_chunks=1, n_eval=1, n_ckpt=1)


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """Both workspaces: the same mesh_0.ply, and stage-0 checkpoints of one
    state: ``best`` at step 3, ``latest`` at step 5 with the EMA field
    doubled."""
    base = tmp_path_factory.mktemp("trainer_stage1")
    (jd, td) = frame_data(1, 0)
    wsj, wst = str(base / "jax"), str(base / "port")
    cfg0 = dict(bound=1.0, grid_size=16, hash_levels=4, hash_log2_size=12, hash_max_res=64)
    jtr = JTrainer("ngp", jfinalize(JConfig(**cfg0, workspace=wsj, data_parallel=False)), jd,
                   nerf_spec=JNeRFSpec(**SPEC))
    ttr = Trainer("ngp", finalize(Config(**cfg0, workspace=wst)), td, nerf_spec=NeRFSpec(**SPEC),
                  device="cpu")
    ttr.state = stage0_state_from_jax(jtr.state, device="cpu")
    for tr in (jtr, ttr):
        tr.global_step = 3
        tr.save_checkpoint(best=True)
        best = tr.state
        tr.state = best._replace(ema_params=jax.tree.map(lambda x: x * 2, best.ema_params))
        tr.global_step = 5
        tr.save_checkpoint()
        tr.state = best
    v, t = sphere_mesh(600)
    from mirres_restir_nerf_mesh_torch.export.meshio import write_ply

    for ws in (wsj, wst):
        write_ply(os.path.join(ws, "mesh_0.ply"), v, t)
    return dict(jd=jd, td=td, wsj=wsj, wst=wst, jbest=jtr.state)


@pytest.fixture(scope="module")
def stage1_case(case):
    """Stage-1 Trainers of both packages on one training frame (the bands
    then alternate: step 1 renders rows 0-7, step 2 rows 8-15), a step
    each; step 2 starts from the reference's state after step 1."""
    jcfg = jfinalize(JConfig(**STAGE1, workspace=case["wsj"], data_parallel=False))
    tcfg = finalize(Config(**STAGE1, workspace=case["wst"]))
    jd1, td1 = case["jd"], case["td"]
    jtr = JTrainer("ngp", jcfg, jd1, nerf_spec=JNeRFSpec(**SPEC))
    # the reference traces with its tile tracer, the port's one kind ("auto"
    # picks the cluster tracer on the CPU, whose loops crawl op by op)
    jtr.static = dataclasses.replace(jtr.static, tracer="tile")
    jtr.train_step = jstage1.make_train_step(jcfg, jtr.static, jtr.base_verts, jtr.topo)
    ttr = FedTrainer("ngp", tcfg, td1, nerf_spec=NeRFSpec(**SPEC), device="cpu",
                     jsampler=jtr.sampler, skip=2)
    boot = (jax.tree.leaves(jtr.state.params.nerf), ttr.state.params.nerf)
    # the material encoder scaled up (as tests/test_torch_train.py's fixture):
    # at its init scale its gradient is rounding noise, and Adam's first
    # step moves a noise entry by +-lr whatever its sign
    p = jtr.state.params
    jtr.state = jtr.state._replace(params=p._replace(mat={**p.mat,
                                                         "encoder": p.mat["encoder"] * 1e3}))
    # the environment sampler's table from the reference: its CDF rounds
    # apart at a few quantile ties (held in tests/test_torch_light.py), which
    # moves the pdf of the texels at those ties by one count in 128
    def reference_sampler(tex, m=65536):
        ref = jenvlight.build_sampler(jnp.asarray(n(tex)), m)
        return tenvlight.EnvSampler(table=torch.as_tensor(np.asarray(ref.table), dtype=torch.int64),
                                    pdf=torch.as_tensor(np.asarray(ref.pdf)))

    steps = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tenvlight, "build_sampler", reference_sampler)
        for i in range(STAGE1["iters"]):
            ttr.state = state_from_jax(jtr.state, device="cpu")
            before = state_to_numpy(ttr.state)
            with jax.disable_jit():
                jtr.train(max_steps=i + 1)
            ttr.train(max_steps=i + 1)
            steps.append(dict(before=before, jstate=jtr.state, tstate=ttr.state,
                              jlog=metrics(case["wsj"])[-1], tlog=metrics(case["wst"])[-1]))
    return dict(jtr=jtr, ttr=ttr, boot=boot, steps=steps)


def test_stage1_bootstrap_matches_reference(case, stage1_case):
    jb, tb = stage1_case["boot"]
    best = leaves_np(case["jbest"].ema_params)
    tb = jax.tree.leaves(tb)
    assert len(tb) == len(jb) == len(best)
    for a, b, c in zip(tb, jb, best):
        np.testing.assert_array_equal(n(a), c)
        np.testing.assert_array_equal(np.asarray(b), c)
    for ws in (case["wst"], case["wsj"]):
        assert "ngp_stage0_best.pkl" in open(os.path.join(ws, "log_ngp.txt")).read()
    ttr = stage1_case["ttr"]
    assert ttr.static.H == STAGE1["stage1_rows"] * 2 and ttr.static.W == 32


@pytest.mark.parametrize("i", [0, 1])
def test_stage1_step_matches_reference(stage1_case, i):
    st = stage1_case["steps"][i]
    lj, lt = st["jlog"], st["tlog"]
    assert lj["step"] == lt["step"] == i + 1
    for k in ("loss", "psnr", "psnr_brdf"):
        np.testing.assert_allclose(lt[k], lj[k], rtol=1e-5, err_msg=k)
    assert lt["uncertain_count"] == lj["uncertain_count"] == 0
    jst = st["jstate"]
    p0, (p1, opt, step) = st["before"][0], state_to_numpy(st["tstate"])
    assert step == int(jst.step) == i + 1
    jp = jst.params
    for mine, ref, start in zip(p1, (jp.nerf, jp.mat, jp.env, jp.offsets), p0):
        for a, b, a0 in zip(jax.tree.leaves(mine), leaves_np(ref), jax.tree.leaves(start)):
            du, dr = np.asarray(a) - a0, b - a0
            if np.abs(dr).max() == 0:
                np.testing.assert_array_equal(du, dr)
                continue
            assert rel_l2(du, dr) <= 1e-3 and cosine(du, dr) >= 0.9999, (
                a0.shape, rel_l2(du, dr), cosine(du, dr))
    for g, gst in jst.opt_state.inner_states.items():
        adam = [s for s in gst.inner_state if hasattr(s, "mu")][0]
        assert opt[g]["count"] == int(adam.count) == i + 1
        for what, mine, ref, tol in (("mu", opt[g]["mu"], leaves_np(adam.mu), 1e-3),
                                     ("nu", opt[g]["nu"], leaves_np(adam.nu), 2e-3)):
            for a, b in zip(mine, ref):
                if np.abs(b).max() > 0:
                    assert rel_l2(a, b) <= tol, (g, what, rel_l2(a, b))


def test_refine_mesh_matches_reference(case, stage1_case):
    jtr, ttr = stage1_case["jtr"], stage1_case["ttr"]
    ttr.state = state_from_jax(jtr.state, device="cpu")
    rng = np.random.RandomState(4)
    F = jtr.tris.shape[0]
    err, cnt = rng.uniform(size=F) * (rng.uniform(size=F) < 0.8), rng.randint(1, 5, F)
    for tr in (jtr, ttr):
        tr._face_err_acc, tr._face_cnt_acc = err.astype(np.float64), cnt.astype(np.float64)
        tr._refine_mesh()
    ply = "mesh_0_updated.ply"
    assert (open(os.path.join(case["wst"], ply), "rb").read()
            == open(os.path.join(case["wsj"], ply), "rb").read())
    np.testing.assert_array_equal(ttr.tris, jtr.tris)
    np.testing.assert_array_equal(ttr.base_verts, jtr.base_verts)
    assert ttr.tris.shape[0] != F and n(ttr.static.tris).shape == ttr.tris.shape
    assert not n(ttr.state.params.offsets).any()
    assert int(ttr.state.opt_state["vert"].count) == 0 and ttr._face_err_acc.shape == (
        ttr.tris.shape[0],)


