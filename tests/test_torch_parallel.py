"""Data parallelism (parallel/mesh.py, the sharded stage-0 step and the
Trainer under ranks): 2 and 3 gloo ranks on the CPU, spawned through
``parallel.mesh.launch``, each test's process group on a ``file://`` store
under its tmp_path (so parallel test workers never share a port), one
thread a rank.  The rank functions live in tests/torch_parallel_ranks.py.

- ``shard_rows``: contiguous, covering, uneven by at most one row.
- The collectives: ``gather_rows`` forward (the whole tensor) and its
  gradient (equal to one process's gradient of the same loss, rank by
  rank), ``all_reduce_sum``'s gradient, ``replicate``, ``all_reduce_grads``;
  a rank that raises makes ``launch`` raise; ``main.py`` launches a rank a
  card, joins torchrun's group, or runs alone.
- The stage-0 step at R = 2 and 3 against the JAX single-device
  ``make_train_step`` on the same draws, at tests/test_torch_stage0_train.py's
  sizes and tolerances (loss 1e-5 relative, num_points equal, each gradient
  leaf 1e-4 relative L2, mu / nu 1e-4 / 2e-4, params and EMA 1e-5 over the
  entries above gradient noise); the point budget set so that the
  cross-ray compaction cuts inside rank 0's shard (R = 2) and inside the
  last rank's (R = 3).  Every rank's state after the step is bit-identical.
- The Trainer at 2 ranks on the JAX Trainer's draws
  (tests/test_torch_trainer.py's FedTrainer), at tests/test_dp_trainer.py's
  config, against the port's one-device Trainer on the same draws, and with
  -O against the JAX single-device Trainer: every param within rtol 2e-4 /
  atol 2e-5 after 20 steps; both ranks' states bit-identical; rank 0 alone
  writes the log.
"""

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
from mirres_restir_nerf_mesh_tpu.train.trainer import Trainer as JTrainer
from mirres_restir_nerf_mesh_torch.config import Config, finalize
from mirres_restir_nerf_mesh_torch.convert import stage0_state_from_jax
from mirres_restir_nerf_mesh_torch.data.provider import FrameData, RayDataset
from mirres_restir_nerf_mesh_torch.models.nerf import NeRFSpec
from mirres_restir_nerf_mesh_torch.parallel import mesh as pmesh
from mirres_restir_nerf_mesh_torch.render.volume import render_rays
from mirres_restir_nerf_mesh_torch.train import stage0 as ts0

import torch_parallel_ranks as ranks
from test_torch_helpers import TORCH_THREADS, stage0_randoms_jax, stage0_spec_kwargs
from test_torch_stage0_train import CFG, frame_data, leaves_np, rel_l2

torch.set_num_threads(TORCH_THREADS)


def run_ranks(tmp_path, fn, nprocs, *args):
    return pmesh.launch(fn, nprocs, backend="gloo", device_of_rank=lambda r: "cpu",
                        init_method=f"file://{tmp_path}/store_{fn.__name__}_{nprocs}",
                        args=args, timeout=600)


@pytest.mark.parametrize("n,world", [(7, 2), (7, 3), (10, 3), (3, 3), (256, 8)])
def test_shard_rows_uneven(n, world):
    parts = [pmesh.shard_rows(n, r, world) for r in range(world)]
    assert parts[0][0] == 0 and parts[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(parts, parts[1:]))
    sizes = [hi - lo for lo, hi in parts]
    assert max(sizes) - min(sizes) <= 1 and min(sizes) >= 1


@pytest.mark.parametrize("world", [2, 3])
def test_collectives(tmp_path, world):
    n = 7
    res = run_ranks(tmp_path, ranks.collectives_rank, world, n)
    x = np.random.RandomState(0).normal(size=(n, 3)).astype(np.float64)
    w = np.random.RandomState(1).normal(size=(n, 3)).astype(np.float64)
    # one process's loss of the whole tensor and its gradient
    loss = ((x * w) ** 2).sum() + (x ** 3).sum()
    grad = 2 * x * w ** 2 + 3 * x ** 2
    assert [(r["lo"], r["hi"]) for r in res] == [pmesh.shard_rows(n, k, world)
                                                 for k in range(world)]
    for r in res:
        np.testing.assert_array_equal(r["full"], x.astype(np.float32))
        np.testing.assert_allclose(r["loss"], loss, rtol=1e-5)
        np.testing.assert_allclose(r["grad"], grad[r["lo"]:r["hi"]], rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(r["rep"][0], [0.0, 0.0])
        assert int(r["rep"][1]) == 1
        np.testing.assert_array_equal(r["summed"][0], np.zeros(2))
        np.testing.assert_array_equal(r["summed"][1], np.full(3, sum(range(world))))


def test_launch_raises_when_a_rank_fails(tmp_path):
    """A rank's exception ends every rank and reaches the caller."""
    with pytest.raises(RuntimeError, match="a planted failure on rank 1"):
        run_ranks(tmp_path, ranks.failing_rank, 2)


def test_main_spawns_a_rank_per_card(monkeypatch):
    """main.py with more than one card visible launches one NCCL rank a
    card; under torchrun (WORLD_SIZE set) it joins the group and runs its
    part; on one device it runs alone."""
    from mirres_restir_nerf_mesh_torch import device as device_mod
    from mirres_restir_nerf_mesh_torch import main as cli

    calls = []
    monkeypatch.setattr(device_mod, "resolve_device", lambda d="cuda": torch.device(d))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    monkeypatch.setattr(pmesh, "launch", lambda fn, n, **k: calls.append(("launch", fn, n, k)))
    monkeypatch.setattr(cli, "run", lambda cfg, device, dp=None: calls.append(("run", device, dp)))
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    argv = ["scene", "--workspace", "ws"]
    cli.main(argv)
    (kind, fn, n, k), = calls
    assert (kind, fn, n, k["backend"], k["args"]) == ("launch", cli._rank_main, 3, "nccl", (argv,))
    calls.clear()
    cli.main(argv, device="cpu")
    assert calls == [("run", "cpu", None)]
    calls.clear()
    dp = pmesh.DataParallel(group=None, rank=1, world=2, device=torch.device("cpu"),
                            backend="gloo")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setattr(pmesh, "init_data_parallel", lambda d: dp)
    monkeypatch.setattr(torch.distributed, "destroy_process_group", lambda: None)
    cli.main(argv, device="cpu")
    assert calls == [("run", torch.device("cpu"), dp)]


# ------------------------------------------------------------------ stage 0
@pytest.fixture(scope="module")
def s0():
    jd, td = frame_data(n_frames=8, H=32, W=32)
    js = JRayDataset(jd, bound=1.0, background="random")
    tsm = RayDataset(td, bound=1.0, background="random", device="cpu")
    kw = stage0_spec_kwargs()
    jspec, tspec = JNeRFSpec(bound=1.0, **kw), NeRFSpec(bound=1.0, **kw)
    jcfg = jfinalize(JConfig(**CFG))
    jstate = js0.init_state(jax.random.PRNGKey(0), jcfg, jspec)
    jstate = js0.make_occ_update(jcfg, jspec)(jstate, jax.random.PRNGKey(9))
    return dict(js=js, tsm=tsm, jspec=jspec, tspec=tspec, jstate=jstate,
                tstate=stage0_state_from_jax(jstate, device="cpu"))


def valid_per_ray(c, cfg, rnd, n_march):
    """Each ray's count of valid marched samples (the compaction's input)."""
    batch = c["tsm"].sample(rnd.sample)
    out = render_rays(c["tstate"].params, c["tstate"].occ.occ, batch["rays_o"], batch["rays_d"],
                      c["tspec"], torch.tensor([-1.0, -1, -1, 1, 1, 1]), K=cfg.samples_per_ray,
                      max_steps=cfg.max_steps, dt_gamma=cfg.dt_gamma, min_near=cfg.min_near,
                      noise=rnd.noise, march_candidates=n_march)
    return out["valid"].sum(dim=1).numpy()


@pytest.mark.parametrize("world,cut_rank", [(2, 0), (3, 2)])
def test_stage0_step_matches_reference(s0, tmp_path, world, cut_rank):
    key = jax.random.PRNGKey(11)
    cfg = finalize(Config(**CFG))
    n_march = ts0.march_candidates_for(cfg, s0["tsm"])
    per_ray = valid_per_ray(s0, cfg, stage0_randoms_jax(key, s0["js"], cfg, n_march), n_march)
    shards = [pmesh.shard_rows(cfg.num_rays, r, world) for r in range(world)]
    per_rank = [int(per_ray[lo:hi].sum()) for lo, hi in shards]
    # the point budget: the compaction's cut falls inside cut_rank's shard
    budget = sum(per_rank[:cut_rank]) + per_rank[cut_rank] // 2
    assert 0 < per_rank[cut_rank] // 2 < per_rank[cut_rank]
    kw = {**CFG, "num_points": budget}
    cfg, jcfg = finalize(Config(**kw)), jfinalize(JConfig(**kw))
    rnd = stage0_randoms_jax(key, s0["js"], cfg, n_march)
    jstep = js0.make_train_step(jcfg, s0["jspec"], s0["js"])
    with jax.disable_jit():
        jnew, jaux = jstep(s0["jstate"], key)
    case = ranks.to_bytes(dict(cfg=cfg, spec=s0["tspec"], sampler=s0["tsm"], state=s0["tstate"],
                               rand=rnd))
    res = run_ranks(tmp_path, ranks.stage0_step_rank, world, case)

    got = res[0]
    np.testing.assert_allclose(got["loss"], float(jaux["loss"]), rtol=1e-5)
    assert got["num_points"] == int(jaux["num_points"])
    jopt = jnew.opt_state[0]
    jmu = leaves_np(jopt.mu)
    jg = [m.astype(np.float64) / (1.0 - np.float32(0.9)) for m in jmu]
    assert len(got["grads"]) == len(jg)
    for g, r in zip(got["grads"], jg):
        assert rel_l2(g, r) < 1e-4
    st = got["state"]
    assert st["step"] == int(jnew.step) and st["opt"]["count"] == int(jopt.count)
    for what, mine, ref, tol in (("mu", st["opt"]["mu"], jmu, 1e-4),
                                 ("nu", st["opt"]["nu"], leaves_np(jopt.nu), 2e-4)):
        for a, b in zip(mine, ref):
            assert rel_l2(a, b) < tol, what
    for what, mine, ref in (("params", jax.tree.leaves(st["params"]), leaves_np(jnew.params)),
                            ("ema", jax.tree.leaves(st["ema_params"]),
                             leaves_np(jnew.ema_params))):
        for a, b, g in zip(mine, ref, jg):
            keep = np.abs(g) > 1e-3 * np.abs(g).max() if np.abs(g).max() > 0 else slice(None)
            assert rel_l2(np.asarray(a)[keep], b[keep]) < 1e-5, what
    # every rank holds the same bits
    assert all(r["same"] for r in res)
    for r in res[1:]:
        for a, b in zip(jax.tree.leaves(r["state"]), jax.tree.leaves(st)):
            np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------------ Trainer
DP_SPEC = dict(bound=1.0, hidden_dim=16, hidden_dim_color=16, geo_feat_dim=7, grid_levels=4,
               grid_log2_hashmap_size=12, grid_desired_resolution=64)
DP_CFG = dict(iters=20, num_rays=256, max_steps=16, samples_per_ray=8, grid_size=16,
              dt_gamma=0.0, lambda_tv=0.0, stochastic_interp=False, update_extra_interval=8,
              n_ckpt=1, n_eval=1)


@pytest.mark.parametrize("extra,reference", [({}, "port"), ({"O": True}, "jax")])
def test_dp_trainer_matches_one_device(tmp_path, extra, reference):
    """tests/test_dp_trainer.py's run: the port's Trainer on 2 ranks against
    the port's one-device Trainer on the same draws ("port"), and with -O
    against the JAX single-device Trainer ("jax").  Without -O the first
    occupancy update thresholds an untrained field at its mean density (every
    cell within 3.3e-5 of 1.0), and the packages' float32 means, summed in
    different orders, lie 5 ulps apart (the port's 0.99999577 is the exact
    mean rounded, the reference's jitted update reads 0.99999636): 4% of the
    occupancy bits differ, and the two runs part from the first step."""
    jd = make_synthetic_dataset(n_frames=2, H=16, W=16)
    td = FrameData(images=jd.images, poses=jd.poses, intrinsics=jd.intrinsics, H=jd.H, W=jd.W,
                   mvps=jd.mvps)
    kw = {**DP_CFG, **extra}
    jtr = JTrainer("ngp", jfinalize(JConfig(**kw, workspace=str(tmp_path / "jax"),
                                            data_parallel=False)),
                   jd, nerf_spec=JNeRFSpec(**DP_SPEC))
    state0 = stage0_state_from_jax(jtr.state, device="cpu")
    case = ranks.to_bytes(dict(cfg=finalize(Config(**kw, workspace=str(tmp_path / "dp"))),
                               data=td, jdata=jd, spec=NeRFSpec(**DP_SPEC), state=state0,
                               steps=20))
    res = run_ranks(tmp_path, ranks.trainer_rank, 2, case)
    if reference == "jax":
        jtr.train(max_steps=20)
        ref_step, ref = int(jtr.state.step), leaves_np(jtr.state.params)
    else:
        from test_torch_trainer import FedTrainer
        from mirres_restir_nerf_mesh_torch.convert import stage0_state_to_numpy

        one = FedTrainer("ngp", finalize(Config(**kw, workspace=str(tmp_path / "one"))), td,
                         nerf_spec=NeRFSpec(**DP_SPEC), device="cpu", jsampler=jtr.sampler,
                         skip=1)
        one.state = state0
        one.train(max_steps=20)
        st = stage0_state_to_numpy(one.state)
        ref_step, ref = st["step"], jax.tree.leaves(st["params"])

    got = res[0]["state"]
    assert got["step"] == ref_step == 20
    mine = jax.tree.leaves(got["params"])
    assert len(mine) == len(ref)
    for a, b in zip(mine, ref):
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-5)
    assert all(r["same"] for r in res)
    for a, b in zip(jax.tree.leaves(res[1]["state"]), jax.tree.leaves(got)):
        np.testing.assert_array_equal(a, b)
    # rank 0 alone wrote the workspace
    log = (tmp_path / "dp" / "log_ngp.txt").read_text()
    assert log.count("[dp] data-parallel over 2 ranks (gloo)") == 1

