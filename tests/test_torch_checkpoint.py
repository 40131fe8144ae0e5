"""train/checkpoint.py and utils/profiling.py of the port.

- A stage-0 and a stage-1 state round-trip bit for bit (every leaf, its
  dtype and device); the payload unpickles with numpy and builtins alone
  (no class of either package); its keys are the leaves' tree paths.
- The file names, the rolling window of 2 and ``best`` are the JAX
  package's: the same saves through both leave the same files, and
  ``find_checkpoint`` finds the same ones.
- The tolerant restore: a leaf whose shape or dtype differs (the offsets
  after a refine) or that is missing keeps the template's and is reported;
  the rest is restored.
- ``MetricsWriter``: one JSON record a line with the step and the seconds;
  ``PhaseTimer`` sums and counts its phases.
"""

import io
import json
import os
import pickle

import numpy as np
import pytest
import torch

from mirres_restir_nerf_mesh_tpu.train import checkpoint as jck
from mirres_restir_nerf_mesh_torch.config import Config, finalize
from mirres_restir_nerf_mesh_torch.models.material import MaterialSpec
from mirres_restir_nerf_mesh_torch.models.nerf import NeRFSpec
from mirres_restir_nerf_mesh_torch.render.stage1 import Stage1Static
from mirres_restir_nerf_mesh_torch.train import checkpoint as ck
from mirres_restir_nerf_mesh_torch.train import stage0, stage1
from mirres_restir_nerf_mesh_torch.utils.profiling import MetricsWriter, PhaseTimer

from test_torch_helpers import TORCH_THREADS, small_spec_kwargs

torch.set_num_threads(TORCH_THREADS)

SPEC = NeRFSpec(bound=1.0, **small_spec_kwargs())


def stage0_state(seed):
    cfg = finalize(Config(bound=1.0, grid_size=16))
    st = stage0.init_state(torch.Generator().manual_seed(seed), cfg, SPEC, device="cpu")
    # an Adam step's worth of moments, a marked grid and a count
    g = torch.Generator().manual_seed(seed + 1)
    return st._replace(opt_state=st.opt_state._replace(
        count=torch.tensor(3, dtype=torch.int32),
        mu=[torch.randn(x.shape, generator=g) for x in st.opt_state.mu]),
        occ=st.occ._replace(occ=(torch.rand(st.occ.occ.shape, generator=g) > 0.5).to(
            torch.uint8)), step=torch.tensor(7, dtype=torch.int32))


def stage1_state(seed, n_verts=10):
    cfg = finalize(Config(bound=1.0, stage=1, env_h=8, env_w=16))
    static = Stage1Static(tris=torch.zeros((1, 3), dtype=torch.int64), nerf_spec=SPEC,
                          mat_spec=MaterialSpec())
    g = torch.Generator().manual_seed(seed)
    nerf = stage0.init_state(g, cfg, SPEC, device="cpu").params
    st = stage1.init_state(g, cfg, static, nerf, n_verts, device="cpu")
    return st._replace(params=st.params._replace(offsets=torch.randn((n_verts, 3), generator=g)))


def leaves(state):
    return ck.flatten_with_path(state)


def assert_equal_states(a, b):
    la, lb = leaves(a), leaves(b)
    assert [k for k, _ in la] == [k for k, _ in lb]
    for (k, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype and x.device == y.device, k
        assert torch.equal(x, y), k


class NumpyOnly(pickle.Unpickler):
    def find_class(self, module, name):
        if module.split(".")[0] not in ("numpy", "builtins", "collections", "copyreg"):
            raise pickle.UnpicklingError(f"{module}.{name}")
        return super().find_class(module, name)


@pytest.mark.parametrize("make", [stage0_state, stage1_state])
def test_round_trip(tmp_path, make):
    st = make(0)
    p = ck.save_checkpoint(str(tmp_path), "ngp", 1, 42, st, extra={"tracer_budgets": {"k": 2}})
    with open(p, "rb") as f:
        payload = NumpyOnly(io.BytesIO(f.read())).load()
    assert payload["step"] == 42 and payload["stage"] == 1
    assert set(payload["state"]) == {k for k, _ in leaves(st)}
    assert ".opt_state" in next(iter(k for k in payload["state"] if "opt_state" in k))
    got, step, extra = ck.load_checkpoint(p, make(5))
    assert step == 42 and extra == {"tracer_budgets": {"k": 2}}
    assert_equal_states(got, st)
    flat, _, _ = ck.load_checkpoint(p)
    for k, x in leaves(st):
        np.testing.assert_array_equal(flat[k], x.numpy())


def test_names_window_and_best_match_reference(tmp_path):
    st = stage0_state(0)
    tdir, jdir = tmp_path / "t", tmp_path / "j"
    for step in (10, 20, 30):
        ck.save_checkpoint(str(tdir), "ngp", 0, step, st)
        jck.save_checkpoint(str(jdir), "ngp", 0, step, {"x": np.zeros(2)})
    ck.save_checkpoint(str(tdir), "ngp", 0, 30, st, best=True)
    jck.save_checkpoint(str(jdir), "ngp", 0, 30, {"x": np.zeros(2)}, best=True)
    names = sorted(os.listdir(tdir / "checkpoints"))
    assert names == sorted(os.listdir(jdir / "checkpoints")) == [
        "ngp_stage0_0000020.pkl", "ngp_stage0_0000030.pkl", "ngp_stage0_best.pkl"]
    for which in ("latest", "best"):
        assert (os.path.basename(ck.find_checkpoint(str(tdir), "ngp", 0, which))
                == os.path.basename(jck.find_checkpoint(str(jdir), "ngp", 0, which)))
    assert ck.find_checkpoint(str(tdir), "ngp", 1) is None
    assert ck.find_checkpoint(str(tdir), "ngp", 1, "best") is None


def test_tolerant_restore(tmp_path, capsys):
    saved = stage1_state(0, n_verts=10)
    p = ck.save_checkpoint(str(tmp_path), "ngp", 1, 3, saved)
    # a refine changed the vertex count; the template has an extra leaf
    tmpl = stage1_state(1, n_verts=14)
    tmpl = tmpl._replace(params=tmpl.params._replace(
        mat={**tmpl.params.mat, "extra": torch.ones(2)}))
    got, step, _ = ck.load_checkpoint(p, tmpl)
    out = capsys.readouterr().out
    # the offsets and their two Adam moments
    assert "3 shape/dtype mismatches" in out and "1 leaves missing" in out
    assert torch.equal(got.params.offsets, tmpl.params.offsets)
    assert torch.equal(got.params.mat["extra"], tmpl.params.mat["extra"])
    assert torch.equal(got.params.env, saved.params.env)
    assert torch.equal(got.params.mat["encoder"], saved.params.mat["encoder"])
    for g in stage1.GROUPS:
        if g == "vert":     # the offsets' moments have the old shape too
            assert got.opt_state[g].mu[0].shape == (14, 3)
            continue
        for a, b in zip(got.opt_state[g].mu, saved.opt_state[g].mu):
            assert torch.equal(a, b)
    # a dtype change is a mismatch as well
    st0 = stage0_state(0)
    p0 = ck.save_checkpoint(str(tmp_path), "ngp", 0, 1, st0)
    tm0 = st0._replace(step=torch.tensor(0, dtype=torch.int64))
    got0, _, _ = ck.load_checkpoint(p0, tm0)
    assert got0.step.dtype == torch.int64 and int(got0.step) == 0


def test_metrics_writer_and_phase_timer(tmp_path):
    w = MetricsWriter(str(tmp_path / "m" / "metrics.jsonl"))
    w.write(100, loss=torch.tensor(0.5), it_per_s=3.25, note="x")
    w.write(200, psnr=np.float32(20.0))
    recs = [json.loads(x) for x in (tmp_path / "m" / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in recs] == [100, 200]
    assert recs[0]["loss"] == 0.5 and recs[0]["it_per_s"] == 3.25 and recs[0]["note"] == "x"
    assert recs[1]["psnr"] == 20.0 and all(r["t"] >= 0 for r in recs)
    timer = PhaseTimer()
    for _ in range(3):
        with timer.phase("a"):
            pass
    with timer.phase("b"):
        pass
    assert timer.counts == {"a": 3, "b": 1}
    assert "a:" in timer.summary() and "x3" in timer.summary()
