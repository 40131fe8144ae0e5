"""Stage 0's train step replayed from CUDA graphs (train/stage0_graph.py)
and what it stands on: the exclusive transmittance's autograd Function
(ops/marching.py), the scene box uploaded once per device, the in-place
Adam and EMA.

On the CPU:

- ``ExclusiveTransmittance``: the forward equals ``torch.cumprod`` of the
  shifted input, and the backward autograd of it, bit for bit, with and
  without exact zeros (an alpha of exactly 1) and behind composite's
  ``T_thresh`` cut.
- ``_aabb`` hands back one tensor per box and device, uploaded once.
- ``make_train_step`` keeps the eager step on the CPU, under data
  parallelism, with ``sdf``, with progressive levels and with a depth
  term; ``graphable`` holds for the published ``-O`` flags on a card.
- ``adam_ema_`` agrees with ``adam_update`` followed by the EMA.
- ``GraphedStep``'s data flow, its graphs faked by re-running the captured
  functions: 20 steps of a tiny trainer, with occupancy updates and a
  batch growth (a re-capture), against the eager step from the same seed.

On the card only (marked ``cuda``; without the suite's conftest:
``python -m pytest tests/test_torch_stage0_graph.py --noconftest -p
no:cacheprovider``): the graphed step against the eager step for 20 steps
with an occupancy update and a batch growth (first loss bit-equal, every
loss and the parameters, mu and nu within 1e-6, aux values not aliased,
the generator untouched by capture), and the transmittance's gradient
against autograd of ``torch.cumprod`` on the card, bit for bit.
"""

import contextlib
import functools

import pytest
import torch

from mirres_restir_nerf_mesh_torch.main import config_from_args
from mirres_restir_nerf_mesh_torch.ops import marching
from mirres_restir_nerf_mesh_torch.train import stage0, stage0_graph
from mirres_restir_nerf_mesh_torch.utils import profiling

from test_torch_profiling import STAGE0_ARGV, tiny_trainer

torch.set_num_threads(2)


def _shifted_cumprod(x):
    return torch.cumprod(torch.cat([torch.ones_like(x[:, :1]), x[:, :-1]], dim=-1), dim=-1)


def _one_minus_alpha(case, N=64, K=24, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.rand((N, K), generator=g, dtype=torch.float64).float()
    if case in ("zeros", "cut"):
        x[::3, 5] = 0.0                              # an alpha of exactly 1
        x[1::7, 0] = 0.0
        x[2::5, 9:11] = 0.0                          # two in a row
        x[4::9, K - 1] = 0.0
    if case == "cut":
        x = x * 0.2                                  # T falls below 1e-4 within a few samples
    return x


def _transmittance_grads(x, case):
    """(the Function's gradient, autograd of the shifted cumprod's) of x."""
    T = _shifted_cumprod(x)
    g = torch.randn(x.shape, generator=torch.Generator().manual_seed(1)).to(x.device)
    if case == "cut":
        g = torch.where(T >= 1e-4, g, 0.0)           # composite's T_thresh cut
    xa = x.clone().requires_grad_(True)
    (ref,) = torch.autograd.grad(_shifted_cumprod(xa), xa, g)
    xf = x.clone().requires_grad_(True)
    Tf = marching.ExclusiveTransmittance.apply(xf)
    assert torch.equal(Tf.detach(), T)
    (got,) = torch.autograd.grad(Tf, xf, g)
    return got, ref


@pytest.mark.parametrize("case", ["no_zeros", "zeros", "cut"])
def test_transmittance_matches_cumprod(case):
    got, ref = _transmittance_grads(_one_minus_alpha(case), case)
    assert torch.equal(got, ref)
    assert torch.all(got[:, -1] == 0)


def test_composite_backward_matches_cumprod_autograd():
    g = torch.Generator().manual_seed(2)
    sig = torch.rand((32, 16), generator=g) * 30
    sig[::4, 3] = 1e4                                # alpha exactly 1
    rgb, ts = torch.rand((32, 16, 3), generator=g), torch.rand((32, 16), generator=g)
    dts = torch.full((32, 16), 0.1)
    valid = torch.rand((32, 16), generator=g) > 0.2

    def loss(s, transmittance):
        alpha = torch.where(valid, 1.0 - torch.exp(-s * dts), 0.0)
        T = transmittance(1.0 - alpha)
        w = torch.where(T >= 1e-4, alpha * T, 0.0)
        return (w[..., None] * rgb).sum() + (w * ts).sum()

    a = sig.clone().requires_grad_(True)
    b = sig.clone().requires_grad_(True)
    (ga,) = torch.autograd.grad(loss(a, _shifted_cumprod), a)
    (gb,) = torch.autograd.grad(loss(b, marching.ExclusiveTransmittance.apply), b)
    assert torch.equal(ga, gb)
    out = marching.composite_rays(b, rgb, ts, dts, valid)
    assert torch.equal(out.weights, marching.composite_rays(a.detach(), rgb, ts, dts,
                                                            valid).weights)


def test_aabb_uploaded_once_per_box_and_device(monkeypatch):
    uploads = []
    monkeypatch.setattr(stage0, "count_upload", lambda site, dev, x=None: uploads.append(site))
    stage0._box_on.cache_clear()
    cfg = config_from_args(STAGE0_ARGV + ["--workspace", "unused"])
    a = stage0._aabb(cfg, "cpu")
    assert stage0._aabb(cfg, torch.device("cpu")) is a
    assert uploads == ["aabb"]
    assert a.tolist() == [-cfg.bound] * 3 + [cfg.bound] * 3
    cfg.scene_aabb = (-0.5, -0.5, -0.5, 0.5, 0.5, 0.5)
    b = stage0._aabb(cfg, "cpu")
    assert b is not a and b.tolist() == list(cfg.scene_aabb) and uploads == ["aabb", "aabb"]
    stage0._box_on.cache_clear()


class _CudaSampler:
    """What ``graphable`` reads of a sampler, on a card."""
    device = torch.device("cuda")
    depths = None
    sparse_coords = None


@pytest.mark.parametrize("what", ["cpu", "dp", "sdf", "progressive", "depth", "card"])
def test_eager_step_kept_where_the_graphs_cannot_serve(tmp_path, monkeypatch, what):
    t = tiny_trainer(str(tmp_path))
    cfg, sampler = t.cfg, _CudaSampler()
    if what == "cpu":
        step = stage0.make_train_step(cfg, t.nerf_spec, t.sampler)
        assert not isinstance(step, stage0_graph.GraphedStep)
        assert step.march_candidates == t.train_step.march_candidates
        assert not stage0_graph.graphable(cfg, t.sampler)
        return
    if what == "dp":
        # graphable or not, a step under data parallelism stays eager
        monkeypatch.setattr(stage0_graph, "graphable", lambda cfg, sampler: True)
        step = stage0.make_train_step(cfg, t.nerf_spec, t.sampler, dp=object())
        assert not isinstance(step, stage0_graph.GraphedStep)
        return
    if what == "sdf":
        cfg.sdf = True
    elif what == "progressive":
        cfg.progressive_level = True
    elif what == "depth":
        sampler.depths = torch.zeros(1)
    assert stage0_graph.graphable(cfg, sampler) == (what == "card")


def test_adam_ema_matches_adam_update():
    g = torch.Generator().manual_seed(3)
    shapes = [(40, 64), (7,), (300, 2), (64, 16)]
    params = [torch.randn(s, generator=g) for s in shapes]
    grads = [torch.randn(s, generator=g) * 1e-2 for s in shapes]
    mu = [torch.randn(s, generator=g) * 1e-3 for s in shapes]
    nu = [torch.rand(s, generator=g) * 1e-5 for s in shapes]
    ema = [p + 0.01 * torch.randn(s, generator=g) for p, s in zip(params, shapes)]
    st = stage0.AdamState(count=torch.tensor(41, dtype=torch.int32), mu=mu, nu=nu)
    lr = stage0.make_optimizer(stage0.Config(lr=1e-2, iters=1000)).lr
    new, st_new = stage0.adam_update(params, grads, st, lr, 1e-15)
    ema_new = [0.95 * e + 0.05 * p for e, p in zip(ema, new)]
    neg_lr, bc1, bc2, count = stage0.adam_scalars(st.count, lr)
    assert int(count) == int(st_new.count) == 42
    scalars = torch.tensor([neg_lr, 1.0 / bc1, 1.0 / bc2], dtype=torch.float32)
    P, M, V, E = ([x.clone() for x in xs] for xs in (params, mu, nu, ema))
    stage0_graph.adam_ema_(P, grads, M, V, E, scalars)
    for got, want in ((P, new), (M, st_new.mu), (V, st_new.nu), (E, ema_new)):
        for a, b in zip(got, want):
            assert torch.allclose(a, b, rtol=1e-6, atol=1e-12)
    assert all(torch.equal(a, b) for a, b in zip(M, st_new.mu))


# ------------------------------------------------- the graphed step, faked
class _FakeGraph:
    """A captured function re-run at each replay, its results copied into
    the outputs the capture handed out; the optimizer is not run at
    capture, as a capture runs nothing."""
    last = {}

    def __init__(self, fn, out):
        self.fn, self.out = fn, out

    def replay(self):
        fn = self.fn
        if isinstance(fn, functools.partial) and fn.func is torch.autograd.grad:
            new = torch.autograd.grad(_FakeGraph.last["loss"], *fn.args[1:])
        elif isinstance(fn, functools.partial) and fn.func is stage0_graph.adam_ema_:
            fn()
            return
        elif isinstance(fn, functools.partial):          # graph B forward
            with torch.enable_grad():
                new = fn()
            _FakeGraph.last["loss"] = new[0]
        else:                                            # graph A
            new = fn()
        _copy_into(self.out, new)


def _copy_into(dst, src):
    if isinstance(dst, torch.Tensor):
        with torch.no_grad():
            dst.copy_(src)
    elif isinstance(dst, dict):
        for k in dst:
            _copy_into(dst[k], src[k])
    elif isinstance(dst, (list, tuple)):
        for a, b in zip(dst, src):
            _copy_into(a, b)


def _fake_captured(fn, pool):
    if isinstance(fn, functools.partial) and fn.func is stage0_graph.adam_ema_:
        return _FakeGraph(fn, None), None
    out = fn()
    return _FakeGraph(fn, out), out


class _Ring:
    def put(self, dst, values):
        dst.copy_(torch.tensor([float(v) for v in values]))


class _Stream:
    def wait_stream(self, s):
        pass


def _run(t, steps, grow_at):
    auxes = []
    for i in range(steps):
        rand = t._stage0_randoms()
        if i % t.cfg.update_extra_interval == 0:
            t.state = t.occ_update(t.state, draws=t._occupancy_draws())
        t.state, aux = t.train_step(t.state, rand=rand)
        auxes.append(aux)
        if i == 0:
            gen = t.generator.get_state()
        if i == grow_at:
            assert t._adapt_num_rays(float(aux["num_points"]) / 4)
    return auxes, gen


def test_graphed_step_data_flow_against_eager(tmp_path, monkeypatch):
    eager = tiny_trainer(str(tmp_path / "eager"))
    e_aux, e_gen = _run(eager, 20, 9)
    sg = stage0_graph
    monkeypatch.setattr(sg, "_captured", _fake_captured)
    monkeypatch.setattr(sg, "_side_stream", lambda d: _Stream())
    monkeypatch.setattr(sg, "_ScalarRing", _Ring)
    monkeypatch.setattr(sg, "graphable", lambda cfg, sampler: True)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: _Stream())
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: None)
    before = profiling.counters()
    graphed = tiny_trainer(str(tmp_path / "graphed"))
    assert isinstance(graphed.train_step, sg.GraphedStep)
    g_aux, g_gen = _run(graphed, 20, 9)
    now = profiling.counters()
    delta = {k: now.get(k, 0) - before.get(k, 0) for k in
             ("graph.capture", "graph.stage0_step", "steps.stage0")}
    assert delta == {"graph.capture": 2, "graph.stage0_step": 20, "steps.stage0": 20}
    assert isinstance(graphed.train_step, sg.GraphedStep) and graphed.cfg.num_rays == 512
    assert torch.equal(e_gen, g_gen)
    assert torch.equal(eager.generator.get_state(), graphed.generator.get_state())
    assert float(e_aux[0]["loss"]) == float(g_aux[0]["loss"])
    for a, b in zip(e_aux, g_aux):
        for k in ("loss", "psnr", "num_points"):
            assert torch.allclose(a[k].double(), b[k].double(), rtol=1e-6), k
    assert len({float(x["loss"]) for x in g_aux}) == len(g_aux)
    L = stage0.tree_leaves
    for x, y in ((L(eager.state.params), L(graphed.state.params)),
                 (eager.state.opt_state.mu, graphed.state.opt_state.mu),
                 (eager.state.opt_state.nu, graphed.state.opt_state.nu),
                 (L(eager.state.ema_params), L(graphed.state.ema_params))):
        for a, b in zip(x, y):
            assert float(torch.linalg.vector_norm(a - b)) <= 1e-5 * float(
                torch.linalg.vector_norm(a)) + 1e-30
    assert int(graphed.state.opt_state.count) == int(graphed.state.step) == 20


# --------------------------------------------------------------- the card
@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from mirres_restir_nerf_mesh_torch import cuda_build

    cuda_build.build()
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["no_zeros", "zeros", "cut"])
def test_transmittance_matches_cumprod_on_the_card(dev, case):
    got, ref = _transmittance_grads(_one_minus_alpha(case, N=8192, K=64, seed=5).to(dev), case)
    assert torch.equal(got, ref)


def _rel(a, b):
    return float(torch.linalg.vector_norm((a - b).double())
                 / torch.linalg.vector_norm(a.double()).clamp_min(1e-30))


@pytest.mark.cuda
def test_graphed_step_matches_eager_on_the_card(dev, tmp_path, monkeypatch):
    monkeypatch.setattr(stage0_graph, "graphable", lambda cfg, sampler: False)
    eager = tiny_trainer(str(tmp_path / "eager"), device=dev, hw=64)
    assert not isinstance(eager.train_step, stage0_graph.GraphedStep)
    e_aux, e_gen = _run(eager, 20, 9)
    monkeypatch.undo()
    graphed = tiny_trainer(str(tmp_path / "graphed"), device=dev, hw=64)
    assert isinstance(graphed.train_step, stage0_graph.GraphedStep)
    before = profiling.counters()
    g_aux, g_gen = _run(graphed, 20, 9)
    now = profiling.counters()
    assert now.get("graph.capture", 0) - before.get("graph.capture", 0) == 2
    assert now.get("graph.stage0_step", 0) - before.get("graph.stage0_step", 0) == 20
    assert torch.equal(e_gen, g_gen)                     # capture draws nothing
    assert float(e_aux[0]["loss"]) == float(g_aux[0]["loss"])
    for a, b in zip(e_aux, g_aux):
        assert abs(float(a["loss"]) - float(b["loss"])) <= 1e-6 * abs(float(a["loss"]))
        assert int(a["num_points"]) == int(b["num_points"])
    ptrs = {x["loss"].data_ptr() for x in g_aux[-3:]}
    assert len(ptrs) == 3 and len({float(x["loss"]) for x in g_aux[-3:]}) == 3
    L = stage0.tree_leaves
    for name, x, y in (("params", L(eager.state.params), L(graphed.state.params)),
                       ("mu", eager.state.opt_state.mu, graphed.state.opt_state.mu),
                       ("nu", eager.state.opt_state.nu, graphed.state.opt_state.nu)):
        rel = [_rel(a, b) for a, b in zip(x, y)]
        print(f"{name}: relative gaps {rel}, bit-equal {[torch.equal(a, b) for a, b in zip(x, y)]}")
        assert max(rel) <= 1e-6
