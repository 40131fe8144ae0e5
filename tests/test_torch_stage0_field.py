"""Port vs reference: the stage-0 field and volume renderer in fp32.

Tiny field (8 levels of 2^15, hidden 32); weights from the reference's
``init_nerf`` with the tables scaled up so the field is not flat.

- ``forward`` (exact and one-corner encode with the reference's own draws,
  with ``max_level``): sigma and rgb within 1e-5 relative.
- ``normal_autodiff`` within 1e-5 relative; ``normal_fd`` within 1e-5 of
  the largest |sigma| / epsilon (a central difference over epsilon 1e-4
  divides two fp32 roundings of sigma by 2e-4); ``neus_alpha`` within 1e-5.
- ``trunc_exp``: forward and the clamped gradient within 1e-6 relative.
- ``hashgrid_tv_loss``: loss within 1e-5 relative and the table gradient
  within 1e-5 relative L2 (the same sums in another order), taken by one
  scatter-add (one ``GatherRows`` over [P, 4L] rows).  At the cell's grid
  (16 levels of 2^19, dense and hashed levels) against the loss formed
  level by level: its rows equal bit for bit for points inside the box,
  on its faces and outside it, the loss within 1e-6 relative and the
  gradient within 1e-6 relative L2; its forward and backward dispatch as
  many top-level operators at 4 levels as at 16, at most 40.
- ``render_rays``: image, depth, weights_sum, weights within 1e-5 relative
  (atol 1e-6), masks equal: plain, perturbed with the cross-ray compaction
  under and over the point budget and the stochastic encode, and SDF mode
  (normal and sdf too), whose eikonal-style loss on the autograd normal
  has its params gradient within 1e-4 relative L2 of the reference's (the
  table's gradient through the normal is first order, which
  ``GatherRows``'s plain backward gives).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.compilation_cache import compilation_cache

from mirres_restir_nerf_mesh_tpu.models import nerf as jnerf
from mirres_restir_nerf_mesh_tpu.ops import hashgrid as jhg
from mirres_restir_nerf_mesh_tpu.render import volume as jvol
from mirres_restir_nerf_mesh_tpu.utils.math import trunc_exp as j_trunc_exp
from mirres_restir_nerf_mesh_torch.models import nerf as tnerf
from mirres_restir_nerf_mesh_torch.ops import hashgrid as thg
from mirres_restir_nerf_mesh_torch.render import volume as tvol
from mirres_restir_nerf_mesh_torch.train.stage0 import tree_leaves, tree_unflatten
from mirres_restir_nerf_mesh_torch.utils.math import trunc_exp as t_trunc_exp

from test_torch_helpers import (TORCH_THREADS, hashgrid_level_meta, hashgrid_level_rows, n,
                                stage0_spec_kwargs, t)

torch.set_num_threads(TORCH_THREADS)


@pytest.fixture(autouse=True)
def pinned_rounding():
    """Each comparison runs with torch on one intra-op thread, the calling
    thread, and with XLA's persistent compile cache off, so both sides round
    the same way in every worker and every run.  One thread: the rows an
    OpenMP worker thread computes can follow state it took from the process
    when it was made (a rounding mode it inherits moves exactly those rows);
    in one xdist worker the forward's last rows came out ~1e-6 lower, 4 of
    3,000 sigmas 1.3e-5 off, its first rows bit for bit as in a fresh
    process.
    The cache: an executable from it may have been compiled by another
    process, on another host's CPU (it lives in the working tree); JAX
    decides once per process whether to use it, so the switch is followed
    by ``reset_cache`` each way."""
    threads, cache = torch.get_num_threads(), jax.config.jax_enable_compilation_cache
    torch.set_num_threads(1)
    jax.config.update("jax_enable_compilation_cache", False)
    compilation_cache.reset_cache()
    yield
    jax.config.update("jax_enable_compilation_cache", cache)
    compilation_cache.reset_cache()
    torch.set_num_threads(threads)


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def field_case(sdf=False, seed=0):
    kw = stage0_spec_kwargs()
    jspec, tspec = jnerf.NeRFSpec(bound=1.0, sdf=sdf, **kw), tnerf.NeRFSpec(bound=1.0, sdf=sdf, **kw)
    jp = jnerf.init_nerf(jax.random.PRNGKey(seed), jspec)
    jp = {**jp, "encoder": jp["encoder"] * 3e3}
    tp = jax.tree.map(lambda x: t(np.asarray(x, np.float32)), jp)
    return jspec, tspec, jp, tp


def points(P, seed):
    rng = np.random.RandomState(seed)
    x = rng.uniform(-0.9, 0.9, (P, 3)).astype(np.float32)
    d = rng.normal(size=(P, 3)).astype(np.float32)
    return x, (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("stochastic,max_level", [(False, None), (True, None), (False, 5),
                                                  (True, 3)])
def test_forward_matches_reference(stochastic, max_level):
    jspec, tspec, jp, tp = field_case()
    x, d = points(3000, 1)
    key = jax.random.PRNGKey(2) if stochastic else None
    u = t(jax.random.uniform(key, (3000, 3))) if stochastic else None
    ml = None if max_level is None else jnp.asarray(max_level, jnp.int32)
    js, jr = jnerf.forward(jp, jnp.asarray(x), jnp.asarray(d), jspec, max_level=ml,
                           stochastic_key=key)
    ts, tr = tnerf.forward(tp, t(x), t(d), tspec, max_level=max_level, stochastic_u=u)
    np.testing.assert_allclose(n(ts), np.asarray(js), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(n(tr), np.asarray(jr), rtol=1e-5, atol=1e-6)


def test_normals_and_neus_alpha_match_reference():
    jspec, tspec, jp, tp = field_case(sdf=True)
    x, d = points(2000, 3)
    ja = jnerf.normal_autodiff(jp, jnp.asarray(x), jspec)
    ta = tnerf.normal_autodiff(tp, t(x), tspec)
    np.testing.assert_allclose(n(ta), np.asarray(ja), rtol=1e-5, atol=1e-5 * np.abs(ja).max())
    jf = jnerf.normal_fd(jp, jnp.asarray(x), jspec)
    tf = tnerf.normal_fd(tp, t(x), tspec)
    sig_max = float(np.abs(np.asarray(jnerf.density(jp, jnp.asarray(x), jspec)["sigma"])).max())
    np.testing.assert_allclose(n(tf), np.asarray(jf), rtol=0, atol=1e-5 * sig_max / 1e-4)
    rng = np.random.RandomState(4)
    sdf = rng.normal(scale=0.05, size=2000).astype(np.float32)
    dts = rng.uniform(0.005, 0.03, 2000).astype(np.float32)
    for ratio in (0.3, 1.0):
        ref = jnerf.neus_alpha(jnp.asarray(sdf), jp["variance"], ja, jnp.asarray(d),
                               jnp.asarray(dts), cos_anneal_ratio=ratio)
        got = tnerf.neus_alpha(t(sdf), tp["variance"], t(np.asarray(ja)), t(d), t(dts),
                               cos_anneal_ratio=ratio)
        np.testing.assert_allclose(n(got), np.asarray(ref), rtol=1e-5, atol=1e-6)


def test_trunc_exp_gradient_is_clamped():
    x = np.linspace(-30, 30, 301).astype(np.float32)
    w = np.random.RandomState(5).normal(size=301).astype(np.float32)
    jv, jg = jax.value_and_grad(lambda v: jnp.sum(j_trunc_exp(v) * w))(jnp.asarray(x))
    xt = t(x).requires_grad_(True)
    tv = torch.sum(t_trunc_exp(xt) * t(w))
    (tg,) = torch.autograd.grad(tv, xt)
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-6)
    np.testing.assert_allclose(n(tg), np.asarray(jg), rtol=1e-6)
    assert abs(float(tg[-1]) - w[-1] * np.exp(np.float32(15.0))) <= 1e-6 * abs(float(tg[-1]))


def test_tv_loss_and_its_gradient_match_reference(monkeypatch):
    _, tspec, jp, tp = field_case()
    spec = tspec.grid
    x, _ = points(5000, 6)               # more than the 4096-point prefix
    jl, jg = jax.value_and_grad(lambda e: jhg.hashgrid_tv_loss(e, jnp.asarray(x),
                                                               jnerf.NeRFSpec(
                                                                   bound=1.0,
                                                                   **stage0_spec_kwargs()).grid,
                                                               1.0))(jp["encoder"])
    calls = []
    orig = thg.scatter_add

    def counting(idx, upd, rows):
        calls.append(tuple(idx.shape))
        return orig(idx, upd, rows)

    monkeypatch.setattr(thg, "scatter_add", counting)
    emb = tp["encoder"].clone().requires_grad_(True)
    tl = thg.hashgrid_tv_loss(emb, t(x), spec, 1.0)
    (tg,) = torch.autograd.grad(tl, emb)
    assert calls == [(4096, 4 * spec.num_levels)]
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    assert rel_l2(n(tg), jg) < 1e-5


# the cell's hash grid: 16 levels of 2^19, levels 0-4 dense, 5-15 hashed
CELL_GRID = thg.HashGridSpec(num_levels=16, log2_hashmap_size=19, desired_resolution=2048)


def tv_rows_per_level(x, spec, bound=1.0):
    """The TV loss's rows as a loop over the levels forms them, each level's
    layout and row formula written out in the tests: the batched
    ``tv_rows``'s yardstick."""
    x01 = torch.clamp((x + bound) / (2.0 * bound), 0.0, 1.0)
    offsets, scales, resolutions, dense = hashgrid_level_meta(spec)
    steps = torch.tensor([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]])
    cols = []
    for lvl in range(spec.num_levels):
        size = int(offsets[lvl + 1] - offsets[lvl])
        pg = torch.floor(x01 * float(scales[lvl]) + 0.5).to(torch.int64)
        pgc = pg[:, None, :] + steps[None]                                  # [P,4,3]
        cols.append(int(offsets[lvl]) +
                    hashgrid_level_rows(pgc, bool(dense[lvl]), int(resolutions[lvl]), size))
    return torch.cat(cols, dim=1).to(torch.int32)


def tv_loss_per_level(embeddings, x, spec, bound=1.0, max_points=4096):
    """The TV loss as a sum of one mean per level and axis."""
    x = x[:max_points]
    vals = thg.GatherRows.apply(embeddings, tv_rows_per_level(x, spec, bound))
    total = torch.zeros((), dtype=torch.float32)
    for lvl in range(spec.num_levels):
        base = vals[:, 4 * lvl]
        for d in range(1, 4):
            total = total + torch.mean((vals[:, 4 * lvl + d] - base) ** 2)
    return total


def tv_points(where, P=5000, seed=8):
    """Points inside the box, on its faces (each point on one or more
    faces) or partly outside it."""
    rng = np.random.RandomState(seed)
    x = rng.uniform(-1.0, 1.0, (P, 3)).astype(np.float32)
    if where == "faces":
        on = rng.rand(P, 3) < 0.5
        x = np.where(on, np.sign(x), x).astype(np.float32)
    elif where == "outside":
        x = rng.uniform(-1.5, 1.5, (P, 3)).astype(np.float32)
    return t(x)


@pytest.mark.parametrize("where", ["inside", "faces", "outside"])
def test_tv_rows_equal_the_per_level_loop(where):
    offsets, dense = CELL_GRID.layout.offsets, CELL_GRID.layout.dense
    assert dense.any() and not dense.all()
    x = tv_points(where)
    rows = thg.tv_rows(x, CELL_GRID)
    assert rows.dtype == torch.int32 and rows.shape == (5000, 4 * CELL_GRID.num_levels)
    assert torch.equal(rows, tv_rows_per_level(x, CELL_GRID))
    assert int(rows.min()) >= 0 and int(rows.max()) < int(offsets[-1])


def test_tv_loss_and_its_gradient_equal_the_per_level_loop():
    x = torch.cat([tv_points("inside", 2000), tv_points("faces", 1500, 9),
                   tv_points("outside", 1500, 10)])
    g = torch.Generator().manual_seed(3)
    emb = thg.init_hashgrid(g, CELL_GRID, std=0.1, device="cpu")
    got, ref = emb.clone().requires_grad_(True), emb.clone().requires_grad_(True)
    tl = thg.hashgrid_tv_loss(got, x, CELL_GRID)
    rl = tv_loss_per_level(ref, x, CELL_GRID)
    (tg,) = torch.autograd.grad(tl, got)
    (rg,) = torch.autograd.grad(rl, ref)
    np.testing.assert_allclose(float(tl), float(rl), rtol=1e-6)
    assert rel_l2(n(tg), n(rg)) < 1e-6


def dispatched_ops(fn):
    """The top-level aten operators fn dispatches, in order: operators not
    called from inside another.  The table gradient's scatter-add counts as
    one, as on the card, where ``scatter_add`` dispatches one ``zeros`` and
    launches K4; on the CPU it runs the plain version's operators."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    names = []
    for ev in prof.events():
        p, inner = ev.cpu_parent, False
        while p is not None and not inner:
            inner = p.name.startswith("aten::") or p.name == "scatter_add"
            p = p.cpu_parent
        if not inner and (ev.name.startswith("aten::") or ev.name == "scatter_add"):
            names.append(ev.name)
    return names


def test_tv_loss_operator_count_does_not_grow_with_levels(monkeypatch):
    orig = thg.scatter_add

    def ranged(*args):
        with torch.profiler.record_function("scatter_add"):
            return orig(*args)

    monkeypatch.setattr(thg, "scatter_add", ranged)
    x, seed = tv_points("inside", 4096), torch.ones(())
    counts = {}
    for levels in (4, 16):
        spec = thg.HashGridSpec(num_levels=levels, log2_hashmap_size=19, desired_resolution=2048)
        emb = torch.zeros((spec.n_params, 2), requires_grad=True)

        def step():
            torch.autograd.grad(thg.hashgrid_tv_loss(emb, x, spec), emb, seed)

        step()                  # the per-level constants are made once per spec and device
        ops = dispatched_ops(step)
        assert ops.count("scatter_add") == 1
        counts[levels] = len(ops)
    assert counts[4] == counts[16] <= 40, counts


def render_case(sdf=False):
    jspec, tspec, jp, tp = field_case(sdf=sdf)
    from mirres_restir_nerf_mesh_tpu.data.provider import RayDataset
    from mirres_restir_nerf_mesh_tpu.data.synthetic import make_synthetic_dataset

    f = RayDataset(make_synthetic_dataset(n_frames=1, H=16, W=16, bound=1.0), 1.0).frame_rays(0)
    occ = (np.random.RandomState(7).rand(1, 32, 32, 32) < 0.4).astype(np.uint8)
    aabb = np.array([-1, -1, -1, 1, 1, 1], np.float32)
    return jspec, tspec, jp, tp, np.asarray(f["rays_o"]), np.asarray(f["rays_d"]), occ, aabb


def compare_render(got, ref, keys=("image", "depth", "weights_sum", "weights", "sigmas")):
    np.testing.assert_array_equal(n(got["valid"]), np.asarray(ref["valid"]))
    assert int(got["num_points"]) == int(ref["num_points"])
    for k in keys:
        np.testing.assert_allclose(n(got[k]), np.asarray(ref[k]), rtol=1e-5, atol=1e-6,
                                   err_msg=k)


@pytest.mark.parametrize("mode", ["plain", "compact_under", "compact_over"])
def test_render_rays_matches_reference(mode):
    jspec, tspec, jp, tp, o, d, occ, aabb = render_case()
    N, K = o.shape[0], 24
    common = dict(K=K, max_steps=128, bg_color=None)
    jkw, tkw = dict(common), dict(common)
    if mode != "plain":
        k_p, k_s = jax.random.split(jax.random.PRNGKey(8))
        # the valid count of this march is ~2,600 of 6,144 lattice samples
        M = 1024 if mode == "compact_under" else 4096
        jkw.update(perturb_key=k_p, stochastic_key=k_s, compact_points=M)
        P = tvol.field_points(N, K, M)
        tkw.update(noise=t(jax.random.uniform(k_p, (N,))), compact_points=M,
                   stochastic_u=t(jax.random.uniform(k_s, (P, 3))))
    ref = jvol.render_rays(jp, jnp.asarray(occ), jnp.asarray(o), jnp.asarray(d), jspec,
                           jnp.asarray(aabb), **jkw)
    got = tvol.render_rays(tp, t(occ), t(o), t(d), tspec, t(aabb), **tkw)
    nv = int(ref["num_points"])
    if mode == "compact_under":
        assert nv > 1024
    if mode == "compact_over":
        assert nv < 4096
    compare_render(got, ref)


def test_render_rays_field_chunk_is_exact():
    _, tspec, _, tp, o, d, occ, aabb = render_case()
    full = tvol.render_rays(tp, t(occ), t(o), t(d), tspec, t(aabb), K=24, max_steps=128)
    part = tvol.render_rays(tp, t(occ), t(o), t(d), tspec, t(aabb), K=24, max_steps=128,
                            field_chunk=1000)
    for k in ("image", "depth", "weights"):
        np.testing.assert_allclose(n(part[k]), n(full[k]), rtol=1e-6, atol=1e-7)


def test_render_rays_sdf_and_its_eikonal_gradient_match_reference():
    jspec, tspec, jp, tp, o, d, occ, aabb = render_case(sdf=True)
    kw = dict(K=16, max_steps=128, cos_anneal_ratio=0.5)

    def jloss(p):
        out = jvol.render_rays(p, jnp.asarray(occ), jnp.asarray(o), jnp.asarray(d), jspec,
                               jnp.asarray(aabb), **kw)
        eik = jnp.mean((jnp.linalg.norm(out["normal"], axis=-1) - 1.0) ** 2)
        return jnp.mean(out["image"]) + 0.1 * eik, out

    (_, ref), jg = jax.value_and_grad(jloss, has_aux=True)(jp)
    leaves = [x.clone().requires_grad_(True) for x in tree_leaves(tp)]
    p = tree_unflatten(tp, iter(leaves))
    got = tvol.render_rays(p, t(occ), t(o), t(d), tspec, t(aabb), **kw)
    eik = torch.mean((torch.linalg.norm(got["normal"], dim=-1) - 1.0) ** 2)
    tg = torch.autograd.grad(torch.mean(got["image"]) + 0.1 * eik, leaves)
    compare_render(got, ref, keys=("image", "depth", "weights_sum", "weights", "sdf"))
    np.testing.assert_allclose(n(got["normal"]), np.asarray(ref["normal"]), rtol=1e-5,
                               atol=1e-5 * float(np.abs(np.asarray(ref["normal"])).max()))
    for a, b in zip(tg, jax.tree.leaves(jg)):
        assert rel_l2(n(a), b) < 1e-4
