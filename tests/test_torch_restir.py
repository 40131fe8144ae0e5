"""Port vs reference: each ReSTIR DI function (render/restir.py) on the same
numpy inputs with the reference's own draws injected.

Scene: a 16x16 pixel context made from a seed (surface points on a gently
bumped plane in front of the four-ball mesh, so neighbours pass the normal
and depth tests and shadow rays can hit), a sky + sun env, 4 light tiles of
32 drawn through the reference's sampler table.  Cross and winner
visibility use the dense tracer path of both packages.

Tolerances: reservoir directions equal (atol 1e-6) on >= 99.5% of pixels
(a pick whose stream sum rounds across its uniform can flip); where they
agree, W, M and p within rtol 1e-4 (the GGX cancellation of
tests/test_torch_light.py) and the validity and visibility masks equal.
Light tiles, records and final samples: rtol 1e-5 on 99.9% of entries, all
within 2e-4; the envmap gradient within 1e-5 relative L2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mirres_restir_nerf_mesh_tpu.models import envlight as jenv
from mirres_restir_nerf_mesh_tpu.ops import tracer as jtr
from mirres_restir_nerf_mesh_tpu.render import restir as jr
from mirres_restir_nerf_mesh_torch.models import envlight as tenv
from mirres_restir_nerf_mesh_torch.ops import tracer as ttr
from mirres_restir_nerf_mesh_torch.render import restir as tr_

from test_torch_helpers import TORCH_THREADS, assert_close_mostly, brdf_u_jax, n, t
from test_torch_light import sky_env
from test_torch_pathtracer import balls_mesh

torch.set_num_threads(TORCH_THREADS)

H = W = 16
P = H * W
T, S = 4, 32


@pytest.fixture(scope="module")
def scene():
    rng = np.random.RandomState(0)
    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    pos = np.stack([(xx - W / 2) * 0.05, (yy - H / 2) * 0.05,
                    -0.9 + 0.02 * np.sin(xx * 0.7) * np.cos(yy * 0.5)], -1).reshape(P, 3)
    nrm = np.array([0.0, 0.0, 1.0]) + rng.normal(size=(P, 3)) * 0.15
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    cam = np.array([0.0, 0.0, -3.0])
    vd = pos - cam
    vd /= np.linalg.norm(vd, axis=1, keepdims=True)
    vd = -vd                                  # looking along -z towards the +z-facing plane
    vd[:, 2] = -np.abs(vd[:, 2])
    fields = dict(
        position=pos, normal=nrm, view_dir=vd, kd=rng.rand(P, 3),
        roughness=rng.uniform(0.3, 1.0, P), metallic=rng.rand(P) * (rng.rand(P) < 0.5),
        mask=rng.rand(P) < 0.85, depth=np.linalg.norm(pos - cam, axis=1) * (1 + 0.01 * rng.rand(P)),
    )
    fields = {k: v.astype(bool if k == "mask" else np.float32) for k, v in fields.items()}
    env = sky_env(16, 32, seed=1)
    jdist = jenv.build_sampler(jnp.asarray(env))
    v, trs = balls_mesh(faces=1200)
    return dict(
        fields=fields, env=env,
        jctx=jr.PixelCtx(**{k: jnp.asarray(v_) for k, v_ in fields.items()}),
        tctx=tr_.PixelCtx(**{k: t(v_) for k, v_ in fields.items()}),
        # one sampler for both (build_sampler's own parity, a table entry off
        # by one count where the CDFs round apart, is tests/test_torch_light.py's)
        jdist=jdist, tdist=tenv.EnvSampler(table=t(jdist.table).long(), pdf=t(jdist.pdf)),
        jtracer=jtr.build_tracer(jnp.asarray(v), jnp.asarray(trs), kind="tile"),
        ttracer=ttr.build_tracer(t(v), t(trs)),
    )


def tiles_of(sc, key):
    u = jax.random.uniform(key, (T, S, 2))
    return (jr.generate_light_tiles(key, jnp.asarray(sc["env"]), sc["jdist"], T, S),
            tr_.generate_light_tiles(t(sc["env"]), sc["tdist"], T, S, t(u)))


def assert_reservoirs_match(ref, got, ref_vis=None, got_vis=None):
    d_ok = np.all(np.abs(n(got.dir) - np.asarray(ref.dir)) <= 1e-6, axis=-1)
    agree = d_ok & (n(got.valid) == np.asarray(ref.valid))
    assert agree.mean() >= 0.995, agree.mean()
    assert np.asarray(ref.valid).mean() > 0.2
    for f in ("W", "M", "p"):
        a = getattr(ref, f)
        if a is None:
            assert getattr(got, f) is None
            continue
        np.testing.assert_allclose(n(getattr(got, f))[agree], np.asarray(a)[agree], rtol=1e-4,
                                   atol=1e-7, err_msg=f)
    if ref_vis is not None:
        np.testing.assert_array_equal(n(got_vis)[agree], np.asarray(ref_vis)[agree])


def test_generate_light_tiles(scene):
    ref, got = tiles_of(scene, jax.random.PRNGKey(1))
    for f in ("dirs", "le", "pdf"):
        assert_close_mostly(n(getattr(got, f)), np.asarray(getattr(ref, f)))
    # nearest-texel Le: the value eval_le_nearest returns for the same direction
    # (up to texel-boundary roundtrips)
    le_back = n(tenv.eval_le_nearest(t(scene["env"]), got.dirs.reshape(-1, 3)))
    assert (np.abs(le_back - n(got.le).reshape(-1, 3)).max(-1) < 1e-6).mean() >= 0.99


def test_eval_le_nearest(scene):
    d = np.random.RandomState(3).normal(size=(4096, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[:2] = [[0, 1, 0], [0, -1, 0]]
    ref = jenv.eval_le_nearest(jnp.asarray(scene["env"]), jnp.asarray(d))
    got = tenv.eval_le_nearest(t(scene["env"]), t(d))
    assert (np.abs(n(got) - np.asarray(ref)).max(-1) == 0).mean() >= 0.999


@pytest.mark.parametrize("visibility", [False, True])
def test_initial_resampling_fast_path(scene, visibility):
    jt, tt = tiles_of(scene, jax.random.PRNGKey(2))
    nl, nb = 8, 1
    k = jax.random.split(jax.random.PRNGKey(3), 4)
    tile_id = jax.random.randint(k[0], (P,), 0, T)
    blk = jax.random.randint(k[1], (P,), 0, S // nl)
    us = jax.random.uniform(k[2], (1 + nb, P))
    bu = brdf_u_jax(k[3], P)
    ref = jr.initial_resampling(k[0], scene["jctx"], jt, jnp.asarray(scene["env"]), scene["jdist"],
                                scene["jtracer"] if visibility else None, nl, nb,
                                check_visibility=visibility, rand=(tile_id, blk, us, [bu]))
    got = tr_.initial_resampling(
        scene["tctx"], tt, t(scene["env"]), scene["tdist"],
        scene["ttracer"] if visibility else None, nl, nb, check_visibility=visibility,
        rand=tr_.InitialRandoms(t(tile_id), t(blk), t(us), [tuple(t(x) for x in bu)]))
    assert_reservoirs_match(ref, got)


def test_initial_resampling_slow_path(scene):
    """tile_size % n_light_samples != 0: the strided walk, streamed one
    candidate at a time; the draws the reference makes from its key."""
    jt, tt = tiles_of(scene, jax.random.PRNGKey(4))
    nl, nb = 6, 1
    key = jax.random.PRNGKey(5)
    ref = jr.initial_resampling(key, scene["jctx"], jt, jnp.asarray(scene["env"]), scene["jdist"],
                                None, nl, nb, check_visibility=False)
    k_tile, k_off, k_u, k_brdf, _ = jax.random.split(key, 5)
    rand = tr_.InitialRandoms(
        tile_id=t(jax.random.randint(k_tile, (P,), 0, T)),
        blk=t(jax.random.randint(k_off, (P,), 0, S)),
        us=t(jax.random.uniform(k_u, (nl + nb, P))),
        brdf_us=[tuple(t(x) for x in brdf_u_jax(jax.random.fold_in(k_brdf, 0), P))],
        stride=t(1 + 2 * jax.random.randint(jax.random.fold_in(k_off, 1), (P,), 0, S // 2)))
    got = tr_.initial_resampling(scene["tctx"], tt, t(scene["env"]), scene["tdist"], None, nl, nb,
                                 check_visibility=False, rand=rand)
    assert_reservoirs_match(ref, got)


def reservoir_pair(seed, p=True, dirs=None):
    """(jax Reservoir, torch Reservoir) of random winners; `dirs` [k,3]
    draws the directions from a small set (so neighbours share them)."""
    rng = np.random.RandomState(seed)
    if dirs is None:
        d = rng.normal(size=(P, 3)) + np.array([0.0, 0.0, 1.5])
        d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    else:
        d = dirs[rng.randint(0, len(dirs), P)]
    valid = rng.rand(P) < 0.8
    f = dict(dir=d, W=np.where(valid, rng.gamma(2.0, 1.0, P), 0).astype(np.float32),
             M=rng.randint(1, 30, P).astype(np.float32), valid=valid,
             p=(np.where(valid, rng.gamma(2.0, 0.5, P), 0).astype(np.float32) if p else None))
    return (jr.Reservoir(**{k: None if v is None else jnp.asarray(v) for k, v in f.items()}),
            tr_.Reservoir(**{k: None if v is None else t(v) for k, v in f.items()}))


@pytest.mark.parametrize("threaded", [False, True])
def test_temporal_resampling(scene, threaded):
    jc, tc = reservoir_pair(10, p=threaded)
    jp, tp = reservoir_pair(11, p=threaded)
    jc = jc._replace(M=jnp.ones((P,)))
    tc = tc._replace(M=torch.ones((P,)))
    u = np.random.RandomState(12).rand(P).astype(np.float32)
    vis = np.random.RandomState(13).rand(2, P) < 0.7
    ctx_j, ctx_t = scene["jctx"], scene["tctx"]
    kw_j = dict(v_curr=jnp.asarray(vis[0]), v_prev=jnp.asarray(vis[1])) if threaded else {}
    kw_t = dict(v_curr=t(vis[0]), v_prev=t(vis[1])) if threaded else {}
    ref = jr.temporal_resampling(jax.random.PRNGKey(0), ctx_j, jc, jp, ctx_j.normal, ctx_j.depth,
                                 jnp.asarray(scene["env"]), u=jnp.asarray(u), **kw_j)
    got = tr_.temporal_resampling(ctx_t, tc, tp, ctx_t.normal, ctx_t.depth, t(scene["env"]),
                                  t(u), **kw_t)
    if threaded:
        assert_reservoirs_match(ref[0], got[0], ref[1], got[1])
    else:
        assert_reservoirs_match(ref, got)


def test_pack_spatial_record(scene):
    jres, tres = reservoir_pair(20, p=False)
    v_self = np.random.RandomState(21).rand(P) < 0.6
    ref = jr.pack_spatial_record(scene["jctx"], jres, jnp.asarray(v_self),
                                 env_tex=jnp.asarray(scene["env"]))
    got = tr_.pack_spatial_record(scene["tctx"], tres, t(v_self), env_tex=t(scene["env"]))
    assert got.shape == ref.shape == (P, 39)
    assert_close_mostly(n(got), np.asarray(ref), rtol=1e-4, rtol_all=1e-3)
    np.testing.assert_array_equal(n(got)[:, 16:19], np.asarray(ref)[:, 16:19])   # dirs, bitwise


@pytest.mark.parametrize("mode", ["unbiased_v_self", "unbiased", "biased"])
def test_spatial_resampling(scene, mode):
    rng = np.random.RandomState(30)
    dirs = rng.normal(size=(3, 3)) + np.array([0.0, 0.0, 1.2])
    dirs = (dirs / np.linalg.norm(dirs, axis=1, keepdims=True)).astype(np.float32)
    jres, tres = reservoir_pair(31, p=True, dirs=dirs)   # three directions: the dedup fires
    v_self = rng.rand(P) < 0.7
    k1, k2 = jax.random.split(jax.random.PRNGKey(33))
    # make_neighbor_offsets from the reference's own uniforms; the spatial
    # pass below then takes the reference's offsets bit for bit (an ulp can
    # move the int truncation of a neighbour offset)
    offsets_j = jr.make_neighbor_offsets(jax.random.PRNGKey(34), 64, 5.0)
    k_a, k_b = jax.random.split(jax.random.PRNGKey(34))
    offs_u = np.stack([np.asarray(jax.random.uniform(k_a, (64,))),
                       np.asarray(jax.random.uniform(k_b, (64,)))], -1)
    np.testing.assert_allclose(n(tr_.make_neighbor_offsets(t(offs_u), 5.0)), np.asarray(offsets_j),
                               rtol=1e-5, atol=1e-5)
    start = jax.random.randint(k1, (P,), 0, 64)
    us = jax.random.uniform(k2, (6, P))
    unbiased = mode != "biased"
    with_v = mode == "unbiased_v_self"
    kw_j = dict(v_self=jnp.asarray(v_self)) if with_v else {}
    kw_t = dict(v_self=t(v_self)) if with_v else {}
    scene["jtracer"].pop_traced()
    scene["ttracer"].pop_traced()
    ref = jr.spatial_resampling(jax.random.PRNGKey(0), scene["jctx"], jres, jnp.asarray(scene["env"]), H, W,
                                offsets_j, tracer=scene["jtracer"], n_neighbors=5,
                                unbiased=unbiased, rand=(start, us), **kw_j)
    got = tr_.spatial_resampling(scene["tctx"], tres, t(scene["env"]), H, W, t(offsets_j),
                                 (t(start), t(us)), tracer=scene["ttracer"], n_neighbors=5,
                                 unbiased=unbiased, **kw_t)
    traced_j = float(scene["jtracer"].pop_traced())
    traced_t = float(scene["ttracer"].pop_traced())
    assert traced_t == traced_j
    if with_v:
        assert_reservoirs_match(ref[0], got[0], ref[1], got[1])
        # the dedup fired: fewer rays than the 2 * P * nn pairs without it
        full = 2 * P * 5
        assert 0 < traced_j < 0.8 * full
    else:
        assert_reservoirs_match(ref, got)
        assert traced_j > 0 if unbiased else traced_j == 0


@pytest.mark.parametrize("known", [False, True])
def test_evaluate_final_samples_and_env_grad(scene, known):
    jres, tres = reservoir_pair(40)
    vis = np.random.RandomState(41).rand(P) < 0.7
    env = scene["env"]
    cot = np.random.RandomState(42).normal(size=(P, 3)).astype(np.float32)

    def f_j(e):
        ls = jr.evaluate_final_samples(scene["jctx"], jres, e, scene["jtracer"],
                                       known_vis=jnp.asarray(vis) if known else None)
        return jnp.sum(ls.Li * cot), ls

    (_, ls_j), g_j = jax.value_and_grad(f_j, has_aux=True)(jnp.asarray(env))
    et = t(env).requires_grad_(True)
    ls_t = tr_.evaluate_final_samples(scene["tctx"], tres, et, scene["ttracer"],
                                      known_vis=t(vis) if known else None)
    (g_t,) = torch.autograd.grad(torch.sum(ls_t.Li * t(cot)), et)
    np.testing.assert_array_equal(n(ls_t.distance), np.asarray(ls_j.distance))
    assert_close_mostly(n(ls_t.Li), np.asarray(ls_j.Li))
    g_j = np.asarray(g_j, np.float64)
    assert np.linalg.norm(n(g_t) - g_j) <= 1e-5 * np.linalg.norm(g_j)
