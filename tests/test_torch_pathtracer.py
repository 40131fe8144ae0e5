"""Port vs reference: the path tracer's random-consuming passes with the
reference's own draws injected (sample_direct_mis, trace_bounce,
render_indirect), plus masked_apply.

Scene: four touching balls (so bounces hit the mesh again) on the dense
path, a sky + sun env.  Tolerances: visibility and validity masks agree on
>= 99.9% of lanes; where they agree, 99.5% of radiance values within atol
1e-4 + rtol 1e-4 and all within rtol 1e-2: MIS weights of glossy samples
carry the GGX-peak conditioning of tests/test_torch_light.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mirres_restir_nerf_mesh_tpu.export.meshops import decimate, marching_tets
from mirres_restir_nerf_mesh_tpu.models import envlight as jenv
from mirres_restir_nerf_mesh_tpu.models import material as jmat
from mirres_restir_nerf_mesh_tpu.ops import tracer as jtr
from mirres_restir_nerf_mesh_tpu.render import pathtracer as jpt
from mirres_restir_nerf_mesh_torch.convert import params_from_jax
from mirres_restir_nerf_mesh_torch.models import envlight as tenv
from mirres_restir_nerf_mesh_torch.models import material as tmat
from mirres_restir_nerf_mesh_torch.ops import tracer as ttr
from mirres_restir_nerf_mesh_torch.render import pathtracer as tpt
from mirres_restir_nerf_mesh_torch.utils.compact import masked_apply

from test_torch_helpers import (TORCH_THREADS, assert_close_mostly, bounce_u_jax, brdf_u_cols, brdf_u_jax,
                                indirect_u_jax, n, t, tree_np)
from test_torch_light import sky_env

torch.set_num_threads(TORCH_THREADS)


def balls_mesh(res=40, faces=2000):
    ax = np.linspace(-1, 1, res, dtype=np.float32)
    X, Y, Z = np.meshgrid(ax, ax, ax, indexing="ij")
    centers = [(-0.42, -0.2, 0.0), (0.42, -0.2, 0.0), (0.0, 0.45, -0.1), (0.0, -0.1, 0.5)]
    field = np.max([0.36 - np.sqrt((X - a) ** 2 + (Y - b) ** 2 + (Z - c) ** 2)
                    for a, b, c in centers], axis=0)
    v, tr = marching_tets(field, 0.0, origin=(-1, -1, -1), spacing=(2 / (res - 1),) * 3)
    return decimate(v, tr, faces)


@pytest.fixture(scope="module")
def scene():
    v, tr = balls_mesh()
    key = jax.random.PRNGKey(0)
    mspec_j = jmat.MaterialSpec(bound=1.0)
    mat = jmat.init_material(key, mspec_j)
    mat = {**mat, "encoder": mat["encoder"] * 1e3}
    env = sky_env(16, 32, seed=1)
    p = params_from_jax({}, tree_np(mat), env, np.zeros((1, 3), np.float32), device="cpu")
    jt = jtr.build_tracer(jnp.asarray(v), jnp.asarray(tr), kind="tile")
    tt = ttr.build_tracer(t(v), t(tr))
    # surface points seen from outside, normals from the face hit
    rng = np.random.RandomState(3)
    N = 2048
    o = rng.normal(size=(N, 3)).astype(np.float32)
    o = o / np.linalg.norm(o, axis=1, keepdims=True) * 2.0
    d = rng.normal(size=(N, 3)).astype(np.float32) * 0.3 - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    hit = tt.intersect(t(o), t(d))
    mask = n(hit.prim) >= 0
    pos = (o + d * np.where(mask, n(hit.t), 0.0)[:, None]).astype(np.float32)
    nrm = n(hit.normal)
    nrm = nrm / np.maximum(np.linalg.norm(nrm, axis=1, keepdims=True), 1e-12)
    nrm = np.where((nrm * d).sum(1, keepdims=True) > 0, -nrm, nrm).astype(np.float32)
    nrm[~mask] = [0, 0, 1]
    kd = rng.rand(N, 3).astype(np.float32)
    rough = rng.uniform(0.08, 1.0, N).astype(np.float32)
    metal = (rng.rand(N) * (rng.rand(N) < 0.3)).astype(np.float32)
    surf = dict(mask=mask, pos=pos, nrm=nrm, vd=d, kd=kd, rough=rough, metal=metal)
    return dict(v=v, tr=tr, mat=mat, mspec_j=mspec_j, mspec_t=tmat.MaterialSpec(bound=1.0), p=p,
                env=env, jt=jt, tt=tt, surf=surf, tracers=(jt, tt))


def j_args(s):
    return [jnp.asarray(s[k]) for k in ("pos", "nrm", "vd", "mask", "kd", "rough", "metal")]


def t_args(s):
    return [t(s[k]) for k in ("pos", "nrm", "vd", "mask", "kd", "rough", "metal")]


def assert_radiance(got, ref, agree):
    assert agree.mean() >= 0.999, agree.mean()
    assert_close_mostly(n(got)[agree], np.asarray(ref)[agree], rtol=1e-4, atol=1e-4, frac=0.995,
                        rtol_all=1e-2)


def test_sample_direct_mis(scene):
    s, env = scene["surf"], scene["env"]
    N = s["pos"].shape[0]
    jd, td = jenv.build_sampler(jnp.asarray(env)), tenv.build_sampler(t(env))
    key = jax.random.PRNGKey(11)
    k_env, k_brdf, k_pick = jax.random.split(key, 3)
    rnd = jax.random.uniform(k_env, (N, 2))
    bu = brdf_u_jax(k_brdf, N)
    pick = jax.random.uniform(k_pick, (N,))
    ref = jpt.sample_direct_mis(key, *j_args(s), jnp.asarray(env), jd, scene["jt"])
    u = np.concatenate([np.asarray(rnd), brdf_u_cols(bu), np.asarray(pick)[:, None]], axis=1)
    got = tpt.sample_direct_mis(*t_args(s), t(env), td, scene["tt"], u=t(u))
    valid = (n(got.distance) > 0) == (np.asarray(ref.distance) > 0)
    assert (np.asarray(ref.distance) > 0).sum() > 200
    assert_radiance(got.Li, ref.Li, valid)
    np.testing.assert_allclose(n(got.dir)[valid], np.asarray(ref.dir)[valid], rtol=1e-4, atol=1e-5)
    _, dj, sj = jpt.shade_direct(ref, jnp.asarray(s["mask"]), jnp.asarray(s["nrm"]), jnp.asarray(s["vd"]),
                                 jnp.asarray(s["kd"]), jnp.asarray(s["rough"]), jnp.asarray(s["metal"]),
                                 jnp.zeros((N, 3)))
    _, dt_, st_ = tpt.shade_direct(got, t(s["mask"]), t(s["nrm"]), t(s["vd"]), t(s["kd"]),
                                   t(s["rough"]), t(s["metal"]), torch.zeros((N, 3)))
    assert_radiance(dt_, dj, valid)
    assert_radiance(st_, sj, valid)


def test_trace_bounce(scene):
    s, env = scene["surf"], scene["env"]
    N = s["pos"].shape[0]
    jd, td = jenv.build_sampler(jnp.asarray(env)), tenv.build_sampler(t(env))
    k0, kb = jax.random.split(jax.random.PRNGKey(5))
    a = j_args(s)
    st_j = jpt.spawn_bounce(k0, a[3], a[0], a[1], a[2], a[4], a[5], a[6])
    st_t = tpt.spawn_bounce(*[t_args(s)[i] for i in (3, 0, 1, 2, 4, 5, 6)], u=t(brdf_u_cols(brdf_u_jax(k0, N))))
    np.testing.assert_array_equal(n(st_t.alive), np.asarray(st_j.alive))
    np.testing.assert_allclose(n(st_t.direction), np.asarray(st_j.direction), rtol=1e-4, atol=1e-5)

    mat, p = scene["mat"], scene["p"]

    def jmat_fn(pts, key=None):
        return jmat.sample_material(mat, pts, scene["mspec_j"], stochastic_key=key)

    def tmat_fn(pts, u=None):
        return tmat.sample_material(p.mat, pts, scene["mspec_t"], stochastic_u=u)

    jv, jtris = jnp.asarray(scene["v"]), jnp.asarray(scene["tr"])
    esc_j, nee_j, nxt_j, pos_j = jpt.trace_bounce(kb, st_j, scene["jt"], jv, jtris, jmat_fn,
                                                  jnp.asarray(env), jd)
    esc_t, nee_t, nxt_t, pos_t = tpt.trace_bounce(
        st_t, scene["tt"], tpt.face_corners(t(scene["v"]), t(scene["tr"])), tmat_fn, t(env), td,
        u=t(bounce_u_jax(kb, N)))
    agree = n(nxt_t.alive) == np.asarray(nxt_j.alive)
    assert np.asarray(nxt_j.alive).sum() > 50, "fixture needs bounces that hit the mesh again"
    assert_radiance(esc_t, esc_j, agree)
    assert_radiance(nee_t, nee_j, agree)
    assert_radiance(nxt_t.throughput, nxt_j.throughput, agree)
    assert float(np.abs(np.asarray(nee_j)).sum()) > 0


def test_render_indirect(scene):
    s, env = scene["surf"], scene["env"]
    N = s["pos"].shape[0]
    jd, td = jenv.build_sampler(jnp.asarray(env)), tenv.build_sampler(t(env))
    mat, p = scene["mat"], scene["p"]
    key = jax.random.PRNGKey(21)
    a = j_args(s)
    ref = jpt.render_indirect(
        key, a[3], a[0], a[1], a[2], a[4], a[5], a[6], scene["jt"], jnp.asarray(scene["v"]),
        jnp.asarray(scene["tr"]),
        lambda pts, k=None: jmat.sample_material(mat, pts, scene["mspec_j"], stochastic_key=k),
        jnp.asarray(env), jd, bounces=2,
    )
    b = t_args(s)
    got = tpt.render_indirect(
        b[3], b[0], b[1], b[2], b[4], b[5], b[6], scene["tt"], t(scene["v"]), t(scene["tr"]),
        lambda pts, u=None: tmat.sample_material(p.mat, pts, scene["mspec_t"], stochastic_u=u),
        t(env), td, bounces=2, u=t(indirect_u_jax(key, N, 2)),
    )
    assert float(np.abs(np.asarray(ref)).sum()) > 0
    close = np.all(np.isclose(n(got), np.asarray(ref), rtol=1e-4, atol=1e-4), axis=1)
    assert close.mean() >= 0.998, close.mean()


def test_masked_apply_compacts_live_lanes():
    rng = np.random.RandomState(0)
    mask = t(rng.rand(64) < 0.4)
    x = t(rng.rand(64, 3).astype(np.float32))
    calls = []

    def fn(xx, mm):
        calls.append(xx.shape[0])
        return xx * 2.0, mm[:, None].float()

    full = masked_apply(fn, mask, (x, mask), fills=(7.0, 3.0), chunks=1)
    comp = masked_apply(fn, mask, (x, mask), fills=(7.0, 3.0), chunks=4)
    assert calls == [64, int(mask.sum())]
    m = n(mask)
    np.testing.assert_array_equal(n(comp[0])[m], n(full[0])[m])
    assert (n(comp[0])[~m] == 7.0).all() and (n(comp[1])[~m] == 3.0).all()
    odd = masked_apply(fn, mask[:63], (x[:63], mask[:63]), fills=(7.0, 3.0), chunks=4)
    assert calls[-1] == 63 and n(odd[0]).shape == (63, 3)   # P % chunks != 0: plain call
