"""Port vs reference: the exact and alias envmap samplers
(models/envlight.py ``EnvDistribution`` / ``build_distribution``,
``AliasTable`` / ``build_alias_table`` / ``sample_li_alias``,
``generate_image``) and the renderers that take an ``EnvDistribution``
(a ReSTIR initial pass, the path tracer's direct MIS), on the CPU.

Tolerances: the distribution's pdfs within 1e-6 relative and its CDFs
within 1e-6 absolute; the alias table's ``alias`` equal (the same numpy
Vose loop) and ``q`` within 1e-6.  Draws on shared uniforms through the
reference's own tables (``convert.*_from_jax``): directions within 1e-5,
Le and pdf within 1e-5 relative on >= 99.9% of samples and 2e-4 on all
(arccos / sin of float32 angles round apart near the poles); through the
port's own distribution directions within 5e-5 (the CDFs, summed in
another order, differ by ~1e-7, which the in-texel offset divides by a
dim texel's mass: 1.7e-5 at most on 8,192 draws).  The
ReSTIR pass and the direct MIS as tests/test_torch_restir.py and
tests/test_torch_pathtracer.py hold them with the quantile sampler.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mirres_restir_nerf_mesh_torch.convert import alias_table_from_jax, env_distribution_from_jax
from mirres_restir_nerf_mesh_torch.models import envlight as tenv
from mirres_restir_nerf_mesh_torch.render import pathtracer as tpt
from mirres_restir_nerf_mesh_torch.render import restir as tr_
from mirres_restir_nerf_mesh_tpu.models import envlight as jenv
from mirres_restir_nerf_mesh_tpu.render import pathtracer as jpt
from mirres_restir_nerf_mesh_tpu.render import restir as jr

from test_torch_helpers import (TORCH_THREADS, assert_close_mostly, brdf_u_cols, brdf_u_jax, n,
                                t)
from test_torch_light import sky_env
from test_torch_pathtracer import assert_radiance
from test_torch_restir import P, S, T, assert_reservoirs_match
from test_torch_restir import scene  # noqa: F401  (the fixture)

torch.set_num_threads(TORCH_THREADS)
ND = 8192


@pytest.mark.parametrize("hw", [(16, 32), (32, 64)])
def test_build_distribution(hw):
    env = sky_env(*hw, seed=2)
    ref = jenv.build_distribution(jnp.asarray(env))
    got = tenv.build_distribution(t(env))
    for f in ("pdf2d", "mpdf"):
        np.testing.assert_allclose(n(getattr(got, f)), np.asarray(getattr(ref, f)), rtol=1e-6,
                                   atol=0, err_msg=f)
    for f in ("row_cdf", "mcdf"):
        np.testing.assert_allclose(n(getattr(got, f)), np.asarray(getattr(ref, f)), rtol=0,
                                   atol=1e-6, err_msg=f)
    np.testing.assert_array_equal(n(tenv.generate_image(t(env))), np.asarray(
        jenv.generate_image(jnp.asarray(env))))


def uniforms(seed, shape=(ND,)):
    u = np.array(jax.random.uniform(jax.random.PRNGKey(seed), shape + (2,)))
    u[:4] = [[0.0, 0.0], [0.999999, 0.999999], [0.5, 0.0], [0.0, 0.5]]
    return u


def check_draw(got, ref):
    np.testing.assert_allclose(n(got[0]), np.asarray(ref[0]), rtol=0, atol=1e-5)
    for g, r in zip(got[1:], ref[1:]):
        assert_close_mostly(n(g), np.asarray(r), rtol=1e-5, atol=1e-7, rtol_all=2e-4)


def test_sample_li_and_pdf_li_exact():
    env = sky_env(16, 32, seed=3)
    jd = jenv.build_distribution(jnp.asarray(env))
    u = uniforms(4)
    ref = jenv.sample_li(jnp.asarray(env), jd, jnp.asarray(u))
    check_draw(tenv.sample_li(t(env), env_distribution_from_jax(jd, device="cpu"), t(u)), ref)
    # the port's own distribution
    own = tenv.sample_li(t(env), tenv.build_distribution(t(env)), t(u))
    np.testing.assert_allclose(n(own[0]), np.asarray(ref[0]), rtol=0, atol=5e-5)
    # shapes [..., 2] and pdf_li at the drawn directions and at the poles
    u2 = u[:1024].reshape(32, 32, 2)
    g2 = tenv.sample_li(t(env), tenv.build_distribution(t(env)), t(u2))
    assert tuple(g2[0].shape) == (32, 32, 3) and tuple(g2[2].shape) == (32, 32)
    dirs = np.concatenate([np.asarray(ref[0]), [[0, 0, 1], [0, 0, -1], [1, 0, 0]]]).astype(
        np.float32)
    assert_close_mostly(n(tenv.pdf_li(tenv.build_distribution(t(env)), t(dirs))),
                        np.asarray(jenv.pdf_li(jd, jnp.asarray(dirs))), rtol=1e-5, atol=1e-7,
                        rtol_all=2e-4)


def test_alias_table_and_sample_li_alias():
    env = sky_env(32, 64, seed=5)
    ref = jenv.build_alias_table(jnp.asarray(env))
    got = tenv.build_alias_table(t(env))
    np.testing.assert_array_equal(n(got.alias), np.asarray(ref.alias).astype(np.int64))
    np.testing.assert_allclose(n(got.q), np.asarray(ref.q), rtol=0, atol=1e-6)
    np.testing.assert_allclose(n(got.pdf), np.asarray(ref.pdf), rtol=1e-6)
    assert (n(got.alias) != np.arange(32 * 64)).any()
    u = uniforms(6)
    ref_d = jenv.sample_li_alias(jnp.asarray(env), ref, jnp.asarray(u))
    check_draw(tenv.sample_li_alias(t(env), alias_table_from_jax(ref, device="cpu"), t(u)), ref_d)
    check_draw(tenv.sample_li_alias(t(env), got, t(u)), ref_d)


def test_restir_initial_pass_with_distribution(scene):  # noqa: F811
    env = scene["env"]
    jd = jenv.build_distribution(jnp.asarray(env))
    td = env_distribution_from_jax(jd, device="cpu")
    key = jax.random.PRNGKey(7)
    u = jax.random.uniform(key, (T, S, 2))
    jt = jr.generate_light_tiles(key, jnp.asarray(env), jd, T, S)
    tt = tr_.generate_light_tiles(t(env), td, T, S, t(u))
    for f in ("dirs", "le", "pdf"):
        assert_close_mostly(n(getattr(tt, f)), np.asarray(getattr(jt, f)), rtol=1e-5, atol=1e-7)
    nl, nb = 8, 1
    k = jax.random.split(jax.random.PRNGKey(8), 4)
    tile_id = jax.random.randint(k[0], (P,), 0, T)
    blk = jax.random.randint(k[1], (P,), 0, S // nl)
    us = jax.random.uniform(k[2], (1 + nb, P))
    bu = brdf_u_jax(k[3], P)
    ref = jr.initial_resampling(k[0], scene["jctx"], jt, jnp.asarray(env), jd, None, nl, nb,
                                check_visibility=False, rand=(tile_id, blk, us, [bu]))
    got = tr_.initial_resampling(
        scene["tctx"], tt, t(env), td, None, nl, nb, check_visibility=False,
        rand=tr_.InitialRandoms(t(tile_id), t(blk), t(us), [tuple(t(x) for x in bu)]))
    assert ref.p is None and got.p is None
    assert_reservoirs_match(ref, got)


def test_direct_mis_with_distribution(scene):  # noqa: F811
    f, env = scene["fields"], scene["env"]
    jd = jenv.build_distribution(jnp.asarray(env))
    td = tenv.build_distribution(t(env))
    keys = ("position", "normal", "view_dir", "mask", "kd", "roughness", "metallic")
    key = jax.random.PRNGKey(9)
    k_env, k_brdf, k_pick = jax.random.split(key, 3)
    rnd = np.asarray(jax.random.uniform(k_env, (P, 2)))
    bu = brdf_u_jax(k_brdf, P)
    pick = np.asarray(jax.random.uniform(k_pick, (P,)))
    ref = jpt.sample_direct_mis(key, *[jnp.asarray(f[k]) for k in keys], jnp.asarray(env), jd,
                                scene["jtracer"])
    u = np.concatenate([rnd, brdf_u_cols(bu), pick[:, None]], axis=1)
    got = tpt.sample_direct_mis(*[t(f[k]) for k in keys], t(env), td, scene["ttracer"], u=t(u))
    valid = (n(got.distance) > 0) == (np.asarray(ref.distance) > 0)
    assert (np.asarray(ref.distance) > 0).sum() > 100
    assert_radiance(got.Li, ref.Li, valid)
    np.testing.assert_allclose(n(got.dir)[valid], np.asarray(ref.dir)[valid], rtol=1e-4, atol=1e-5)
