"""Port vs reference: the all-texel dump renderer (render/dump.py) and the
image-space losses (train/image_loss.py), on the CPU.

- ``envmap_dirs_and_weights``: directions within 1e-6, solid angles
  within 1e-6 relative.
- ``render_dump`` on 64 shading points under a 8x16 env, in texel chunks
  of 64 (of 48, a ragged last chunk, without visibility): with a mesh ``Tracer`` (the cluster kind of
  both packages: a mesh under ``dense_threshold``, whose dense pass is
  K3's plain version on the port's side and XLA's on the reference's),
  with ``nerf_visibility_fn`` of a small NeRF field carried over by
  ``convert.params_from_jax``, and with neither.  Every output within
  1e-5 relative (1e-6 absolute) on >= 99.9% of entries and 1e-4 on all:
  the two einsums sum 48 texels in another order, and the GGX term is
  ill-conditioned at grazing light (tests/test_torch_light.py).
- ``image_loss`` in each loss and transform, ``mape_loss``, ``huber_loss``:
  within 1e-6 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mirres_restir_nerf_mesh_torch.convert import params_from_jax
from mirres_restir_nerf_mesh_torch.models import nerf as tnerf
from mirres_restir_nerf_mesh_torch.ops import tracer as ttr
from mirres_restir_nerf_mesh_torch.render import dump as tdump
from mirres_restir_nerf_mesh_torch.train import image_loss as til
from mirres_restir_nerf_mesh_tpu.models import nerf as jnerf
from mirres_restir_nerf_mesh_tpu.ops import tracer as jtr
from mirres_restir_nerf_mesh_tpu.render import dump as jdump
from mirres_restir_nerf_mesh_tpu.train import image_loss as jil

from test_torch_helpers import (TORCH_THREADS, assert_close_mostly, make_sphere, n,
                                small_spec_kwargs, t, tree_np)
from test_torch_light import sky_env

torch.set_num_threads(TORCH_THREADS)
P = 64
KEYS = ("position", "normal", "view_dir", "mask", "kd", "roughness", "metallic")


def test_envmap_dirs_and_weights():
    for h, w in ((8, 16), (5, 7)):
        rd, rw = jdump.envmap_dirs_and_weights(h, w)
        gd, gw = tdump.envmap_dirs_and_weights(h, w)
        np.testing.assert_allclose(n(gd), np.asarray(rd), rtol=0, atol=1e-6)
        np.testing.assert_allclose(n(gw), np.asarray(rw), rtol=1e-6)


@pytest.fixture(scope="module")
def surface():
    """Points on the outside of a sphere of radius 0.7 (shadowed by a second,
    smaller sphere beside it), seen from 2.5 away; a quarter masked off."""
    rng = np.random.RandomState(0)
    nrm = rng.normal(size=(P, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    pos = nrm * 0.7
    cam = np.array([0.0, 0.3, 2.5], np.float32)
    vd = pos - cam
    vd /= np.linalg.norm(vd, axis=1, keepdims=True)
    f = dict(position=pos, normal=nrm, view_dir=vd, mask=rng.rand(P) < 0.75, kd=rng.rand(P, 3),
             roughness=rng.uniform(0.2, 1.0, P), metallic=rng.rand(P) * (rng.rand(P) < 0.5))
    f = {k: v.astype(bool if k == "mask" else np.float32) for k, v in f.items()}
    v1, t1 = make_sphere(10, 20, radius=0.7)
    v2, t2 = make_sphere(8, 16, radius=0.3)
    v = np.concatenate([v1, v2 + np.array([0.0, 1.05, 0.0], np.float32)])
    tr = np.concatenate([t1, t2 + len(v1)]).astype(np.int32)
    return f, sky_env(8, 16, seed=4), v, tr


def compare(got, ref):
    for k in ("image_brdf", "diffuse_light", "specular_light"):
        assert_close_mostly(n(got[k]), np.asarray(ref[k]), rtol=1e-5, atol=1e-6, rtol_all=1e-4)


@pytest.mark.parametrize("vis", ["tracer", "nerf", "none"])
def test_render_dump_matches(surface, vis, monkeypatch):
    f, env, v, tr = surface
    jargs = [jnp.asarray(f[k]) for k in KEYS] + [jnp.asarray(env)]
    targs = [t(f[k]) for k in KEYS] + [t(env)]
    jkw, tkw = {}, {}
    if vis == "tracer":
        jkw["tracer"] = jtr.build_tracer(jnp.asarray(v), jnp.asarray(tr), kind="cluster")
        tkw["tracer"] = ttr.build_tracer(t(v), t(tr), kind="cluster")
    elif vis == "nerf":
        jspec = jnerf.NeRFSpec(bound=1.0, **small_spec_kwargs())
        tspec = tnerf.NeRFSpec(bound=1.0, **small_spec_kwargs())
        jparams = jnerf.init_nerf(jax.random.PRNGKey(5), jspec)
        tparams = params_from_jax(tree_np(jparams), {}, env, np.zeros((1, 3), np.float32),
                                  device="cpu").nerf
        jkw["visibility_fn"] = jdump.nerf_visibility_fn(jparams, jspec, n_steps=16)
        monkeypatch.setattr(tdump, "VIS_RAY_CHUNK", 999)      # ragged field queries
        tkw["visibility_fn"] = tdump.nerf_visibility_fn(tparams, tspec, n_steps=16)
        o = np.random.RandomState(6).uniform(-0.5, 0.5, (300, 3)).astype(np.float32)
        d = np.random.RandomState(7).normal(size=(300, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        vr = np.asarray(jkw["visibility_fn"](jnp.asarray(o), jnp.asarray(d)))
        vg = n(tkw["visibility_fn"](t(o), t(d)))
        np.testing.assert_allclose(vg, vr, rtol=1e-5)
        assert 0.01 < vr.min() and vr.max() < 0.99
    chunk = 48 if vis == "none" else 64     # one chunk shape: the reference compiles once
    ref = jdump.render_dump(*jargs, texel_chunk=chunk, **jkw)
    got = tdump.render_dump(*targs, texel_chunk=chunk, **tkw)
    compare(got, ref)
    if vis == "tracer":
        free = tdump.render_dump(*targs, texel_chunk=48)
        lit = n(free["diffuse_light"]).sum(1)
        assert (n(got["diffuse_light"]).sum(1) < lit - 1e-6).any()   # some texels shadowed
        assert float(tkw["tracer"].pop_traced()) > 0


@pytest.mark.parametrize("transform", ["none", "log", "tonemap"])
def test_image_losses_match(transform):
    rng = np.random.RandomState(8)
    img = (rng.rand(2, 16, 16, 3) * 3 - 0.5).astype(np.float32)
    ref_img = (rng.rand(2, 16, 16, 3) * 2).astype(np.float32)
    for loss in ("l1", "mse", "smape", "relmse"):
        r = float(jil.image_loss(jnp.asarray(img), jnp.asarray(ref_img), loss, transform))
        g = float(til.image_loss(t(img), t(ref_img), loss, transform))
        np.testing.assert_allclose(g, r, rtol=1e-6, err_msg=loss)
    np.testing.assert_allclose(float(til.mape_loss(t(img), t(ref_img))),
                               float(jil.mape_loss(jnp.asarray(img), jnp.asarray(ref_img))),
                               rtol=1e-6)
    for delta in (0.1, 1.0):
        np.testing.assert_allclose(float(til.huber_loss(t(img), t(ref_img), delta)),
                                   float(jil.huber_loss(jnp.asarray(img), jnp.asarray(ref_img),
                                                        delta)), rtol=1e-6)
