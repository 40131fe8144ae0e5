"""Port vs reference: environment light (sampler tables, eval_le, sample_li,
pdf_li on the EnvSampler branch) and the GGX BRDF (eval, pdf, sample).

Tolerances: rtol 1e-5 (atol 1e-6 near zero).  Table entries, texel counts
and texel picks are discrete: equal except where the float sums behind the
CDF round differently at a quantile or texel boundary (XLA accumulates the
CDF in float32, PyTorch's CPU cumsum in double), at most 0.1% of entries,
by one count.  Env lookups and BRDF values: 99.9% within rtol 1e-5, all
within 2e-4 (texel seams of the bilinear lookup; the GGX peak cancels in
its denominator).  The pdf of a sampled direction sits on that peak: at
the material's lowest roughness (alpha = 0.0064) one ulp of h.z moves D by
~0.3%, so 98% within 1e-5 and all within 1e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mirres_restir_nerf_mesh_tpu.models import envlight as jenv
from mirres_restir_nerf_mesh_tpu.render import brdf as jbrdf
from mirres_restir_nerf_mesh_torch.models import envlight as tenv
from mirres_restir_nerf_mesh_torch.render import brdf as tbrdf

from test_torch_helpers import TORCH_THREADS, assert_close_mostly, n, t

torch.set_num_threads(TORCH_THREADS)


def sky_env(h, w, seed):
    """Sky gradient + a bright sun disk + noise (bench.py's shape of env)."""
    theta = (np.arange(h) + 0.5) / h * np.pi
    sky = np.clip(np.cos(theta), 0, None)[:, None] ** 1.5
    env = np.tile((0.08 + 0.5 * sky)[:, :, None], (1, w, 3)).astype(np.float32)
    env[h // 10:h // 10 + 3, w // 4:w // 4 + 4] = [60.0, 55.0, 45.0]
    env *= 1.0 + 0.3 * np.random.RandomState(seed).rand(h, w, 3).astype(np.float32)
    return env


def unit_dirs(N, seed):
    d = np.random.RandomState(seed).normal(size=(N, 3)).astype(np.float32)
    return d / np.linalg.norm(d, axis=1, keepdims=True)


@pytest.mark.parametrize("hw", [(16, 32), (64, 128)])
def test_env_sampler_and_lookups(hw):
    env = sky_env(*hw, seed=0)
    ref = jenv.build_sampler(jnp.asarray(env))
    got = tenv.build_sampler(t(env))
    tab_eq = n(got.table) == np.asarray(ref.table)
    assert tab_eq.mean() >= 0.999, tab_eq.mean()
    H, W = hw
    cnt_ref = np.bincount(np.asarray(ref.table), minlength=H * W).reshape(H, W)
    cnt_got = np.bincount(n(got.table), minlength=H * W).reshape(H, W)
    assert np.abs(cnt_got - cnt_ref).max() <= 1 and (cnt_got != cnt_ref).mean() <= 0.001 * 65536 / (H * W)
    same = cnt_got == cnt_ref
    np.testing.assert_allclose(n(got.pdf)[same], np.asarray(ref.pdf)[same], rtol=1e-5, atol=1e-6)

    rnd = np.random.RandomState(1).rand(4096, 2).astype(np.float32)
    dj, lj, pj = jenv.sample_li(jnp.asarray(env), ref, jnp.asarray(rnd))
    dt, lt, pt = tenv.sample_li(t(env), got, t(rnd))
    k = np.clip((rnd[:, 0] * 65536).astype(np.int32), 0, 65535)
    pick = tab_eq[k] & same.reshape(-1)[np.asarray(ref.table)[k]]
    assert pick.mean() >= 0.995
    np.testing.assert_allclose(n(dt)[pick], np.asarray(dj)[pick], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(n(lt)[pick], np.asarray(lj)[pick], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(n(pt)[pick], np.asarray(pj)[pick], rtol=1e-5, atol=1e-6)

    d = unit_dirs(4096, 2)
    d[:3] = [[0, 1, 0], [0, -1, 0], [1, 0, 0]]           # poles and a seam
    assert_close_mostly(n(tenv.eval_le(t(env), t(d))), np.asarray(jenv.eval_le(jnp.asarray(env), jnp.asarray(d))))
    p_ref = np.asarray(jenv.pdf_li(ref, jnp.asarray(d)))
    p_got = n(tenv.pdf_li(got, t(d)))
    uv = np.asarray(jenv.dir_to_uv(jenv.ngp_dir(jnp.asarray(d))))
    col = np.clip((uv[:, 0] * W).astype(np.int32), 0, W - 1)
    row = np.clip(((1.0 - uv[:, 1]) * H).astype(np.int32), 0, H - 1)
    agree = same[row, col]
    assert agree.mean() >= 0.95
    close = np.isclose(p_got, p_ref, rtol=1e-5, atol=1e-6)[agree]
    assert close.mean() >= 0.999, close.mean()    # texel seams of the uv mapping


def brdf_inputs(N, seed):
    rng = np.random.RandomState(seed)
    wv = rng.normal(size=(N, 3)).astype(np.float32)
    wv[:, 2] = np.abs(wv[:, 2]) + 0.05
    wv /= np.linalg.norm(wv, axis=1, keepdims=True)
    wl = unit_dirs(N, seed + 1)
    kd = rng.rand(N, 3).astype(np.float32)
    metal = rng.rand(N).astype(np.float32) * (rng.rand(N) < 0.5)
    rough = rng.uniform(0.08, 1.0, N).astype(np.float32)   # the material range
    rough[:16] = 0.005                                    # alpha below kMinGGXAlpha
    return wv, wl, kd, metal.astype(np.float32), rough


def test_brdf_eval_pdf_sample():
    N = 4096
    wv, wl, kd, metal, rough = brdf_inputs(N, 0)
    aj = jbrdf.alpha_from_roughness(jnp.asarray(rough))
    at = tbrdf.alpha_from_roughness(t(rough))
    pdj, psj = jbrdf.lobe_probabilities(jnp.asarray(kd), jnp.asarray(metal), jnp.asarray(wv[:, 2]))
    pdt, pst = tbrdf.lobe_probabilities(t(kd), t(metal), t(wv[:, 2]))
    np.testing.assert_allclose(n(pdt), np.asarray(pdj), rtol=1e-5, atol=1e-6)
    f_ref = jbrdf.brdf_eval(jnp.asarray(wv), jnp.asarray(wl), jnp.asarray(kd), jnp.asarray(metal), aj, pdj, psj)
    f_got = tbrdf.brdf_eval(t(wv), t(wl), t(kd), t(metal), at, pdt, pst)
    assert_close_mostly(n(f_got), np.asarray(f_ref))
    p_ref = jbrdf.brdf_pdf(jnp.asarray(wv), jnp.asarray(wl), aj, pdj, psj)
    p_got = tbrdf.brdf_pdf(t(wv), t(wl), at, pdt, pst)
    assert_close_mostly(n(p_got), np.asarray(p_ref))

    key = jax.random.PRNGKey(4)
    k_sel, k_d, k_s = jax.random.split(key, 3)
    u = (jax.random.uniform(k_sel, (N,)), jax.random.uniform(k_d, (N, 2)), jax.random.uniform(k_s, (N, 2)))
    s_ref = jbrdf.brdf_sample(key, jnp.asarray(wv), jnp.asarray(kd), jnp.asarray(metal), aj)
    s_got = tbrdf.brdf_sample(t(wv), t(kd), t(metal), at, u=tuple(t(x) for x in u))
    np.testing.assert_array_equal(n(s_got.valid), np.asarray(s_ref.valid))
    np.testing.assert_array_equal(n(s_got.specular_bounce), np.asarray(s_ref.specular_bounce))
    for f in ("w_light_l", "weight"):
        assert_close_mostly(n(getattr(s_got, f)), np.asarray(getattr(s_ref, f)))
    assert_close_mostly(n(s_got.pdf), np.asarray(s_ref.pdf), frac=0.98, rtol_all=1e-2)

    nrm = unit_dirs(N, 9)
    np.testing.assert_allclose(n(tbrdf.to_global(tbrdf.to_local(t(wl), t(nrm)), t(nrm))), wl, atol=1e-5)
    np.testing.assert_allclose(n(tbrdf.to_local(t(wl), t(nrm))),
                               np.asarray(jbrdf.to_local(jnp.asarray(wl), jnp.asarray(nrm))), rtol=1e-5, atol=1e-6)
