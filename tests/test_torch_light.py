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
~0.3%.  The pdf of a random light direction meets the same cancellation
more mildly: at alpha 0.05-0.10 (roughness 0.22-0.31) one ulp of h.z moves
D by up to 5e-5, so 99.9% within 1e-4 and all within 2e-4.

A sampled half vector has sin(theta_h) = sqrt(1 - cos^2) with cos close to
1 at small alpha, so one ulp of cos (XLA's CPU rsqrt and division round
differently from PyTorch's) moves the small components of the sampled
direction by ~eps / sin(theta_h) absolute, up to ~2e-5.  The direction is a
unit vector and is held in absolute terms: 99.9% within 1e-5, every row
within 1e-5 + 32 eps / sin(theta_h) (the worst row reads 16).  The weight
and pdf are then held against the reference's own formulas at the port's
direction, so the direction's error does not pass through the GGX peak:
weight 99.9% within 1e-5 and all within 2e-4; pdf every row within
1e-5 + 4 eps kappa (at most 1e-2), where kappa = 4 c^2 (1 - a^2) /
(1 - c^2 (1 - a^2)) is D's relative condition number in c = h.z (the worst
row reads 2 eps kappa).
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

EPS32 = 2.0 ** -24        # half an ulp of 1.0 in float32


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
    assert_close_mostly(n(p_got), np.asarray(p_ref), rtol=1e-4, frac=0.999, rtol_all=2e-4)

    key = jax.random.PRNGKey(4)
    k_sel, k_d, k_s = jax.random.split(key, 3)
    u = (jax.random.uniform(k_sel, (N,)), jax.random.uniform(k_d, (N, 2)), jax.random.uniform(k_s, (N, 2)))
    s_ref = jbrdf.brdf_sample(key, jnp.asarray(wv), jnp.asarray(kd), jnp.asarray(metal), aj)
    s_got = tbrdf.brdf_sample(t(wv), t(kd), t(metal), at, u=tuple(t(x) for x in u))
    valid = n(s_got.valid)
    np.testing.assert_array_equal(valid, np.asarray(s_ref.valid))
    np.testing.assert_array_equal(n(s_got.specular_bounce), np.asarray(s_ref.specular_bounce))

    # Sampled direction: a unit vector, held in absolute terms; every row
    # within the conditioning of sin(theta_h) = sqrt(1 - cos^2).
    wi_got, wi_ref = n(s_got.w_light_l), np.asarray(s_ref.w_light_l, np.float64)
    h = wi_ref + wv
    h /= np.linalg.norm(h, axis=1, keepdims=True)
    sin_h = np.sqrt(np.maximum(1.0 - h[:, 2] ** 2, 0.0))
    err = np.abs(wi_got - wi_ref)
    assert (err <= 1e-5).mean() >= 0.999, (err <= 1e-5).mean()
    assert (err.max(1) <= 1e-5 + 32 * EPS32 / np.maximum(sin_h, 1e-30)).all()

    # Weight and pdf: the reference's formulas at the port's own direction.
    wi = jnp.asarray(wi_got)
    sharp = jnp.asarray(n(s_got.specular_bounce))
    p_spec = psj * jbrdf.specular_pdf(jnp.asarray(wv), wi, aj)
    pdf_ref = np.where(valid, np.asarray(jnp.where(sharp, p_spec, pdj * jbrdf.diffuse_pdf(wi) + p_spec)), 0.0)
    f_ref = np.asarray(jbrdf.brdf_eval(jnp.asarray(wv), wi, jnp.asarray(kd), jnp.asarray(metal), aj, pdj, psj))
    w_ref = np.where(valid[:, None], f_ref / np.maximum(pdf_ref, 1e-12)[:, None], 0.0)
    assert_close_mostly(n(s_got.weight), w_ref)
    hg = wi_got.astype(np.float64) + wv
    c2 = (hg[:, 2] / np.linalg.norm(hg, axis=1)) ** 2
    a = n(at).astype(np.float64)
    kappa = 4 * c2 * (1 - a * a) / np.maximum(1 - c2 * (1 - a * a), 1e-30)
    rtol_row = np.minimum(1e-5 + 4 * EPS32 * kappa, 1e-2)
    pdf_got = n(s_got.pdf).astype(np.float64)
    assert (np.abs(pdf_got - pdf_ref) <= 1e-6 + rtol_row * np.abs(pdf_ref)).all()

    nrm = unit_dirs(N, 9)
    np.testing.assert_allclose(n(tbrdf.to_global(tbrdf.to_local(t(wl), t(nrm)), t(nrm))), wl, atol=1e-5)
    np.testing.assert_allclose(n(tbrdf.to_local(t(wl), t(nrm))),
                               np.asarray(jbrdf.to_local(jnp.asarray(wl), jnp.asarray(nrm))), rtol=1e-5, atol=1e-6)
