"""Port vs reference: the screen-space denoisers (render/denoise.py): EAW
(values and the vector-Jacobian product with respect to the colour),
bilateral, normal_ao and variance_phi, on one 24x20 image made from a seed.

Tolerance: rtol 1e-5 (atol 1e-6): both sum the same fp32 taps in the same
order; exp and the squares may round an ulp apart.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mirres_restir_nerf_mesh_tpu.render import denoise as jd
from mirres_restir_nerf_mesh_torch.render import denoise as td

from test_torch_helpers import TORCH_THREADS, n, t

torch.set_num_threads(TORCH_THREADS)

H, W = 24, 20


def image(seed=0):
    rng = np.random.RandomState(seed)
    color = rng.gamma(2.0, 0.3, (H, W, 3)).astype(np.float32)
    nrm = rng.normal(size=(H, W, 3)).astype(np.float32) * 0.3 + np.array([0, 0, 1], np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    pos = (rng.rand(H, W, 3) * 0.5).astype(np.float32)
    mask = rng.rand(H, W) < 0.7
    mask[:, :3] = False
    return color, nrm, pos, mask


def close(got, ref):
    np.testing.assert_allclose(n(got), np.asarray(ref), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("iters,sw", [(2, 2), (4, 8)])
def test_eaw_values_and_vjp(iters, sw):
    c, nr, p, m = image(1)
    ref = jd.eaw_denoise(jnp.asarray(c), jnp.asarray(nr), jnp.asarray(p), jnp.asarray(m), iters,
                         sw, 1.0, 0.1, 0.1, differentiable=True)
    ct = t(c).requires_grad_(True)
    got = td.eaw_denoise(ct, t(nr), t(p), t(m), iters, sw, 1.0, 0.1, 0.1, differentiable=True)
    close(got, ref)
    cot = np.random.RandomState(2).normal(size=(H, W, 3)).astype(np.float32)
    _, vjp = jax.vjp(lambda x: jd.eaw_denoise(x, jnp.asarray(nr), jnp.asarray(p), jnp.asarray(m),
                                              iters, sw, 1.0, 0.1, 0.1), jnp.asarray(c))
    (g_ref,) = vjp(jnp.asarray(cot))
    (g_got,) = torch.autograd.grad(got, ct, t(cot))
    close(g_got, g_ref)
    nd = td.eaw_denoise(ct, t(nr), t(p), t(m), iters, sw, differentiable=False)
    assert not nd.requires_grad


def test_bilateral():
    c, nr, _, _ = image(3)
    z = np.random.RandomState(4).rand(H, W).astype(np.float32) + 1.0
    zdz = np.stack([z, np.full((H, W), 2.0, np.float32)], -1)
    ref = jd.bilateral_denoise(jnp.asarray(c), jnp.asarray(nr), jnp.asarray(zdz))
    close(td.bilateral_denoise(t(c), t(nr), t(zdz)), ref)


def test_normal_ao_and_variance_phi():
    c, nr, p, m = image(5)
    close(td.normal_ao(t(nr), t(m)), jd.normal_ao(jnp.asarray(nr), jnp.asarray(m)))
    for sw in (1, 2):
        close(td.variance_phi(t(c), t(nr), t(p), t(m), sw),
              jd.variance_phi(jnp.asarray(c), jnp.asarray(nr), jnp.asarray(p), jnp.asarray(m), sw))
