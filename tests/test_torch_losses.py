"""Port vs reference: train/losses.py, every loss's value and gradient
(jax.grad against torch.autograd on the same seeded inputs), the mesh
topology, and the sRGB helpers.

Tolerances: topology exact (integer numpy code); values and gradients
rtol 1e-5, atol 1e-7 (another summation order).  Inputs avoid the ties
where the two frameworks' gradients differ by definition (|x| at 0, clip
at its bounds): shading buffers are strictly positive.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mirres_restir_nerf_mesh_tpu.train import losses as jL
from mirres_restir_nerf_mesh_tpu.utils import math as jm
from mirres_restir_nerf_mesh_torch.train import losses as tL
from mirres_restir_nerf_mesh_torch.utils import math as tm

from test_torch_helpers import TORCH_THREADS, bumpy_sphere, n, t

torch.set_num_threads(TORCH_THREADS)


def compare(jfn, tfn, *arrays):
    """Value and gradient w.r.t. every array argument."""
    jv, jg = jax.value_and_grad(lambda *a: jfn(*a), argnums=tuple(range(len(arrays))))(
        *(jnp.asarray(a) for a in arrays))
    ts = [t(a).requires_grad_(True) for a in arrays]
    tv = tfn(*ts)
    grads = torch.autograd.grad(tv, ts, allow_unused=True)
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-5, atol=1e-7)
    for a, b in zip(jg, grads):
        b = np.zeros_like(np.asarray(a)) if b is None else n(b)
        np.testing.assert_allclose(b, np.asarray(a), rtol=1e-5, atol=1e-7)


@pytest.fixture(scope="module")
def mesh():
    v, tr = bumpy_sphere(10, 16)
    v = v + np.random.RandomState(0).normal(size=v.shape).astype(np.float32) * 0.01
    return v, tr, jL.build_topology(tr, v.shape[0]), tL.build_topology(tr, v.shape[0])


def test_build_topology_exact(mesh):
    _, _, jt, tt = mesh
    for f in jt._fields:
        np.testing.assert_array_equal(getattr(tt, f), getattr(jt, f), err_msg=f)


def test_mesh_losses(mesh):
    v, tr, jt, tt = mesh
    compare(lambda x: jL.laplacian_smooth_loss(x, jt), lambda x: tL.laplacian_smooth_loss(x, tt), v)
    compare(lambda x: jL.normal_consistency_loss(x, jnp.asarray(tr), jt),
            lambda x: tL.normal_consistency_loss(x, t(tr), tt), v)
    compare(lambda x: jL.edge_length_loss(x, jt), lambda x: tL.edge_length_loss(x, tt), v)
    off = np.random.RandomState(1).normal(size=v.shape).astype(np.float32) * 1e-2
    compare(jL.offsets_loss, tL.offsets_loss, off)
    compare(lambda x: jL.offsets_loss(x, 100), lambda x: tL.offsets_loss(x, 100), off)


def test_shading_material_chroma_losses():
    rng = np.random.RandomState(2)
    P = 500
    d = rng.uniform(0.01, 3.0, (P, 3)).astype(np.float32)
    s = rng.uniform(0.01, 1.0, (P, 3)).astype(np.float32)
    ref = rng.uniform(0.05, 1.5, (P, 3)).astype(np.float32)
    compare(lambda a, b, c: jL.shading_loss(a, b, c, 0.0015, 2.5e-5),
            lambda a, b, c: tL.shading_loss(a, b, c, 0.0015, 2.5e-5), d, s, ref)
    kd_g = rng.uniform(0, 0.3, (P, 3)).astype(np.float32)
    ks_g = rng.uniform(0, 0.3, (P,)).astype(np.float32)
    nrm_g = rng.uniform(0, 0.3, (P,)).astype(np.float32)
    compare(lambda a, b, c: jL.material_smoothness_grad(a, b, c, 0.005, 0.0025, 0.00025),
            lambda a, b, c: tL.material_smoothness_grad(a, b, c, 0.005, 0.0025, 0.00025),
            kd_g, ks_g, nrm_g)
    kd = rng.uniform(0.02, 1.0, (P, 3)).astype(np.float32)
    compare(lambda a, b: jL.chroma_loss(a, b, 0.1), lambda a, b: tL.chroma_loss(a, b, 0.1), kd, ref)


def test_srgb_helpers():
    x = np.concatenate([np.linspace(-0.1, 1.2, 1001), [0.0031308, 0.04045]]).astype(np.float32)
    np.testing.assert_allclose(n(tm.linear_to_srgb(t(x))), np.asarray(jm.linear_to_srgb(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(n(tm.srgb_to_linear(t(x))), np.asarray(jm.srgb_to_linear(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-7)
