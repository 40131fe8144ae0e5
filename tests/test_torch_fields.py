"""Port vs reference: hash-grid encoder (exact and one-corner stochastic),
SH encoder, material field and the NeRF radiance query, fp32.

Tolerances: hash indices exact (the stochastic encoding is a pure gather,
so it must match bit for bit); interpolated features and MLP outputs
rtol 1e-5, atol 1e-6 (sums over corners and matmuls may associate
differently in XLA and PyTorch).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mirres_restir_nerf_mesh_tpu.models import material as jmat
from mirres_restir_nerf_mesh_tpu.models import nerf as jnerf
from mirres_restir_nerf_mesh_tpu.ops import hashgrid as jhg
from mirres_restir_nerf_mesh_tpu.ops import sh as jsh
from mirres_restir_nerf_mesh_torch.convert import params_from_jax
from mirres_restir_nerf_mesh_torch.models import material as tmat
from mirres_restir_nerf_mesh_torch.models import nerf as tnerf
from mirres_restir_nerf_mesh_torch.ops import hashgrid as thg
from mirres_restir_nerf_mesh_torch.ops import sh as tsh

from test_torch_helpers import TORCH_THREADS, n, small_spec_kwargs, t, tree_np

torch.set_num_threads(TORCH_THREADS)

SPECS = {
    # dense levels only / hashed levels / the material field's full layout
    "dense": dict(num_levels=3, base_resolution=4, log2_hashmap_size=14, desired_resolution=16),
    "mixed": dict(num_levels=6, base_resolution=8, log2_hashmap_size=10, desired_resolution=256),
    "material": dict(num_levels=16, base_resolution=16, log2_hashmap_size=19, desired_resolution=4096),
}


def points(N, seed, bound=1.0):
    x = np.random.RandomState(seed).uniform(-bound, bound, (N, 3)).astype(np.float32)
    x[:4] = [[-bound] * 3, [bound] * 3, [bound, -bound, 0.0], [0.0, 0.0, 0.0]]
    return x


@pytest.mark.parametrize("name", list(SPECS))
def test_hashgrid_exact_and_stochastic(name):
    jspec = jhg.HashGridSpec(level_dim=2, **SPECS[name])
    tspec = thg.HashGridSpec(level_dim=2, **SPECS[name])
    assert tspec.level_meta()[0].tolist() == jspec.level_meta()[0].tolist()
    emb = jhg.init_hashgrid(jax.random.PRNGKey(1), jspec, std=1.0)
    x = points(2048, 3)
    ref = jhg.hashgrid_encode(emb, jnp.asarray(x), jspec)
    got = thg.hashgrid_encode(t(emb), t(x), tspec)
    np.testing.assert_allclose(n(got), np.asarray(ref), rtol=1e-5, atol=1e-6)

    key = jax.random.PRNGKey(7)
    u = np.asarray(jax.random.uniform(key, x.shape))
    ref_s = jhg.hashgrid_encode(emb, jnp.asarray(x), jspec, stochastic_key=key)
    got_s = thg.hashgrid_encode(t(emb), t(x), tspec, stochastic_u=t(u))
    np.testing.assert_array_equal(n(got_s), np.asarray(ref_s))


def test_hash_index_uint32_wrap_exact():
    """The xor-hash in uint32 (products by primes above 2^31 wrap) against
    the int64-and-mask form, at grid coordinates up to 2^20."""
    rng = np.random.RandomState(0)
    pg = rng.randint(0, 1 << 20, (4096, 3)).astype(np.uint32)
    primes = jnp.asarray(jhg._PRIMES)
    p = jnp.asarray(pg)
    for size in (524288, 12345, 8):
        ref = ((p[..., 0] * primes[0]) ^ (p[..., 1] * primes[1]) ^ (p[..., 2] * primes[2])) % jnp.uint32(size)
        got = thg.level_index(t(pg.astype(np.int64)), False, 0, size)
        np.testing.assert_array_equal(n(got), np.asarray(ref).astype(np.int64))


def test_sh_encode():
    d = np.random.RandomState(1).normal(size=(512, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    for deg in (1, 2, 3, 4):
        np.testing.assert_allclose(n(tsh.sh_encode(t(d), deg)), np.asarray(jsh.sh_encode(jnp.asarray(d), deg)),
                                   rtol=1e-5, atol=1e-6)


def test_sample_material_and_rgb_only():
    key = jax.random.PRNGKey(0)
    mspec_j, mspec_t = jmat.MaterialSpec(bound=1.0), tmat.MaterialSpec(bound=1.0)
    nspec_j = jnerf.NeRFSpec(bound=1.0, **small_spec_kwargs())
    nspec_t = tnerf.NeRFSpec(bound=1.0, **small_spec_kwargs())
    mat = jmat.init_material(key, mspec_j)
    mat = {**mat, "encoder": mat["encoder"] * 1e3}      # features large enough to matter
    nerf = jnerf.init_nerf(jax.random.fold_in(key, 1), nspec_j)
    nerf = {**nerf, "encoder": nerf["encoder"] * 1e3}
    p = params_from_jax(tree_np(nerf), tree_np(mat), np.zeros((2, 2, 3), np.float32),
                        np.zeros((1, 3), np.float32), device="cpu")
    x = points(1024, 5)
    d = np.random.RandomState(6).normal(size=(1024, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)

    ref = jmat.sample_material(mat, jnp.asarray(x), mspec_j)
    got = tmat.sample_material(p.mat, t(x), mspec_t)
    np.testing.assert_allclose(n(got), np.asarray(ref), rtol=1e-5, atol=1e-6)
    assert np.asarray(ref)[:, 0].std() > 1e-3
    kd, r, m = tmat.split_material(got)
    assert kd.shape == (1024, 3) and r.shape == m.shape == (1024,)

    k_mat = jax.random.PRNGKey(9)
    u = np.asarray(jax.random.uniform(k_mat, x.shape))
    ref_s = jmat.sample_material(mat, jnp.asarray(x), mspec_j, stochastic_key=k_mat)
    got_s = tmat.sample_material(p.mat, t(x), mspec_t, stochastic_u=t(u))
    np.testing.assert_allclose(n(got_s), np.asarray(ref_s), rtol=1e-5, atol=1e-6)

    ref_rgb = jnerf.rgb_only(nerf, jnp.asarray(x), jnp.asarray(d), nspec_j)
    got_rgb = tnerf.rgb_only(p.nerf, t(x), t(d), nspec_t)
    np.testing.assert_allclose(n(got_rgb), np.asarray(ref_rgb), rtol=1e-5, atol=1e-6)
    ref_den = jnerf.density(nerf, jnp.asarray(x), nspec_j)
    got_den = tnerf.density(p.nerf, t(x), nspec_t)
    np.testing.assert_allclose(n(got_den["sigma"]), np.asarray(ref_den["sigma"]), rtol=1e-5, atol=1e-6)

    # bf16 MLPs are honoured (values move, stay close)
    got_bf = tnerf.rgb_only(p.nerf, t(x), t(d), tnerf.NeRFSpec(bound=1.0, compute_dtype=torch.bfloat16,
                                                               **small_spec_kwargs()))
    assert got_bf.dtype == torch.float32
    np.testing.assert_allclose(n(got_bf), n(got_rgb), atol=2e-2)


def test_params_round_trip():
    key = jax.random.PRNGKey(3)
    nspec = jnerf.NeRFSpec(bound=1.0, **small_spec_kwargs())
    nerf = tree_np(jnerf.init_nerf(key, nspec))
    mat = tree_np(jmat.init_material(jax.random.fold_in(key, 1), jmat.MaterialSpec()))
    env = np.random.RandomState(0).rand(8, 16, 3).astype(np.float32)
    off = np.random.RandomState(1).rand(10, 3).astype(np.float32)
    from mirres_restir_nerf_mesh_torch.convert import params_to_numpy

    back = params_to_numpy(params_from_jax(nerf, mat, env, off, device="cpu"))
    for a, b in zip(jax.tree.leaves((nerf, mat, env, off)), jax.tree.leaves(tuple(back))):
        np.testing.assert_array_equal(a, b)
    assert set(back[0]) == {"encoder", "sigma_net", "color_net"} and set(back[1]) == {"encoder", "net"}
