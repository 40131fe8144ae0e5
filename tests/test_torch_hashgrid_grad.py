"""Port vs reference: gradients of the hash-grid encoder with respect to the
table and to the positions, exact and one-corner stochastic paths, against
jax.grad of the reference's hashgrid_encode (whose backward on the CPU is
the fp32 scatter of ``_grm_bwd`` plus XLA's scatter for the packed dense
levels), with the same cotangent; plus a float64 gradcheck of GatherRows.

Specs: the material field's full grid (16 levels, 2^19, dense packed levels
at the bottom) and a small all-hashed grid.  Tolerances: table gradient
within 1e-5 relative + 1e-6 of its largest entry (sums of the same terms in
another order); position gradient within 1e-4 relative + 1e-5 of its
largest entry (a sum of 8L weight derivatives times table differences).
Points lie strictly inside the bound, where clip has no tie.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mirres_restir_nerf_mesh_tpu.ops import hashgrid as jhg
from mirres_restir_nerf_mesh_torch.ops import hashgrid as thg

from test_torch_helpers import TORCH_THREADS, n, t

torch.set_num_threads(TORCH_THREADS)

SPECS = {
    "material": dict(num_levels=16, base_resolution=16, log2_hashmap_size=19,
                     desired_resolution=4096),
    "hashed": dict(num_levels=4, base_resolution=16, log2_hashmap_size=8, desired_resolution=64),
}


def close(got, ref, rtol, atol_frac):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol_frac * np.abs(ref).max())


@pytest.mark.parametrize("stochastic", [False, True])
@pytest.mark.parametrize("name", list(SPECS))
def test_encode_gradients_match_reference(name, stochastic):
    jspec = jhg.HashGridSpec(level_dim=2, **SPECS[name])
    tspec = thg.HashGridSpec(level_dim=2, **SPECS[name])
    rng = np.random.RandomState(3)
    N = 1500
    emb = rng.uniform(-1, 1, (jspec.n_params, 2)).astype(np.float32)
    x = rng.uniform(-0.98, 0.98, (N, 3)).astype(np.float32)
    cot = rng.normal(size=(N, tspec.output_dim)).astype(np.float32)
    key = jax.random.PRNGKey(11) if stochastic else None

    def f(e, xx):
        return jnp.sum(jhg.hashgrid_encode(e, xx, jspec, stochastic_key=key) * cot)

    g_emb, g_x = jax.grad(f, argnums=(0, 1))(jnp.asarray(emb), jnp.asarray(x))
    te, tx = t(emb).requires_grad_(True), t(x).requires_grad_(True)
    u = t(np.asarray(jax.random.uniform(key, x.shape))) if stochastic else None
    out = thg.hashgrid_encode(te, tx, tspec, stochastic_u=u)
    (out * t(cot)).sum().backward()
    assert np.abs(np.asarray(g_emb)).max() > 0
    close(n(te.grad), g_emb, 1e-5, 1e-6)
    if stochastic:     # a pure gather: no gradient to the positions in either
        assert not np.asarray(g_x).any() and not n(tx.grad).any()
    else:
        assert np.abs(np.asarray(g_x)).max() > 0
        close(n(tx.grad), g_x, 1e-4, 1e-5)


def test_gather_rows_gradcheck():
    table = torch.randn((11, 2), dtype=torch.float64, requires_grad=True)
    idx = torch.tensor([[0, 3, 3], [10, 0, 7], [3, 3, 3], [5, 1, 0]], dtype=torch.int32)
    assert torch.autograd.gradcheck(lambda tb: thg.GatherRows.apply(tb, idx), (table,))
    out = thg.GatherRows.apply(table, idx)
    assert out.shape == (4, 3, 2)
    torch.testing.assert_close(out, table[idx.long()])
