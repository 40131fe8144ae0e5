"""Port vs reference: K4's plain version (``ops/scatter.py:scatter_add_plain``,
what ``scatter_add`` runs on the CPU) against ``pallas_scatter_add`` in
interpret mode and against the fp32 ``.at[].add`` of the hash-grid
backward's CPU branch.

Tolerances: against the Pallas kernel, exact on bf16-exact update values
(the kernel rounds every update to bf16 before its one-hot product, and
bf16-exact values pass that rounding unchanged; both then sum in fp32 and
match a float64 sum of these few terms exactly); against the fp32 scatter,
|port - ref| <= 1e-5 * sum|upd| at that row + 1e-30 (another summation
order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mirres_restir_nerf_mesh_tpu.ops.pallas_scatter import pallas_scatter_add
from mirres_restir_nerf_mesh_torch.ops.scatter import scatter_add, scatter_add_plain

from test_torch_helpers import TORCH_THREADS, n, t

torch.set_num_threads(TORCH_THREADS)


def case(M, rows, C, seed, bf16_exact):
    rng = np.random.RandomState(seed)
    idx = rng.randint(0, rows, M).astype(np.int32)
    idx[: M // 4] = rng.randint(0, min(rows, 5), M // 4)      # repeated rows
    idx[rng.rand(M) < 0.1] = -1                               # padding
    upd = rng.normal(size=(M, C)).astype(np.float32)
    if bf16_exact:
        upd = (upd.view(np.uint32) & np.uint32(0xFFFF0000)).view(np.float32)
    return idx, upd


def bound(idx, upd, rows):
    keep = idx >= 0
    a = np.zeros((rows, upd.shape[1]), np.float64)
    np.add.at(a, idx[keep], np.abs(upd[keep]).astype(np.float64))
    return 1e-5 * a + 1e-30


@pytest.mark.parametrize("M,rows,C", [(1000, 300, 2), (3000, 1000, 2), (777, 129, 1), (512, 200, 3)])
def test_plain_matches_pallas_interpret(M, rows, C):
    """bf16-exact updates, padding, repeated rows, table_rows % 128 != 0."""
    idx, upd = case(M, rows, C, seed=M, bf16_exact=True)
    ref = np.asarray(pallas_scatter_add(jnp.asarray(idx), jnp.asarray(upd), rows, C))
    got = n(scatter_add(t(idx), t(upd), rows))
    exact = np.zeros((rows, C), np.float64)
    keep = idx >= 0
    np.add.at(exact, idx[keep], upd[keep].astype(np.float64))
    np.testing.assert_array_equal(ref, exact.astype(np.float32))
    np.testing.assert_array_equal(got, ref)
    assert got.shape == (rows, C) and got.dtype == np.float32


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_matches_fp32_scatter(seed):
    """fp32 updates against the .at[].add of _grm_bwd's CPU branch (which
    has no padding: its ids are all valid)."""
    rows = 4920
    idx, upd = case(20000, rows, 2, seed, bf16_exact=False)
    idx = np.abs(idx)
    ref = np.asarray(jnp.zeros((rows, 2), jnp.float32).at[jnp.asarray(idx)].add(jnp.asarray(upd)))
    got = n(scatter_add_plain(t(idx), t(upd), rows))
    assert (np.abs(got - ref) <= bound(idx, upd, rows)).all()


def test_scatter_add_checks_and_drops():
    idx = t(np.array([0, -1, 5, 2, 2], np.int32))
    upd = torch.ones((5, 2))
    out = scatter_add(idx, upd, 4)       # 5 is out of range: dropped, as the reference drops it
    np.testing.assert_array_equal(n(out), [[1, 1], [0, 0], [2, 2], [0, 0]])
    before = scatter_add.launches
    with pytest.raises(TypeError):
        scatter_add(idx.long(), upd, 4)
    with pytest.raises(ValueError):
        scatter_add(idx, torch.ones((4, 2)), 4)
    assert scatter_add.launches == before            # the CPU path launches nothing
