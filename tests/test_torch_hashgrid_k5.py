"""The hash grid's rows and the one-corner encode (ops/hashgrid.py
``OneCornerEncode``, kernel K5 on the card) on the CPU, where it runs its
plain version:

- ``encode_rows``, all levels at once, equals the loop over the levels
  (the tests' copy, layout and row formula written out level by level) bit
  for bit: the exact path's rows and weights, with the features and the
  table gradient they give, and the one-corner rows, on points inside the
  box, on its faces, outside it and for no point at all;
- through ``hashgrid_encode`` the one-corner encode equals the encode as
  ``encode_rows`` with ``stochastic_u`` followed by ``GatherRows`` forms
  it, bit for bit in rows, features and the table gradient, for the
  stage-0 NeRF grid and the material grid, with and without a gradient,
  on points inside the box, on its faces, outside it, and for no point at
  all;
- the per-level block handed to K5's launcher equals the grid's layout, as
  do the layout's device constants (``level_tensors``);
- K5's arithmetic, mirrored in numpy from that block (fp32 operations
  rounded one by one, uint32 products wrapping), gives the plain rows;
- what K5 does not take raises before any launch.

The kernel itself is held to the plain version on the card
(tests/test_torch_cuda.py).
"""

import numpy as np
import pytest
import torch

from mirres_restir_nerf_mesh_torch.models.material import MaterialSpec
from mirres_restir_nerf_mesh_torch.ops import hashgrid as thg

from test_torch_helpers import encode_rows_per_level, hashgrid_level_meta, launches

# the train0 cell's NeRF grid (16 levels of 2^19, levels 0-4 dense) and the
# material grid of stage 1's bounce re-query (16 levels, resolution 4096)
GRIDS = {"nerf": thg.HashGridSpec(num_levels=16, log2_hashmap_size=19, desired_resolution=2048),
         "material": MaterialSpec(bound=1.0).grid}


def points(where, P=3000, seed=3):
    """(x, u) [P, 3]: points inside the box, on its faces (each point on
    one or more faces), partly outside it, or none."""
    rng = np.random.RandomState(seed)
    if where == "empty":
        P = 0
    x = rng.uniform(-1.0, 1.0, (P, 3)).astype(np.float32)
    if where == "faces":
        x = np.where(rng.rand(P, 3) < 0.5, np.sign(x), x).astype(np.float32)
    elif where == "outside":
        x = rng.uniform(-1.5, 1.5, (P, 3)).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(rng.rand(P, 3).astype(np.float32))


@pytest.fixture(scope="module")
def tables():
    g = torch.Generator().manual_seed(5)
    return {k: torch.rand((s.n_params, s.level_dim), generator=g) - 0.5 for k, s in GRIDS.items()}


@pytest.mark.parametrize("where", ["inside", "faces", "outside", "empty"])
@pytest.mark.parametrize("grad", [True, False])
@pytest.mark.parametrize("grid", list(GRIDS))
def test_one_corner_encode_equals_encode_rows_and_gather_rows(tables, grid, grad, where):
    spec = GRIDS[grid]
    x, u = points(where)
    N, L = x.shape[0], spec.num_levels
    rows = thg.encode_rows(x, spec, stochastic_u=u)[0]
    table = tables[grid].clone().requires_grad_(grad)
    ref = thg.GatherRows.apply(table, rows).reshape(N, L * spec.level_dim)
    before = launches("hashgrid_encode")
    got = thg.hashgrid_encode(table, x, spec, stochastic_u=u)
    assert launches("hashgrid_encode") == before          # the plain version launches nothing
    assert got.shape == (N, L * spec.level_dim) and got.dtype == torch.float32
    assert torch.equal(got, ref)
    if not grad:
        assert got.grad_fn is None
        return
    (saved,) = got.grad_fn.saved_tensors
    assert saved.dtype == torch.int32 and torch.equal(saved, rows)
    cot = torch.randn(got.shape, generator=torch.Generator().manual_seed(6))
    (g_got,) = torch.autograd.grad(got, table, cot)
    (g_ref,) = torch.autograd.grad(ref, table, cot)
    assert torch.equal(g_got, g_ref)


@pytest.mark.parametrize("grid", list(GRIDS))
def test_one_corner_encode_under_no_grad_keeps_no_rows(tables, grid):
    """The occupancy update's call: under no_grad nothing is saved, and
    max_level still zeroes the levels above it after the call."""
    spec = GRIDS[grid]
    x, u = points("inside")
    table = tables[grid].clone().requires_grad_(True)
    with torch.no_grad():
        got = thg.hashgrid_encode(table, x, spec, stochastic_u=u, max_level=5)
    assert got.grad_fn is None
    ref = thg.one_corner_plain(tables[grid], x, u, spec)[0].reshape(-1, spec.num_levels, 2)
    ref[:, 5:] = 0.0
    assert torch.equal(got, ref.reshape(got.shape))


@pytest.mark.parametrize("grid", list(GRIDS))
def test_level_block_equals_level_meta_and_tv_levels(grid):
    """K5's block equals the grid's layout, and so do the layout's device
    constants; the layout equals the tests' level-by-level copy."""
    spec = GRIDS[grid]
    blk, lay = thg.level_block(spec), spec.layout
    lv = thg.level_tensors(spec, torch.device("cpu"))
    L = spec.num_levels
    for got, ref in zip((lay.offsets, lay.scales, lay.resolutions, lay.dense),
                        hashgrid_level_meta(spec)):
        assert np.array_equal(got, ref)
    assert blk.num_levels == L
    assert [bool(blk.dense >> lvl & 1) for lvl in range(L)] == lay.dense.tolist() \
        == lv.dense.reshape(-1).tolist()
    got_scales = np.array(blk.scale[:L], dtype=np.float32)
    assert np.array_equal(got_scales, lay.scales.astype(np.float32))
    assert np.array_equal(got_scales, lv.scales.reshape(-1).numpy())
    assert list(blk.offset[:L]) == lay.offsets[:-1].tolist() == lv.offsets.reshape(-1).tolist()
    assert list(blk.size[:L]) == np.diff(lay.offsets).tolist() == lv.sizes.reshape(-1).tolist()
    assert [list(m) for m in blk.mult[:L]] == lay.mult.tolist() == lv.mult.reshape(L, 3).tolist()
    assert all(list(m) == list(thg.PRIMES) for m, d in zip(blk.mult[:L], lay.dense) if not d)
    assert lv.corners.tolist() == lay.corners.tolist()


@pytest.mark.parametrize("where", ["inside", "faces", "outside", "empty"])
@pytest.mark.parametrize("path", ["exact", "one_corner"])
@pytest.mark.parametrize("grid", list(GRIDS))
def test_encode_rows_equal_the_per_level_loop(tables, grid, path, where):
    """All levels at once against the loop over the levels, bit for bit: the
    rows and, on the exact path, the weights, the features and the table
    gradient through ``GatherRows`` (the exact encode of ``hashgrid_encode``)."""
    spec = GRIDS[grid]
    assert spec.layout.dense.any() and not spec.layout.dense.all()
    x, u = points(where)
    u = u if path == "one_corner" else None
    rows, w = thg.encode_rows(x, spec, stochastic_u=u)
    ref_rows, ref_w = encode_rows_per_level(x, spec, stochastic_u=u)
    assert rows.dtype == torch.int32 and torch.equal(rows, ref_rows)
    if path == "one_corner":
        assert w is None
        return
    assert w.dtype == torch.float32 and torch.equal(w.view(torch.int32), ref_w.view(torch.int32))
    N, L, C = x.shape[0], spec.num_levels, spec.level_dim
    table = tables[grid].clone().requires_grad_(True)
    got = thg.hashgrid_encode(table, x, spec)
    vals = thg.GatherRows.apply(table, ref_rows).reshape(N, L, 8, C)
    ref = torch.sum(vals * ref_w[..., None], dim=2).reshape(N, L * C)
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))
    cot = torch.randn(got.shape, generator=torch.Generator().manual_seed(7))
    (g_got,) = torch.autograd.grad(got, table, cot)
    (g_ref,) = torch.autograd.grad(ref, table, cot)
    assert torch.equal(g_got.view(torch.int32), g_ref.view(torch.int32))


def k5_mirror(x, u, spec, bound=1.0):
    """K5's arithmetic in numpy, from the block its launcher gets: each fp32
    operation rounded by itself, uint32 products and sums wrapping."""
    blk = thg.level_block(spec)
    x, u = x.numpy(), u.numpy()
    v = (x + np.float32(bound)) / np.float32(2.0 * bound)
    v = np.minimum(np.maximum(v, np.float32(0.0)), np.float32(1.0))
    cols = []
    for lvl in range(blk.num_levels):
        pos = v * np.float32(blk.scale[lvl]) + np.float32(0.5)
        g = np.floor(pos)
        c = g.astype(np.uint32) + (u < pos - g).astype(np.uint32)
        a, b, e = (c[:, d] * np.uint32(blk.mult[lvl][d]) for d in range(3))
        idx = a + b + e if blk.dense >> lvl & 1 else a ^ b ^ e
        cols.append(np.uint32(blk.offset[lvl]) + idx % np.uint32(blk.size[lvl]))
    return np.stack(cols, axis=1).astype(np.int32)


@pytest.mark.parametrize("where", ["inside", "faces", "outside"])
@pytest.mark.parametrize("grid", list(GRIDS))
def test_k5_arithmetic_mirrored_gives_the_plain_rows(grid, where):
    spec = GRIDS[grid]
    x, u = points(where, P=20_000, seed=9)
    with np.errstate(over="ignore"):
        rows = k5_mirror(x, u, spec)
    assert np.array_equal(rows, thg.encode_rows(x, spec, stochastic_u=u)[0].numpy())


@pytest.mark.parametrize("case", ["level_dim", "levels", "device"])
def test_one_corner_kernel_refuses_what_k5_does_not_take(case):
    spec = {"level_dim": thg.HashGridSpec(num_levels=4, level_dim=4, log2_hashmap_size=10),
            "levels": thg.HashGridSpec(num_levels=33, log2_hashmap_size=10),
            "device": thg.HashGridSpec(num_levels=4, log2_hashmap_size=10)}[case]
    x, u = points("inside", P=10)
    table = torch.zeros((spec.n_params, spec.level_dim))
    with pytest.raises(ValueError, match="K5"):
        thg.one_corner_kernel(table, x, u, spec)
