"""Port vs reference: the rules the redesigned kernels follow, in plain
PyTorch on the CPU.

- K1/K2 split a small launch's tiles over several blocks and combine them
  by the smallest (t, candidate position, slot) per ray
  (``tile_tracer.queue_trace_split_plain``): that must give the unsplit
  ``queue_trace_plain`` rows bit for bit, also on crafted ties (one cluster
  at two positions, a copy of a cluster under another id, so the same t
  and slot in two clusters), and the JAX ``tile_trace`` through the whole
  entry point.
- K4's [N, Kc] entry (the layout ``GatherRows`` passes) gives the 1-D
  entry's and the reference's sums.

Tolerances: the tile tracer as in test_torch_tile_tracer.py (rows of the
port exact; against JAX prims >= 99.9%, t within 1e-5 relative, u, v
within 5e-5); K4 exact against the 1-D entry (the same plain sum) and
within 1e-5 * sum|upd| per row against the reference's fp32 scatter.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mirres_restir_nerf_mesh_tpu.ops import cluster_bvh as jc
from mirres_restir_nerf_mesh_tpu.ops import tile_tracer as jt
from mirres_restir_nerf_mesh_torch.ops import cluster_bvh as tc
from mirres_restir_nerf_mesh_torch.ops import tile_tracer as tt
from mirres_restir_nerf_mesh_torch.ops.scatter import scatter_add, scatter_add_plain

from test_torch_helpers import TORCH_THREADS, bumpy_sphere, n, shell_rays, t
from test_torch_tile_tracer import assert_hits_match

torch.set_num_threads(TORCH_THREADS)


@pytest.fixture(scope="module")
def mesh32():
    v, tr = bumpy_sphere(32, 64)
    return (jc.build_clusters(jnp.asarray(v), jnp.asarray(tr), 128),
            tc.build_clusters(t(v), t(tr), 128))


@pytest.mark.parametrize("n_tiles,sms,want", [(58, 132, 5), (128, 132, 3), (576, 132, 1),
                                              (2048, 132, 1), (1, 132, 8), (0, 132, 8)])
def test_split_factor(n_tiles, sms, want):
    assert tt.split_factor(n_tiles, sms) == want


@pytest.mark.parametrize("any_hit", [False, True])
def test_split_combine_equals_unsplit(mesh32, any_hit):
    """Random incoherent rays, k_cap 24, dead lanes: every split gives the
    unsplit rows."""
    _, tcm = mesh32
    o, d = shell_rays(1536, seed=13)
    tm = np.where(np.random.RandomState(3).rand(1536) < 0.8, 1e9, 0.0).astype(np.float32)
    work = tt.prepare_trace(tcm, t(o), t(d), t_max=t(tm), k_cap=24, sort_octants="morton",
                            tile=256)
    args = (tcm.geom_cm, work.rays_cm, work.cand, work.octs, work.n_active, 1e-4, any_hit)
    ref = tt.queue_trace_plain(*args)
    assert (ref[:, 0] < 1e29).any()
    for split in (2, 3, 8):
        assert torch.equal(tt.queue_trace_split_plain(*args, split=split), ref), split


@pytest.mark.parametrize("any_hit", [False, True])
def test_split_combine_crafted_ties(mesh32, any_hit):
    """Each tile's first candidate repeated at position 1 and, as a copy of
    its geometry under a new cluster id, at position 2: the same t at the
    same slot in three places.  The sequential rule keeps position 0 (its
    cluster id), whichever part of a split finds it first."""
    _, tcm = mesh32
    o, d = shell_rays(1024, seed=17)
    work = tt.prepare_trace(tcm, t(o), t(d), k_cap=16, tile=256)
    C = tcm.geom_cm.shape[0]
    T = work.cand.shape[0]
    geom = torch.cat([tcm.geom_cm, tcm.geom_cm[work.cand[:, 0].long()]])
    cand, octs = work.cand.clone(), work.octs.clone()
    cand[:, 1] = cand[:, 0]
    octs[:, 1] = octs[:, 0]
    cand[:, 2] = C + torch.arange(T)
    octs[:, 2] = octs[:, 0]
    n_run = torch.clamp_min(work.n_active, 3)
    args = (geom, work.rays_cm, cand, octs, n_run, 1e-4, any_hit)
    ref = tt.queue_trace_plain(*args)
    hit = ref[:, 0] < 1e29
    assert hit.any()
    if not any_hit:   # some hits lie in the tied clusters, and keep position 0's id
        tied = hit & (ref[:, 4] == cand[:, 0, None].float())
        assert tied.any()
        assert not (ref[:, 4] >= C).any()
    for split in (2, 3):
        assert torch.equal(tt.queue_trace_split_plain(*args, split=split), ref), split


@pytest.mark.parametrize("any_hit", [False, True])
def test_split_combine_through_entry_point(mesh32, monkeypatch, any_hit):
    """tile_trace with K1's plain version replaced by the split rule (3
    parts): hits and uncertain as the JAX reference's, and equal to the
    unsplit port's."""
    jcm, tcm = mesh32
    o, d = shell_rays(1024, seed=11)
    tm = np.where(np.random.RandomState(2).rand(1024) < 0.8, 1e9, 0.0).astype(np.float32)
    kw = dict(k_cap=12, sort_octants="morton", sort_block=512, any_hit=any_hit)
    unsplit = tt.tile_trace(tcm, t(o), t(d), t_max=t(tm), **kw)
    monkeypatch.setattr(tt, "queue_trace",
                        lambda *a: tt.queue_trace_split_plain(*a, split=3))
    got = tt.tile_trace(tcm, t(o), t(d), t_max=t(tm), **kw)
    ref = jt.tile_trace(jcm, jnp.asarray(o), jnp.asarray(d), t_max=jnp.asarray(tm), **kw)
    for f in ("t", "prim", "u", "v", "normal"):
        assert torch.equal(getattr(got.hit, f), getattr(unsplit.hit, f)), f
    assert torch.equal(got.uncertain, unsplit.uncertain)
    np.testing.assert_array_equal(n(got.uncertain), np.asarray(ref.uncertain))
    assert_hits_match(ref.hit, got.hit)


@pytest.mark.parametrize("cols", [128, 16, 3])
def test_scatter_2d_entry_matches_1d_and_reference(cols):
    rng = np.random.RandomState(cols)
    N, rows = 700, 4000
    idx = rng.randint(0, rows, (N, cols)).astype(np.int32)
    idx[:, : max(1, cols // 4)] = rng.randint(0, 20, (N, max(1, cols // 4)))
    idx[rng.rand(N, cols) < 0.05] = -1
    upd = rng.normal(size=(N, cols, 2)).astype(np.float32)
    flat = scatter_add(t(idx).reshape(-1), t(upd).reshape(-1, 2), rows)
    for u in (t(upd), t(upd).reshape(-1, 2)):
        assert torch.equal(scatter_add(t(idx), u, rows), flat)
    keep = idx.reshape(-1) >= 0
    ref = np.asarray(jnp.zeros((rows, 2), jnp.float32)
                     .at[jnp.asarray(idx.reshape(-1)[keep])].add(jnp.asarray(upd.reshape(-1, 2)[keep])))
    mag = n(scatter_add_plain(t(idx), t(np.abs(upd)), rows))
    assert (np.abs(n(flat) - ref) <= 1e-5 * mag + 1e-30).all()


def test_scatter_2d_entry_checks():
    idx = torch.zeros((4, 8), dtype=torch.int32)
    with pytest.raises(ValueError):
        scatter_add(idx, torch.ones((4, 7, 2)), 10)      # columns differ
    with pytest.raises(ValueError):
        scatter_add(idx, torch.ones((31, 2)), 10)        # M differs
    with pytest.raises(TypeError):
        scatter_add(idx[None], torch.ones((1, 4, 8, 2)), 10)
    out = scatter_add(idx, torch.ones((4, 8, 2)), 10)
    np.testing.assert_array_equal(n(out)[0], [32, 32])
