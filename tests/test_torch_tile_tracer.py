"""Port vs reference: the tile tracer (ops/tile_tracer.py), K1's plain version
against the Pallas queue kernel in interpret mode, on the bumpy-sphere
fixtures of tests/test_tile_tracer.py.

Tolerances: candidate tables, budgets, `dropped` and `uncertain` exact
(integer or selection results of identical float arithmetic); hit prims
agree on >= 99.9% of rays (shared-edge ties); where they agree, t within
1e-5 relative and u, v within 5e-5 of their [0, 1] range: XLA's CPU code
rounds the barycentric dot products differently (it may fuse
multiply-adds; the port, like the kernel, does not), and on grazing
triangles the division by a small determinant magnifies that to ~3e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mirres_restir_nerf_mesh_tpu.ops import cluster_bvh as jc
from mirres_restir_nerf_mesh_tpu.ops import tile_tracer as jt
from mirres_restir_nerf_mesh_torch.ops import cluster_bvh as tc
from mirres_restir_nerf_mesh_torch.ops import tile_tracer as tt

from test_torch_helpers import TORCH_THREADS, bumpy_sphere, camera_rays, n, shell_rays, t

torch.set_num_threads(TORCH_THREADS)


@pytest.fixture(scope="module")
def mesh32():
    v, tr = bumpy_sphere(32, 64)
    return (jc.build_clusters(jnp.asarray(v), jnp.asarray(tr), 128),
            tc.build_clusters(t(v), t(tr), 128))


def assert_hits_match(ref, got):
    rp, gp = np.asarray(ref.prim), n(got.prim)
    same = rp == gp
    assert same.mean() >= 0.999, f"prim agreement {same.mean()}"
    hit = same & (rp >= 0)
    np.testing.assert_allclose(n(got.t)[hit], np.asarray(ref.t)[hit], rtol=1e-5, err_msg="t")
    for f in ("u", "v"):
        np.testing.assert_allclose(n(getattr(got, f))[hit], np.asarray(getattr(ref, f))[hit],
                                   rtol=0, atol=5e-5, err_msg=f)


def tiles_of(o, d, tm, R):
    N = o.shape[0]
    pad = (-N) % R
    o = np.concatenate([o, np.zeros((pad, 3), np.float32)])
    d = np.concatenate([d, np.ones((pad, 3), np.float32)])
    tm = np.concatenate([tm, np.zeros((pad,), np.float32)])
    T = o.shape[0] // R
    return o.reshape(T, R, 3), d.reshape(T, R, 3), tm.reshape(T, R)


@pytest.mark.parametrize("any_hit", [False, True])
def test_candidates_budget_and_queue_kernel_match(mesh32, any_hit):
    """_octant_candidates_blocked, the budget and the queue kernel on the same
    tiles: tables exact, kernel rows as hits."""
    jcm, tcm = mesh32
    o, d = shell_rays(2048, seed=3)
    alive = np.random.RandomState(4).rand(2048) < 0.6
    alive[1024:1536] = False                       # one fully dead tile block
    tm = np.where(alive, 1e9, 0.0).astype(np.float32)
    rot, rdt, tmt = tiles_of(o, d, tm, 256)
    k_cap = 20                                      # < C: exercises `dropped`
    ref = jt._octant_candidates_blocked(jcm, jnp.asarray(rot), jnp.asarray(rdt), jnp.asarray(tmt),
                                        1e-4, k_cap)
    got = tt._octant_candidates_blocked(tcm, t(rot), t(rdt), t(tmt), 1e-4, k_cap)
    for name, a, b in zip(("cand", "octs", "counts", "dropped", "entries"), ref, got):
        np.testing.assert_array_equal(n(b), np.asarray(a), err_msg=name)
    assert np.isfinite(np.asarray(ref[3])).any()

    rays_cm = np.zeros((rot.shape[0], 8, 256), np.float32)
    rays_cm[:, 0:3], rays_cm[:, 3:6], rays_cm[:, 6] = rot.transpose(0, 2, 1), rdt.transpose(0, 2, 1), tmt
    out_ref, dropped_ref = jt._run_queue(jcm, *ref, jnp.asarray(rays_cm), t_min=1e-4,
                                         any_hit=any_hit, S=128, R=256, q_avg=64)
    n_active, dropped = tt._queue_budget(*got[2:5], 64)
    np.testing.assert_array_equal(n(dropped), np.asarray(dropped_ref))
    out = tt.queue_trace(tcm.geom_cm, t(rays_cm), got[0], got[1], n_active, 1e-4, any_hit)
    ro, go = np.asarray(out_ref)[:, :5], n(out)
    found = ro[:, 0] < 1e29
    np.testing.assert_array_equal(go[:, 0] < 1e29, found)
    if not any_hit:
        same = (ro[:, 1] == go[:, 1]) & (ro[:, 4] == go[:, 4])
        assert same[found].mean() >= 0.999
        m = found & same
        np.testing.assert_allclose(go[:, 0][m], ro[:, 0][m], rtol=1e-5)
        for row in (2, 3):
            np.testing.assert_allclose(go[:, row][m], ro[:, row][m], rtol=0, atol=5e-5)


def test_queue_budget_clip_matches_reference(mesh32):
    """A crowded launch that the global budget clips: n_active and `dropped`
    exactly as the reference's _run_queue (:541-567)."""
    jcm, _ = mesh32
    C = jcm.prim.shape[0]
    rng = np.random.RandomState(0)
    T, K, R = 64, 512, 128
    counts = rng.randint(120, K + 1, T).astype(np.int32)
    counts[:4] = 0
    ent = np.sort(rng.uniform(0, 3, (T, K)).astype(np.float32), 1)
    ent[np.arange(K)[None] >= counts[:, None]] = np.inf
    cand = rng.randint(0, C, (T, K)).astype(np.int32)
    octs = rng.randint(1, 256, (T, K)).astype(np.int32)
    dropped = np.where(counts == K, 5.0, np.inf).astype(np.float32)
    _, dropped_ref = jt._run_queue(
        jcm, jnp.asarray(cand), jnp.asarray(octs), jnp.asarray(counts), jnp.asarray(dropped),
        jnp.asarray(ent), jnp.zeros((T, 8, R), jnp.float32), t_min=1e-4, any_hit=False,
        S=128, R=R, q_avg=64,
    )
    n_active, got = tt._queue_budget(t(counts).long(), t(dropped), t(ent), 64)
    np.testing.assert_array_equal(n(got), np.asarray(dropped_ref))
    assert (n(n_active) < counts).any(), "fixture must trigger the budget clip"
    assert (n(n_active)[:4] == 0).all()


@pytest.mark.parametrize("mode", [False, True, "dir", "morton", "morton_dir2"])
def test_tile_trace_sort_modes_match(mesh32, mode):
    """Whole tile_trace per sort mode, closest and any hit, at a tight
    candidate cap so `uncertain` is mixed and must match exactly."""
    jcm, tcm = mesh32
    o, d = shell_rays(1024, seed=11)
    tm = np.where(np.random.RandomState(2).rand(1024) < 0.8, 1e9, 0.0).astype(np.float32)
    kw = dict(k_cap=12, sort_octants=mode, sort_block=512, t_max=tm)
    for any_hit in (False, True):
        ref = jt.tile_trace(jcm, jnp.asarray(o), jnp.asarray(d), any_hit=any_hit,
                            **{**kw, "t_max": jnp.asarray(tm)})
        got = tt.tile_trace(tcm, t(o), t(d), any_hit=any_hit, **{**kw, "t_max": t(tm)})
        np.testing.assert_array_equal(n(got.uncertain), np.asarray(ref.uncertain))
        assert_hits_match(ref.hit, got.hit)
    u = np.asarray(ref.uncertain)
    assert u.any() and not u.all()


def test_tile_trace_coherent_rays_match(mesh32):
    """Camera-shaped (coherent, unsorted) batch with padding: full budget,
    nothing uncertain, hits as the reference."""
    jcm, tcm = mesh32
    o, d = camera_rays(700, seed=5)
    C = jcm.prim.shape[0]
    ref = jt.tile_trace(jcm, jnp.asarray(o), jnp.asarray(d), k_cap=C)
    got = tt.tile_trace(tcm, t(o), t(d), k_cap=C)
    assert not n(got.uncertain).any()
    assert_hits_match(ref.hit, got.hit)
    np.testing.assert_allclose(n(got.hit.normal), np.asarray(ref.hit.normal), rtol=1e-5, atol=1e-7)


def test_two_level_prep_matches(monkeypatch):
    """Above HIER_MIN_C the prep goes through superclusters; a tight keep
    budget makes `dropped` and `uncertain` depend on it."""
    v, tr = bumpy_sphere(48, 96)
    jcm = jc.build_clusters(jnp.asarray(v), jnp.asarray(tr), 128)
    tcm = tc.build_clusters(t(v), t(tr), 128)
    for mod in (jt, tt):
        monkeypatch.setattr(mod, "HIER_MIN_C", 1)
        monkeypatch.setattr(mod, "HIER_KEEP", 3)
    o, d = shell_rays(1024, seed=9, radius=1.4)
    rot, rdt, tmt = tiles_of(o, d, np.full((1024,), 1e9, np.float32), 512)
    ref = jt._octant_candidates(jcm, jnp.asarray(rot), jnp.asarray(rdt), jnp.asarray(tmt), 1e-4, 64)
    got = tt._octant_candidates(tcm, t(rot), t(rdt), t(tmt), 1e-4, 64)
    for name, a, b in zip(("cand", "octs", "counts", "dropped", "entries"), ref, got):
        np.testing.assert_array_equal(n(b), np.asarray(a), err_msg=name)
    ref_t = jt.tile_trace(jcm, jnp.asarray(o), jnp.asarray(d), k_cap=64, sort_octants="morton")
    got_t = tt.tile_trace(tcm, t(o), t(d), k_cap=64, sort_octants="morton")
    np.testing.assert_array_equal(n(got_t.uncertain), np.asarray(ref_t.uncertain))
    assert np.asarray(ref_t.uncertain).any()
    assert_hits_match(ref_t.hit, got_t.hit)


@pytest.mark.parametrize("any_hit", [False, True])
def test_tile_trace_grid_matches_reference(mesh32, any_hit):
    """queue=False (the dense grid, kernel K2 and its plain version): no
    work budget, `dropped` from the k_cap cut alone.  Hits, `uncertain` and
    `dropped` as the reference's interpret-mode _kernel, closest and any hit."""
    jcm, tcm = mesh32
    o, d = shell_rays(1536, seed=21)
    tm = np.where(np.random.RandomState(5).rand(1536) < 0.7, 1e9, 0.0).astype(np.float32)
    kw = dict(k_cap=12, sort_octants="morton", queue=False)
    ref = jt.tile_trace(jcm, jnp.asarray(o), jnp.asarray(d), any_hit=any_hit,
                        t_max=jnp.asarray(tm), **kw)
    got = tt.tile_trace(tcm, t(o), t(d), any_hit=any_hit, t_max=t(tm), **kw)
    np.testing.assert_array_equal(n(got.uncertain), np.asarray(ref.uncertain))
    u = np.asarray(ref.uncertain)
    assert u.any() and not u.all()
    assert_hits_match(ref.hit, got.hit)
    work = tt.prepare_trace(tcm, t(o), t(d), t_max=t(tm), **kw)
    assert torch.equal(work.n_active, work.counts)
    tiles = (work.rays_cm[:, 0:3].transpose(1, 2), work.rays_cm[:, 3:6].transpose(1, 2),
             work.rays_cm[:, 6])
    dropped_ref = jt._octant_candidates_blocked(jcm, *(jnp.asarray(n(x)) for x in tiles), 1e-4, 12)[3]
    np.testing.assert_array_equal(n(work.dropped), np.asarray(dropped_ref))
    assert np.isfinite(np.asarray(dropped_ref)).any()
    occ, unc = tt.occluded_tiles_t(tcm, t(o), t(d), t(tm), k_cap=12, sort_octants="morton",
                                   queue=False)
    occ_ref, unc_ref = jt.occluded_tiles_t(jcm, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tm),
                                           k_cap=12, sort_octants="morton", queue=False)
    np.testing.assert_array_equal(n(occ), np.asarray(occ_ref))
    np.testing.assert_array_equal(n(unc), np.asarray(unc_ref))
