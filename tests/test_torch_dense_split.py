"""Port vs reference: the rules of the redesigned dense tracer (K3), in
plain PyTorch on the CPU.

- The closest hit splits the triangle range over several parts and
  combines them by the smallest (t, index) per ray
  (``dense_tracer.dense_hit_split_plain``): that must give the unsplit
  ``dense_hit_plain`` bit for bit, also on crafted ties (the mesh three
  times over, so every hit's t recurs at indices in different parts).
- The any hit (``dense_occluded_plain``, the dense route of
  ``occluded_tiles_t``) must equal the closest hit's ``prim >= 0`` and the
  reference's ``occluded_tiles_t`` on the dense path, with per-ray t_max
  that includes dead lanes and t_max equal to a hit's t.
- ``intersect_tiles_t(any_hit=True)`` on the dense path keeps the closest
  hit, the reference's HitResult.
- ``_intersect_dense`` reads the cluster SoA; the padded [16, Mpad] table
  gives the same rows; the route's octant + origin order (``dense_order``)
  gives every ray its unsorted answer.
- The kernel's culls (csrc/dense_hit.cu ``cull_mt`` before the division,
  written out here, and the warp-bundle test ``group_maybe``, whose mirror
  ``dense_tracer.bundle_keep_plain`` also counts the work the kernel cannot
  skip), in the same fp32 operations, never drop a test that mirres_mt
  accepts.

Tolerances: port against port exact; against JAX the prims (masks) on
>= 99.9% of rays with t within 1e-5 relative and u, v within 5e-5, as in
test_torch_tracer.py (XLA's CPU code may round a cancelling sum
differently), exact where both sides compute the same t.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mirres_restir_nerf_mesh_tpu.ops import cluster_bvh as jc
from mirres_restir_nerf_mesh_tpu.ops import tile_tracer as jt
from mirres_restir_nerf_mesh_torch.ops import cluster_bvh as tc
from mirres_restir_nerf_mesh_torch.ops import dense_tracer as td
from mirres_restir_nerf_mesh_torch.ops import tile_tracer as tt

from test_torch_helpers import TORCH_THREADS, bumpy_sphere, camera_rays, n, shell_rays, t

torch.set_num_threads(TORCH_THREADS)


def rays_towards(count, seed, radius=1.5):
    o, _ = shell_rays(count, seed=seed, radius=radius)
    d = np.random.RandomState(seed + 1).normal(size=o.shape).astype(np.float32) * 0.4 - o
    return o, (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)


@pytest.fixture(scope="module")
def tripled():
    """The mesh three times over in one [16, Mpad] table (prim = column of
    the first copy): every hit's t recurs in three places."""
    v, tr = bumpy_sphere(12, 26)
    cm = td.pack_tris_cm(t(v), t(tr))[:10, :tr.shape[0]]
    return td.tris_cm_from_soa(torch.cat([cm, cm, cm], dim=1)), tr.shape[0]


@pytest.mark.parametrize("n_ray_blocks,sms,blocks,want", [
    (512, 132, 24, 6), (231, 132, 24, 10), (2300, 132, 24, 6), (8192, 132, 40, 10),
    (1, 132, 24, 16), (1, 132, 3, 3), (100, 132, 1, 1)])
def test_split_factor(n_ray_blocks, sms, blocks, want):
    assert td.split_factor(n_ray_blocks, sms, blocks) == want


@pytest.mark.parametrize("M,split", [(1, 1), (255, 2), (6016, 5), (6016, 16), (1800, 8)])
def test_part_bounds_cover_in_order(M, split):
    b = td.part_bounds(M, split)
    assert b[0][0] == 0 and b[-1][1] == M and len(b) == split
    for (a0, a1), (b0, _) in zip(b, b[1:]):
        assert a1 == b0 and a0 <= a1 and a0 % td.KERNEL_BM == 0


@pytest.mark.parametrize("split", [2, 3, 5, 8])
def test_split_combine_crafted_ties(tripled, split):
    tris, m0 = tripled
    o, d = rays_towards(700, seed=21)
    ref = td.dense_hit_plain(tris, t(o), t(d))
    hit = ref[1] >= 0
    assert hit.sum() > 200 and (ref[1][hit] < m0).all()   # the first copy wins
    got = td.dense_hit_split_plain(tris, t(o), t(d), split=split)
    for a, b in zip(got, ref):
        assert same_bits(a, b)


def same_bits(a, b):
    return a.dtype == b.dtype and torch.equal(a.view(torch.int32) if a.is_floating_point() else a,
                                              b.view(torch.int32) if b.is_floating_point() else b)


@pytest.mark.parametrize("neg_first", [False, True])
def test_split_combine_signed_zero_tie(neg_first):
    """One triangle with t = +0 and one with t = -0 (the origin on their
    plane, det of either sign; t_min < 0), in different parts: the first
    index wins with its own t, whichever sign comes first."""
    e1, e2 = [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]
    neg = torch.tensor([0.0, 0.0, 0.0, *e1, *e2, 0.0])    # det -1: t = -0
    pos = torch.tensor([0.0, 0.0, 0.0, *e2, *e1, 1.0])    # det +1: t = +0
    tris = torch.zeros((10, 2 * td.KERNEL_BM))
    tris[9] = -1.0
    tris[:, 0], tris[:, td.KERNEL_BM] = (neg, pos) if neg_first else (pos, neg)
    o = torch.tensor([[0.0, 0.25, 0.25]])
    d = torch.tensor([[1.0, 0.0, 0.0]])
    ref = td.dense_hit_plain(tris, o, d, t_min=-1.0)
    assert int(ref[1][0]) == 0 and float(ref[0][0]) == 0.0
    assert bool(torch.signbit(ref[0][0])) == neg_first
    got = td.dense_hit_split_plain(tris, o, d, t_min=-1.0, split=2)
    for x, y in zip(got, ref):
        assert same_bits(x, y)


def small_mesh():
    v, tr = bumpy_sphere(13, 17)           # C*S padding, ragged against the staged block
    return v, tr, jc.build_clusters(jnp.asarray(v), jnp.asarray(tr), 128), \
        tc.build_clusters(t(v), t(tr), 128)


def test_occluded_equals_closest_and_reference():
    v, tr, jcm, tcm = small_mesh()
    o, d = camera_rays(900, seed=23)
    closest = tc._intersect_dense(tcm, t(o), t(d), 1e-4, torch.full((900,), 1e10))
    ref_t = np.asarray(jc._intersect_dense(jcm, jnp.asarray(o), jnp.asarray(d), 1e-4,
                                           jnp.full((900,), 1e10)).t)
    t_hit = n(closest.t)
    rs = np.random.RandomState(24)
    tm = rs.uniform(0.2, 4.0, 900).astype(np.float32)
    same_t = np.isfinite(t_hit) & (t_hit == ref_t)
    k = rs.rand(900)
    tm = np.where(same_t & (k < 0.3), t_hit, tm)                   # t_max at the hit's t
    tm = np.where((k >= 0.3) & (k < 0.5), rs.choice([0.0, 1e-4, -1.0], 900), tm)   # dead lanes
    tm = tm.astype(np.float32)
    assert (same_t & (k < 0.3)).sum() > 50 and (tm <= 1e-4).sum() > 100
    occ, unc = tt.occluded_tiles_t(tcm, t(o), t(d), t(tm))
    assert not unc.any()
    got_closest = tc._intersect_dense(tcm, t(o), t(d), 1e-4, t(tm)).prim >= 0
    assert torch.equal(occ, got_closest)
    assert torch.equal(occ, td.dense_occluded_plain(tcm.soa, t(o), t(d), t(tm)))
    assert not occ[torch.from_numpy(tm <= 1e-4)].any()
    assert not occ[torch.from_numpy(same_t & (k < 0.3))].any()    # t < t_max is strict
    ref, ref_unc = jt.occluded_tiles_t(jcm, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tm))
    assert not np.asarray(ref_unc).any()
    np.testing.assert_array_equal(n(occ), np.asarray(ref))


def test_occluded_parts_or_to_whole():
    """The any hit's split: the parts' masks OR to the whole mask."""
    _, _, _, tcm = small_mesh()
    o, d = camera_rays(400, seed=25)
    tm = t(np.random.RandomState(26).uniform(0.0, 3.0, 400).astype(np.float32))
    whole = td.dense_occluded_plain(tcm.soa, t(o), t(d), tm)
    assert whole.any() and not whole.all()
    for split in (2, 3):
        parts = torch.zeros_like(whole)
        for a, b in td.part_bounds(tcm.soa.shape[1], split):
            parts |= td.dense_occluded_plain(tcm.soa[:, a:b], t(o), t(d), tm)
        assert torch.equal(parts, whole)


def test_intersect_any_hit_keeps_closest_hit():
    v, tr, jcm, tcm = small_mesh()
    o, d = camera_rays(500, seed=27)
    tmax = np.random.RandomState(28).uniform(1.0, 4.0, 500).astype(np.float32)
    got = tt.intersect_tiles_t(tcm, t(o), t(d), t_max=t(tmax), any_hit=True)
    closest = tt.intersect_tiles_t(tcm, t(o), t(d), t_max=t(tmax), any_hit=False)
    for f in got.hit._fields:
        assert torch.equal(getattr(got.hit, f), getattr(closest.hit, f)), f
    assert not got.uncertain.any()
    ref = jc._intersect_dense(jcm, jnp.asarray(o), jnp.asarray(d), 1e-4, jnp.asarray(tmax))
    same = n(got.hit.prim) == np.asarray(ref.prim)
    assert same.mean() >= 0.999
    hit = same & (np.asarray(ref.prim) >= 0)
    assert hit.sum() > 50 and (np.asarray(ref.prim) < 0).sum() > 10
    np.testing.assert_allclose(n(got.hit.t)[hit], np.asarray(ref.t)[hit], rtol=1e-5)
    for f in ("u", "v"):
        np.testing.assert_allclose(n(getattr(got.hit, f))[hit], np.asarray(getattr(ref, f))[hit],
                                   rtol=0, atol=5e-5)


@pytest.mark.parametrize("any_hit", [False, True])
def test_sorted_route_equals_input_order(monkeypatch, any_hit):
    """The dense route in octant + origin order (forced here below its
    65,536-ray threshold) gives every ray the answer of the unsorted pass,
    back in input order."""
    _, _, _, tcm = small_mesh()
    o, d = shell_rays(1500, seed=33)
    tm = t(np.where(np.random.RandomState(34).rand(1500) < 0.7, 1e9, 0.0).astype(np.float32))
    assert tt.dense_order(tcm, t(o), t(d), tm, "morton")[3] is None     # below the threshold
    monkeypatch.setattr(tt, "DENSE_SORT_MIN", 0)
    perm = tt.dense_order(tcm, t(o), t(d), tm, "morton")[3]
    assert perm is not None and not torch.equal(perm, torch.arange(1500))
    if any_hit:
        got = tt.occluded_tiles_t(tcm, t(o), t(d), tm, sort_octants="morton")[0]
        ref = tt.occluded_tiles_t(tcm, t(o), t(d), tm)[0]
        assert got.any() and torch.equal(got, ref)
    else:
        got = tt.intersect_tiles_t(tcm, t(o), t(d), t_max=tm, sort_octants="morton").hit
        ref = tt.intersect_tiles_t(tcm, t(o), t(d), t_max=tm).hit
        assert (ref.prim >= 0).any()
        for f in ref._fields:
            assert same_bits(getattr(got, f), getattr(ref, f)), f


def test_soa_route_equals_padded_table():
    v, tr = bumpy_sphere(13, 17)
    tcm = tc.build_clusters(t(v), t(tr), 100)     # S % 128 != 0: the dense path at any size
    o, d = camera_rays(300, seed=29)
    assert tcm.soa.shape[1] % td.BM != 0 and tt._takes_dense(tcm, 0)
    a = td.dense_hit(tcm.soa, t(o), t(d))
    b = td.dense_hit(td.tris_cm_from_soa(tcm.soa), t(o), t(d))
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    # a row-strided view (the left half of a wider table) is taken as is
    M = tcm.soa.shape[1]
    wide = torch.zeros((10, M + 7))
    wide[:, :M] = tcm.soa
    c = td.dense_hit(wide[:, :M], t(o), t(d))
    for x, y in zip(a, c):
        assert torch.equal(x, y)


def cull_rejects(comp, o, d, t_min, t_lim):
    """csrc/dense_hit.cu cull_mt's early exits, in its fp32 operations:
    [N, M] True where the kernel drops the test before the division."""
    ox, oy, oz, dx, dy, dz = (o[:, 0:1], o[:, 1:2], o[:, 2:3], d[:, 0:1], d[:, 1:2], d[:, 2:3])
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = (comp[i][None] for i in range(9))
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    adet = det.abs()
    sg = torch.where(torch.signbit(det), -1.0, 1.0)
    tx, ty, tz = ox - v0x, oy - v0y, oz - v0z
    us = (tx * px + ty * py + tz * pz) * sg
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    vs = (dx * qx + dy * qy + dz * qz) * sg
    ts = (e2x * qx + e2y * qy + e2z * qz) * sg
    big = adet < 1e20
    rej = ((us < -1e-20) & big) | ((vs < -1e-20) & big)
    rej |= (us >= 0) & (vs >= 0) & (us + vs > adet * np.float32(1.000001))
    if t_min >= 0:
        rej |= ts <= 0
    rej |= ts > torch.clamp_min(t_lim * adet, 1e-30) * np.float32(1.000001)
    return rej


@pytest.mark.parametrize("scale", [1.0, 1e-3, 1e3])
def test_culls_never_drop_a_hit(scale):
    """Rays aimed at the triangles' edges and vertices (u, v, u + v at 0 and
    1 within rounding), at several scales, and t limits at the hits' t."""
    v, tr = bumpy_sphere(10, 20)
    v = (v * scale).astype(np.float32)
    tris = td.pack_tris_cm(t(v), t(tr))[:10, :tr.shape[0]]
    rs = np.random.RandomState(31)
    f = rs.randint(0, tr.shape[0], 3000)
    bary = rs.choice([0.0, 1e-7, 0.5, 1.0 - 1e-7, 1.0], size=(3000, 2)).astype(np.float32)
    bary[:, 1] = np.where(rs.rand(3000) < 0.5, 1.0 - bary[:, 0], bary[:, 1])
    p = v[tr[f, 0]] + bary[:, :1] * (v[tr[f, 1]] - v[tr[f, 0]]) + bary[:, 1:] * (v[tr[f, 2]] - v[tr[f, 0]])
    o = (rs.normal(size=(3000, 3)) * 2 * scale).astype(np.float32)
    d = (p - o) / np.linalg.norm(p - o, axis=1, keepdims=True)
    o, d = t(o), t(d.astype(np.float32))
    ok, tt_, _, _ = td._mt(tris, *(o[:, i:i + 1] for i in range(3)),
                           *(d[:, i:i + 1] for i in range(3)), 1e-4 * scale)
    assert ok.sum() > 3000
    best = torch.where(ok, tt_, td.BIG).amin(dim=1, keepdim=True)
    for t_lim in (torch.full_like(best, td.BIG), best, torch.nextafter(best, torch.tensor(np.inf))):
        accepted = ok & (tt_ < t_lim)
        rej = cull_rejects(tris, o, d, 1e-4 * scale, t_lim)
        assert not (accepted & rej).any()
    assert cull_rejects(tris, o, d, 1e-4 * scale, best).float().mean() > 0.5


@pytest.mark.parametrize("kind", ["camera", "fan", "random"])
def test_bundle_cull_never_drops_a_hit(kind):
    """Coherent camera rays, narrow fans from near-common origins grazing
    the mesh, and random rays; t limits at the closest hit and beyond:
    every (ray, triangle) hit lies in a group the warp keeps."""
    v, tr = bumpy_sphere(16, 32)
    tris = td.pack_tris_cm(t(v), t(tr))[:10]
    rs = np.random.RandomState(41)
    n_rays = 32 * 64
    if kind == "camera":    # a 32 x 64 pinhole image in row order: a warp is one row
        py, px = np.meshgrid(np.linspace(-0.45, 0.45, 64), np.linspace(-0.45, 0.45, 32),
                             indexing="ij")
        d = np.stack([px.ravel(), py.ravel(), -np.ones(n_rays)], 1)
        o = np.tile([0.0, 0.0, 2.5], (n_rays, 1))
    elif kind == "fan":
        base = rs.normal(size=(64, 1, 3)) * 1.5
        o = base + rs.normal(size=(64, 32, 3)) * 1e-3
        tgt = v[rs.randint(0, v.shape[0], 64)][:, None] + rs.normal(size=(64, 32, 3)) * 0.05
        o, d = o.reshape(-1, 3), (tgt - o).reshape(-1, 3)
    else:
        o, d = shell_rays(n_rays, seed=43)
    o = t(np.asarray(o, np.float32))
    d = t(np.asarray(d / np.linalg.norm(d, axis=1, keepdims=True), np.float32))
    ok, tt_, _, _ = td._mt(tris, *(o[:, i:i + 1] for i in range(3)),
                           *(d[:, i:i + 1] for i in range(3)), 1e-4)
    best = torch.where(ok, tt_, td.BIG).amin(dim=1, keepdim=True)
    assert ok.any(1).sum() > 100
    for t_lim in (torch.full_like(best, td.BIG), torch.nextafter(best, torch.tensor(np.inf))):
        keep, _ = td.bundle_keep_plain(tris, o, d, t_lim[:, 0])            # [W, G]
        hit = (ok & (tt_ < t_lim)).reshape(64, 32, -1, 4).any(dim=(1, 3))   # [W, G]
        assert not (hit & ~keep).any()
        if kind == "fan":
            assert keep.float().mean() < 0.5     # the cull does cut narrow warps' work


def test_bundle_cull_mirror_with_dead_lanes():
    """bundle_keep_plain with lanes that are not live (as the any hit's dead
    lanes and the last warp's padding): the live rays' hits below their
    limits lie in kept groups, a warp with no live ray culls every group,
    and dropping lanes never widens what a warp keeps."""
    v, tr = bumpy_sphere(16, 32)
    tris = td.pack_tris_cm(t(v), t(tr))[:10]
    o, d = rays_towards(32 * 48 + 7, seed=47)
    o, d = t(o), t(d)
    ok, tt_, _, _ = td._mt(tris, *(o[:, i:i + 1] for i in range(3)),
                           *(d[:, i:i + 1] for i in range(3)), 1e-4)
    best = torch.where(ok, tt_, td.BIG).amin(dim=1)
    live = torch.from_numpy(np.random.RandomState(48).rand(o.shape[0]) < 0.7)
    live[32 * 5:32 * 6] = False
    t_lim = torch.nextafter(best, torch.tensor(np.inf))
    keep, culls = td.bundle_keep_plain(tris, o, d, t_lim, live, warps_per_pass=7)
    assert keep.shape == (49, -(-tris.shape[1] // 4)) and culls.shape == (49,)
    G = keep.shape[1]
    hitc = ok & (tt_ < t_lim[:, None]) & live[:, None]
    hitc = torch.cat([hitc, hitc.new_zeros((o.shape[0], 4 * G - tris.shape[1]))], 1)
    hitc = torch.cat([hitc, hitc.new_zeros((32 * 49 - o.shape[0], 4 * G))])
    hit = hitc.reshape(49, 32, G, 4).any(dim=(1, 3))
    assert not (hit & ~keep).any()
    assert not keep[5].any() and keep.any(1).sum() > 40
    full, _ = td.bundle_keep_plain(tris, o, d, t_lim)
    assert not (keep & ~full).any()
