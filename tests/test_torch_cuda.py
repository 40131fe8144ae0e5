"""On the card only: the CUDA kernels K1 and K2 (csrc/tile_trace.cu, with
the tile split forced off and on), K3 (csrc/dense_hit.cu, closest and
any hit, split forced off and on, also with t_min < 0, rows equal bit for
bit; on a bare mesh through ``dense_intersect`` and as the cluster tracer
kind's dense pass) and K4
(csrc/scatter_add.cu, its 1-D and [N, Kc] entries and a contention-heavy
input) against their plain PyTorch versions on the same inputs, and the
launch counters.  Skipped without a CUDA device.  On a
machine with the card and without JAX, run them without the suite's
conftest (which imports JAX):
`python -m pytest tests/test_torch_cuda.py --noconftest -p no:cacheprovider`.

Tolerances: hit prims agree on >= 99.99% of rays; t, u, v within 1e-5
relative (kernel and plain version round the same fp32 operations in the
same order, the kernel built with --fmad=false).  K4 sums with atomics in
an arbitrary order: |kernel - plain| <= 1e-5 * sum|upd| at that row + 1e-30.
"""

import numpy as np
import pytest
import torch

from mirres_restir_nerf_mesh_torch.ops import cluster_bvh, dense_tracer, hashgrid, scatter, tile_tracer

from test_torch_helpers import bumpy_sphere, launches, shell_rays

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def test_dense_hit_kernel_matches_plain(dev):
    v, tr = bumpy_sphere(24, 48)
    o, _ = shell_rays(5000, seed=1, radius=1.5)
    d = np.random.RandomState(2).normal(size=o.shape).astype(np.float32) * 0.4 - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    cm = dense_tracer.pack_tris_cm(torch.from_numpy(v).to(dev), torch.from_numpy(tr).to(dev))
    ro, rd = torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev)
    before = launches("dense_hit")
    k = dense_tracer.dense_hit(cm, ro, rd)
    torch.cuda.synchronize()
    assert launches("dense_hit") == before + 1
    p = dense_tracer.dense_hit_plain(cm, ro, rd)
    same = (k[1] == p[1]).float().mean().item()
    assert same >= 0.9999
    m = (k[1] == p[1]) & (p[1] >= 0)
    for a, b in zip(k[0:1] + k[2:], p[0:1] + p[2:]):
        torch.testing.assert_close(a[m], b[m], rtol=1e-5, atol=1e-6)


def same_bits(a, b):
    return a.dtype == b.dtype and torch.equal(a.view(torch.int32) if a.is_floating_point() else a,
                                              b.view(torch.int32) if b.is_floating_point() else b)


def dense_case(dev, n_rays=5037):
    """A ragged case: the cluster SoA of S = 100 (not a multiple of the
    staged block), rays towards the mesh, t_max with dead lanes and t_max at
    the hit's t."""
    v, tr = bumpy_sphere(24, 48)
    cm = cluster_bvh.build_clusters(torch.from_numpy(v).to(dev), torch.from_numpy(tr).to(dev), 100)
    o, _ = shell_rays(n_rays, seed=11, radius=1.5)
    d = np.random.RandomState(12).normal(size=o.shape).astype(np.float32) * 0.4 - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    ro, rd = torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev)
    t_hit = dense_tracer.dense_hit_plain(cm.soa, ro, rd)[0]
    k = torch.from_numpy(np.random.RandomState(13).rand(n_rays)).to(dev)
    tm = torch.where(k < 0.2, 0.0, torch.where(k < 0.5, t_hit, 0.5 + 3 * k.float()))
    return cm.soa, ro, rd, tm


@pytest.mark.parametrize("split", [1, 3, None])
def test_dense_hit_kernel_rows_equal_plain(dev, split):
    """K3 closest hit unsplit, split in 3 and at the wrapper's split, on the
    SoA and on the padded [16, Mpad] table: rows equal bit for bit."""
    soa, ro, rd, _ = dense_case(dev)
    p = dense_tracer.dense_hit_plain(soa, ro, rd)
    assert int((p[1] >= 0).sum()) > 1000
    for tris in (soa, dense_tracer.tris_cm_from_soa(soa)):
        before = launches("dense_hit")
        k = dense_tracer.dense_hit(tris, ro, rd, split=split)
        torch.cuda.synchronize()
        assert launches("dense_hit") == before + 1
        for a, b in zip(k, p):
            assert same_bits(a, b)


@pytest.mark.parametrize("split", [1, 3, None])
def test_dense_occluded_kernel_equals_plain(dev, split):
    soa, ro, rd, tm = dense_case(dev)
    p = dense_tracer.dense_occluded_plain(soa, ro, rd, tm)
    assert p.any() and not p.all()
    before = launches("dense_occluded")
    k = dense_tracer.dense_occluded(soa, ro, rd, tm, split=split)
    torch.cuda.synchronize()
    assert launches("dense_occluded") == before + 1
    assert torch.equal(k, p)


@pytest.mark.parametrize("split", [1, None])
def test_dense_kernels_negative_t_min_equal_plain(dev, split):
    """t_min < 0, so hits behind the origin count: warps of 32 rays in a
    narrow fan from inside the mesh (a narrow cone, which the bundle cull
    would use to drop every group behind them), t_min = -2, so the closest
    hit lies behind the origin.  Closest rows and the any-hit mask (t_max
    behind the origin, ahead of it, and dead) equal the plain version's bit
    for bit."""
    v, tr = bumpy_sphere(24, 48)
    cm = cluster_bvh.build_clusters(torch.from_numpy(v).to(dev), torch.from_numpy(tr).to(dev), 100)
    rs = np.random.RandomState(21)
    axis = rs.normal(size=(160, 1, 3))
    d = axis / np.linalg.norm(axis, axis=2, keepdims=True) + rs.normal(size=(160, 32, 3)) * 0.03
    d /= np.linalg.norm(d, axis=2, keepdims=True)
    o = rs.normal(size=(160, 1, 3)) * 0.1 + rs.normal(size=(160, 32, 3)) * 0.01
    ro = torch.tensor(o.reshape(-1, 3), dtype=torch.float32, device=dev)
    rd = torch.tensor(d.reshape(-1, 3), dtype=torch.float32, device=dev)
    t_min = -2.0
    p = dense_tracer.dense_hit_plain(cm.soa, ro, rd, t_min)
    assert int(((p[1] >= 0) & (p[0] < 0)).sum()) > 4000
    k = dense_tracer.dense_hit(cm.soa, ro, rd, t_min, split=split)
    torch.cuda.synchronize()
    for a, b in zip(k, p):
        assert same_bits(a, b)
    u = torch.from_numpy(rs.rand(ro.shape[0])).to(dev)
    tm = torch.where(u < 0.2, -2.5, torch.where(u < 0.5, -1.95, torch.where(u < 0.75, -0.5, 0.3)))
    tm = tm.float()
    po = dense_tracer.dense_occluded_plain(cm.soa, ro, rd, tm, t_min)
    assert po.any() and not po.all()
    ko = dense_tracer.dense_occluded(cm.soa, ro, rd, tm, t_min, split=split)
    torch.cuda.synchronize()
    assert torch.equal(ko, po)


@pytest.mark.parametrize("any_hit", [False, True])
def test_tile_trace_kernel_matches_plain(dev, any_hit):
    v, tr = bumpy_sphere(48, 96)
    cm = cluster_bvh.build_clusters(torch.from_numpy(v).to(dev), torch.from_numpy(tr).to(dev))
    o, d = shell_rays(20000, seed=3)
    work = tile_tracer.prepare_trace(cm, torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev),
                                     k_cap=32, sort_octants="morton")
    before = launches("queue_trace")
    out_k = tile_tracer.queue_trace(cm.geom_cm, work.rays_cm, work.cand, work.octs, work.n_active,
                                    1e-4, any_hit)
    torch.cuda.synchronize()
    assert launches("queue_trace") == before + 1
    out_p = tile_tracer.queue_trace_plain(cm.geom_cm, work.rays_cm, work.cand, work.octs,
                                          work.n_active, 1e-4, any_hit)
    hk = tile_tracer.finish_trace(cm, work, out_k, any_hit)
    hp = tile_tracer.finish_trace(cm, work, out_p, any_hit)
    assert torch.equal(hk.uncertain, hp.uncertain)
    assert (hk.hit.prim == hp.hit.prim).float().mean().item() >= 0.9999
    m = (hk.hit.prim == hp.hit.prim) & (hp.hit.prim >= 0)
    for f in ("t", "u", "v"):
        torch.testing.assert_close(getattr(hk.hit, f)[m], getattr(hp.hit, f)[m], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("any_hit", [False, True])
def test_grid_trace_kernel_matches_plain(dev, any_hit):
    """K2: every tile's k_cap-cut candidates, no work budget."""
    v, tr = bumpy_sphere(48, 96)
    cm = cluster_bvh.build_clusters(torch.from_numpy(v).to(dev), torch.from_numpy(tr).to(dev))
    o, d = shell_rays(20000, seed=5)
    work = tile_tracer.prepare_trace(cm, torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev),
                                     k_cap=32, sort_octants="morton", queue=False)
    assert torch.equal(work.n_active, work.counts)
    before = launches("grid_trace")
    out_k = tile_tracer.grid_trace(cm.geom_cm, work.rays_cm, work.cand, work.octs, work.counts,
                                   1e-4, any_hit)
    torch.cuda.synchronize()
    assert launches("grid_trace") == before + 1
    out_p = tile_tracer.queue_trace_plain(cm.geom_cm, work.rays_cm, work.cand, work.octs,
                                          work.counts, 1e-4, any_hit)
    hk = tile_tracer.finish_trace(cm, work, out_k, any_hit)
    hp = tile_tracer.finish_trace(cm, work, out_p, any_hit)
    assert torch.equal(hk.uncertain, hp.uncertain)
    assert (hk.hit.prim == hp.hit.prim).float().mean().item() >= 0.9999
    m = (hk.hit.prim == hp.hit.prim) & (hp.hit.prim >= 0)
    for f in ("t", "u", "v"):
        torch.testing.assert_close(getattr(hk.hit, f)[m], getattr(hp.hit, f)[m], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("split", [1, 4])
@pytest.mark.parametrize("any_hit", [False, True])
def test_tile_trace_kernel_split_rows_equal_plain(dev, split, any_hit):
    """K1 with the tile split forced off (1) and on (4 blocks a tile, the
    keyed combine and the finish kernel): rows equal the plain version's."""
    v, tr = bumpy_sphere(48, 96)
    cm = cluster_bvh.build_clusters(torch.from_numpy(v).to(dev), torch.from_numpy(tr).to(dev))
    o, d = shell_rays(6000, seed=7)
    work = tile_tracer.prepare_trace(cm, torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev),
                                     k_cap=32, sort_octants="morton")
    args = (cm.geom_cm, work.rays_cm, work.cand, work.octs, work.n_active, 1e-4, any_hit)
    before = launches("queue_trace")
    out_k = tile_tracer.queue_trace(*args, split=split)
    torch.cuda.synchronize()
    assert launches("queue_trace") == before + 1
    assert torch.equal(out_k, tile_tracer.queue_trace_plain(*args))


def scatter_within(k, idx, upd, rows):
    p = scatter.scatter_add_plain(idx, upd, rows)
    mag = scatter.scatter_add_plain(idx, upd.abs(), rows)
    return bool(((k - p).abs() <= 1e-5 * mag + 1e-30).all())


def test_scatter_add_kernel_contention(dev):
    """Every update into 8 rows: long groups in every warp and every block."""
    rng = np.random.RandomState(6)
    idx = torch.from_numpy(rng.randint(0, 8, (20_000, 128)).astype(np.int32)).to(dev)
    upd = torch.from_numpy(rng.normal(size=(20_000, 128, 2)).astype(np.float32)).to(dev)
    k = scatter.scatter_add(idx, upd, 8)
    torch.cuda.synchronize()
    assert scatter_within(k, idx, upd, 8)


@pytest.mark.parametrize("cols,C", [(128, 2), (16, 2), (3, 2), (8, 3)])
def test_scatter_add_kernel_2d_entry(dev, cols, C):
    """The [N, Kc] entry (Kc = 8L exact, L stochastic, an odd width, and
    the scalar path of C != 2): coarse columns repeat rows, the rest are
    spread; padding and rows out of range are dropped."""
    rng = np.random.RandomState(cols)
    N, rows = 3001, 50_000
    idx = rng.randint(0, rows, (N, cols)).astype(np.int32)
    idx[:, : cols // 4] = rng.randint(0, 40, (N, cols // 4))
    idx[rng.rand(N, cols) < 0.05] = -1
    idx[0, 0] = rows + 3
    idx_d = torch.from_numpy(idx).to(dev)
    upd = torch.from_numpy(rng.normal(size=(N, cols, C)).astype(np.float32)).to(dev)
    before = launches("scatter_add")
    k = scatter.scatter_add(idx_d, upd, rows)
    torch.cuda.synchronize()
    assert launches("scatter_add") == before + 1
    assert scatter_within(k, idx_d, upd, rows)
    flat = scatter.scatter_add(idx_d.reshape(-1), upd.reshape(-1, C), rows)
    assert scatter_within(flat, idx_d, upd, rows)


def test_scatter_add_kernel_matches_plain(dev):
    rng = np.random.RandomState(4)
    rows, M = 70_000, 400_000
    idx = rng.randint(0, rows, M).astype(np.int32)
    idx[: M // 4] = rng.randint(0, 64, M // 4)          # contended rows
    idx[rng.rand(M) < 0.05] = -1                        # padding
    idx_d = torch.from_numpy(idx).to(dev)
    upd = torch.from_numpy(rng.normal(size=(M, 2)).astype(np.float32)).to(dev)
    before = launches("scatter_add")
    k = scatter.scatter_add(idx_d, upd, rows)
    torch.cuda.synchronize()
    assert launches("scatter_add") == before + 1
    assert scatter_within(k, idx_d, upd, rows)


def test_scatter_add_kernel_stage0_encode_shape(dev):
    """K4 at the stage-0 train step's encode backward: 262,144 points x 16
    levels of one-corner row ids ([N, L]) into the 6,119,864-row NeRF table
    (16 levels of 2^19), points clustered along rays as a march gives them."""
    spec = hashgrid.HashGridSpec(num_levels=16, base_resolution=16, log2_hashmap_size=19,
                                 desired_resolution=2048)
    assert spec.n_params == 6_119_864
    g = torch.Generator(device=dev).manual_seed(7)
    o = torch.randn((8192, 1, 3), generator=g, device=dev)
    o = o / o.norm(dim=-1, keepdim=True) * 2.0
    tgt = torch.rand((8192, 1, 3), generator=g, device=dev) - 0.5
    ts = torch.rand((8192, 32, 1), generator=g, device=dev) * 0.8 + 0.6
    x = torch.clamp(o + (tgt - o) / 2.0 * ts, -1.0, 1.0).reshape(-1, 3)
    idx, _ = hashgrid.encode_rows(x, spec, stochastic_u=torch.rand(x.shape, generator=g,
                                                                   device=dev))
    assert tuple(idx.shape) == (262_144, 16)
    upd = torch.randn((262_144, 16, 2), generator=g, device=dev)
    before = launches("scatter_add")
    k = scatter.scatter_add(idx, upd, spec.n_params)
    torch.cuda.synchronize()
    assert launches("scatter_add") == before + 1
    assert scatter_within(k, idx, upd, spec.n_params)


def test_gather_rows_backward_launches_k4(dev):
    spec = hashgrid.HashGridSpec(num_levels=4, base_resolution=16, log2_hashmap_size=12,
                                 desired_resolution=128)
    table = (torch.rand((spec.n_params, 2), device=dev) - 0.5).requires_grad_(True)
    x = torch.rand((5000, 3), device=dev) * 1.8 - 0.9
    before = launches("scatter_add")
    hashgrid.hashgrid_encode(table, x, spec).square().sum().backward()
    torch.cuda.synchronize()
    assert launches("scatter_add") == before + 1
    ref = table.detach().cpu().requires_grad_(True)
    hashgrid.hashgrid_encode(ref, x.cpu(), spec).square().sum().backward()
    torch.testing.assert_close(table.grad.cpu(), ref.grad, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("split", [1, None])
def test_dense_intersect_launches_k3_equal_plain(dev, split):
    """dense_intersect on a bare mesh: one K3 launch, its HitResult equal bit
    for bit to the one computed from the plain version's rows."""
    v, tr = bumpy_sphere(24, 48)
    o, _ = shell_rays(5000, seed=3, radius=1.5)
    d = np.random.RandomState(4).normal(size=o.shape).astype(np.float32) * 0.4 - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    vt, tt = torch.from_numpy(v).to(dev), torch.from_numpy(tr).to(dev)
    ro, rd = torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev)
    before = launches("dense_hit")
    k = dense_tracer.dense_intersect(vt, tt, ro, rd, t_max=2.5, split=split)
    torch.cuda.synchronize()
    assert launches("dense_hit") == before + 1
    p = dense_tracer.dense_intersect(vt.cpu(), tt.cpu(), ro.cpu(), rd.cpu(), t_max=2.5)
    assert (p.prim >= 0).any() and (p.prim < 0).any()
    for f in k._fields:
        assert same_bits(getattr(k, f).cpu(), getattr(p, f)), f


def test_cluster_kind_dense_pass_launches_k3(dev):
    """The cluster tracer kind's dense pass (a mesh under dense_threshold)
    runs K3's closest hit on the card, for closest and any hit."""
    from mirres_restir_nerf_mesh_torch.ops.tracer import build_tracer

    v, tr = bumpy_sphere(24, 48)
    o, d = shell_rays(4096, seed=5)
    ro, rd = torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev)
    tracer = build_tracer(torch.from_numpy(v).to(dev), torch.from_numpy(tr).to(dev),
                          kind="cluster")
    before = launches("dense_hit")
    hit = tracer.intersect(ro, rd)
    occ = tracer.occluded(ro, rd, 1e9)
    torch.cuda.synchronize()
    assert launches("dense_hit") == before + 2
    assert torch.equal(occ, hit.prim >= 0)
