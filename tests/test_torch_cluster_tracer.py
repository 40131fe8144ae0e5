"""Port vs reference: the cluster tracer (ops/cluster_bvh.py
``intersect_clusters`` / ``occluded_clusters``), the Tracer of every kind
(ops/tracer.py) and ``dense_intersect`` (K3 on a bare mesh), on the CPU.

- ``intersect_clusters``: the candidate route (C*S above
  ``dense_threshold``; ``max_candidates`` 4 and 10; t_max a scalar and per
  ray) and the dense route: prim and the normal equal, t within 1e-6
  relative on >= 99.9% of the hits and 1e-5 on all, u, v within 5e-5;
  ``occluded_clusters``' mask equal.  On the candidate route both packages
  run the same plain gathers; the dense route is the port's K3 plain
  version against the reference's XLA pass.
- ``Tracer`` / ``build_tracer`` of the kinds tile, cluster and lbvh: hits
  and masks equal the reference's Tracer of the same kind (prim on >=
  99.9% for tile, exactly for the other two); the ``sort=`` override
  (tile kind: "morton_dir2" and no sort give the hits the default order
  gives); uncertain counts recorded by tile alone, traced lanes by every
  kind, equal to the reference's.
- ``dense_intersect`` (K3's plain version on the CPU) against
  ``pallas_intersect`` run in interpret mode, as tests/test_mesh_bvh.py
  runs it: prim on >= 99.9% of the rays, t within 1e-5 relative, u, v
  within 5e-5, the normal within 1e-6 where prims agree (the interpreter's
  MT rounds apart from PyTorch's by an ulp on grazing hits).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mirres_restir_nerf_mesh_torch.ops import cluster_bvh as tc
from mirres_restir_nerf_mesh_torch.ops import dense_tracer as td
from mirres_restir_nerf_mesh_torch.ops import tracer as ttr
from mirres_restir_nerf_mesh_tpu.ops import cluster_bvh as jc
from mirres_restir_nerf_mesh_tpu.ops import pallas_tracer as jp
from mirres_restir_nerf_mesh_tpu.ops import tracer as jtr

from test_torch_helpers import (TORCH_THREADS, assert_close_mostly, bumpy_sphere, camera_rays,
                                make_sphere, n, shell_rays, t)

torch.set_num_threads(TORCH_THREADS)
N = 1536


@pytest.fixture(scope="module")
def scene():
    v, tr = bumpy_sphere(24, 48)                         # 2,208 triangles
    o, d = shell_rays(N, seed=11)
    d[: N // 2] = -o[: N // 2] + np.random.RandomState(12).uniform(-0.4, 0.4, (N // 2, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_max = np.random.RandomState(13).uniform(0.3, 2.5, N).astype(np.float32)
    return v, tr, o.astype(np.float32), d.astype(np.float32), t_max


def check_hits(got, ref, exact_prim=True):
    gp, rp = n(got.prim), np.asarray(ref.prim).astype(np.int64)
    same = gp == rp
    if exact_prim:
        assert same.all()
    else:
        assert same.mean() >= 0.999
    hit = same & (rp >= 0)
    assert np.isinf(n(got.t)[same & (rp < 0)]).all()
    assert_close_mostly(n(got.t)[hit], np.asarray(ref.t)[hit], rtol=1e-6, atol=0, rtol_all=1e-5)
    for f in ("u", "v"):
        np.testing.assert_allclose(n(getattr(got, f))[hit], np.asarray(getattr(ref, f))[hit],
                                   rtol=0, atol=5e-5, err_msg=f)
    np.testing.assert_allclose(n(got.normal)[hit], np.asarray(ref.normal)[hit], rtol=0,
                               atol=1e-6)
    return hit


@pytest.mark.parametrize("route,k", [("candidates", 4), ("candidates", 10), ("dense", 10)])
def test_intersect_clusters_matches(scene, route, k):
    v, tr, o, d, t_max = scene
    cs, thr = (32, 1024) if route == "candidates" else (128, 8192)
    jcm = jc.build_clusters(jnp.asarray(v), jnp.asarray(tr), cs)
    tcm = tc.build_clusters(t(v), t(tr), cs)
    C, S = tcm.prim.shape
    assert (C * S > thr) == (route == "candidates")
    for tm in (1e10, t_max):
        ref = jc.intersect_clusters(jcm, jnp.asarray(o), jnp.asarray(d), t_max=jnp.asarray(tm),
                                    dense_threshold=thr, max_candidates=k)
        got = tc.intersect_clusters(tcm, t(o), t(d), t_max=torch.as_tensor(tm),
                                    dense_threshold=thr, max_candidates=k)
        hit = check_hits(got, ref, exact_prim=route == "candidates")
        assert hit.sum() > 200
    occ_ref = jc.occluded_clusters(jcm, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max),
                                   dense_threshold=thr, max_candidates=k)
    occ = tc.occluded_clusters(tcm, t(o), t(d), t(t_max), dense_threshold=thr, max_candidates=k)
    np.testing.assert_array_equal(n(occ), np.asarray(occ_ref))
    assert n(occ).any() and not n(occ).all()


@pytest.mark.parametrize("kind", ["tile", "cluster", "lbvh"])
def test_tracer_kinds_match(scene, kind):
    v, tr, o, d, t_max = scene
    live = np.where(np.random.RandomState(14).rand(N) < 0.8, t_max, 0.0).astype(np.float32)
    kw = dict(cluster_size=32, dense_threshold=1024, max_candidates=10)
    ref = jtr.build_tracer(jnp.asarray(v), jnp.asarray(tr), kind=kind, **kw)
    got = ttr.build_tracer(t(v), t(tr), kind=kind, **kw)
    assert got.kind == kind
    h_ref = ref.intersect(jnp.asarray(o), jnp.asarray(d), t_max=jnp.asarray(live))
    h_got = got.intersect(t(o), t(d), t_max=t(live))
    check_hits(h_got, h_ref, exact_prim=kind != "tile")
    occ_ref = ref.occluded(jnp.asarray(o), jnp.asarray(d), jnp.asarray(live), incoherent=True)
    occ = got.occluded(t(o), t(d), t(live), incoherent=True)
    np.testing.assert_array_equal(n(occ), np.asarray(occ_ref))
    if kind == "tile":
        for sort in ("morton_dir2", False):
            h_s = got.intersect(t(o), t(d), t_max=t(live), incoherent=True, sort=sort)
            assert (n(h_s.prim) == n(h_got.prim)).mean() >= 0.999
            occ_s = got.occluded(t(o), t(d), t(live), incoherent=True, sort=sort)
            np.testing.assert_array_equal(n(occ_s), n(occ))
            h_r = ref.intersect(jnp.asarray(o), jnp.asarray(d), t_max=jnp.asarray(live),
                                incoherent=True, sort=sort)
            ref.occluded(jnp.asarray(o), jnp.asarray(d), jnp.asarray(live), incoherent=True,
                         sort=sort)
            assert (n(h_s.prim) == np.asarray(h_r.prim)).mean() >= 0.999
    assert len(got.telemetry) == len(ref.telemetry) == (6 if kind == "tile" else 0)
    assert float(got.pop_telemetry()) == float(ref.pop_telemetry())
    launches = 6 if kind == "tile" else 2
    assert float(got.pop_traced()) == float(ref.pop_traced()) == launches * (live > 1e-4).sum()
    assert got.traced == [] and got.telemetry == []


def test_tracer_unknown_kind_raises():
    v, tr = make_sphere(4, 6)
    with pytest.raises(ValueError):
        ttr.build_tracer(t(v), t(tr), kind="bvh")
    with pytest.raises(ValueError):
        ttr.Tracer(None, kind="dense")
    assert ttr.build_tracer(t(v), t(tr)).kind == "tile"


@pytest.mark.parametrize("t_max", ["scalar", "per-ray"])
def test_dense_intersect_matches_pallas_interpret(t_max):
    v, tr = make_sphere(24, 48)
    o, d = camera_rays(600, seed=15)
    tm = 1e10 if t_max == "scalar" else np.random.RandomState(16).uniform(1.5, 3.5, 600).astype(
        np.float32)
    ref = jp.pallas_intersect(jnp.asarray(v), jnp.asarray(tr), jnp.asarray(o), jnp.asarray(d),
                              t_max=jnp.asarray(tm))
    got = td.dense_intersect(t(v), t(tr), t(o), t(d), t_max=torch.as_tensor(tm))
    same = n(got.prim) == np.asarray(ref.prim)
    assert same.mean() >= 0.999
    hit = same & (np.asarray(ref.prim) >= 0)
    assert hit.sum() > 100 and (np.asarray(ref.prim) < 0).sum() > 20
    assert np.isinf(n(got.t)[~(n(got.prim) >= 0)]).all()
    np.testing.assert_allclose(n(got.t)[hit], np.asarray(ref.t)[hit], rtol=1e-5)
    for f in ("u", "v"):
        np.testing.assert_allclose(n(getattr(got, f))[hit], np.asarray(getattr(ref, f))[hit],
                                   rtol=0, atol=5e-5)
    np.testing.assert_allclose(n(got.normal)[hit], np.asarray(ref.normal)[hit], rtol=0, atol=1e-6)
    assert (n(got.normal)[n(got.prim) < 0] == 0).all()
