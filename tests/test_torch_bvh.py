"""Port vs reference: the LBVH (ops/bvh.py), build and traversal, on the CPU.

- ``build_bvh``: every field equal bit for bit (the stable Morton sort,
  the Karras search loops and the box sweeps), on ~1,000 triangles whose
  centroids repeat (equal Morton codes), on a sphere and on one triangle.
- ``intersect_bvh`` (closest and any hit) and ``occluded`` on 4,096 rays,
  with t_max a scalar and per ray: prim and the occlusion mask exact; t
  within 1e-6 relative on >= 99.5% of the hits (the soup's closest hits:
  2 of 1,343 beyond it, its any hits 2 of 766) and within 1e-5 on every
  hit; u, v within 5e-5 of their [0, 1] range (as
  tests/test_torch_tile_tracer.py); the normal within 1e-6 absolute.  The
  grazing hits' Moeller-Trumbore terms divide cancelling sums by a small
  determinant, and XLA's fused CPU code rounds them nearer the fp64 value
  than plain float32 does (ray 80 of the soup: t fp64 1.8766187, XLA
  1.8766184, PyTorch and numpy float32 1.8766162; u, v of the soup's small
  triangles, hit from 1.6 away, up to 3.4e-5 apart).  The traversal runs
  on the reference's own tree (``convert.bvh_from_jax``) and on the
  port's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mirres_restir_nerf_mesh_torch.convert import bvh_from_jax
from mirres_restir_nerf_mesh_torch.ops import bvh as tb
from mirres_restir_nerf_mesh_tpu.ops import bvh as jb

from test_torch_helpers import TORCH_THREADS, assert_close_mostly, make_sphere, n, shell_rays, t

torch.set_num_threads(TORCH_THREADS)
R = 4096


def soup(n_tris=1000, seed=0):
    """Random small triangles in [-1, 1]^3; 40 of them share the centroids of
    40 others, so equal Morton codes meet the stable sort."""
    rng = np.random.RandomState(seed)
    c = rng.uniform(-1, 1, (n_tris, 3)).astype(np.float32)
    c[500:540] = c[460:500]
    off = rng.normal(0, 0.06, (n_tris, 3, 3)).astype(np.float32)
    off[500:540] = off[460:500]
    v = (c[:, None] + off).reshape(-1, 3)
    return v, np.arange(3 * n_tris, dtype=np.int32).reshape(n_tris, 3)


MESHES = {"soup": soup, "sphere": lambda: make_sphere(16, 32),
          "one": lambda: (np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32),
                          np.array([[0, 1, 2]], np.int32))}


@pytest.fixture(scope="module", params=sorted(MESHES))
def trees(request):
    v, tr = MESHES[request.param]()
    return request.param, v, tr, jb.build_bvh(jnp.asarray(v), jnp.asarray(tr)), \
        tb.build_bvh(t(v), t(tr))


def test_build_bvh_bit_exact(trees):
    name, _, tr, ref, got = trees
    assert len(np.unique(n(got.prim))) == tr.shape[0]
    for f in ref._fields:
        a, b = np.asarray(getattr(ref, f)), n(getattr(got, f))
        assert a.shape == b.shape, f
        np.testing.assert_array_equal(b, a.astype(b.dtype), err_msg=f)


def rays(seed):
    o, d = shell_rays(R, seed, radius=1.6)
    # aim half the rays at the mesh's box so most of them hit
    d[: R // 2] = -o[: R // 2] + np.random.RandomState(seed).uniform(-0.5, 0.5, (R // 2, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def check_hits(got, ref):
    np.testing.assert_array_equal(n(got.prim), np.asarray(ref.prim).astype(np.int64))
    hit = np.asarray(ref.prim) >= 0
    rt, gt = np.asarray(ref.t), n(got.t)
    assert np.isinf(gt[~hit]).all()
    assert_close_mostly(gt[hit], rt[hit], rtol=1e-6, atol=0, frac=0.995, rtol_all=1e-5)
    for f in ("u", "v"):
        np.testing.assert_allclose(n(getattr(got, f))[hit], np.asarray(getattr(ref, f))[hit],
                                   rtol=0, atol=5e-5, err_msg=f)
    np.testing.assert_allclose(n(got.normal)[hit], np.asarray(ref.normal)[hit], rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("tree", ["reference", "port"])
def test_intersect_and_occluded_match(trees, tree):
    name, _, _, jtree, ttree = trees
    tree_t = bvh_from_jax(jtree, device="cpu") if tree == "reference" else ttree
    o, d = rays(1)
    t_max = np.random.RandomState(2).uniform(0.2, 3.0, R).astype(np.float32)
    ref = jb.intersect_bvh(jtree, jnp.asarray(o), jnp.asarray(d))
    got = tb.intersect_bvh(tree_t, t(o), t(d))
    check_hits(got, ref)
    if name != "one":
        assert 0.05 < (n(got.prim) >= 0).mean() < 0.95
    ref_any = jb.intersect_bvh(jtree, jnp.asarray(o), jnp.asarray(d), t_max=jnp.asarray(t_max),
                               any_hit=True)
    got_any = tb.intersect_bvh(tree_t, t(o), t(d), t_max=t(t_max), any_hit=True)
    check_hits(got_any, ref_any)
    occ_ref = np.asarray(jb.occluded(jtree, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max)))
    occ = n(tb.occluded(tree_t, t(o), t(d), t(t_max)))
    np.testing.assert_array_equal(occ, occ_ref)
    assert occ.any() and not occ.all()
