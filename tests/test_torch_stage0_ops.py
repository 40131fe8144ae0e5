"""Port vs reference: the stage-0 ops on shared numpy-seeded inputs.

- occupancy: ``init_occupancy`` and ``grid_cell_centers`` equal;
  ``update_occupancy`` with an analytic density and the reference's own
  jitter draws: grid within 1e-6 relative, bits and the cells at -1 equal;
  ``mark_untrained_grid`` equal; ``packbits`` / ``unpackbits`` equal.
- ``near_far_from_aabb`` within 1 ulp.
- ``march_rays``: valid masks equal, ts / dts within 1 ulp, xyzs within
  1e-6 (fp32), on the single-cascade supercell path (grid 32), two
  cascades, ``dt_gamma > 0`` (the reference's scan), contract, perturbed
  with the reference's own noise draw.
- ``composite_rays`` (T_thresh, alpha mode) within 1e-5 relative;
  ``sph_from_ray``, ``flatten_rays``; ``freq_encode`` within 1e-6.
- data/rays.py's pose helpers and ``compute_mvps`` within 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mirres_restir_nerf_mesh_tpu.data import provider as jprov
from mirres_restir_nerf_mesh_tpu.data import rays as jrays
from mirres_restir_nerf_mesh_tpu.ops import freq as jfreq
from mirres_restir_nerf_mesh_tpu.ops import marching as jm
from mirres_restir_nerf_mesh_tpu.ops import occupancy as jo
from mirres_restir_nerf_mesh_torch.data import provider as tprov
from mirres_restir_nerf_mesh_torch.data import rays as trays
from mirres_restir_nerf_mesh_torch.ops import freq as tfreq
from mirres_restir_nerf_mesh_torch.ops import marching as tm
from mirres_restir_nerf_mesh_torch.ops import occupancy as to

from test_torch_helpers import TORCH_THREADS, n, occupancy_draws_jax, t

torch.set_num_threads(TORCH_THREADS)


def blob_density(scale=60.0):
    """An analytic density with a dense core and empty corners, written
    once for both packages' arrays."""
    def fn(p, xp):
        r2 = (p ** 2).sum(-1)
        return scale * xp.exp(-4.0 * r2) - 5.0 * p[..., 0]
    return fn


def test_occupancy_update_matches_reference():
    C, H, bound = 2, 16, 2.0
    js = jo.init_occupancy(C, H)
    ts = to.init_occupancy(C, H, device="cpu")
    np.testing.assert_array_equal(n(ts.occ), np.asarray(js.occ))
    np.testing.assert_array_equal(n(ts.density_grid), np.asarray(js.density_grid))
    np.testing.assert_allclose(n(to.grid_cell_centers(H)), np.asarray(jo.grid_cell_centers(H)),
                               rtol=0, atol=0)
    rng = np.random.RandomState(0)
    grid = rng.uniform(0, 20, (C, H, H, H)).astype(np.float32)
    grid[rng.rand(C, H, H, H) < 0.1] = -1.0
    js = js._replace(density_grid=jnp.asarray(grid))
    ts = ts._replace(density_grid=t(grid))
    dens = blob_density()
    key = jax.random.PRNGKey(3)
    for step in range(2):
        k = jax.random.fold_in(key, step)
        js = jo.update_occupancy(js, lambda p: dens(p, jnp), k, bound, 10.0)
        ts = to.update_occupancy(ts, lambda p, u: dens(p, torch),
                                 occupancy_draws_jax(k, C, H, bound, False), bound, 10.0)
        np.testing.assert_allclose(n(ts.density_grid), np.asarray(js.density_grid), rtol=1e-6,
                                   atol=1e-5)
        np.testing.assert_array_equal(n(ts.occ), np.asarray(js.occ))
        np.testing.assert_array_equal(n(ts.density_grid) == -1, np.asarray(js.density_grid) == -1)
        np.testing.assert_allclose(float(ts.mean_density), float(js.mean_density), rtol=1e-5)


def test_mark_untrained_and_packbits_match_reference():
    from mirres_restir_nerf_mesh_tpu.data.synthetic import make_synthetic_dataset

    d = make_synthetic_dataset(n_frames=4, H=16, W=16, bound=2.0)
    C, H = 2, 16
    rng = np.random.RandomState(1)
    grid = rng.uniform(0, 5, (C, H, H, H)).astype(np.float32)
    js = jo.init_occupancy(C, H)._replace(density_grid=jnp.asarray(grid))
    ts = to.init_occupancy(C, H, device="cpu")._replace(density_grid=t(grid))
    ref = jo.mark_untrained_grid(js, jnp.asarray(d.poses), jnp.asarray(d.intrinsics), 16, 16, 2.0)
    got = to.mark_untrained_grid(ts, t(d.poses), d.intrinsics, 16, 16, 2.0)
    assert (np.asarray(ref.density_grid) == -1).any()
    np.testing.assert_array_equal(n(got.density_grid), np.asarray(ref.density_grid))
    occ = (rng.rand(C, H, H, H) < 0.3).astype(np.uint8)
    bits = to.packbits(t(occ))
    np.testing.assert_array_equal(n(bits), np.asarray(jo.packbits(jnp.asarray(occ))))
    np.testing.assert_array_equal(n(to.unpackbits(bits, occ.shape)), occ)


def ray_batch(N, seed, origin_r=2.0):
    """Rays from a sphere of radius origin_r towards jittered points near
    the centre (some miss the unit box)."""
    rng = np.random.RandomState(seed)
    o = rng.normal(size=(N, 3)).astype(np.float32)
    o = o / np.linalg.norm(o, axis=1, keepdims=True) * origin_r
    target = rng.uniform(-1.3, 1.3, (N, 3)).astype(np.float32)
    d = target - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return o, d


def test_near_far_matches_reference():
    o, d = ray_batch(2000, 0)
    d[:5, 0] = 0.0                        # axis-parallel: the 1e-15 guard
    aabb = np.array([-1, -1, -1, 1, 1, 1], np.float32)
    jn, jf = jm.near_far_from_aabb(jnp.asarray(o), jnp.asarray(d), jnp.asarray(aabb), 0.05)
    tn, tf = tm.near_far_from_aabb(t(o), t(d), t(aabb), 0.05)
    np.testing.assert_array_max_ulp(n(tn), np.asarray(jn), maxulp=1)
    np.testing.assert_array_max_ulp(n(tf), np.asarray(jf), maxulp=1)


@pytest.mark.parametrize("case", ["supercell", "cascades", "dt_gamma", "contract"])
def test_march_rays_matches_reference(case):
    N, K = 384, 32
    bound = 2.0 if case == "cascades" else 1.0
    C = 2 if case == "cascades" else 1
    H = 32
    max_steps = 64 if case == "dt_gamma" else 128
    dt_gamma = 1.0 / 64 if case == "dt_gamma" else 0.0
    rng = np.random.RandomState(2)
    occ = (rng.rand(C, H, H, H) < 0.35).astype(np.uint8)
    o, d = ray_batch(N, 3, origin_r=2.5 * bound)
    aabb = np.array([-bound] * 3 + [bound] * 3, np.float32)
    jn, jf = jm.near_far_from_aabb(jnp.asarray(o), jnp.asarray(d), jnp.asarray(aabb), 0.05)
    key = jax.random.PRNGKey(4)
    ref = jm.march_rays(jnp.asarray(o), jnp.asarray(d), jnp.asarray(occ), jn, jf, bound, K=K,
                        max_steps=max_steps, dt_gamma=dt_gamma, perturb_key=key,
                        contract=case == "contract")
    noise = t(jax.random.uniform(key, (N,)))
    got = tm.march_rays(t(o), t(d), t(occ), t(jn), t(jf), bound, K=K, max_steps=max_steps,
                        dt_gamma=dt_gamma, noise=noise, contract=case == "contract")
    valid = np.asarray(ref.valid)
    assert 0.05 < valid.mean() < 0.95
    np.testing.assert_array_equal(n(got.valid), valid)
    np.testing.assert_array_max_ulp(n(got.ts), np.asarray(ref.ts), maxulp=1)
    np.testing.assert_array_max_ulp(n(got.dts), np.asarray(ref.dts), maxulp=1)
    np.testing.assert_allclose(n(got.xyzs), np.asarray(ref.xyzs), rtol=1e-6, atol=1e-6)


def test_march_candidate_cap_is_exact():
    """n_candidates at the span bound changes nothing (the reference's
    claim, held in the port)."""
    N, K, H = 256, 32, 32
    occ = (np.random.RandomState(5).rand(1, H, H, H) < 0.5).astype(np.uint8)
    o, d = ray_batch(N, 6)
    aabb = t(np.array([-1, -1, -1, 1, 1, 1], np.float32))
    nr, fr = tm.near_far_from_aabb(t(o), t(d), aabb)
    full = tm.march_rays(t(o), t(d), t(occ), nr, fr, 1.0, K=K, max_steps=128)
    span = float((fr - nr)[fr < 1e9].max())
    cap = int(np.ceil(span / (2 * np.sqrt(3) / 128))) + 2
    part = tm.march_rays(t(o), t(d), t(occ), nr, fr, 1.0, K=K, max_steps=128, n_candidates=cap)
    for a, b in zip(part, full):
        np.testing.assert_array_equal(n(a), n(b))


@pytest.mark.parametrize("alpha_mode", [False, True])
def test_composite_matches_reference(alpha_mode):
    rng = np.random.RandomState(7)
    N, K = 500, 48
    sig = rng.exponential(3.0 if not alpha_mode else 0.1, (N, K)).astype(np.float32)
    sig[:20] *= 200.0                      # opaque rays: T falls below T_thresh
    rgb = rng.rand(N, K, 3).astype(np.float32)
    ts = np.sort(rng.uniform(0.5, 3.0, (N, K)), axis=1).astype(np.float32)
    dts = rng.uniform(0.005, 0.05, (N, K)).astype(np.float32)
    valid = rng.rand(N, K) < 0.8
    ref = jm.composite_rays(*(jnp.asarray(x) for x in (sig, rgb, ts, dts, valid)),
                            alpha_mode=alpha_mode)
    got = tm.composite_rays(*(t(x) for x in (sig, rgb, ts, dts, valid)), alpha_mode=alpha_mode)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(n(a), np.asarray(b), rtol=1e-5, atol=1e-7)


def test_sph_flatten_freq_match_reference():
    o, d = ray_batch(300, 8, origin_r=0.5)
    np.testing.assert_allclose(n(tm.sph_from_ray(t(o), t(d), 3.0)),
                               np.asarray(jm.sph_from_ray(jnp.asarray(o), jnp.asarray(d), 3.0)),
                               rtol=1e-5, atol=1e-6)
    counts = np.random.RandomState(9).randint(0, 6, 40).astype(np.int32)
    total = int(counts.sum())
    np.testing.assert_array_equal(n(tm.flatten_rays(t(counts), total)),
                                  np.asarray(jm.flatten_rays(jnp.asarray(counts), total)))
    x = np.random.RandomState(10).uniform(-1, 1, (64, 3)).astype(np.float32)
    np.testing.assert_allclose(n(tfreq.freq_encode(t(x), 6)),
                               np.asarray(jfreq.freq_encode(jnp.asarray(x), 6)),
                               rtol=1e-6, atol=1e-6)


def test_pose_helpers_match_reference():
    pose = np.random.RandomState(11).normal(size=(4, 4)).astype(np.float32)
    np.testing.assert_array_equal(trays.nerf_matrix_to_ngp(pose, 0.8, (0.1, 0, -0.2)),
                                  jrays.nerf_matrix_to_ngp(pose, 0.8, (0.1, 0, -0.2)))
    np.testing.assert_array_equal(trays.perspective_matrix(0.9, 1.5, 0.05, 2.05),
                                  jrays.perspective_matrix(0.9, 1.5, 0.05, 2.05))
    cams = trays.create_dodecahedron_cameras(2.5, (0.1, 0.0, 0.0))
    np.testing.assert_allclose(cams, jrays.create_dodecahedron_cameras(2.5, (0.1, 0.0, 0.0)),
                               rtol=1e-6, atol=1e-6)
    intr = np.array([40.0, 40.0, 16.0, 12.0], np.float32)
    np.testing.assert_allclose(tprov.compute_mvps(cams[:5], intr, 24, 32, 1.0),
                               jprov.compute_mvps(cams[:5], intr, 24, 32, 1.0), rtol=1e-6,
                               atol=1e-6)
