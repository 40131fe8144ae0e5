"""Shared helpers of the port's parity tests (tests/test_torch_*.py).

Inputs are made from a seed with numpy and handed to both packages; where
the JAX reference draws random numbers from keys, these helpers mirror its
key derivation and pass the resulting arrays to the port.  No tests here.
JAX is imported inside the functions that need it, so the card-only tests
can use the mesh and ray makers on a machine without JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from mirres_restir_nerf_mesh_torch.render.stage1 import FrameRandoms

TORCH_THREADS = 2


def t(x, dtype=None) -> torch.Tensor:
    """numpy / jax array -> CPU tensor."""
    a = np.asarray(x)
    return torch.from_numpy(a.copy() if dtype is None else a.astype(dtype))


def launches(wrapper: str) -> int:
    """The registry's launch count of a kernel wrapper so far."""
    from mirres_restir_nerf_mesh_torch.utils.profiling import counters

    return counters().get(f"launches.{wrapper}", 0)


def n(x) -> np.ndarray:
    """tensor / jax array -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assert_close_mostly(got, ref, rtol=1e-5, atol=1e-6, frac=0.999, rtol_all=2e-4):
    """At least `frac` of the elements within (rtol, atol), every element within
    rtol_all: for ill-conditioned expressions (the GGX peak at tiny alpha, the
    barycentrics of grazing triangles) where XLA's CPU code and PyTorch
    round a cancelling sum differently."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    ok = np.abs(got - ref) <= atol + rtol * np.abs(ref)
    assert ok.mean() >= frac, f"only {ok.mean():.5f} within rtol {rtol}"
    np.testing.assert_allclose(got, ref, rtol=rtol_all, atol=atol)


def tree_np(tree):
    """JAX pytree of arrays -> same nested dicts/lists of numpy arrays."""
    if isinstance(tree, dict):
        return {k: tree_np(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_np(v) for v in tree]
    return np.asarray(tree)


def make_sphere(n_theta=24, n_phi=48, radius=0.7):
    th = np.linspace(1e-3, np.pi - 1e-3, n_theta)
    ph = np.linspace(0, 2 * np.pi, n_phi, endpoint=False)
    T, P = np.meshgrid(th, ph, indexing="ij")
    pts = radius * np.stack([np.sin(T) * np.cos(P), np.sin(T) * np.sin(P), np.cos(T)], -1).reshape(-1, 3)
    tris = []
    for i in range(n_theta - 1):
        for j in range(n_phi):
            a, b = i * n_phi + j, i * n_phi + (j + 1) % n_phi
            c, d = (i + 1) * n_phi + j, (i + 1) * n_phi + (j + 1) % n_phi
            tris += [[a, b, c], [b, d, c]]
    return np.asarray(pts, np.float32), np.asarray(tris, np.int32)


def bumpy_sphere(n_theta, n_phi):
    """Sphere with radial noise: many morton clusters, grazing-ray heavy
    (the fixture of tests/test_tile_tracer.py)."""
    v, tr = make_sphere(n_theta, n_phi)
    v = v * (1.0 + 0.15 * np.sin(9 * v[:, :1]) * np.cos(7 * v[:, 1:2]))
    return v.astype(np.float32), tr


def shell_rays(n, seed, radius=1.2):
    """Incoherent rays: origins on a sphere around the mesh, random dirs."""
    rng = np.random.RandomState(seed)
    o = rng.normal(size=(n, 3)).astype(np.float32)
    o = o / np.linalg.norm(o, axis=1, keepdims=True) * radius
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def camera_rays(n, seed, origin=(0.0, 0.0, 2.5)):
    """Coherent pinhole rays toward -z."""
    rng = np.random.RandomState(seed)
    o = np.tile(np.asarray(origin, np.float32), (n, 1))
    d = np.concatenate([rng.uniform(-0.45, 0.45, (n, 2)).astype(np.float32),
                        -np.ones((n, 1), np.float32)], axis=1)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def brdf_u_jax(key, N):
    """brdf_sample's own draws: (u_sel [N], u_d [N,2], u_s [N,2])."""
    import jax

    k_sel, k_d, k_s = jax.random.split(key, 3)
    return (jax.random.uniform(k_sel, (N,)), jax.random.uniform(k_d, (N, 2)),
            jax.random.uniform(k_s, (N, 2)))


def brdf_u_cols(u):
    """(u_sel, u_d, u_s) -> [N, 5] numpy block."""
    return np.concatenate([np.asarray(u[0])[:, None], np.asarray(u[1]), np.asarray(u[2])], axis=1)


def bounce_u_jax(kb, N):
    """trace_bounce's draws from its key, as the port's [N, 10] block."""
    import jax

    k_nee, k_next, k_mat = jax.random.split(kb, 3)
    nee = np.asarray(jax.random.uniform(k_nee, (N, 2)))
    mat = np.asarray(jax.random.uniform(k_mat, (N, 3)))
    return np.concatenate([nee, mat, brdf_u_cols(brdf_u_jax(k_next, N))], axis=1)


def indirect_u_jax(key, N, bounces):
    """render_indirect's draws from its key, as the port's [N, 5+10B] block."""
    import jax

    k0, key = jax.random.split(key)
    cols = [brdf_u_cols(brdf_u_jax(k0, N))]
    for _ in range(bounces):
        key, kb = jax.random.split(key)
        cols.append(bounce_u_jax(kb, N))
    return np.concatenate(cols, axis=1).astype(np.float32)


def direct_u_jax(k_s, P):
    """The per-spp draws render_stage1 passes to sample_direct_mis, as the
    port's [P, 8] block."""
    import jax

    k_env, k_brdf, k_pick = jax.random.split(k_s, 3)
    env = np.asarray(jax.random.uniform(k_env, (P, 2)))
    pick = np.asarray(jax.random.uniform(k_pick, (P,)))[:, None]
    return np.concatenate([env, brdf_u_cols(brdf_u_jax(k_brdf, P)), pick], axis=1).astype(np.float32)


def frame_randoms_jax(key, P, spp, bounces, H, static=None) -> FrameRandoms:
    """render_stage1's (compact_chunks=1) draws from `key`; with a ReSTIR
    `static` (use_restir=True) the ReSTIR draws in place of the direct ones."""
    import jax

    k_jit, k_di, k_ind, k_frame = jax.random.split(key, 4)
    jitter = np.asarray(jax.random.normal(k_jit, (P, 3)))
    tap = (np.asarray(jax.random.normal(jax.random.fold_in(k_jit, 7), (P, 2))) if H > 0
           else np.zeros((P, 2), np.float32))
    base = dict(jitter=t(jitter), tap=t(tap), indirect=t(indirect_u_jax(k_ind, spp * P, bounces)))
    if static is None or not static.use_restir:
        direct = np.stack([direct_u_jax(jax.random.fold_in(k_di, s), P) for s in range(spp)])
        return FrameRandoms(direct=t(direct), **base)
    return FrameRandoms(direct=None, **base, **restir_randoms_jax(k_di, k_frame, P, static))


def restir_randoms_jax(k_di, k_frame, P, static):
    """The ReSTIR draws of render_stage1 (its non-chunked chain) as the
    port's FrameRandoms fields: offsets from fold_in(frame key, 99), light
    tiles from fold_in(k_di, 10_007), initial RIS from fold_in(k_di, 1), and
    per spp the temporal and spatial keys of fold_in(k_di, s)."""
    import jax

    spp, nl, nbs = static.spp, static.restir_light_samples, static.restir_brdf_samples
    nn, T, S = static.restir_neighbors, static.restir_tiles, static.restir_tile_size
    k1, k2 = jax.random.split(jax.random.fold_in(k_frame, 99))
    offs_u = np.stack([np.asarray(jax.random.uniform(k1, (static.restir_offsets,))),
                       np.asarray(jax.random.uniform(k2, (static.restir_offsets,)))], -1)
    tiles_u = np.asarray(jax.random.uniform(jax.random.fold_in(k_di, 10_007), (T, S, 2)))
    ki_t, ki_b, ki_u, ki_s = jax.random.split(jax.random.fold_in(k_di, 1), 4)
    Nb = spp * P
    out = dict(
        restir_tiles=t(tiles_u), restir_offsets=t(offs_u),
        init_tile=t(jax.random.randint(ki_t, (Nb,), 0, T), np.int64),
        init_blk=t(jax.random.randint(ki_b, (Nb,), 0, max(S // max(nl, 1), 1)), np.int64),
        init_us=t(jax.random.uniform(ki_u, (Nb, 1 + nbs))),
        init_bu=t(jax.random.uniform(ki_s, (Nb, max(nbs, 1) * 5))),
    )
    tm, st, us = [], [], []
    for s in range(spp):
        _, _, k_tm, k_sp = jax.random.split(jax.random.fold_in(k_di, s), 4)
        k_off, k_pick = jax.random.split(k_sp)
        tm.append(np.asarray(jax.random.uniform(k_tm, (P,))))
        st.append(np.asarray(jax.random.randint(k_off, (P,), 0, static.restir_offsets)))
        us.append(np.asarray(jax.random.uniform(k_pick, (nn + 1, P))))
    out.update(temporal_u=t(np.stack(tm)), spatial_start=t(np.stack(st), np.int64),
               spatial_us=t(np.stack(us)))
    return out


def small_spec_kwargs():
    """Narrow field widths for the parity tests."""
    return dict(hidden_dim=16, hidden_dim_color=16, grid_levels=4, grid_log2_hashmap_size=12,
                grid_desired_resolution=32)


def stage0_spec_kwargs():
    """The stage-0 parity tests' field: 8 levels of 2^15, hidden 32."""
    return dict(hidden_dim=32, hidden_dim_color=32, grid_levels=8, grid_log2_hashmap_size=15,
                grid_desired_resolution=128)


def sample_draws_jax(k_batch, jsampler, num_rays):
    """RayDataset.sample's draws from its key (single pixels), as the
    port's SampleDraws."""
    import jax

    from mirres_restir_nerf_mesh_torch.data.provider import SampleDraws

    k_img, k_pix, k_bg = jax.random.split(k_batch, 3)
    n_frames = jsampler.images.shape[0]
    img = jax.random.randint(k_img, (num_rays,), 0, n_frames)
    pix = jax.random.randint(k_pix, (num_rays,), 0, jsampler.H * jsampler.W)
    sparse = {}
    if jsampler.sparse_coords is not None:
        k_sd, k_f, k_m = jax.random.split(k_bg, 3)
        sparse = dict(use_sparse=t(jax.random.uniform(k_sd, ()) < 0.1),
                      sparse_frame=t(jax.random.randint(k_f, (), 0, n_frames), np.int64),
                      sparse_m=t(jax.random.randint(k_m, (num_rays,), 0,
                                                    jsampler.sparse_coords.shape[1]), np.int64))
    bg = None
    if jsampler.background == "random" and jsampler.images.shape[-1] == 4:
        bg = t(jax.random.uniform(k_bg, (num_rays, 3)))
    return SampleDraws(img_idx=t(img, np.int64), pix_idx=t(pix, np.int64), bg=bg, **sparse)


def stage0_randoms_jax(key, jsampler, cfg, n_march):
    """make_train_step's draws from a step key (k_batch, k_perturb =
    split(key); k_perturb -> march noise and stochastic key), as the port's
    Stage0Randoms."""
    import jax

    from mirres_restir_nerf_mesh_torch.render.volume import field_points
    from mirres_restir_nerf_mesh_torch.train.stage0 import Stage0Randoms

    k_batch, k_perturb = jax.random.split(key)
    N = cfg.num_rays
    k_march, k_stoch = jax.random.split(k_perturb)
    S = cfg.max_steps if n_march is None else min(n_march, cfg.max_steps)
    P = field_points(N, min(cfg.samples_per_ray, S),
                     cfg.num_points if cfg.adaptive_num_rays else None)
    su = t(jax.random.uniform(k_stoch, (P, 3))) if cfg.stochastic_interp else None
    return Stage0Randoms(sample_draws_jax(k_batch, jsampler, N),
                         noise=t(jax.random.uniform(k_march, (N,))), stochastic_u=su)


def occupancy_draws_jax(key, C, H, bound, stochastic):
    """update_occupancy's jitter (per cascade from fold_in(key, cas)) and
    make_occ_update's stochastic uniforms (fold_in(key, 777)) as the port's
    OccupancyDraws."""
    import jax

    from mirres_restir_nerf_mesh_torch.ops.occupancy import OccupancyDraws

    jit = []
    for cas in range(C):
        half = min(2.0 ** cas, bound) / H
        jit.append(np.asarray(jax.random.uniform(jax.random.fold_in(key, cas), (H ** 3, 3),
                                                 minval=-half, maxval=half)))
    su = (t(jax.random.uniform(jax.random.fold_in(key, 777), (H ** 3, 3))) if stochastic
          else None)
    return OccupancyDraws(jitter=t(np.stack(jit)), stochastic_u=su)


def lpips_weights_npz(path):
    """The JAX package's random-VGG LPIPS params (``random_params(PRNGKey(0))``)
    written as a vendored-weights .npz, which both packages load."""
    import jax

    from mirres_restir_nerf_mesh_tpu.train.lpips import random_params

    params = jax.jit(random_params)(jax.random.PRNGKey(0))
    np.savez(path, **{k: np.asarray(v) for k, v in params.items()})
    return str(path)
