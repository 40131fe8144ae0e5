"""Port vs reference: stage-0 mesh extraction and the mesh files.

- ``query_density_grid`` on an analytic density (computed in numpy for
  both, so the grids are equal and QEM decimation, which an ulp can steer,
  sees the same input): equal.
- ``mark_unseen_triangles`` through the port's tracer (its plain versions
  on the CPU) against the reference's: the unseen face sets equal, on an
  outer shell that hides an inner sphere (the reference's own fixture,
  tests/test_export.py) and with a downscale.
- ``export_stage0_mesh`` on a tiny analytic field, with and without the
  visibility culling, two cascades: vertices and faces equal (the same
  native extraction on equal grids), and the files equal.
- ``make_render_fn`` + ``render_frame`` (the eval render of a trained-ish
  state: the EMA params, the occupancy grid after an update) against the
  reference's, run op by op (``jax.disable_jit``, as in
  test_torch_stage0_train.py): image and depth within 1e-5 relative.
- ``clean_components`` equal; ``write_ply`` / ``read_ply`` / ``write_obj``
  equal to the reference's bytes; ``stage0_state_from_jax`` /
  ``stage0_state_to_numpy`` round-trip bit for bit.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from mirres_restir_nerf_mesh_tpu.export import meshio as jio
from mirres_restir_nerf_mesh_tpu.export import meshops as jmo
from mirres_restir_nerf_mesh_tpu.export import stage0_export as jex
from mirres_restir_nerf_mesh_torch.export import meshio as tio
from mirres_restir_nerf_mesh_torch.export import meshops as tmo
from mirres_restir_nerf_mesh_torch.export import stage0_export as tex

from test_torch_helpers import TORCH_THREADS, make_sphere, n, stage0_spec_kwargs, t

torch.set_num_threads(TORCH_THREADS)


def density(p, xp):
    """Two blobs, a speck (a small component the cleanup drops) and a blob
    outside the unit box (the outer cascade's shell)."""
    r1 = xp.sqrt(((p - xp.asarray([0.2, 0.0, 0.0])) ** 2).sum(-1))
    r2 = xp.sqrt(((p + xp.asarray([0.3, 0.1, 0.0])) ** 2).sum(-1))
    r3 = xp.sqrt(((p - xp.asarray([0.0, 0.8, 0.8])) ** 2).sum(-1))
    r4 = xp.sqrt(((p - xp.asarray([1.45, 0.0, 0.3])) ** 2).sum(-1))
    return 40.0 * (xp.exp(-12.0 * r1 ** 2) + xp.exp(-20.0 * r2 ** 2)
                   + 0.4 * xp.exp(-900.0 * r3 ** 2) + xp.exp(-12.0 * r4 ** 2))


def jdens(p):
    return jnp.asarray(density(np.asarray(p, np.float64), np).astype(np.float32))


def tdens(p):
    return t(density(n(p).astype(np.float64), np).astype(np.float32))


def test_query_density_grid_matches_reference():
    got = tex.query_density_grid(tdens, 20, 1.5, chunk=1000, device="cpu")
    ref = jex.query_density_grid(jdens, 20, 1.5, chunk=1000)
    np.testing.assert_array_equal(got, ref)


def shell_views():
    """4 cameras on the x / y axes looking at the origin."""
    poses = []
    for axis in range(2):
        for sgn in (1.0, -1.0):
            z = np.zeros(3)
            z[axis] = sgn
            up = np.array([0.0, 1.0, 0.0]) if axis != 1 else np.array([1.0, 0, 0])
            x = np.cross(up, z)
            x /= np.linalg.norm(x)
            p = np.eye(4, dtype=np.float32)
            p[:3, 0], p[:3, 1], p[:3, 2], p[:3, 3] = x, np.cross(z, x), z, z * 2.0
            poses.append(p)
    return np.stack(poses), np.array([80.0, 80.0, 32.0, 32.0], np.float32)


def test_mark_unseen_triangles_matches_reference():
    vo, to_ = make_sphere(radius=0.6)
    vi, ti = make_sphere(radius=0.2)
    verts = np.concatenate([vo, vi])
    tris = np.concatenate([to_, ti + vo.shape[0]]).astype(np.int32)
    poses, intr = shell_views()
    for ds in (1, 2):
        ref = jex.mark_unseen_triangles(verts, tris, poses, intr, 64, 64, downscale=ds)
        got = tex.mark_unseen_triangles(verts, tris, poses, intr, 64, 64, downscale=ds,
                                        device="cpu")
        assert got[to_.shape[0]:].all()
        np.testing.assert_array_equal(got, ref)


def test_export_stage0_mesh_matches_reference(tmp_path):
    from mirres_restir_nerf_mesh_tpu.data.synthetic import make_synthetic_dataset

    data = make_synthetic_dataset(n_frames=4, H=24, W=24, bound=2.0)
    for cull in (False, True):
        kw = dict(bound=2.0, cascade=2, resolution=40, env_reso=24, density_thresh=10.0,
                  decimate_target=600, dataset=data, visibility_culling=cull)
        ref = jex.export_stage0_mesh(jdens, str(tmp_path / f"j{cull}"), **kw)
        got = tex.export_stage0_mesh(tdens, str(tmp_path / f"t{cull}"), device="cpu", **kw)
        assert len(got) == len(ref) == 2
        for (gv, gt), (rv, rt) in zip(got, ref):
            assert gt.shape[0] > 0
            np.testing.assert_array_equal(gt, rt)
            np.testing.assert_array_equal(gv, rv)
        for name in os.listdir(tmp_path / f"j{cull}"):
            assert (tmp_path / f"t{cull}" / name).read_bytes() == \
                (tmp_path / f"j{cull}" / name).read_bytes()


def test_export_stage0_mesh_empty_outer_cascade(tmp_path):
    """A compact object at bound 2: the outer cascade keeps no face once the
    inner box's are cut, so there is nothing to cull; mesh_1.ply is written
    empty and mesh_0 equals the reference's (run with one cascade: with two
    and culling on, it builds a tracer on the empty mesh and fails)."""
    from mirres_restir_nerf_mesh_tpu.data.synthetic import make_synthetic_dataset

    def inner(p, xp):
        r1 = xp.sqrt(((p - xp.asarray([0.2, 0.0, 0.0])) ** 2).sum(-1))
        r2 = xp.sqrt(((p + xp.asarray([0.3, 0.1, 0.0])) ** 2).sum(-1))
        return 40.0 * (xp.exp(-12.0 * r1 ** 2) + xp.exp(-20.0 * r2 ** 2))

    data = make_synthetic_dataset(n_frames=4, H=24, W=24, bound=2.0)
    kw = dict(bound=2.0, resolution=40, env_reso=24, density_thresh=10.0, decimate_target=600,
              dataset=data, visibility_culling=True)
    got = tex.export_stage0_mesh(lambda p: t(inner(n(p).astype(np.float64), np).astype(np.float32)),
                                 str(tmp_path / "t"), cascade=2, device="cpu", **kw)
    ref = jex.export_stage0_mesh(
        lambda p: jnp.asarray(inner(np.asarray(p, np.float64), np).astype(np.float32)),
        str(tmp_path / "j"), cascade=1, **kw)
    assert len(got) == 2 and got[0][1].shape[0] > 0 and got[1][1].shape[0] == 0
    np.testing.assert_array_equal(got[0][1], ref[0][1])
    np.testing.assert_array_equal(got[0][0], ref[0][0])
    assert (tmp_path / "t" / "mesh_1.ply").exists()


def test_clean_components_and_mesh_files_match_reference(tmp_path):
    n_ = 28
    ax = np.linspace(-1, 1, n_, dtype=np.float32)
    X, Y, Z = np.meshgrid(ax, ax, ax, indexing="ij")
    field = np.maximum(0.5 - np.sqrt(X ** 2 + Y ** 2 + Z ** 2),
                       0.09 - np.sqrt((X - 0.8) ** 2 + (Y - 0.8) ** 2 + Z ** 2))
    v, f = tmo.marching_tets(field, 0.0, origin=(-1, -1, -1), spacing=(2 / (n_ - 1),) * 3)
    for args in ((8, 0.05), (8, 0.3), (200, 0.0)):
        gv, gf = tmo.clean_components(v, f, *args)
        rv, rf = jmo.clean_components(v, f, *args)
        np.testing.assert_array_equal(gf, rf)
        np.testing.assert_array_equal(gv, rv)
    tio.write_ply(str(tmp_path / "t.ply"), v, f)
    jio.write_ply(str(tmp_path / "j.ply"), v, f)
    assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()
    for reader in (tio.read_ply, jio.read_ply):
        rv, rf = reader(str(tmp_path / "t.ply"))
        np.testing.assert_array_equal(rv, v)
        np.testing.assert_array_equal(rf, f)
    ascii_ply = ("ply\nformat ascii 1.0\nelement vertex 3\nproperty float x\nproperty float y\n"
                 "property float z\nelement face 1\nproperty list uchar int vertex_indices\n"
                 "end_header\n0 0 0\n1 0 0\n0 1 0\n3 0 1 2\n")
    (tmp_path / "a.ply").write_text(ascii_ply)
    for a, b in zip(tio.read_ply(str(tmp_path / "a.ply")), jio.read_ply(str(tmp_path / "a.ply"))):
        np.testing.assert_array_equal(a, b)
    uv = np.random.RandomState(0).rand(v.shape[0], 2).astype(np.float32)
    tio.write_obj(str(tmp_path / "t.obj"), v, f, uv, f, feat0_png="a.png", feat1_png="b.png")
    jio.write_obj(str(tmp_path / "j.obj"), v, f, uv, f, feat0_png="a.png", feat1_png="b.png")
    assert (tmp_path / "t.obj").read_text().replace("t.mtl", "j.mtl") == \
        (tmp_path / "j.obj").read_text()
    assert (tmp_path / "t.mtl").read_bytes() == (tmp_path / "j.mtl").read_bytes()


def test_stage0_state_round_trip():
    from mirres_restir_nerf_mesh_tpu.config import Config, finalize
    from mirres_restir_nerf_mesh_tpu.models.nerf import NeRFSpec
    from mirres_restir_nerf_mesh_tpu.train import stage0 as js0
    from mirres_restir_nerf_mesh_torch.convert import stage0_state_from_jax, stage0_state_to_numpy

    cfg = finalize(Config(grid_size=16))
    js = js0.init_state(jax.random.PRNGKey(1), cfg, NeRFSpec(sdf=True, **stage0_spec_kwargs()))
    rng = np.random.RandomState(2)
    js = js._replace(
        opt_state=jax.tree.map(lambda x: jnp.asarray(rng.normal(size=np.shape(x)), x.dtype)
                               if x.dtype == jnp.float32 else x + 3, js.opt_state),
        step=js.step + 3)
    got = stage0_state_to_numpy(stage0_state_from_jax(js, device="cpu"))
    assert got["step"] == 3 and got["opt"]["count"] == 3
    for a, b in zip(jax.tree.leaves(got["params"]), jax.tree.leaves(js.params)):
        np.testing.assert_array_equal(a, np.asarray(b))
    for a, b in zip(got["opt"]["mu"] + got["opt"]["nu"],
                    jax.tree.leaves(js.opt_state[0].mu) + jax.tree.leaves(js.opt_state[0].nu)):
        np.testing.assert_array_equal(a, np.asarray(b))
    for k in ("density_grid", "occ", "mean_density"):
        np.testing.assert_array_equal(got["occ"][k], np.asarray(getattr(js.occ, k)))


def test_render_frame_matches_reference():
    from mirres_restir_nerf_mesh_tpu.config import Config as JConfig
    from mirres_restir_nerf_mesh_tpu.config import finalize as jfinalize
    from mirres_restir_nerf_mesh_tpu.data.provider import RayDataset
    from mirres_restir_nerf_mesh_tpu.data.synthetic import make_synthetic_dataset
    from mirres_restir_nerf_mesh_tpu.models.nerf import NeRFSpec as JSpec
    from mirres_restir_nerf_mesh_tpu.train import stage0 as js0
    from mirres_restir_nerf_mesh_torch.config import Config, finalize
    from mirres_restir_nerf_mesh_torch.convert import stage0_state_from_jax
    from mirres_restir_nerf_mesh_torch.models.nerf import NeRFSpec
    from mirres_restir_nerf_mesh_torch.train import stage0 as ts0

    kw = dict(bound=1.0, max_steps=128, samples_per_ray_infer=24, grid_size=16)
    jcfg, cfg = jfinalize(JConfig(**kw)), finalize(Config(**kw))
    jspec, tspec = JSpec(bound=1.0, **stage0_spec_kwargs()), NeRFSpec(bound=1.0,
                                                                       **stage0_spec_kwargs())
    js = js0.init_state(jax.random.PRNGKey(3), jcfg, jspec)
    js = js._replace(params={**js.params, "encoder": js.params["encoder"] * 3e3},
                     ema_params={**js.ema_params, "encoder": js.ema_params["encoder"] * 2e3})
    js = js0.make_occ_update(jcfg, jspec)(js, jax.random.PRNGKey(4))
    f = RayDataset(make_synthetic_dataset(n_frames=1, H=12, W=12, bound=1.0), 1.0).frame_rays(0)
    with jax.disable_jit():
        ref = js0.render_frame(js, js0.make_render_fn(jcfg, jspec), f["rays_o"], f["rays_d"],
                               12, 12, chunk=100)
    got = ts0.render_frame(stage0_state_from_jax(js, device="cpu"),
                           ts0.make_render_fn(cfg, tspec), t(f["rays_o"]), t(f["rays_d"]), 12,
                           12, chunk=100)
    for a, b in zip(got, ref):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
