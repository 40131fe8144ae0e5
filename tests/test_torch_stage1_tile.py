"""The slice as a whole on the tile tracer: render_stage1 with the mesh just
above dense_threshold, so every primary, shadow and bounce launch goes
through the candidate prep and K1's plain version (the reference runs its
Pallas queue kernel in interpret mode).  16x16 pixels, spp 1, 2 bounces;
tolerances as in tests/test_torch_stage1.py.
"""

import torch

from mirres_restir_nerf_mesh_torch.render import stage1 as ts

from test_torch_helpers import TORCH_THREADS
from test_torch_stage1 import assert_frames_match, frame_case

torch.set_num_threads(TORCH_THREADS)


def test_render_stage1_tile_path_matches_reference():
    ref, params, static, inputs, rand = frame_case(H=16, spp=1, faces=1200, dense_threshold=1024)
    C = -(-int(static.tris.shape[0]) // 128)
    assert C * 128 > static.dense_threshold
    got = ts.render_stage1(params, static, *inputs, rand=rand)
    assert_frames_match(ref, got)


def test_frame_rays_and_bench_mesh_match_reference():
    """The port's own copies of the synthetic orbit cameras + get_rays and of
    the meshops wrapper give the reference's rays (within 1e-6: einsum vs
    matmul order) and, at chip_smoke's bench settings shrunk to a 32^3 grid,
    the reference's mesh bit for bit."""
    import numpy as np

    from mirres_restir_nerf_mesh_tpu.data.provider import RayDataset
    from mirres_restir_nerf_mesh_tpu.data.synthetic import make_synthetic_dataset
    from mirres_restir_nerf_mesh_tpu.export import meshops as jmesh
    from mirres_restir_nerf_mesh_torch.data.synthetic import frame_rays, synthetic_cameras
    from mirres_restir_nerf_mesh_torch.export import meshops as tmesh

    ref = RayDataset(make_synthetic_dataset(n_frames=1, H=24, W=32, radius=1.3), bound=1.0)
    ref = ref.frame_rays(0)
    poses, intr = synthetic_cameras(n_frames=1, H=24, W=32, radius=1.3)
    got = frame_rays(poses[0], intr, 24, 32, "cpu")
    for k in ("rays_o", "rays_d"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=0, atol=1e-6, err_msg=k)

    ax = np.linspace(-1, 1, 32, dtype=np.float32)
    X, Y, Z = np.meshgrid(ax, ax, ax, indexing="ij")
    field = 0.55 + 0.06 * np.sin(9 * X) * np.sin(7 * Y) * np.cos(5 * Z) - np.sqrt(X**2 + Y**2 + Z**2)
    kw = dict(origin=(-1, -1, -1), spacing=(2 / 31,) * 3)
    vr, tr = jmesh.decimate(*jmesh.marching_tets(field, 0.0, **kw), 2000)
    vg, tg = tmesh.decimate(*tmesh.marching_tets(field, 0.0, **kw), 2000)
    np.testing.assert_array_equal(vg, vr)
    np.testing.assert_array_equal(tg, tr)
