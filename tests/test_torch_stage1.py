"""The slice as a whole: the port's render_stage1 (use_restir=False) against
the reference's on the same weights, mesh, rays and random draws.

32x32 pixels, spp 2, 2 bounces, a four-ball mesh on the dense tracer path,
compact_chunks=1 (the reference then draws every random number from the
frame key, and the helpers mirror that derivation).  Tolerances: mask and
face_id agree on >= 99.9% of pixels; on the pixels where both agree, 99.5%
of every other output within atol 1e-4 (+ rtol 1e-4 for radiance above 1)
and all within rtol 1e-2 (a glossy sample's MIS weight sits on the GGX
peak, whose denominator cancels: see tests/test_torch_light.py); the
scalar counters equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mirres_restir_nerf_mesh_tpu.data.provider import RayDataset
from mirres_restir_nerf_mesh_tpu.data.synthetic import make_synthetic_dataset
from mirres_restir_nerf_mesh_tpu.models.material import MaterialSpec as JMatSpec
from mirres_restir_nerf_mesh_tpu.models.material import init_material
from mirres_restir_nerf_mesh_tpu.models.nerf import NeRFSpec as JNeRFSpec
from mirres_restir_nerf_mesh_tpu.models.nerf import init_nerf
from mirres_restir_nerf_mesh_tpu.render import stage1 as js
from mirres_restir_nerf_mesh_torch.convert import params_from_jax
from mirres_restir_nerf_mesh_torch.models.material import MaterialSpec
from mirres_restir_nerf_mesh_torch.models.nerf import NeRFSpec
from mirres_restir_nerf_mesh_torch.render import stage1 as ts

from test_torch_helpers import (TORCH_THREADS, assert_close_mostly, frame_randoms_jax, n,
                                small_spec_kwargs, t, tree_np)
from test_torch_light import sky_env
from test_torch_pathtracer import balls_mesh

torch.set_num_threads(TORCH_THREADS)


def frame_case(H, spp, faces, dense_threshold, run_reference=True):
    """(reference out or None, port params/static/inputs, randoms) of one frame."""
    v, tr = balls_mesh(faces=faces)
    data = make_synthetic_dataset(n_frames=1, H=H, W=H, bound=1.0)
    f = RayDataset(data, bound=1.0).frame_rays(0)
    kw = small_spec_kwargs()
    key = jax.random.PRNGKey(0)
    mat = init_material(jax.random.fold_in(key, 1), JMatSpec(bound=1.0))
    mat = {**mat, "encoder": mat["encoder"] * 1e3}
    params = js.Stage1Params(nerf=init_nerf(key, JNeRFSpec(bound=1.0, **kw)),
                             offsets=jnp.asarray(np.random.RandomState(2).normal(
                                 size=(v.shape[0], 3)).astype(np.float32) * 1e-3),
                             mat=mat, env=jnp.asarray(sky_env(16, 32, seed=3)))
    common = dict(spp=spp, bounces=2, H=H, W=H, compact_chunks=1, dense_threshold=dense_threshold,
                  k_cap=640, k_cap_incoherent=640, queue_avg=256, queue_avg_incoherent=64)
    jstatic = js.Stage1Static(tris=jnp.asarray(tr), nerf_spec=JNeRFSpec(bound=1.0, **kw),
                              mat_spec=JMatSpec(bound=1.0), tracer="tile", **common)
    fk = jax.random.PRNGKey(5)
    ref = (js.render_stage1(params, jstatic, jnp.asarray(v), f["rays_o"], f["rays_d"], fk)
           if run_reference else None)
    tparams = params_from_jax(tree_np(params.nerf), tree_np(params.mat), np.asarray(params.env),
                              np.asarray(params.offsets), device="cpu")
    tstatic = ts.Stage1Static(tris=t(tr), nerf_spec=NeRFSpec(bound=1.0, **kw),
                              mat_spec=MaterialSpec(bound=1.0), **common)
    inputs = (t(v), t(f["rays_o"]), t(f["rays_d"]))
    return ref, tparams, tstatic, inputs, frame_randoms_jax(fk, H * H, spp, 2, H)


def assert_frames_match(ref, got):
    assert set(got) == set(ref)
    m_ref, f_ref = np.asarray(ref["mask"]), np.asarray(ref["face_id"])
    agree = (n(got["mask"]) == m_ref) & (n(got["face_id"]) == f_ref)
    assert agree.mean() >= 0.999, agree.mean()
    assert 0.1 < m_ref.mean() < 0.9
    for k in ref:
        a, b = np.asarray(ref[k]), n(got[k])
        if a.ndim == 0:
            assert float(b) == float(a), k
            continue
        assert_close_mostly(b[agree], a[agree], rtol=1e-4, atol=1e-4, frac=0.995, rtol_all=1e-2)


def test_render_stage1_matches_reference():
    ref, params, static, inputs, rand = frame_case(H=32, spp=2, faces=1200, dense_threshold=8192)
    got = ts.render_stage1(params, static, *inputs, rand=rand)
    assert_frames_match(ref, got)
    assert float(np.abs(np.asarray(ref["img_brdf_indirect"])).max()) > 1e-3, "indirect must matter"
    assert float(ref["traced_rays"]) > 32 * 32


def test_compact_chunks_equivalence():
    """Live-lane compaction (compact_chunks=4) reproduces compact_chunks=1 on
    every covered pixel, deterministic, direct and indirect outputs alike
    (the randoms ride in pixel space)."""
    _, params, static, inputs, rand = frame_case(H=16, spp=2, faces=1200, dense_threshold=8192,
                                                 run_reference=False)
    outs = {}
    for chunks in (1, 4):
        st = ts.Stage1Static(**{**static.__dict__, "compact_chunks": chunks})
        outs[chunks] = ts.render_stage1(params, st, *inputs, rand=rand)
    m = n(outs[1]["weights_sum"]) > 0.5
    assert m.any() and (~m).any()
    for k in ("image", "image_brdf", "kd", "diffuse_light", "specular_light", "img_brdf_indirect",
              "kd_grad", "normal"):
        np.testing.assert_allclose(n(outs[4][k])[m], n(outs[1][k])[m], atol=1e-6, err_msg=k)
    assert float(outs[4]["traced_rays"]) == float(outs[1]["traced_rays"])


def test_unported_options_raise():
    st = ts.Stage1Static(tris=torch.zeros((1, 3), dtype=torch.int64), nerf_spec=NeRFSpec(),
                         mat_spec=MaterialSpec(), use_restir=True)
    with pytest.raises(NotImplementedError):
        ts.render_stage1(None, st, torch.zeros((3, 3)), torch.zeros((4, 3)), torch.zeros((4, 3)))
    st = ts.Stage1Static(tris=torch.zeros((1, 3), dtype=torch.int64), nerf_spec=NeRFSpec(),
                         mat_spec=MaterialSpec(), denoise_iters=2)
    with pytest.raises(NotImplementedError):
        ts.render_stage1(None, st, torch.zeros((3, 3)), torch.zeros((4, 3)), torch.zeros((4, 3)))
