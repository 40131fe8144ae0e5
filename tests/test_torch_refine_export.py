"""Port vs reference: export/refine.py and export/stage1_export.py.

- ``subdivide_faces`` and ``refine_and_decimate`` (with and without the
  edge-length cut and the QEM decimation): vertices and faces equal.
- ``grid_atlas``, ``chart_atlas`` and ``knn_inpaint``: equal (numpy on
  the host in both packages).
- ``bake_textures`` of the material field (the reference's params carried
  over, the encoder scaled by 1e4 so that kd spans 0.15): kd and ks within
  1e-5 (measured 3.3e-6 / 6.2e-6; the two packages' encodes and matmuls
  round apart, and the difference grows with the field's gain: the MLP
  weights x 3 as well take kd's span to 0.87 and the difference to 5.5e-5).
- ``export_stage1_mesh``: the OBJ and MTL text equal; the two PNGs' pixels
  equal on >= 99.9% and every one within 1 LSB (an sRGB or material value
  on a quantization step may round to the neighbouring byte).
"""

import os

import jax
import numpy as np
import torch
from PIL import Image

from mirres_restir_nerf_mesh_tpu.export import refine as jref
from mirres_restir_nerf_mesh_tpu.export import stage1_export as jex
from mirres_restir_nerf_mesh_tpu.models.material import MaterialSpec as JMatSpec
from mirres_restir_nerf_mesh_tpu.models.material import init_material, sample_material
from mirres_restir_nerf_mesh_torch.export import refine as tref
from mirres_restir_nerf_mesh_torch.export import stage1_export as tex
from mirres_restir_nerf_mesh_torch.models.material import MaterialSpec
from mirres_restir_nerf_mesh_torch.models.material import sample_material as t_sample

from test_torch_helpers import TORCH_THREADS, make_sphere, t, tree_np

torch.set_num_threads(TORCH_THREADS)


def bumpy(n_theta=16, n_phi=32, seed=0):
    v, tr = make_sphere(n_theta, n_phi, radius=0.6)
    rng = np.random.RandomState(seed)
    return (v * (1.0 + 0.1 * rng.uniform(size=(v.shape[0], 1)))).astype(np.float32), tr


def test_subdivide_and_refine_match_reference():
    v, tr = bumpy()
    rng = np.random.RandomState(1)
    mask = rng.uniform(size=tr.shape[0]) < 0.2
    for a, b in zip(tref.subdivide_faces(v, tr, mask), jref.subdivide_faces(v, tr, mask)):
        np.testing.assert_array_equal(a, b)
    errs = np.where(rng.uniform(size=tr.shape[0]) < 0.7, rng.uniform(size=tr.shape[0]), 0.0)
    for kw in (dict(decimate_ratio=0.0), dict(decimate_ratio=0.1, min_edge_len=0.05),
               dict(refine_quantile=0.5, decimate_ratio=0.3)):
        got, ref = tref.refine_and_decimate(v, tr, errs, **kw), jref.refine_and_decimate(
            v, tr, errs, **kw)
        assert got[1].shape[0] != tr.shape[0]
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(tref.refine_and_decimate(v, tr, np.zeros(tr.shape[0])),
                    jref.refine_and_decimate(v, tr, np.zeros(tr.shape[0]))):
        np.testing.assert_array_equal(a, b)


def test_atlases_and_inpaint_match_reference():
    v, tr = bumpy()
    for a, b in zip(tex.grid_atlas(tr.shape[0], 256), jex.grid_atlas(tr.shape[0], 256)):
        np.testing.assert_array_equal(a, b)
    for kw in (dict(), dict(cone=0.9, max_chart_faces=50)):
        got, ref = tex.chart_atlas(v, tr, 128, **kw), jex.chart_atlas(v, tr, 128, **kw)
        assert got[2] == ref[2] > 1
        for a, b in zip(got[:2], ref[:2]):
            np.testing.assert_array_equal(a, b)
    rng = np.random.RandomState(2)
    feat = rng.uniform(size=(48, 48, 6)).astype(np.float32)
    covered = np.zeros((48, 48), bool)
    covered[10:30, 5:25] = True
    covered[35:40, 35:47] = True
    np.testing.assert_array_equal(tex.knn_inpaint(feat, covered, pad=8),
                                  jex.knn_inpaint(feat, covered, pad=8))


def material_case():
    spec_j, spec_t = JMatSpec(bound=1.0), MaterialSpec(bound=1.0)
    mat = init_material(jax.random.PRNGKey(3), spec_j)
    mat = {**mat, "encoder": mat["encoder"] * 1e4}
    tmat = tree_np(mat)
    tmat = {"encoder": t(tmat["encoder"]), "net": [t(x) for x in tmat["net"]]}
    jfn = jax.jit(lambda p: sample_material(mat, p, spec_j))

    def tfn(p):
        return t_sample(tmat, p, spec_t)

    return jfn, tfn


def test_bake_textures_matches_reference():
    v, tr = bumpy()
    jfn, tfn = material_case()
    uv, _, _ = jex.chart_atlas(v, tr, 64)
    kd_j, ks_j = jex.bake_textures(v, tr, uv, jfn, 64)
    kd_t, ks_t = tex.bake_textures(v, tr, uv, tfn, 64, device="cpu")
    assert np.ptp(kd_j) > 0.05
    np.testing.assert_allclose(kd_t, kd_j, rtol=0, atol=1e-5)
    np.testing.assert_allclose(ks_t, ks_j, rtol=0, atol=1e-5)


def test_export_stage1_mesh_matches_reference(tmp_path):
    v, tr = bumpy()
    jfn, tfn = material_case()
    jdir, tdir = tmp_path / "j", tmp_path / "t"
    jobj = jex.export_stage1_mesh(v, tr, jfn, str(jdir), texture_size=64)
    tobj = tex.export_stage1_mesh(v, tr, tfn, str(tdir), texture_size=64, device="cpu")
    assert os.path.basename(jobj) == os.path.basename(tobj) == "mesh_0.obj"
    for f in ("mesh_0.obj", "mesh_0.mtl"):
        assert (tdir / f).read_text() == (jdir / f).read_text()
    for f in ("feat0_0.png", "feat1_0.png"):
        a = np.asarray(Image.open(tdir / f)).astype(np.int32)
        b = np.asarray(Image.open(jdir / f)).astype(np.int32)
        assert a.shape == b.shape == (64, 64, 3)
        assert np.abs(a - b).max() <= 1
        assert (a == b).mean() >= 0.999
    f1 = np.asarray(Image.open(tdir / "feat1_0.png"))
    assert f1[..., 1].max() > 0     # roughness baked
