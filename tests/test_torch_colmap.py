"""Port vs reference: ``data/colmap.py`` on the COLMAP fixtures of
tests/test_colmap.py (PNG frames written with PIL).

- The binary and text readers return the reference's dicts and arrays
  equal; an image with no keypoints (text model) and one with no tracked
  point (binary model) load.
- ``extract_sparse_depth`` with untracked keypoints, ids the model lacks
  and a downscale: tables and cam_near_far equal to the reference's.
- ``load_colmap`` (train / val / test, binary and text, downscale 1) and
  ``per_view_near_far``: images, poses, intrinsics, mvps, the sparse
  tables, cam_near_far and pts3d equal to 1e-6; dense depth maps under
  depths/ (at the frame's size and at another, resized by PIL's BILINEAR
  in float in the reference and by the antialiased bilinear here): within
  1e-4 of the map's range.
- ``align_dense_depth``: on depths that lie exactly on a line with 20-30%
  gross outliers, the port's numpy RANSAC and the reference's (scikit-
  learn's RANSACRegressor) both recover scale and bias within 1e-4; the
  two negative-scale fallbacks against the reference with scikit-learn
  hidden (its weighted lstsq then fits the same exact line).
- ``RayDataset.sample`` of a colmap FrameData against the reference's
  sampler with its own draws, on keys whose sparse-depth branch fires and
  keys whose does not.
"""

import os
import struct
import sys

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from mirres_restir_nerf_mesh_tpu.data import colmap as jcm
from mirres_restir_nerf_mesh_tpu.data.provider import RayDataset as JRayDataset
from mirres_restir_nerf_mesh_torch.data import colmap as tcm
from mirres_restir_nerf_mesh_torch.data.provider import RayDataset as TRayDataset

from test_colmap import make_fixture, make_fixture_text
from test_torch_helpers import TORCH_THREADS, n, sample_draws_jax

torch.set_num_threads(TORCH_THREADS)

FIELDS = ("images", "poses", "intrinsics", "mvps", "sparse_coords", "sparse_depth",
          "sparse_weight", "cam_near_far", "pts3d", "depths")


def assert_same(got, ref, atol=1e-6, depth_atol=None):
    assert (got.H, got.W) == (ref.H, ref.W)
    for f in FIELDS:
        g, r = getattr(got, f), getattr(ref, f, None)
        assert (g is None) == (r is None), f
        if g is None:
            continue
        assert g.shape == r.shape, f
        if f == "sparse_coords":
            np.testing.assert_array_equal(g, r)
        else:
            np.testing.assert_allclose(g, r, rtol=1e-6, atol=depth_atol if f == "depths" and
                                       depth_atol is not None else atol, err_msg=f)


def workspace(tmp_path, fmt):
    if fmt == "bin":
        make_fixture(tmp_path)
    else:
        make_fixture_text(tmp_path)
    return str(tmp_path)


@pytest.mark.parametrize("fmt", ["bin", "txt"])
def test_model_readers_match_reference(tmp_path, fmt):
    root = workspace(tmp_path, fmt)
    sp = os.path.join(root, "sparse", "0")
    for name, tread, jread in (
            ("cameras", (tcm.read_cameras_binary, tcm.read_cameras_text),
             (jcm.read_cameras_binary, jcm.read_cameras_text)),
            ("images", (tcm.read_images_binary, tcm.read_images_text),
             (jcm.read_images_binary, jcm.read_images_text))):
        got = tcm._read_model_file(sp, name, *tread)
        ref = jcm._read_model_file(sp, name, *jread)
        assert got.keys() == ref.keys()
        for k in ref:
            assert got[k].keys() == ref[k].keys()
            for f in ref[k]:
                np.testing.assert_array_equal(np.asarray(got[k][f]), np.asarray(ref[k][f]))
    got = tcm._read_model_file(sp, "points3D", tcm.read_points3d_binary, tcm.read_points3d_text)
    ref = jcm._read_model_file(sp, "points3D", jcm.read_points3d_binary, jcm.read_points3d_text)
    for g, r in zip(got[:2], ref[:2]):
        assert g.dtype == r.dtype
        np.testing.assert_array_equal(g, r)
    assert got[2] == ref[2]


def test_images_without_points(tmp_path):
    p = tmp_path / "images.txt"
    p.write_text("# comment\n1 1.0 0.0 0.0 0.0 0.1 0.2 2.0 1 a.png\n\n"
                 "2 1.0 0.0 0.0 0.0 0.3 0.4 2.5 1 b.png\n1.5 2.5 7 3.5 4.5 -1\n")
    got, ref = tcm.read_images_text(str(p)), jcm.read_images_text(str(p))
    assert sorted(got) == sorted(ref) == [1, 2] and got[1]["xys"].shape == (0, 2)
    for k in ref:
        for f in ref[k]:
            np.testing.assert_array_equal(np.asarray(got[k][f]), np.asarray(ref[k][f]))
    # binary: the second view keeps its keypoints but none is tracked
    make_fixture(tmp_path / "ws")
    images = tcm.read_images_binary(str(tmp_path / "ws/sparse/0/images.bin"))
    buf = bytearray((tmp_path / "ws/sparse/0/images.bin").read_bytes())
    pos = 8
    for iid in sorted(images):
        pos += 4 + 32 + 24 + 4 + len(images[iid]["name"]) + 1
        (m,) = struct.unpack_from("<Q", buf, pos)
        pos += 8
        if iid == 2:
            for j in range(m):
                struct.pack_into("<q", buf, pos + 24 * j + 16, -1)
        pos += 24 * m
    (tmp_path / "ws/sparse/0/images.bin").write_bytes(bytes(buf))
    kw = dict(split="train", test_every=100, bound=2.0)
    assert_same(tcm.load_colmap(str(tmp_path / "ws"), **kw),
                jcm.load_colmap(str(tmp_path / "ws"), **kw))


def test_extract_sparse_depth_matches_reference():
    rng = np.random.RandomState(3)
    P, F = 60, 4
    pts = rng.uniform(-0.5, 0.5, (P, 3)).astype(np.float32)
    err = rng.uniform(0.1, 1.0, P).astype(np.float32)
    ids = rng.choice(10_000, P, replace=False)
    id_map = {int(i): r for r, i in enumerate(ids)}
    poses = np.tile(np.eye(4, dtype=np.float32), (F, 1, 1))
    poses[:, 2, 3] = 2.0 + rng.uniform(0, 0.5, F)
    poses[:, 0, 3] = rng.uniform(-0.3, 0.3, F)
    meta = {}
    for k in range(F):
        m = 25 + 7 * k
        pid = ids[rng.randint(0, P, m)].astype(np.int64)
        pid[::5] = -1                                  # untracked
        pid[1::9] = 20_000 + k                         # not in the model
        meta[10 + k] = dict(xys=rng.uniform(0, 1, (m, 2)) * [64, 48], point3D_ids=pid)
    keys = [12, 10, 13, 11]
    for ds in (1, 2):
        got = tcm.extract_sparse_depth(meta, keys, poses, pts, err, id_map, 48 // ds, 64 // ds, ds)
        ref = jcm.extract_sparse_depth(meta, keys, poses, pts, err, id_map, 48 // ds, 64 // ds, ds)
        for g, r in zip(got, ref):
            assert g.dtype == r.dtype and g.shape == r.shape
            np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("fmt", ["bin", "txt"])
@pytest.mark.parametrize("split", ["train", "val", "test"])
def test_load_colmap_matches_reference(tmp_path, fmt, split):
    root = workspace(tmp_path, fmt)
    kw = dict(split=split, test_every=3, bound=2.0, offset=(0.1, 0.0, -0.2))
    got, ref = tcm.load_colmap(root, **kw), jcm.load_colmap(root, **kw)
    assert_same(got, ref)
    np.testing.assert_allclose(tcm.per_view_near_far(got), jcm.per_view_near_far(ref),
                               rtol=1e-6)
    kw = dict(split=split, test_every=3, bound=2.0, scale=0.7, enable_cam_center=True,
              with_images=False)
    assert_same(tcm.load_colmap(root, **kw), jcm.load_colmap(root, **kw))


@pytest.mark.parametrize("resized", [False, True])
def test_load_colmap_dense_depth_matches_reference(tmp_path, resized):
    make_fixture(tmp_path)
    kw = dict(split="train", test_every=100, bound=2.0)
    fd = jcm.load_colmap(str(tmp_path), **kw)
    os.makedirs(tmp_path / "depths")
    rng = np.random.RandomState(4)
    H, W = (fd.H + 13, fd.W * 2) if resized else (fd.H, fd.W)
    for i in range(4):
        # a monocular map of this view: the sparse depths' own affine image at
        # their pixels (scale 0.4, bias 0.7), a smooth field elsewhere
        dm = (1.0 + 0.3 * np.sin(np.arange(H)[:, None] / 5.0 + np.arange(W)[None] / 7.0)
              + 0.01 * rng.normal(size=(H, W)))
        if not resized and i > 0:
            c, d, w = fd.sparse_coords[i - 1], fd.sparse_depth[i - 1], fd.sparse_weight[i - 1]
            dm[c[w > 0, 0], c[w > 0, 1]] = 0.4 * d[w > 0] + 0.7
        np.save(tmp_path / "depths" / f"img_{i:02d}.npy", dm.astype(np.float32))
    got, ref = tcm.load_colmap(str(tmp_path), **kw), jcm.load_colmap(str(tmp_path), **kw)
    assert got.depths is not None and got.depths.shape == (3, fd.H, fd.W)
    if resized:
        # the resize alone: the scale and bias come from RANSAC on other data
        raw = np.load(tmp_path / "depths" / "img_01.npy")
        want = np.asarray(Image.fromarray(raw).resize((fd.W, fd.H), Image.BILINEAR), np.float32)
        mine = tcm.resize_bilinear_aa(raw[..., None], fd.H, fd.W)[..., 0]
        np.testing.assert_allclose(mine, want, rtol=0, atol=1e-5 * np.ptp(raw))
    else:
        # exact line: both RANSACs recover it
        np.testing.assert_allclose(got.depths, ref.depths, rtol=0,
                                   atol=1e-4 * float(np.ptp(ref.depths)))
        got.depths = ref.depths = None
        assert_same(got, ref)


def exact_line_with_outliers(seed, share, n=200, scale=2.5, bias=-0.8):
    rng = np.random.RandomState(seed)
    dense = rng.uniform(0.5, 3.0, (20, 30)).astype(np.float32)
    coords = np.stack([rng.randint(0, 20, n), rng.randint(0, 30, n)], -1).astype(np.int32)
    sdepth = (dense[coords[:, 0], coords[:, 1]].astype(np.float64) * scale + bias)
    bad = rng.rand(n) < share
    sdepth[bad] += rng.uniform(2.0, 6.0, bad.sum()) * rng.choice([-1, 1], bad.sum())
    weight = rng.uniform(0.2, 2.0, n).astype(np.float32)
    return dense, coords, sdepth.astype(np.float32), weight, (scale, bias)


@pytest.mark.parametrize("share,seed", [(0.2, 0), (0.25, 1), (0.3, 2)])
def test_ransac_recovers_scale_and_bias_like_sklearn(share, seed):
    dense, coords, sdepth, weight, (a, b) = exact_line_with_outliers(seed, share)
    want = dense * a + b
    for align in (tcm.align_dense_depth, jcm.align_dense_depth):
        got = align(dense, coords, sdepth, weight)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("case", ["two_heaviest", "through_origin"])
def test_negative_scale_fallbacks_match_reference(monkeypatch, case):
    rng = np.random.RandomState(5)
    dense = rng.uniform(0.5, 3.0, (10, 12)).astype(np.float32)
    coords = np.stack([rng.randint(0, 10, 40), rng.randint(0, 12, 40)], -1).astype(np.int32)
    x = dense[coords[:, 0], coords[:, 1]].astype(np.float64)
    sdepth = (5.0 - 1.2 * x).astype(np.float32)         # a negative line, no outlier
    weight = np.full(40, 0.5, np.float32)
    i, j = np.argsort(x)[[0, -1]]
    if case == "two_heaviest":
        # the two heaviest points rise: the first fallback's line is positive
        sdepth[i], sdepth[j] = 1.0, 4.0
    else:
        sdepth[i], sdepth[j] = 4.0, 1.0                 # they fall: the ratio of the heaviest
    weight[i], weight[j] = 0.6, 0.59                    # the two heaviest, off the line
    monkeypatch.setitem(sys.modules, "sklearn.linear_model", None)
    ref = jcm.align_dense_depth(dense, coords, sdepth, weight)
    got = tcm.align_dense_depth(dense, coords, sdepth, weight)
    x0, y0, x1, y1 = x[i], float(sdepth[i]), x[j], float(sdepth[j])
    a = (y0 - y1) / (x0 - x1)
    want = dense * a + (y0 - x0 * a) if case == "two_heaviest" else dense * (y0 / x0)
    np.testing.assert_allclose(ref, want.astype(np.float32), rtol=1e-5)
    np.testing.assert_allclose(got, ref, rtol=1e-6)


def test_sampler_sparse_branch_matches_reference(tmp_path):
    make_fixture(tmp_path)
    fd_j = jcm.load_colmap(str(tmp_path), split="train", test_every=100, bound=2.0)
    fd_t = tcm.load_colmap(str(tmp_path), split="train", test_every=100, bound=2.0)
    js, ts = JRayDataset(fd_j, bound=2.0), TRayDataset(fd_t, bound=2.0, device="cpu")
    fired = []
    for s in range(40):
        key = jax.random.PRNGKey(s)
        draws = sample_draws_jax(key, js, 128)
        ref, got = js.sample(key, 128), ts.sample(draws)
        fired.append(bool(draws.use_sparse))
        assert got.keys() == ref.keys()
        for k in ref:
            np.testing.assert_allclose(n(got[k]), np.asarray(ref[k]), rtol=1e-6, atol=1e-6,
                                       err_msg=k)
        if fired[-1]:
            assert (n(got["depth_weight"]) > 0).all() and (n(got["depth"]) > 0).all()
        else:
            assert (n(got["depth_weight"]) == 0).all()
    assert any(fired) and not all(fired)
