"""Port vs reference: morton codes, cluster build, the dense tracer (K3's
plain version against pallas_dense_hit in interpret mode and against the
reference's XLA dense pass) and the Tracer's counters; plus the port's
import boundary (no JAX, nothing of the JAX package).

Tolerances: morton codes and cluster tables exact (integer and copy
arithmetic); dense-hit prims agree on >= 99.9% of rays (shared-edge ties);
where they agree t within 1e-5 relative, u, v within 5e-5 of their [0, 1]
range (see tests/test_torch_tile_tracer.py for why).
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mirres_restir_nerf_mesh_tpu.ops import cluster_bvh as jc
from mirres_restir_nerf_mesh_tpu.ops import morton as jm
from mirres_restir_nerf_mesh_tpu.ops import pallas_tracer as jp
from mirres_restir_nerf_mesh_tpu.ops import tracer as jtr
from mirres_restir_nerf_mesh_torch.device import resolve_device
from mirres_restir_nerf_mesh_torch.ops import cluster_bvh as tc
from mirres_restir_nerf_mesh_torch.ops import dense_tracer as td
from mirres_restir_nerf_mesh_torch.ops import morton as tm
from mirres_restir_nerf_mesh_torch.ops import tracer as ttr

from test_torch_helpers import (TORCH_THREADS, bumpy_sphere, camera_rays, make_sphere, n,
                                shell_rays, t)

torch.set_num_threads(TORCH_THREADS)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_morton_codes_exact():
    rng = np.random.RandomState(0)
    c = rng.randint(0, 1024, (4096, 3)).astype(np.int32)
    c[:8] = [[0, 0, 0], [1023, 1023, 1023], [1023, 0, 0], [0, 1023, 0],
             [0, 0, 1023], [512, 511, 1], [1, 2, 3], [1000, 17, 999]]
    ref = np.asarray(jm.morton3d(jnp.asarray(c))).astype(np.int64)
    got = n(tm.morton3d(t(c)))
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("mesh", ["bumpy", "ragged", "tiny"])
def test_build_clusters_exact(mesh):
    """Cluster order, AABBs, soa/packed/geom_cm and superclusters, bit for bit
    (stable morton sort, as jnp.argsort)."""
    if mesh == "bumpy":
        v, tr = bumpy_sphere(24, 48)
    elif mesh == "ragged":
        v, tr = make_sphere(13, 17)          # C*S padding, C % 8 != 0
    else:
        v, tr = make_sphere(4, 6)            # fewer triangles than S
    ref = jc.build_clusters(jnp.asarray(v), jnp.asarray(tr), 128)
    got = tc.build_clusters(t(v), t(tr), 128)
    for f in ref._fields:
        np.testing.assert_array_equal(n(getattr(got, f)), np.asarray(getattr(ref, f)), err_msg=f)


def test_dense_hit_plain_matches_pallas_interpret():
    v, tr = make_sphere(24, 48)
    o, _ = shell_rays(700, seed=3, radius=1.5)
    d = np.random.RandomState(4).normal(size=(700, 3)).astype(np.float32) * 0.4 - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    cm_ref = jp.pack_tris_cm(jnp.asarray(v), jnp.asarray(tr))
    cm = td.pack_tris_cm(t(v), t(tr))
    np.testing.assert_array_equal(n(cm), np.asarray(cm_ref))
    bt, bl, bu, bv = jp.pallas_dense_hit(cm_ref, jnp.asarray(o), jnp.asarray(d))
    gt, gl, gu, gv = td.dense_hit(cm, t(o), t(d))
    same = n(gl) == np.asarray(bl)
    assert same.mean() >= 0.999
    hit = same & (np.asarray(bl) >= 0)
    assert hit.sum() > 100
    np.testing.assert_allclose(n(gt)[hit], np.asarray(bt)[hit], rtol=1e-5)
    np.testing.assert_allclose(n(gu)[hit], np.asarray(bu)[hit], rtol=0, atol=5e-5)
    np.testing.assert_allclose(n(gv)[hit], np.asarray(bv)[hit], rtol=0, atol=5e-5)
    assert (n(gt)[~(np.asarray(bl) >= 0)] >= 1e29).all()


def test_intersect_dense_matches_reference():
    """The dense path of intersect_tiles_t (ragged triangle count, finite
    per-ray t_max) against the reference's XLA dense pass."""
    v, tr = bumpy_sphere(13, 17)
    o, d = camera_rays(333, seed=7)
    tmax = np.random.RandomState(8).uniform(1.0, 4.0, 333).astype(np.float32)
    ref = jc._intersect_dense(jc.build_clusters(jnp.asarray(v), jnp.asarray(tr), 128),
                              jnp.asarray(o), jnp.asarray(d), 1e-4, jnp.asarray(tmax))
    got = tc._intersect_dense(tc.build_clusters(t(v), t(tr), 128), t(o), t(d), 1e-4, t(tmax))
    same = n(got.prim) == np.asarray(ref.prim)
    assert same.mean() >= 0.999
    hit = same & (np.asarray(ref.prim) >= 0)
    assert hit.sum() > 50 and (np.asarray(ref.prim) < 0).sum() > 10
    np.testing.assert_allclose(n(got.t)[hit], np.asarray(ref.t)[hit], rtol=1e-5)
    for f in ("u", "v"):
        np.testing.assert_allclose(n(getattr(got, f))[hit], np.asarray(getattr(ref, f))[hit],
                                   rtol=0, atol=5e-5)
    np.testing.assert_allclose(n(got.normal)[hit], np.asarray(ref.normal)[hit], rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("dense", [True, False])
def test_tracer_counters_match_reference(dense):
    """Tracer('tile') telemetry (uncertain) and traced-lane counts per launch
    kind, dense dispatch and tile path at a tight budget."""
    v, tr = bumpy_sphere(24, 48)
    o, d = shell_rays(1024, seed=5)
    tmax = np.where(np.random.RandomState(6).rand(1024) < 0.7, 1e9, 0.0).astype(np.float32)
    kw = dict(dense_threshold=8192 if dense else 1, k_cap=4, k_cap_incoherent=4)
    ref = jtr.Tracer(jc.build_clusters(jnp.asarray(v), jnp.asarray(tr), 128), "tile", **kw)
    got = ttr.Tracer(tc.build_clusters(t(v), t(tr), 128), "tile", **kw)
    h_ref = ref.intersect(jnp.asarray(o), jnp.asarray(d), t_max=jnp.asarray(tmax))
    h_got = got.intersect(t(o), t(d), t_max=t(tmax))
    occ_ref = ref.occluded(jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmax), incoherent=True)
    occ_got = got.occluded(t(o), t(d), t(tmax), incoherent=True)
    np.testing.assert_array_equal(n(occ_got), np.asarray(occ_ref))
    assert (n(h_got.prim) == np.asarray(h_ref.prim)).mean() >= 0.999
    unc_ref, unc_got = float(ref.pop_telemetry()), float(got.pop_telemetry())
    assert unc_got == unc_ref
    assert (unc_got == 0) == dense
    assert float(got.pop_traced()) == float(ref.pop_traced()) == 2 * (tmax > 1e-4).sum()


def test_cuda_request_without_card_raises():
    if torch.cuda.is_available():
        assert resolve_device("cuda").type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    from mirres_restir_nerf_mesh_torch.models.material import MaterialSpec, init_material
    with pytest.raises(RuntimeError):
        init_material(None, MaterialSpec())


def test_port_imports_no_jax():
    """Every module of the port (bench.py among them), and chip_smoke.py,
    imports with `jax`, the JAX package, PIL, cv2, scikit-learn, the root
    scripts main.py, albedo_eval.py and bench.py (which import the JAX
    package), depth_tools/ and scripts/ blocked; no import statement names
    any of them.  (The card
    machine has no PIL, cv2 or scikit-learn; the optional `lpips` package
    stays a guarded import.)"""
    blocked = ("'jax', 'mirres_restir_nerf_mesh_tpu', 'PIL', 'cv2', 'sklearn', 'main', "
               "'albedo_eval', 'bench', 'depth_tools', 'scripts', 'dpt_jax', 'extract_depth'")
    code = (
        "import sys, pkgutil, importlib\n"
        f"for m in ({blocked}):\n"
        "    sys.modules[m] = None\n"
        "import mirres_restir_nerf_mesh_torch as p\n"
        "import mirres_restir_nerf_mesh_torch.bench\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        f"for m in ({blocked}):\n"
        "    assert sys.modules.get(m) is None, m\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    import re

    pat = re.compile(r"^\s*(import|from)\s+(jax|mirres_restir_nerf_mesh_tpu|PIL|cv2|sklearn|main|"
                     r"albedo_eval|bench|depth_tools|scripts|dpt_jax|extract_depth)\b", re.M)
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(REPO, "mirres_restir_nerf_mesh_torch")):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    offenders = [p for p in paths if pat.search(open(p).read())]
    assert not offenders, offenders
