"""On the card only: the CUDA kernels K1 (csrc/tile_trace.cu) and K3
(csrc/dense_hit.cu) against their plain PyTorch versions on the same
inputs, and the launch counters.  Skipped without a CUDA device.  On a
machine with the card and without JAX, run them without the suite's
conftest (which imports JAX):
`python -m pytest tests/test_torch_cuda.py --noconftest -p no:cacheprovider`.

Tolerances: hit prims agree on >= 99.99% of rays; t, u, v within 1e-5
relative (kernel and plain version round the same fp32 operations in the
same order, the kernel built with --fmad=false).
"""

import numpy as np
import pytest
import torch

from mirres_restir_nerf_mesh_torch.ops import cluster_bvh, dense_tracer, tile_tracer

from test_torch_helpers import bumpy_sphere, shell_rays

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def test_dense_hit_kernel_matches_plain(dev):
    v, tr = bumpy_sphere(24, 48)
    o, _ = shell_rays(5000, seed=1, radius=1.5)
    d = np.random.RandomState(2).normal(size=o.shape).astype(np.float32) * 0.4 - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    cm = dense_tracer.pack_tris_cm(torch.from_numpy(v).to(dev), torch.from_numpy(tr).to(dev))
    ro, rd = torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev)
    before = dense_tracer.dense_hit.launches
    k = dense_tracer.dense_hit(cm, ro, rd)
    torch.cuda.synchronize()
    assert dense_tracer.dense_hit.launches == before + 1
    p = dense_tracer.dense_hit_plain(cm, ro, rd)
    same = (k[1] == p[1]).float().mean().item()
    assert same >= 0.9999
    m = (k[1] == p[1]) & (p[1] >= 0)
    for a, b in zip(k[0:1] + k[2:], p[0:1] + p[2:]):
        torch.testing.assert_close(a[m], b[m], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("any_hit", [False, True])
def test_tile_trace_kernel_matches_plain(dev, any_hit):
    v, tr = bumpy_sphere(48, 96)
    cm = cluster_bvh.build_clusters(torch.from_numpy(v).to(dev), torch.from_numpy(tr).to(dev))
    o, d = shell_rays(20000, seed=3)
    work = tile_tracer.prepare_trace(cm, torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev),
                                     k_cap=32, sort_octants="morton")
    before = tile_tracer.queue_trace.launches
    out_k = tile_tracer.queue_trace(cm.geom_cm, work.rays_cm, work.cand, work.octs, work.n_active,
                                    1e-4, any_hit)
    torch.cuda.synchronize()
    assert tile_tracer.queue_trace.launches == before + 1
    out_p = tile_tracer.queue_trace_plain(cm.geom_cm, work.rays_cm, work.cand, work.octs,
                                          work.n_active, 1e-4, any_hit)
    hk = tile_tracer.finish_trace(cm, work, out_k, any_hit)
    hp = tile_tracer.finish_trace(cm, work, out_p, any_hit)
    assert torch.equal(hk.uncertain, hp.uncertain)
    assert (hk.hit.prim == hp.hit.prim).float().mean().item() >= 0.9999
    m = (hk.hit.prim == hp.hit.prim) & (hp.hit.prim >= 0)
    for f in ("t", "u", "v"):
        torch.testing.assert_close(getattr(hk.hit, f)[m], getattr(hp.hit, f)[m], rtol=1e-5, atol=1e-6)
