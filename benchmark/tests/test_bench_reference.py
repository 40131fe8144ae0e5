"""The reference agrees with itself across block sizes, and its
comparison reads what it should."""

import torch

from benchmark.harness.scene import blob_mesh, icosphere
from benchmark.reference import brute, compare


def _rays(n, seed):
    g = torch.Generator().manual_seed(seed)
    o = torch.randn((n, 3), generator=g) * 0.1 + torch.tensor([0.0, 0.0, 3.0])
    d = torch.nn.functional.normalize(-o + torch.randn((n, 3), generator=g) * 0.4, dim=-1)
    return o, d


def test_brute_force_equal_across_triangle_blocks(monkeypatch):
    v, f = blob_mesh(3, 0.8)
    verts, tris = torch.as_tensor(v), torch.as_tensor(f)
    o, d = _rays(64, 0)
    tmax = torch.full((64,), 1e10)
    base = brute.closest_t(verts, tris, o, d, 1e-4, tmax)
    for chunk in (7, 100, 1 << 20):
        monkeypatch.setattr(brute, "TRI_CHUNK", chunk)
        assert torch.equal(brute.closest_t(verts, tris, o, d, 1e-4, tmax), base)
    assert torch.isfinite(base).float().mean() > 0.5


def test_brute_force_on_the_unit_sphere():
    v, f = icosphere(4)
    verts, tris = torch.as_tensor(v), torch.as_tensor(f)
    o = torch.tensor([[0.0, 0.0, 3.0], [0.0, 0.0, 3.0], [0.0, 0.0, 0.0]])
    d = torch.tensor([[0.0, 0.0, -1.0], [0.0, 1.0, 0.0], [1.0, 0.0, 0.0]])
    t = brute.closest_t(verts, tris, o, d, 1e-4, torch.full((3,), 1e10))
    assert abs(float(t[0]) - 2.0) < 2e-2 and not torch.isfinite(t[1])
    assert abs(float(t[2]) - 1.0) < 2e-2
    # an occlusion only counts before t_max
    t2 = brute.closest_t(verts, tris, o[:1], d[:1], 1e-4, torch.tensor([1.5]))
    assert not torch.isfinite(t2[0])


def test_judges():
    t_ref = torch.tensor([2.0, float("inf"), 3.0], dtype=torch.float64)
    bad = brute.judge_hits(torch.tensor([2.00001, float("inf"), 3.1]),
                           torch.tensor([5, -1, 7]), t_ref)
    assert bad.tolist() == [False, False, True]
    assert brute.judge_occlusion(torch.tensor([True, True, False]), t_ref).tolist() == \
        [False, True, True]


def test_comparison_readings():
    ref = {"losses": [1.0, 2.0], "grad_norms": {"net": [1.0, 2.0, 1e-6]},
           "change_norms": {"net": [0.1, 0.2, 0.5]}, "hits_wrong_share": 0.25,
           "occlusions_wrong_share": 0.0}
    prog = {"losses": [1.0, 2.02], "grad_norms": {"net": [1.0, 2.2, 0.0]},
            "change_norms": {"net": [0.1, 0.1, 9.0]}, "uncertain": 0.0}
    r = compare.readings(prog, ref)
    assert abs(r["loss"] - 0.01) < 1e-12
    assert r["hits"] == 0.25 and r["occlusions"] == 0.0
    assert abs(r["grad"] - 0.1) < 1e-12            # (2.2 - 2) / max(2, median 1)
    # the third leaf's gradient is under 1e-3 of the median: its change is not compared
    assert abs(r["change"] - 0.5) < 1e-12          # (0.2 - 0.1) / max(0.2, median 0.15)
    unchanged = dict(prog, change_norms={"net": [0.0, 0.0, 0.0]})
    assert compare.readings(unchanged, ref)["change"] == 1.0
