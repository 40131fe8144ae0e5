"""The contract's last line: its keys, the checks last, the forbidden
module test by whole top-level names."""

import json

from benchmark.harness import result


def test_line_is_well_formed():
    checks = result.checks_block({"loss": 1e-5, "grad": None}, {"loss": 1e-3, "grad": 1e-2})
    line = result.line(True, 12, 0, {"setup_s": {"value": 41.5, "unit": "s"}},
                       {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
                        "memory_peak_bytes": 123}, {"device_ops": [["k", 1.0]], "idle_gaps": []},
                       checks)
    assert "\n" not in line
    obj = json.loads(line)
    assert list(obj)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(obj)[-1] == "checks"
    assert obj["checks"]["loss"] == {"value": 1e-5, "limit": 1e-3}
    assert not result.passed(checks)          # a missing reading fails


def test_passed_is_at_or_under_each_limit():
    assert result.passed(result.checks_block({"a": 0.0, "b": 2.0}, {"a": 0.0, "b": 2.0}))
    assert not result.passed(result.checks_block({"a": 0.0, "b": 2.01}, {"a": 0.0, "b": 2.0}))


def test_forbidden_modules_by_whole_top_level_name():
    mods = {"jaxtyping": 1, "mirres_restir_nerf_mesh_torch.ops": 1, "numpy": 1}
    assert result.forbidden_modules(mods) == []
    mods.update({"jax.numpy": 1, "mirres_restir_nerf_mesh_tpu": 1, "flax.linen": 1})
    assert result.forbidden_modules(mods) == ["flax", "jax", "mirres_restir_nerf_mesh_tpu"]
