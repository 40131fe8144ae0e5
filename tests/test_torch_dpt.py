"""Port vs reference: the DPT-Hybrid depth net (``depth/dpt.py`` against
depth_tools/dpt_jax.py).

- ``random_params`` draws the reference's parameters bit for bit: the same
  names in the same order, equal raw arrays, and the converted tensors
  equal to the reference's converted arrays (its HWIO convolutions
  transposed back).
- ``dpt_depth`` at 384^2 on one seeded input against ``dpt_jax.dpt_depth``
  (jitted) within 2e-4 of the map's largest magnitude, the tolerance of
  tests/test_depth_net.py.
- The checkpoint manifest (tests/fixtures/dpt_hybrid_manifest.json): a
  Lightning-wrapped checkpoint with the real file's keys and shapes, extra
  keys included, loads into ``DPTDepth`` and runs (shapes, on the meta
  device); ``param_spec`` is the manifest's required set.
- A saved checkpoint loads through ``load_dpt`` with the reference's
  prefix rule; the entry points default to the card and raise without one.
"""

import json
import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mirres_restir_nerf_mesh_torch.depth import dpt

from test_torch_helpers import TORCH_THREADS

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "depth_tools"))
import dpt_jax  # noqa: E402

torch.set_num_threads(TORCH_THREADS)

MANIFEST = os.path.join(os.path.dirname(__file__), "fixtures", "dpt_hybrid_manifest.json")


@pytest.fixture(scope="module")
def params():
    """(port state dict, reference converted params); the raw arrays are
    held equal on the way."""
    t_sd, t_raw = dpt.random_params()
    j_params, j_raw = dpt_jax.random_params()
    assert list(t_raw) == list(j_raw)
    for k in j_raw:
        assert t_raw[k].dtype == j_raw[k].dtype and np.array_equal(t_raw[k], j_raw[k]), k
    del t_raw, j_raw
    return t_sd, j_params


def test_random_params_equal_reference_bit_for_bit(params):
    t_sd, j_params = params
    assert set(t_sd) == set(j_params)
    for k, v in t_sd.items():
        ref = np.asarray(j_params[k])
        if ref.ndim == 4 and k.endswith("weight"):
            ref = ref.transpose(3, 2, 0, 1)          # HWIO -> OIHW
        assert v.dtype == torch.float32 and np.array_equal(v.numpy(), ref), k


def test_dpt_depth_matches_dpt_jax(params):
    t_sd, j_params = params
    x = np.random.RandomState(7).rand(1, 384, 384, 3).astype(np.float32)
    x = (x - 0.5) / 0.5
    ref = np.asarray(jax.jit(dpt_jax.dpt_depth)(j_params, jnp.asarray(x)))
    got = dpt.dpt_depth(dpt.build_dpt(t_sd, "cpu"), torch.from_numpy(x).permute(0, 3, 1, 2))
    assert got.shape == (1, 384, 384) and torch.isfinite(got).all()
    scale = max(float(np.abs(ref).max()), 1e-3)
    np.testing.assert_allclose(got.numpy() / scale, ref / scale, rtol=0, atol=2e-4)


def test_checkpoint_manifest_loads():
    with open(MANIFEST) as f:
        man = json.load(f)
    assert {k: list(s) for k, s in dpt.param_spec()} == man["required"]
    fake = {f"model.{k}": torch.zeros(s) for k, s in {**man["required"],
                                                      **man["optional_extras"]}.items()}
    sd = dpt.convert_state_dict({"state_dict": fake, "epoch": 0, "global_step": 0})
    assert set(sd) == set(man["required"]) | set(man["optional_extras"])
    model = dpt.build_dpt(sd, "meta")
    assert {k: list(v.shape) for k, v in model.state_dict().items()} == man["required"]
    out = model(torch.zeros((1, 3, 384, 384), device="meta"))
    assert out.shape == (1, 384, 384)
    del sd[next(iter(man["required"]))]
    with pytest.raises(KeyError):
        dpt.build_dpt(sd, "meta")


def test_load_dpt_strips_the_lightning_prefix(tmp_path, params):
    t_sd, _ = params
    path = tmp_path / "dpt.ckpt"
    torch.save({"state_dict": {f"model.{k}": v for k, v in t_sd.items()}, "epoch": 3}, path)
    model = dpt.load_dpt(str(path), device="cpu")
    for k, v in model.state_dict().items():
        assert torch.equal(v, t_sd[k]), k
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            dpt.load_dpt(str(path))
