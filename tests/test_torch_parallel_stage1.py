"""Data parallelism in stage 1: the ReSTIR train step on 2 gloo ranks, each
rendering a band of whole image rows, against the port's single-rank step
(which tests/test_torch_stage1_restir.py holds to the JAX package).

The tiny step of tests/torch_parallel_ranks.py: a 24x24 GT frame rendered
at ssaa 2 (48x48), the four-ball mesh, spp 1, ReSTIR with 5 neighbours in
a 6 px radius (reaching across the band edge), the EAW denoiser
(denoise_iters 2), normal-AO with lambda_extra_kd, silhouette antialiasing,
LPIPS on the full frame (random VGG weights) and the mesh regularizers;
once on the whole frame and once on a stage1_rows band of 16 GT rows that
the ranks split.  Gates: the loss within 1e-5 relative, every gradient
leaf (summed over the ranks) within 1e-5 relative L2, face_cnt equal,
uncertain_count 0 on every rank.  A planted fault (gather_rows replaced by
the rank's own rows, zeros elsewhere) must fail that comparison: the test
sees what crosses the band edge.
"""

import numpy as np
import pytest
import torch

from mirres_restir_nerf_mesh_torch.parallel import mesh as pmesh

import torch_parallel_ranks as ranks
from test_torch_helpers import TORCH_THREADS

torch.set_num_threads(TORCH_THREADS)


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def worst(got, ref):
    """(relative loss error, worst relative L2 over the gradient leaves)."""
    errs = [rel_l2(a, b) for g in ref["grads"] for a, b in zip(got["grads"][g], ref["grads"][g])]
    return abs(got["loss"] - ref["loss"]) / abs(ref["loss"]), max(errs)


def run_ranks(tmp_path, *args):
    return pmesh.launch(ranks.stage1_grads, 2, backend="gloo", device_of_rank=lambda r: "cpu",
                        init_method=f"file://{tmp_path}/store", args=args, timeout=600)


@pytest.mark.parametrize("rows", [None, (4, 20)], ids=["frame", "stage1_rows"])
def test_stage1_dp_step_matches_single_rank(tmp_path, rows):
    ref = ranks.stage1_grads(None, rows)
    res = run_ranks(tmp_path, rows, False)
    P = (ranks.S1_H if rows is None else rows[1] - rows[0]) * ranks.S1_SSAA * ranks.S1_H * 2
    assert [r["band"] for r in res] == [(0, P // 2), (P // 2, P)]
    err_loss, err_grad = worst(res[0], ref)
    assert err_loss < 1e-5 and err_grad < 1e-5, (err_loss, err_grad)
    for r in res:
        assert r["uncertain"] == 0.0
        np.testing.assert_array_equal(r["face_cnt"], ref["face_cnt"])
        assert r["loss"] == res[0]["loss"]
    assert ref["face_cnt"].sum() > 0


def test_planted_halo_fault_is_seen(tmp_path):
    """With each rank's own rows in place of the gathered frame, the step no
    longer equals the single-rank step."""
    ref = ranks.stage1_grads(None)
    err_loss, err_grad = worst(run_ranks(tmp_path, None, True)[0], ref)
    assert err_loss > 1e-3 and err_grad > 1e-2, (err_loss, err_grad)
