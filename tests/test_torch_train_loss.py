"""Port vs reference: ``stage1_loss`` (render, SSAA downsample, every loss
term, per-face error sums) and its gradient with respect to every leaf of
the params, against jax.grad of the JAX package's ``stage1_loss``, on the
32x32, spp-2 four-ball fixture (randoms drawn from the key as the reference
draws them, compact_chunks=1; normal, edge and chroma terms switched on).

Tolerances: loss, psnr within 1e-5 relative; face_cnt equal, face_err
within 1e-5 of its largest entry; per optimizer group and leaf, gradient
relative L2 <= 1e-3 and cosine >= 0.99999 (the same terms summed in
another order; the largest measured relative L2 is 1.1e-4, on the material
encoder, whose entries are sums of many cancelling contributions).  The
ssaa=2 case (32x32 render, 16x16 ground truth) compares the loss and the
aux values with the same tolerances, also with the LPIPS term on
(``test_lpips_raises``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mirres_restir_nerf_mesh_tpu.train import stage1 as jtr
from mirres_restir_nerf_mesh_torch.convert import params_from_jax
from mirres_restir_nerf_mesh_torch.train import stage1 as ttr

from test_torch_helpers import TORCH_THREADS, lpips_weights_npz, n, t, tree_np
from test_torch_train import cosine, jax_groups, rel_l2, train_case

torch.set_num_threads(TORCH_THREADS)


def port_params(p):
    return params_from_jax(tree_np(p.nerf), tree_np(p.mat), np.asarray(p.env),
                           np.asarray(p.offsets), device="cpu")


def check_aux(aux_t, aux_j):
    for k in ("loss", "psnr", "psnr_brdf"):
        np.testing.assert_allclose(float(aux_t[k]), float(aux_j[k]), rtol=1e-5, err_msg=k)
    assert float(aux_t["uncertain_count"]) == float(aux_j["uncertain_count"]) == 0
    np.testing.assert_array_equal(n(aux_t["face_cnt"]), np.asarray(aux_j["face_cnt"]))
    fe = np.asarray(aux_j["face_err"])
    assert fe.max() > 0
    np.testing.assert_allclose(n(aux_t["face_err"]), fe, rtol=0, atol=1e-5 * fe.max())


def test_stage1_loss_and_grads_match_reference():
    c = train_case()
    key = jax.random.PRNGKey(5)

    def f(p):
        return jtr.stage1_loss(p, c["jstatic"], jnp.asarray(c["v"]), c["jtopo"], c["batch"], key,
                               c["jcfg"])

    (loss_j, aux_j), g_j = jax.jit(jax.value_and_grad(f, has_aux=True))(c["params"])
    loss_t, aux_t, g_t = ttr.loss_and_grads(port_params(c["params"]), c["tstatic"], t(c["v"]),
                                            c["ttopo"], c["tbatch"], c["tcfg"], rand=c["rand"](key))
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5)
    check_aux(aux_t, aux_j)
    for grp, leaves in jax_groups(g_j).items():
        assert len(leaves) == len(g_t[grp])
        for j, (a, b) in enumerate(zip(leaves, g_t[grp])):
            a = np.asarray(a)
            assert np.abs(a).max() > 0, (grp, j)
            assert b is not None, (grp, j)
            assert rel_l2(n(b), a) <= 1e-3 and cosine(n(b), a) >= 0.99999, (
                grp, j, rel_l2(n(b), a), cosine(n(b), a))


@pytest.mark.parametrize("ssaa", [2])
def test_stage1_loss_ssaa_matches_reference(ssaa):
    c = train_case(H=32, ssaa=ssaa)
    assert c["tbatch"]["pixels"].shape[0] == (32 // ssaa) ** 2
    key = jax.random.PRNGKey(6)
    loss_j, aux_j = jax.jit(lambda p: jtr.stage1_loss(p, c["jstatic"], jnp.asarray(c["v"]),
                                                      c["jtopo"], c["batch"], key, c["jcfg"]))(
        c["params"])
    loss_t, aux_t = ttr.stage1_loss(port_params(c["params"]), c["tstatic"], t(c["v"]), c["ttopo"],
                                    c["tbatch"], c["tcfg"], rand=c["rand"](key))
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5)
    check_aux(aux_t, aux_j)


def test_lpips_raises(tmp_path):
    """The LPIPS term, which raised before it was ported, now runs and matches
    the reference: the ssaa=2 case with lambda_lpips 0.1 on the reference's
    random-VGG weights carried over through an .npz (both images, at the GT
    size after the downsample): loss and aux at the tolerances above, and
    the term adds to the loss."""
    weights = lpips_weights_npz(tmp_path / "vgg_random.npz")
    c = train_case(H=32, ssaa=2)
    jcfg = jtr.Config(**{**c["jcfg"].__dict__, "lambda_lpips": 0.1, "lpips_weights": weights})
    tcfg = ttr.Config(**{**c["tcfg"].__dict__, "lambda_lpips": 0.1, "lpips_weights": weights})
    key = jax.random.PRNGKey(8)
    loss_j, aux_j = jax.jit(lambda p: jtr.stage1_loss(p, c["jstatic"], jnp.asarray(c["v"]),
                                                      c["jtopo"], c["batch"], key, jcfg))(
        c["params"])
    loss_t, aux_t = ttr.stage1_loss(port_params(c["params"]), c["tstatic"], t(c["v"]), c["ttopo"],
                                    c["tbatch"], tcfg, rand=c["rand"](key))
    loss_0, _ = ttr.stage1_loss(port_params(c["params"]), c["tstatic"], t(c["v"]), c["ttopo"],
                                c["tbatch"], c["tcfg"], rand=c["rand"](key))
    assert float(loss_t) > float(loss_0) + 1e-4
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5)
    check_aux(aux_t, aux_j)
