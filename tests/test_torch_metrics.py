"""Port vs reference: train/metrics.py and train/lpips.py, and the LPIPS term
of the stage-1 loss.

- ``psnr`` / ``ssim`` on numpy-seeded images: within 1e-5.
- ``lpips_distance`` on the JAX package's ``random_params(PRNGKey(0))``
  carried over through an ``.npz`` (``load_weights``): within 1e-4
  relative, single and batched; its gradient with respect to the
  prediction within 1e-4 relative L2.  ``make_lpips`` / ``lpips_fn`` on
  that file: kind "vgg", the same value; without weights both packages
  say "random-vgg"; without a card the default device raises.  ``convert_state_dicts`` equal.
- ``stage1_loss`` with ``lambda_lpips`` 0.1 and that ``.npz`` as
  ``lpips_weights`` on the four-ball fixture of test_torch_train.py: loss
  and aux, and every gradient leaf, at test_torch_train_loss.py's
  tolerances (loss 1e-5 relative; per leaf relative L2 <= 1e-3, cosine >=
  0.99999).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mirres_restir_nerf_mesh_tpu.train import lpips as jl
from mirres_restir_nerf_mesh_tpu.train import metrics as jm
from mirres_restir_nerf_mesh_tpu.train import stage1 as jtr
from mirres_restir_nerf_mesh_torch.train import lpips as tl
from mirres_restir_nerf_mesh_torch.train import metrics as tm
from mirres_restir_nerf_mesh_torch.train import stage1 as ttr

from test_torch_helpers import TORCH_THREADS, lpips_weights_npz, n, t
from test_torch_train import cosine, jax_groups, rel_l2, train_case
from test_torch_train_loss import check_aux, port_params

torch.set_num_threads(TORCH_THREADS)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """The JAX package's random-VGG params as a vendored-weights .npz."""
    return lpips_weights_npz(tmp_path_factory.mktemp("lpips") / "vgg_random.npz")


def images(seed, shape=(16, 16, 3)):
    rng = np.random.RandomState(seed)
    a = rng.uniform(0, 1, shape).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, shape), 0, 1).astype(np.float32)
    return a, b


def test_psnr_ssim_match_reference():
    for seed, shape in ((0, (24, 30, 3)), (1, (40, 17, 3))):
        a, b = images(seed, shape)
        np.testing.assert_allclose(float(tm.psnr(t(a), t(b))), float(jm.psnr(a, b)), rtol=1e-5)
        np.testing.assert_allclose(float(tm.ssim(t(a), t(b))), float(jm.ssim(a, b)), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(float(tm.ssim(t(a), t(a))), 1.0, atol=1e-5)


def test_lpips_distance_matches_reference(weights):
    jp, tp = jl.load_weights(weights), tl.load_weights(weights, device="cpu")
    a, b = images(2)
    dist = jax.jit(jl.lpips_distance)
    ref = float(dist(jp, jnp.asarray(a), jnp.asarray(b)))
    assert ref > 0
    np.testing.assert_allclose(float(tl.lpips_distance(tp, t(a), t(b))), ref, rtol=1e-4)
    a2, b2 = images(3, (2, 16, 16, 3))
    np.testing.assert_allclose(n(tl.lpips_distance(tp, t(a2), t(b2))),
                               np.asarray(dist(jp, jnp.asarray(a2), jnp.asarray(b2))), rtol=1e-4)
    # the gradient with respect to the prediction (the loss term's)
    g_ref = np.asarray(jax.jit(jax.grad(lambda x: jl.lpips_distance(jp, x, jnp.asarray(b))))(
        jnp.asarray(a)))
    x = t(a).requires_grad_(True)
    (g,) = torch.autograd.grad(tl.lpips_distance(tp, x, t(b)), [x])
    assert rel_l2(n(g), g_ref) <= 1e-4


def test_lpips_fn_kinds(weights):
    a, b = images(4)
    fj, ft = jm.lpips_fn(weights), tm.lpips_fn(weights, device="cpu")
    assert fj.kind == ft.kind == "vgg"
    np.testing.assert_allclose(ft(a, b), fj(a, b), rtol=1e-4)
    assert tl.lpips_kind("") == jl.lpips_kind("") == "random-vgg"
    assert tm.lpips_fn("", device="cpu").kind == "random-vgg"
    # random-VGG from a torch.Generator: the same layout as the reference's
    rp, jp = tl.random_params(torch.Generator().manual_seed(0), "cpu"), jl.random_params()
    assert {k: tuple(v.shape) for k, v in rp.items()} == {k: v.shape for k, v in jp.items()}
    # the entry points default to the card and raise without one
    if not torch.cuda.is_available():
        for fn in (tm.lpips_fn, tl.make_lpips, tl.default_params, tl.load_weights):
            with pytest.raises(RuntimeError, match="CUDA"):
                fn(weights)


def test_convert_state_dicts_matches_reference():
    rng = np.random.RandomState(5)
    vgg, lin, cin = {}, {}, 3
    for i, idx in enumerate(tl._VGG16_CONV_IDX):
        cout = tl._PLAN[i][0]
        vgg[f"features.{idx}.weight"] = rng.normal(size=(cout, cin, 3, 3)).astype(np.float32)
        vgg[f"features.{idx}.bias"] = rng.normal(size=(cout,)).astype(np.float32)
        cin = cout
    for j, c in enumerate((64, 128, 256, 512, 512)):
        lin[f"lin{j}.model.1.weight"] = rng.uniform(size=(1, c, 1, 1)).astype(np.float32)
    got, ref = tl.convert_state_dicts(vgg, lin), jl.convert_state_dicts(vgg, lin)
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k])


def test_stage1_loss_with_lpips_matches_reference(weights):
    c = train_case()
    jcfg = jtr.Config(**{**c["jcfg"].__dict__, "lambda_lpips": 0.1, "lpips_weights": weights})
    tcfg = ttr.Config(**{**c["tcfg"].__dict__, "lambda_lpips": 0.1, "lpips_weights": weights})
    key = jax.random.PRNGKey(7)

    def f(p):
        return jtr.stage1_loss(p, c["jstatic"], jnp.asarray(c["v"]), c["jtopo"], c["batch"], key,
                               jcfg)

    (loss_j, aux_j), g_j = jax.jit(jax.value_and_grad(f, has_aux=True))(c["params"])
    loss_t, aux_t, g_t = ttr.loss_and_grads(port_params(c["params"]), c["tstatic"], t(c["v"]),
                                            c["ttopo"], c["tbatch"], tcfg, rand=c["rand"](key))
    # the term is really on: without it the loss is smaller
    loss_0, _ = ttr.stage1_loss(port_params(c["params"]), c["tstatic"], t(c["v"]), c["ttopo"],
                                c["tbatch"], c["tcfg"], rand=c["rand"](key))
    assert float(loss_t) > float(loss_0) + 1e-4
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5)
    check_aux(aux_t, aux_j)
    for grp, leaves in jax_groups(g_j).items():
        for j, (a, b) in enumerate(zip(leaves, g_t[grp])):
            a = np.asarray(a)
            assert b is not None, (grp, j)
            assert rel_l2(n(b), a) <= 1e-3 and cosine(n(b), a) >= 0.99999, (
                grp, j, rel_l2(n(b), a), cosine(n(b), a))
