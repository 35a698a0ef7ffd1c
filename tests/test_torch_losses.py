"""dlsg_tpu_torch.ops.losses against dlsg_tpu.ops.losses on the same numpy
inputs. fp32 on both sides: atol 1e-5 on every loss value and on the
gradient penalty's parameter gradient."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlsg_tpu.ops import losses as jl
from dlsg_tpu_torch.ops import losses as tl

ATOL = 1e-5


def _t(x):
    return torch.tensor(np.asarray(x))


def test_length_mask_and_onehot():
    lengths = np.array([0, 3, 5], np.int32)
    np.testing.assert_array_equal(
        tl.length_mask(_t(lengths), 5).numpy(), np.asarray(jl.length_mask(lengths, 5))
    )
    seq = np.array([[0, 4, 2], [1, 0, 3]], np.int32)
    np.testing.assert_array_equal(tl.to_onehot(_t(seq), 6).numpy(), np.asarray(jl.to_onehot(seq, 6)))


def test_masked_cross_entropy_and_its_gradient():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(3, 5, 11)).astype(np.float32) * 3
    targets = rng.integers(0, 11, size=(3, 5)).astype(np.int32)
    lengths = np.array([5, 2, 4], np.int32)
    want, jg = jax.value_and_grad(jl.masked_cross_entropy)(logits, targets, lengths)
    x = _t(logits).requires_grad_(True)
    got = tl.masked_cross_entropy(x, _t(targets), _t(lengths))
    (tg,) = torch.autograd.grad(got, x)
    np.testing.assert_allclose(got.item(), float(want), atol=ATOL)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=ATOL)


def test_wgan_g_loss_and_psl_diversity():
    rng = np.random.default_rng(1)
    f = rng.normal(size=(6,)).astype(np.float32)
    np.testing.assert_allclose(float(tl.wgan_g_loss(_t(f))), float(jl.wgan_g_loss(f)), atol=ATOL)
    psl = rng.normal(size=(3, 5, 7)).astype(np.float32)
    for margin in (0.0, 0.2):
        np.testing.assert_allclose(
            float(tl.psl_diversity_loss(_t(psl), margin)),
            float(jl.psl_diversity_loss(psl, margin)), atol=ATOL,
        )
    assert tl.GP_WEIGHT == jl.GP_WEIGHT


# A small nonlinear D (nonzero Hessian), the same function in both packages.
B, T, V, H = 4, 3, 5, 7


def _inputs():
    rng = np.random.default_rng(2)
    params = {
        "w1": (rng.normal(size=(T * V, H)) * 0.3).astype(np.float32),
        "w2": (rng.normal(size=(H,)) * 0.3).astype(np.float32),
    }
    real = rng.normal(size=(B, T, V)).astype(np.float32)
    fake = rng.normal(size=(B, T, V)).astype(np.float32)
    eps = rng.uniform(size=(B, 1, 1)).astype(np.float32)
    return params, real, fake, eps


def _jax_d(p, x):
    return jnp.tanh(x.reshape(x.shape[0], -1) @ p["w1"]) @ p["w2"]


def _torch_d(p, x):
    return torch.tanh(x.reshape(x.shape[0], -1) @ p["w1"]) @ p["w2"]


def _torch_params(params):
    return {k: _t(v).requires_grad_(True) for k, v in params.items()}


@pytest.mark.parametrize("jax_variant", ["autodiff", "reverse_over_forward"])
def test_gradient_penalty_and_its_parameter_gradient(jax_variant):
    """The port's double-backward penalty against both JAX forms: value and
    the gradient with respect to D's parameters."""
    params, real, fake, eps = _inputs()
    if jax_variant == "autodiff":
        def jgp(p):
            return jl.gradient_penalty(lambda x: _jax_d(p, x), real, fake, eps)
    else:
        rof = jl.make_gradient_penalty_rof(_jax_d)

        def jgp(p):
            return rof(p, real * eps + fake * (1.0 - eps))
    want, jg = jax.value_and_grad(jgp)(params)

    tp = _torch_params(params)
    got = tl.gradient_penalty(lambda x: _torch_d(tp, x), _t(real), _t(fake), _t(eps))
    tg = torch.autograd.grad(got, [tp["w1"], tp["w2"]])
    np.testing.assert_allclose(got.item(), float(want), atol=ATOL)
    for k, g in zip(("w1", "w2"), tg):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg[k]), atol=ATOL, err_msg=k)


def test_gradient_penalty_input_gradient():
    """With fake requiring grad, the penalty's gradient reaches it, as
    jax.grad of gradient_penalty with respect to fake."""
    params, real, fake, eps = _inputs()
    jg = jax.grad(lambda f: jl.gradient_penalty(lambda x: _jax_d(params, x), real, f, eps))(fake)
    tp = {k: _t(v) for k, v in params.items()}
    f = _t(fake).requires_grad_(True)
    (tg,) = torch.autograd.grad(
        tl.gradient_penalty(lambda x: _torch_d(tp, x), _t(real), f, _t(eps)), f
    )
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=ATOL)


@pytest.mark.parametrize("fused", [False, True])
def test_wgan_d_loss(fused):
    """wgan_d_loss and wgan_d_loss_fused: loss, wasserstein, gp and the
    loss's parameter gradient. The toy D is row-independent, so the fused
    form's d_fn3 is D itself."""
    params, real, fake, eps = _inputs()
    jfn = jl.wgan_d_loss_fused if fused else jl.wgan_d_loss
    tfn = tl.wgan_d_loss_fused if fused else tl.wgan_d_loss

    (jloss, jaux), jg = jax.value_and_grad(
        lambda p: jfn(lambda x: _jax_d(p, x), real, fake, eps), has_aux=True
    )(params)
    tp = _torch_params(params)
    tloss, taux = tfn(lambda x: _torch_d(tp, x), _t(real), _t(fake), _t(eps))
    tg = torch.autograd.grad(tloss, [tp["w1"], tp["w2"]])
    np.testing.assert_allclose(tloss.item(), float(jloss), atol=ATOL)
    for k in ("wasserstein", "gp"):
        np.testing.assert_allclose(taux[k].item(), float(jaux[k]), atol=ATOL, err_msg=k)
    for k, g in zip(("w1", "w2"), tg):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg[k]), atol=ATOL, err_msg=k)
