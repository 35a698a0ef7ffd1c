"""dlsg_tpu_torch's discriminator and its layers against dlsg_tpu's flax
modules with the same weights (weights.params_from_jax) on the same numpy
inputs, deterministic (no dropout), fp32.

Tolerances: atol 1e-5 on forward values, 1e-4 on gradients (the input
gradient runs back through D's 9-step LSTM and attention)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlsg_tpu.config import tiny_test_config as jax_tiny
from dlsg_tpu.models import discriminator as jd
from dlsg_tpu.models import layers as jlayers
from dlsg_tpu_torch.config import tiny_test_config
from dlsg_tpu_torch.models import discriminator as td
from dlsg_tpu_torch.models import layers as tlayers
from dlsg_tpu_torch.weights import params_from_jax, params_to_jax

FWD_ATOL = 1e-5
GRAD_ATOL = 1e-4
V = 30
B = 4


def _t(x):
    return torch.tensor(np.asarray(x))


def _load(module, params):
    module.load_state_dict(params_from_jax(params))
    return module


def test_resblock_matches_flax():
    x = np.random.default_rng(0).normal(size=(3, 7, 10)).astype(np.float32)
    jm = jlayers.ResBlock(10)
    p = jm.init(jax.random.PRNGKey(0), x)["params"]
    assert p["conv"]["kernel"].shape == (3, 10, 10)
    tm = _load(tlayers.ResBlock(10), p)
    with torch.no_grad():
        got = tm(_t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(jm.apply({"params": p}, x)), atol=FWD_ATOL)


def test_joint_embed_matches_flax():
    rng = np.random.default_rng(1)
    v, s = rng.normal(size=(2, 3, 6)).astype(np.float32), rng.normal(size=(2, 3, 5)).astype(np.float32)
    jm = jlayers.JointEmbedVideoModel2(8)
    p = jm.init(jax.random.PRNGKey(0), v, s)["params"]
    tm = _load(tlayers.JointEmbedVideoModel2(6, 5, 8), p)
    with torch.no_grad():
        got = tm(_t(v), _t(s))
    np.testing.assert_allclose(got.numpy(), np.asarray(jm.apply({"params": p}, v, s)), atol=FWD_ATOL)


def _psl_inputs(groups, P=6, K=3, H=12, A=10, T=5):
    rng = np.random.default_rng(groups)
    n = B * groups
    psl = rng.normal(size=(n, P, H)).astype(np.float32)
    alpha = rng.uniform(size=(n, T, P)).astype(np.float32)
    att = rng.normal(size=(n, T, A)).astype(np.float32)
    lens = rng.integers(1, T + 1, size=n)
    mask = (np.arange(T)[None, :] < lens[:, None]).astype(np.float32)
    seq_mask = np.repeat(mask[:, :, None], K, axis=2)
    return (P, K, H, A), (psl, alpha, att, seq_mask)


@pytest.mark.parametrize("groups", [1, 2])
def test_psl_score2_matches_flax(groups):
    """Post-softmax masking; with groups=2 one batch mean per sub-batch."""
    (P, K, H, A), args = _psl_inputs(groups)
    jm = jd.PSLScore2(P, K, dim=16, groups=groups)
    p = jm.init(jax.random.PRNGKey(0), *args)["params"]
    tm = _load(td.PSLScore2(P, K, H, A, dim=16), p)
    with torch.no_grad():
        got = tm(*map(_t, args), groups=groups)
    want = np.asarray(jm.apply({"params": p}, *args))
    assert got.shape == want.shape == ((groups,) if groups > 1 else ())
    np.testing.assert_allclose(got.numpy(), want, atol=FWD_ATOL)


def test_psl_score_matches_flax():
    (P, K, H, A), args = _psl_inputs(1)
    jm = jd.PSLScore(P, K, dim=16)
    p = jm.init(jax.random.PRNGKey(0), *args)["params"]
    tm = _load(td.PSLScore(P, K, H, A, dim=16), p)
    with torch.no_grad():
        got = tm(*map(_t, args))
    np.testing.assert_allclose(got.numpy(), np.asarray(jm.apply({"params": p}, *args)), atol=FWD_ATOL)


def test_topk_ties_take_the_lowest_index():
    """Equal attention mass on every proposal: lax.top_k keeps the first K."""
    (P, K, H, A), (psl, alpha, att, seq_mask) = _psl_inputs(1)
    alpha = np.ones_like(alpha)
    jm = jd.PSLScore2(P, K, dim=16)
    p = jm.init(jax.random.PRNGKey(0), psl, alpha, att, seq_mask)["params"]
    tm = _load(td.PSLScore2(P, K, H, A, dim=16), p)
    with torch.no_grad():
        got = tm(*map(_t, (psl, alpha, att, seq_mask)))
    want = jm.apply({"params": p}, psl, alpha, att, seq_mask)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FWD_ATOL)


_DISC = {}


def _disc():
    """(flax DiscV2, params, torch DiscV2, one set of inputs), built once."""
    if not _DISC:
        cfg = jax_tiny()
        T, P, H = cfg.max_words, cfg.num_proposals, cfg.visual_hidden_size
        rng = np.random.default_rng(5)
        lens = rng.integers(2, T + 1, size=B)
        caps = np.where(np.arange(T)[None] < lens[:, None], rng.integers(4, V, size=(B, T)), 0)
        seq = (caps > 0).astype(np.float32)
        args = (
            np.eye(V, dtype=np.float32)[caps],
            rng.normal(size=(B, P, H)).astype(np.float32),
            rng.normal(size=(B, P, H)).astype(np.float32),
            seq[:, :, None] * seq[:, None, :],
            np.asarray(jax.nn.softmax(rng.normal(size=(B, T, 2 * P)), axis=-1), np.float32),
        )
        jm = jd.DiscV2(cfg, V)
        p = jm.init(jax.random.PRNGKey(0), *args)["params"]
        tm = _load(td.DiscV2(tiny_test_config(), V, device="cpu"), p)
        _DISC.update(jm=jm, p=p, tm=tm, args=args)
    return _DISC["jm"], _DISC["p"], _DISC["tm"], _DISC["args"]


def _stack(args, groups, rng):
    """`groups` sub-batches: other caption distributions, the rest repeated."""
    caps = [args[0]] + [
        np.asarray(jax.nn.softmax(rng.normal(size=args[0].shape) * 3, -1), np.float32)
        for _ in range(groups - 1)
    ]
    return (np.concatenate(caps),) + tuple(np.concatenate([a] * groups) for a in args[1:])


@pytest.mark.parametrize("groups", [1, 2, 3])
def test_discv2_matches_flax(groups):
    jm, p, tm, args = _disc()
    args = _stack(args, groups, np.random.default_rng(groups))
    want = np.asarray(jm.apply({"params": p}, *args, groups=groups))
    with torch.no_grad():
        got = tm(*map(_t, args), groups=groups)
    assert got.shape == (B * groups,)
    np.testing.assert_allclose(got.numpy(), want, atol=FWD_ATOL)


def test_discv2_input_gradient_matches_flax():
    """grad_x sum D(x) (what the gradient penalty needs), at a soft caption
    distribution."""
    jm, p, tm, args = _disc()
    x = np.asarray(jax.nn.softmax(np.random.default_rng(7).normal(size=args[0].shape), -1), np.float32)
    want = jax.grad(lambda c: jnp.sum(jm.apply({"params": p}, c, *args[1:])))(x)
    xt = _t(x).requires_grad_(True)
    (got,) = torch.autograd.grad(tm(xt, *map(_t, args[1:])).sum(), xt)
    assert float(got.abs().max()) > 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=GRAD_ATOL)


def test_discv2_weight_round_trip():
    """DiscV2's flax tree (with the [3, in, out] Conv kernel) loads strictly
    into the port and comes back equal, path for path."""
    _, p, tm, _ = _disc()
    sd = params_from_jax(p)
    np.testing.assert_array_equal(
        sd["block.conv.weight"].numpy(), np.asarray(p["block"]["conv"]["kernel"]).transpose(2, 1, 0)
    )

    def flat(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}{k}/") if hasattr(v, "items") else {f"{prefix}{k}": np.asarray(v)})
        return out

    back, want = flat(params_to_jax(tm.state_dict())), flat(p)
    assert back.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)
