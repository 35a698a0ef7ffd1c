"""dlsg_tpu_torch's teacher-forced CapGnnModel forward (the training path)
against dlsg_tpu's, with the same weights on the same numpy inputs, fp32.

Dropout is switched off on both sides: the generator's configured rate by
`tiny_test_config(dropout=0.0)`, the hard-coded rates by patching flax's
`Dropout.__call__` and the port's one `dropout` function to identity. The
scheduled-sampling coins are deterministic at epsilon 1 (all gold) and 0
(all argmax) in both packages.

Tolerances: logits, alpha and proposals atol 1e-4 (26-step recurrences at
fp32, summation order only); the CE gradient of every generator parameter
within 1e-4 of that tensor's max-abs."""

import flax.linen
import jax
import numpy as np
import pytest
import torch

from dlsg_tpu.config import tiny_test_config as jax_tiny
from dlsg_tpu.models.generator import CapGnnModel as JaxCapGnnModel
from dlsg_tpu.ops.losses import masked_cross_entropy as jax_ce
from dlsg_tpu_torch.config import tiny_test_config
from dlsg_tpu_torch.models.generator import CapGnnModel
from dlsg_tpu_torch.ops import linear
from dlsg_tpu_torch.ops.losses import masked_cross_entropy
from dlsg_tpu_torch.weights import params_from_jax
from test_torch_train_steps import one_torch_thread  # noqa: F401  (autouse)

V = 40
B = 4
ATOL = 1e-4
_CACHE = {}


def _identity(self, inputs, deterministic=None, rng=None):
    return inputs


@pytest.fixture
def no_dropout(monkeypatch):
    monkeypatch.setattr(flax.linen.Dropout, "__call__", _identity)
    monkeypatch.setattr(linear, "dropout", lambda x, rate, rng: x)


def _setup():
    if not _CACHE:
        jcfg = jax_tiny(dropout=0.0)
        rng = np.random.default_rng(3)
        frames = rng.normal(size=(B, jcfg.max_frames, jcfg.feature_size)).astype(np.float32)
        regions = rng.normal(
            size=(B, jcfg.max_frames, jcfg.num_obj, jcfg.region_feature_size)
        ).astype(np.float32)
        lengths = rng.integers(2, jcfg.max_words + 1, size=B).astype(np.int32)
        caps = np.where(
            np.arange(jcfg.max_words)[None] < lengths[:, None],
            rng.integers(4, V, size=(B, jcfg.max_words)), 0,
        ).astype(np.int32)
        jm = JaxCapGnnModel(jcfg, V)
        params = jm.init(jax.random.PRNGKey(0), frames, regions, caps)["params"]
        tm = CapGnnModel(tiny_test_config(dropout=0.0), V, device="cpu")
        tm.load_state_dict(params_from_jax(params))
        _CACHE.update(jm=jm, params=params, tm=tm, inputs=(frames, regions, caps, lengths))
    return _CACHE["jm"], _CACHE["params"], _CACHE["tm"], _CACHE["inputs"]


def _t(x):
    return torch.tensor(np.asarray(x))


def _jax_forward(jm, params, frames, regions, caps, epsilon):
    keys = jax.random.split(jax.random.PRNGKey(1))
    return jm.apply(
        {"params": params}, frames, regions, caps, epsilon, False,
        rngs={"dropout": keys[0], "sample": keys[1]},
    )


@pytest.mark.parametrize("epsilon", [1.0, 0.0])
def test_teacher_forced_forward_matches_jax(no_dropout, epsilon):
    jm, params, tm, (frames, regions, caps, _) = _setup()
    want = _jax_forward(jm, params, frames, regions, caps, epsilon)
    tm.train()
    try:
        with torch.no_grad():
            got = tm(_t(frames), _t(regions), _t(caps), epsilon, rng=torch.Generator().manual_seed(0))
    finally:
        tm.eval()
    assert got[0].shape == (B, tm.cfg.max_words, V)
    assert got[3].shape == (B, tm.cfg.max_words, 2 * tm.cfg.num_proposals)
    for name, g, w in zip(("logits", "obj", "motion", "alpha"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, err_msg=name)


def test_ce_gradient_matches_jax(no_dropout):
    """d masked_cross_entropy / d theta for every generator parameter."""
    jm, params, tm, (frames, regions, caps, lengths) = _setup()

    def loss_fn(p):
        out = _jax_forward(jm, p, frames, regions, caps, 1.0)[0]
        return jax_ce(out, caps, lengths)

    want = params_from_jax(jax.grad(loss_fn)(params))
    tm.train()
    try:
        out = tm(_t(frames), _t(regions), _t(caps), 1.0, rng=torch.Generator().manual_seed(0))[0]
    finally:
        tm.eval()
    names, ps = zip(*tm.named_parameters())
    grads = torch.autograd.grad(masked_cross_entropy(out, _t(caps), _t(lengths)), ps)
    assert set(names) == set(want)
    for n, g in zip(names, grads):
        scale = float(want[n].abs().max())
        np.testing.assert_allclose(g.numpy(), want[n].numpy(), atol=1e-4 * scale + 1e-12, err_msg=n)


def test_dropout_is_on_in_train_mode_only():
    """Port only: training mode with a generator drops out (repeatably for
    one seed, differently for another); eval mode is the deterministic
    forward whatever the generator; training mode without one raises."""
    cfg = tiny_test_config()  # dropout 0.3
    _, _, _, (frames, regions, caps, _) = _setup()
    tm = CapGnnModel(cfg, V, device="cpu")
    args = (_t(frames), _t(regions), _t(caps), 1.0)
    with torch.no_grad():
        det = tm(*args)[0]
        assert torch.equal(tm(*args, rng=torch.Generator().manual_seed(0))[0], det)
        tm.train()
        try:
            a = tm(*args, rng=torch.Generator().manual_seed(0))[0]
            b = tm(*args, rng=torch.Generator().manual_seed(0))[0]
            c = tm(*args, rng=torch.Generator().manual_seed(1))[0]
            with pytest.raises(ValueError, match="rng"):
                tm(*args)
        finally:
            tm.eval()
    assert torch.equal(a, b)
    assert not torch.allclose(a, det) and not torch.allclose(a, c)


def test_dropout_function_matches_flax_semantics():
    """Kept elements scaled by 1/(1-p), the rest zero, rate 0 and no
    generator leave x as it is, and the mask comes from the generator."""
    x = torch.rand(4000) + 0.5
    y = linear.dropout(x, 0.25, torch.Generator().manual_seed(3))
    kept = y != 0
    torch.testing.assert_close(y[kept], x[kept] / 0.75)
    assert 0.7 < float(kept.float().mean()) < 0.8
    assert linear.dropout(x, 0.0, torch.Generator()) is x
    assert linear.dropout(x, 0.25, None) is x
    assert torch.equal(linear.dropout(x, 0.25, torch.Generator().manual_seed(3)), y)
