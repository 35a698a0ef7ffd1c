"""dlsg_tpu_torch's rematerialization (ops/remat.py; `cfg.decoder_remat` on
the generator's teacher-forced scan, `cfg.disc_remat` on D's grouped
real | fake pass) against the same steps without it, and against JAX's
`disc_remat="dots"` GAN step (the port of tests/test_losses.py:140-210).

Tolerances, those of tests/test_losses.py:140-210: losses rtol 1e-5,
parameters atol 2e-5. Against the port's own "none" step the steps run with
dropout on (0.3 from the config and every hard-coded rate) and a
teacher-forcing ratio of 0.5, so the masks and the coins are drawn: a mask
drawn anew in the backward would show (the negative control below shows it
does, by far more than the tolerance). Against JAX, dropout is off on both
sides (as tests/test_torch_train_steps.py switches it off), and the port is
held to JAX by that file's rule (`check_gan_case`: Adam moments 1e-4 of each
tensor's max-abs, parameters 1e-5 where an update is not a rounding-level
sign, metrics 1e-5), plus loss_D to rtol 1e-5. fp32, tiny dims.
"""

from dataclasses import replace

import numpy as np
import pytest
import torch

from dlsg_tpu_torch.config import tiny_test_config
from dlsg_tpu_torch.evaluation.decode import make_decode_fn
from dlsg_tpu_torch.models.discriminator import DiscV2
from dlsg_tpu_torch.models.generator import CapGnnModel
from dlsg_tpu_torch.ops import linear
from dlsg_tpu_torch.ops import remat as remat_mod
from dlsg_tpu_torch.ops.linear import dropout
from dlsg_tpu_torch.ops.remat import remat
from dlsg_tpu_torch.train.gan_lambda import init_lambda_state
from dlsg_tpu_torch.train.optim import TrainState, make_optimizer
from dlsg_tpu_torch.train.steps import make_ce_train_step, make_gan_train_step

from test_torch_train_steps import B, KEY, LR, V, _batch, check_gan_case, run_gan_case
from test_torch_train_steps import one_torch_thread  # noqa: F401  (autouse)

LOSS_RTOL = 1e-5
PARAM_ATOL = 2e-5
RATIO = 0.5  # teacher forcing: the coins are drawn


@pytest.fixture
def count_checkpoints(monkeypatch):
    """The number of `checkpoint` calls the remat helper makes."""
    calls = []
    real = remat_mod.checkpoint

    def counting(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(remat_mod, "checkpoint", counting)
    return calls


def _run(kind: str, **remat_fields):
    """One GAN or CE step from the seeded init at dropout 0.3: (metrics,
    {name: tensor} of every parameter after it)."""
    cfg = tiny_test_config(**remat_fields)
    batch = _batch(cfg)
    g = CapGnnModel(cfg, V, device="cpu")
    gs = TrainState.create(g, make_optimizer(LR))
    if kind == "ce":
        gs, m = make_ce_train_step(g, cfg)(gs, batch, KEY, RATIO)
        return m, {f"G.{k}": v for k, v in g.state_dict().items()}
    d = DiscV2(cfg, V, device="cpu")
    ds = TrainState.create(d, make_optimizer(LR))
    gs, ds, _, m = make_gan_train_step(g, d, cfg)(
        gs, ds, init_lambda_state(0.01, device="cpu"), batch, KEY, RATIO)
    return m, {**{f"G.{k}": v for k, v in g.state_dict().items()},
               **{f"D.{k}": v for k, v in d.state_dict().items()}}


@pytest.fixture(scope="module")
def without_remat():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return {kind: _run(kind) for kind in ("ce", "gan")}
    finally:
        torch.set_num_threads(n)


def _check_equal(got, want):
    (gm, gp), (wm, wp) = got, want
    for k in ("cap_loss", "loss_G", "loss_D", "wasserstein", "grad_penalty"):
        if k in wm:
            np.testing.assert_allclose(float(gm[k]), float(wm[k]), rtol=LOSS_RTOL, err_msg=k)
    assert set(gp) == set(wp)
    for name, t in wp.items():
        np.testing.assert_allclose(gp[name].numpy(), t.numpy(), rtol=0, atol=PARAM_ATOL,
                                   err_msg=name)


@pytest.mark.parametrize("policy", ["dots", "full"])
@pytest.mark.parametrize("kind", ["ce", "gan"])
def test_decoder_remat_step_equals_none(without_remat, count_checkpoints, kind, policy):
    """Each of the scan's max_words steps is checkpointed once (the GAN
    step's single forward serves both phases) and the step is unchanged."""
    got = _run(kind, decoder_remat=policy)
    assert len(count_checkpoints) == tiny_test_config().max_words
    _check_equal(got, without_remat[kind])


@pytest.mark.parametrize("policy", ["dots", "full"])
def test_disc_remat_gan_step_equals_none(without_remat, count_checkpoints, policy):
    """D's grouped pass is checkpointed once a substep; the penalty's pass
    never is."""
    got = _run("gan", disc_remat=policy)
    assert len(count_checkpoints) == tiny_test_config().num_D_visual
    _check_equal(got, without_remat["gan"])


def test_disc_remat_dots_gan_step_matches_jax():
    """tests/test_losses.py:140-210's `disc_remat="dots"` case, JAX's step
    against the port's at dropout 0."""
    want, got = run_gan_case(single_fwd=True, disc_remat="dots")
    np.testing.assert_allclose(got["metrics"]["loss_D"], want["metrics"]["loss_D"], rtol=LOSS_RTOL)
    check_gan_case(want, got)


def _dropout_fn(w):
    def fn(x, rng=None):
        return torch.tanh(dropout(x @ w, 0.5, rng)).sum(0)
    return fn


def _grads(fn, x, w):
    return torch.autograd.grad((fn(x) ** 2).sum(), (x, w))


def test_plain_checkpoint_redraws_the_masks_and_remat_does_not():
    """Negative control: `torch.utils.checkpoint` of a function that draws
    its dropout mask from an explicit generator recomputes with a new mask
    (its `preserve_rng_state` restores only the default generators), so its
    gradient differs from the unwrapped function's by far more than the
    tolerance; `remat` replays the generator and matches. Both leave the
    caller's generator where one forward leaves it."""
    rs = np.random.default_rng(5)
    x = torch.tensor(rs.normal(size=(16, 24)), dtype=torch.float32, requires_grad=True)
    w = torch.tensor(rs.normal(size=(24, 32)), dtype=torch.float32, requires_grad=True)
    fn = _dropout_fn(w)

    gen = torch.Generator().manual_seed(3)
    want = _grads(lambda a: fn(a, rng=gen), x, w)
    after_one = gen.get_state()

    gen = torch.Generator().manual_seed(3)
    naive = _grads(lambda a: torch.utils.checkpoint.checkpoint(
        fn, a, rng=gen, use_reentrant=False), x, w)
    assert max(float((a - b).abs().max()) for a, b in zip(naive, want)) > 100 * PARAM_ATOL
    assert not torch.equal(gen.get_state(), after_one)  # the recompute drew again

    for policy in ("dots", "full"):
        gen = torch.Generator().manual_seed(3)
        got = _grads(remat(fn, policy, gen), x, w)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=PARAM_ATOL)
        assert torch.equal(gen.get_state(), after_one), policy


def test_remat_recomputes_in_the_forwards_mode():
    """A backward that runs after the module went back to eval mode (the
    train steps' updates do) recomputes in training mode, with dropout."""
    layer = linear.Dropout(0.5)
    layer.train()
    x = torch.randn(8, 12, generator=torch.Generator().manual_seed(1), requires_grad=True)

    def fn(a, rng=None):
        return layer(a, rng) * a

    gen = torch.Generator().manual_seed(4)
    (want,) = torch.autograd.grad(fn(x, rng=gen).sum(), x)
    gen = torch.Generator().manual_seed(4)
    out = remat(fn, "full", gen, module=layer)(x)
    layer.eval()
    (got,) = torch.autograd.grad(out.sum(), x)
    assert torch.equal(got, want)
    assert not layer.training


def test_dots_keeps_the_products_and_recomputes_the_rest():
    """Under "dots" the policy saves exactly the matrix products (not the
    convolution the port computes as one); the remaining ops are computed
    again."""
    ctx = None
    aten = torch.ops.aten
    save = remat_mod.CheckpointPolicy.MUST_SAVE
    for op in (aten.mm.default, aten.addmm.default, aten.bmm.default, aten.baddbmm.default):
        assert remat_mod._save_dots(ctx, op) == save
    for op in (aten.tanh.default, aten.rand.default, aten.convolution.default):
        assert remat_mod._save_dots(ctx, op) != save
    with remat_mod.not_a_dot():
        assert remat_mod._save_dots(ctx, aten.mm.default) != save
    assert remat_mod._save_dots(ctx, aten.mm.default) == save
    with pytest.raises(ValueError, match="remat policy"):
        remat(lambda rng: None, "some", None)


def test_no_decode_path_checkpoints(monkeypatch):
    """Greedy (in eval and in training mode), beam (fused head off and
    on) and the eval-mode teacher-forced forward never rematerialize, even
    with both fields set (JAX's inference never does)."""
    def refuse(*args, **kwargs):
        raise AssertionError("a decode path called checkpoint")

    monkeypatch.setattr(remat_mod, "checkpoint", refuse)
    cfg = tiny_test_config(decoder_remat="full", disc_remat="full", beam_size=3)
    batch = _batch(cfg)
    g = CapGnnModel(cfg, V, device="cpu")
    fr, rg = torch.from_numpy(batch["frames"]), torch.from_numpy(batch["regions"])
    ids = g(fr, rg)[0]
    assert ids.shape == (B, cfg.max_words)
    g.train()  # greedy in training mode, under grad, with a generator
    assert torch.equal(g(fr, rg, rng=torch.Generator().manual_seed(0))[0], ids)
    g.eval()
    for head in ("off", "on"):
        hcfg = replace(cfg, use_fused_vocab_head=head)
        assert make_decode_fn(g, hcfg, device="cpu")(batch["frames"], batch["regions"]).shape[0] == B
    logits = g(fr, rg, torch.from_numpy(batch["captions"]).long())[0]
    assert logits.shape == (B, cfg.max_words, V)

