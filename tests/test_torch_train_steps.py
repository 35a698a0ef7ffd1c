"""dlsg_tpu_torch's train steps, optimizer, schedules and GAN-lambda state
machine against dlsg_tpu's, on the same numpy inputs with the same weights.

The steps run with dropout switched off on both sides (the generator's rate
by `tiny_test_config(dropout=0.0)`, every hard-coded rate by patching flax's
`Dropout.__call__` and the port's one `dropout` function) at epsilon 1 (all
coins gold in both), and the port's step is fed the gradient penalty's
mixing weights that JAX's key chain draws. fp32.

Tolerances: Adam first moments (optax `mu`, torch `exp_avg`) within 1e-4 of
each tensor's max-abs; parameters atol 1e-5 wherever the moment is above
1e-6 of the tensor's max-abs (a step-1 Adam update is lr * sign(grad), so a
gradient at rounding level may move either way); metrics atol 1e-5. D takes
5 updates in a GAN step, and an element whose gradient sat at rounding level
in any one of them may move by up to lr either way there: so D's parameters
hold atol 1e-5 for all but 1e-5 of the compared elements (12 of 5.6 million
differ on this setup), and those within 2 * 5 * lr.

The GAN step with `gan_single_forward=False` is in
test_torch_train_gan_two_forward.py, so that xdist spreads the JAX compiles.
"""

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dlsg_tpu.config import tiny_test_config as jax_tiny
from dlsg_tpu.models.discriminator import DiscV2 as JaxDiscV2
from dlsg_tpu.models.generator import CapGnnModel as JaxCapGnnModel
from dlsg_tpu.train import gan_lambda as jgl
from dlsg_tpu.train import optim as joptim
from dlsg_tpu.train import schedule as jschedule
from dlsg_tpu.train import steps as jsteps
from dlsg_tpu_torch.config import tiny_test_config
from dlsg_tpu_torch.models.discriminator import DiscV2
from dlsg_tpu_torch.models.generator import CapGnnModel
from dlsg_tpu_torch.ops import linear
from dlsg_tpu_torch.ops.linear import Dense, Embed
from dlsg_tpu_torch.train import gan_lambda as tgl
from dlsg_tpu_torch.train import optim as toptim
from dlsg_tpu_torch.train import schedule as tschedule
from dlsg_tpu_torch.train import steps as tsteps
from dlsg_tpu_torch.weights import params_from_jax

V = 40
B = 4
LR = 1e-4
KEY = 2  # JAX PRNGKey(KEY) and the port's step key
METRICS = ("cap_loss", "loss_G", "loss_D", "wasserstein", "grad_penalty", "gan_lambda")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch intra-op thread per test. The suite runs several test
    processes on the CPU at once, and torch's default of one thread per core
    in each of them oversubscribes the cores many times over: a tiny GAN step
    then takes tens of times longer. The port's test modules that run models
    import this fixture, which applies it to their tests too."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _identity(self, inputs, deterministic=None, rng=None):
    return inputs


def _batch(cfg):
    rng = np.random.default_rng(21)
    lengths = rng.integers(2, cfg.max_words + 1, size=B).astype(np.int32)
    caps = np.where(
        np.arange(cfg.max_words)[None] < lengths[:, None],
        rng.integers(4, V, size=(B, cfg.max_words)), 0,
    ).astype(np.int32)
    return {
        "frames": rng.normal(size=(B, cfg.max_frames, cfg.feature_size)).astype(np.float32),
        "regions": rng.normal(
            size=(B, cfg.max_frames, cfg.num_obj, cfg.region_feature_size)
        ).astype(np.float32),
        "captions": caps,
        "lengths": lengths,
    }


def _adam_mu(opt_state):
    """optax's first moment tree inside a make_optimizer state."""
    (adam,) = [
        s for s in jax.tree_util.tree_leaves(
            opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState)
        ) if isinstance(s, optax.ScaleByAdamState)
    ]
    return adam.mu


def _eps_gp(cfg, step=0):
    """The penalty's mixing weights of JAX's GAN step: [num_D, B]."""
    rng_d = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(KEY), step), 3)[1]
    return np.stack([
        np.asarray(jax.random.uniform(jax.random.split(sub)[0], (B, 1, 1))).reshape(B)
        for sub in jax.random.split(rng_d, cfg.num_D_visual)
    ])


def _jax_models(cfg, batch):
    gen, disc = JaxCapGnnModel(cfg, V), JaxDiscV2(cfg, V)
    g = gen.init(jax.random.PRNGKey(0), batch["frames"], batch["regions"], batch["captions"])
    T, P, H = cfg.max_words, cfg.num_proposals, cfg.visual_hidden_size
    _, att = jsteps.make_masks(jnp.asarray(batch["captions"]))
    alpha = jnp.ones((B, T, 2 * P)) / (2 * P)
    obj = jnp.zeros((B, P, H))
    d = disc.init(jax.random.PRNGKey(1), jax.nn.one_hot(batch["captions"], V), obj, obj, att, alpha)
    return gen, disc, g["params"], d["params"]


def run_gan_case(single_fwd: bool):
    """One GAN step in both packages from the same weights: (JAX result,
    port result), each {"g_mu", "g_params", "d_mu", "d_params", "metrics",
    "g_step", "d_step"} of numpy arrays keyed like the port's state_dict."""
    jcfg = jax_tiny(dropout=0.0, gan_single_forward=single_fwd)
    batch = _batch(jcfg)
    gen, disc, gp, dp = _jax_models(jcfg, batch)
    g0, d0 = params_from_jax(gp), params_from_jax(dp)  # before the donating step
    gstate = joptim.TrainState.create(gp, joptim.make_optimizer(LR))
    dstate = joptim.TrainState.create(dp, joptim.make_optimizer(LR))
    step = jsteps.make_gan_train_step(gen, disc, jcfg)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax.linen.Dropout, "__call__", _identity)
        g2, d2, _, m = step(
            gstate, dstate, jgl.init_lambda_state(0.01),
            {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(KEY), jnp.float32(1.0),
        )
    want = {
        "g_mu": params_from_jax(_adam_mu(g2.opt_state)), "g_params": params_from_jax(g2.params),
        "d_mu": params_from_jax(_adam_mu(d2.opt_state)), "d_params": params_from_jax(d2.params),
        "metrics": {k: np.asarray(v) for k, v in m.items()},
        "g_step": int(g2.step), "d_step": int(d2.step),
    }

    cfg = tiny_test_config(dropout=0.0, gan_single_forward=single_fwd)
    tg, td = CapGnnModel(cfg, V, device="cpu"), DiscV2(cfg, V, device="cpu")
    tg.load_state_dict(g0)
    td.load_state_dict(d0)
    gs = toptim.TrainState.create(tg, toptim.make_optimizer(LR))
    ds = toptim.TrainState.create(td, toptim.make_optimizer(LR))
    tstep = tsteps.make_gan_train_step(tg, td, cfg)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(linear, "dropout", lambda x, rate, rng: x)
        gs, ds, _, tm = tstep(
            gs, ds, tgl.init_lambda_state(0.01, device="cpu"), batch, KEY, 1.0, eps_gp=torch.from_numpy(_eps_gp(cfg))
        )
    got = {
        "g_mu": gs.first_moments(), "g_params": tg.state_dict(),
        "d_mu": ds.first_moments(), "d_params": td.state_dict(),
        "metrics": {k: v.numpy() for k, v in tm.items()},
        "g_step": gs.step, "d_step": ds.step,
    }
    assert not tg.training and not td.training  # the step restored eval mode
    return want, got


def check_state(want_mu, want_params, got_mu, got_params, updates: int = 1):
    """Moments and parameters after `updates` Adam updates (module doc)."""
    assert set(got_mu) == set(want_mu)
    compared = off = 0
    for n, w in want_mu.items():
        w, g = w.numpy(), got_mu[n].detach().numpy()
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(g, w, atol=1e-4 * scale + 1e-12, err_msg=f"moment {n}")
        moved = np.abs(w) > 1e-6 * scale
        diff = np.abs(got_params[n].numpy() - want_params[n].numpy())[moved]
        if updates == 1:
            np.testing.assert_array_less(diff, 1e-5, err_msg=f"parameter {n}")
        else:
            np.testing.assert_array_less(diff, 2 * updates * LR, err_msg=f"parameter {n}")
        compared += diff.size
        off += int((diff >= 1e-5).sum())
    assert off <= 1e-5 * compared, (off, compared)


def check_gan_case(want, got):
    check_state(want["g_mu"], want["g_params"], got["g_mu"], got["g_params"])
    check_state(want["d_mu"], want["d_params"], got["d_mu"], got["d_params"],
                updates=jax_tiny().num_D_visual)
    for k in METRICS:
        np.testing.assert_allclose(got["metrics"][k], want["metrics"][k], atol=1e-5, err_msg=k)
    np.testing.assert_array_equal(got["metrics"]["sample_tokens"], want["metrics"]["sample_tokens"])
    assert got["d_step"] == want["d_step"] == jax_tiny().num_D_visual
    assert got["g_step"] == want["g_step"] == 1


def test_gan_step_single_forward_matches_jax():
    check_gan_case(*run_gan_case(single_fwd=True))


def test_ce_step_matches_jax():
    jcfg = jax_tiny(dropout=0.0)
    batch = _batch(jcfg)
    gen, _, gp, _ = _jax_models(jcfg, batch)
    g0 = params_from_jax(gp)
    state = joptim.TrainState.create(gp, joptim.make_optimizer(LR))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax.linen.Dropout, "__call__", _identity)
        state, m = jsteps.make_ce_train_step(gen, jcfg)(
            state, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(KEY),
            jnp.float32(1.0),
        )
    cfg = tiny_test_config(dropout=0.0)
    tg = CapGnnModel(cfg, V, device="cpu")
    tg.load_state_dict(g0)
    ts = toptim.TrainState.create(tg, toptim.make_optimizer(LR))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(linear, "dropout", lambda x, rate, rng: x)
        ts, tm = tsteps.make_ce_train_step(tg, cfg)(ts, batch, KEY, 1.0)
    check_state(
        params_from_jax(_adam_mu(state.opt_state)), params_from_jax(state.params),
        ts.first_moments(), tg.state_dict(),
    )
    np.testing.assert_allclose(tm["cap_loss"].numpy(), np.asarray(m["cap_loss"]), atol=1e-5)
    np.testing.assert_array_equal(tm["sample_tokens"].numpy(), np.asarray(m["sample_tokens"]))
    assert ts.step == int(state.step) == 1


def test_make_masks_matches_jax():
    caps = np.array([[5, 6, 2, 0], [7, 2, 0, 0]], np.int32)
    for got, want in zip(tsteps.make_masks(torch.from_numpy(caps)), jsteps.make_masks(caps)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _cap_losses():
    """800 caption losses: flat, a sharp rise that triggers a decrease, then
    flat long enough for the 500-step schedule to finish."""
    rng = np.random.default_rng(0)
    return np.concatenate([
        3.0 + 0.01 * rng.standard_normal(220), np.linspace(3.0, 4.0, 30),
        4.0 + 0.01 * rng.standard_normal(550),
    ]).astype(np.float32)


def test_lambda_update_matches_jax():
    jstate, tstate = jgl.init_lambda_state(0.01), tgl.init_lambda_state(0.01, device="cpu")
    upd = jax.jit(jgl.lambda_update)
    seen = set()
    for n, loss in enumerate(_cap_losses()):
        jstate, jlam = upd(jstate, jnp.float32(loss))
        tstate, tlam = tgl.lambda_update(tstate, torch.tensor(loss))
        assert float(tlam) == pytest.approx(float(jlam), abs=1e-9), n
        for k in ("count", "state", "sched_step"):
            assert int(tstate[k]) == int(jstate[k]), (n, k)
        np.testing.assert_array_equal(tstate["window"].numpy(), np.asarray(jstate["window"]))
        seen.add(int(tstate["state"]))
    assert tgl.DECREASE in seen and int(tstate["state"]) == tgl.STABLE


def test_gan_lambda_handler_matches_jax():
    th, jh = tgl.GANLambdaHandler(100, 0.01), jgl.GANLambdaHandler(100, 0.01)
    assert th.decrease_schedule == jh.decrease_schedule
    assert th.increase_schedule == jh.increase_schedule
    for n, loss in enumerate(_cap_losses()):
        th.update_gan_lambda(0, n, float(loss))
        jh.update_gan_lambda(0, n, float(loss))
        assert th.get_current_lambda() == jh.get_current_lambda(), n
        assert (th.state, th.current_schedule_step) == (jh.state, jh.current_schedule_step)


class _Tiny(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.word_embed = Embed(5, 3)
        self.dense = Dense(3, 2)


def test_optimizer_clamp_frozen_and_learning_rate_match_optax():
    """Elementwise clamp before Adam, a frozen subtree (no update, no
    moments), and a learning-rate change between steps, against optax."""
    rng = np.random.default_rng(4)
    params = {
        "word_embed": {"embedding": rng.normal(size=(5, 3)).astype(np.float32)},
        "dense": {"kernel": rng.normal(size=(3, 2)).astype(np.float32),
                  "bias": rng.normal(size=(2,)).astype(np.float32)},
    }
    grads = [jax.tree_util.tree_map(lambda p: (rng.normal(size=p.shape) * 3).astype(np.float32), params)
             for _ in range(3)]
    grads[0]["dense"]["bias"] = np.array([100.0, 1e-3], np.float32)
    jstate = joptim.TrainState.create(
        params, joptim.make_optimizer(0.1, grad_clip=1.0, frozen_paths=("word_embed",))
    )
    module = _Tiny()
    module.load_state_dict(params_from_jax(params))
    tstate = toptim.TrainState.create(
        module, toptim.make_optimizer(0.1, grad_clip=1.0, frozen_paths=("word_embed",))
    )
    assert tstate.names == ["dense.weight", "dense.bias"]
    for i, g in enumerate(grads):
        if i == 2:
            jstate = jstate.set_learning_rate(0.05)
            tstate = tstate.set_learning_rate(0.05)
        jstate = jstate.apply_gradients(g)
        tg = params_from_jax(g)
        tstate.apply_gradients([tg[n] for n in tstate.names])
    for n, w in params_from_jax(jstate.params).items():
        np.testing.assert_allclose(module.state_dict()[n].numpy(), w.numpy(), atol=1e-6, err_msg=n)
    np.testing.assert_array_equal(module.word_embed.embedding.detach().numpy(),
                                  params["word_embed"]["embedding"])
    assert tstate.step == 3 and module.word_embed.embedding not in tstate.optimizer.state


def test_schedules_match_jax():
    for epoch in range(0, 12, 3):
        for milestones in ([4, 7], [1, 4]):
            assert toptim.multistep_lr(1.6e-4, milestones, 0.5, epoch) == joptim.multistep_lr(
                1.6e-4, milestones, 0.5, epoch
            )
        for dataset in ("msvd", "msr-vtt"):
            for step in (0, 90):
                assert tschedule.scheduled_sampling_epsilon(
                    20, epoch, dataset, step, 100
                ) == jschedule.scheduled_sampling_epsilon(20, epoch, dataset, step, 100)
            assert tschedule.saving_schedule(epoch, 400, dataset) == jschedule.saving_schedule(
                epoch, 400, dataset
            )
