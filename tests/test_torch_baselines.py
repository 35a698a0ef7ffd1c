"""dlsg_tpu_torch's baseline generators (CapModel, CapBaselineModel,
CapBaseline1), their baseline encoders and their CE steps against
dlsg_tpu's, from the same weights (drawn by JAX's `init` and carried over
by `params_from_jax` with a strict load) on the same numpy inputs, at
tiny_test_config sizes.

Tolerances: fp32 encoder outputs and teacher-forced logits atol 1e-5
(summation order only); bf16 encoder outputs atol 5e-2, the bf16 tolerance
of tests/test_torch_encoder_decoder.py (the two frameworks round bf16 at
slightly different places); greedy and beam-3 token ids exactly equal; the
CE steps by `check_state` (Adam moments 1e-4 of each tensor's max-abs,
parameters 1e-5), cap loss atol 1e-5. The JAX side runs its Pallas LSTM in
interpret mode and its fused vocab head through its interpreted kernel off a
TPU; the port's wrappers take their plain versions on CPU tensors.
"""

import functools

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dlsg_tpu.ops.pallas.lstm_scan as jax_lstm_scan_mod
from dlsg_tpu.config import apply_dataset_overrides as jax_overrides
from dlsg_tpu.config import tiny_test_config as jax_tiny
from dlsg_tpu.data.synthetic import SyntheticDataset as JaxSyntheticDataset
from dlsg_tpu.data.synthetic import make_vocab as jax_make_vocab
from dlsg_tpu.evaluation.evaluate import make_decode_fn as jax_make_decode_fn
from dlsg_tpu.models import encoders as jenc
from dlsg_tpu.models import generator as jgen
from dlsg_tpu.ops.pallas.lstm_scan import lstm_scan_pallas
from dlsg_tpu.train import optim as joptim
from dlsg_tpu.train import steps as jsteps
from dlsg_tpu.train.trainer import RunLegacy as JaxRunLegacy
from dlsg_tpu_torch.config import apply_dataset_overrides, tiny_test_config
from dlsg_tpu_torch.evaluation.decode import make_decode_fn
from dlsg_tpu_torch.models import CapBaseline1, CapBaselineModel, CapModel, encoders
from dlsg_tpu_torch.ops import linear
from dlsg_tpu_torch.train import optim as toptim
from dlsg_tpu_torch.train import steps as tsteps
from dlsg_tpu_torch.weights import params_from_jax, params_to_jax
from test_torch_train_steps import KEY, LR, _adam_mu, _identity, check_state
from test_torch_train_steps import one_torch_thread  # noqa: F401  (autouse)

V = 40
B = 4
NAMES = ("CapModel", "CapBaseline1", "CapBaselineModel")
PORT = {"CapModel": CapModel, "CapBaseline1": CapBaseline1, "CapBaselineModel": CapBaselineModel}
FRAMES_ONLY = ("CapModel",)  # JAX's signature: (frames, caption, ...) and outputs alone


@pytest.fixture
def pallas_interpret(monkeypatch):
    """Run the JAX package's Pallas LSTM in interpret mode, as its own CPU
    tests do."""
    monkeypatch.setattr(
        jax_lstm_scan_mod, "lstm_scan_pallas",
        functools.partial(lstm_scan_pallas, interpret=True),
    )


def _inputs(cfg, seed=7):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(2, cfg.max_words + 1, size=B).astype(np.int32)
    return {
        "frames": rng.normal(size=(B, cfg.max_frames, cfg.feature_size)).astype(np.float32),
        "regions": rng.normal(
            size=(B, cfg.max_frames, cfg.num_obj, cfg.region_feature_size)).astype(np.float32),
        "captions": np.where(np.arange(cfg.max_words)[None] < lengths[:, None],
                             rng.integers(4, V, size=(B, cfg.max_words)), 0).astype(np.int32),
        "lengths": lengths,
    }


def _jax_args(name, x, caption):
    """JAX's call arguments of generator `name` (frames-only or not)."""
    if name in FRAMES_ONLY:
        return (x["frames"], caption)
    return (x["frames"], x["regions"], caption)


_CACHE = {}


def _pair(name, **overrides):
    """(JAX module, its params, the port's model with them, inputs), cached."""
    key = (name, tuple(sorted(overrides.items())))
    if key not in _CACHE:
        jcfg = jax_tiny(**overrides)
        x = _inputs(jcfg)
        jm = getattr(jgen, name)(jcfg, V)
        params = jm.init(jax.random.PRNGKey(3), *_jax_args(name, x, x["captions"]))["params"]
        tm = PORT[name](tiny_test_config(**overrides), V, device="cpu")
        tm.load_state_dict(params_from_jax(params))  # strict
        _CACHE[key] = (jm, params, tm, x)
    return _CACHE[key]


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ---------------------------------------------------------------- encoders


@pytest.mark.parametrize("compute_dtype, atol", [("float32", 1e-5), ("bfloat16", 5e-2)])
@pytest.mark.parametrize("which", ["EncoderVisual", "CapGnnEncoder"])
def test_baseline_encoder_matches_jax(which, compute_dtype, atol):
    """EncoderVisual(baseline=True): `out_try` in place of the
    self-attention, an fp32 product also at bf16 compute, as JAX's Dense
    without a dtype. CapGnnEncoder(baseline=True): both graph branches'
    aggregated frames [B, T, H], no LatentPSL."""
    jcfg, cfg = jax_tiny(compute_dtype=compute_dtype), tiny_test_config(compute_dtype=compute_dtype)
    x = _inputs(jcfg, seed=11)
    if which == "EncoderVisual":
        jmod, args = jenc.EncoderVisual(jcfg, baseline=True), (x["frames"],)
        tmod = encoders.EncoderVisual(cfg, cfg.feature_size, baseline=True)
    else:
        jmod, args = jenc.CapGnnEncoder(jcfg, baseline=True), (x["frames"], x["regions"])
        tmod = encoders.CapGnnEncoder(cfg, baseline=True)
    params = jmod.init(jax.random.PRNGKey(0), *args)["params"]
    assert not any("v2l_layer" in k or "self_attention" in k for k in params_from_jax(params)
                   if not k.startswith("motion_pre_encoder"))
    tmod.load_state_dict(params_from_jax(params))  # strict: no v2l_layer, no self-attention
    want = jmod.apply({"params": params}, *args)
    with torch.no_grad():
        got = tmod(*(_t(a) for a in args))
    want, got = (want, got) if which == "CapGnnEncoder" else ((want,), (got,))
    for w, g in zip(want, got):
        assert g.shape == (B, cfg.max_frames, cfg.visual_hidden_size)
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w, np.float32), atol=atol)
    if which == "EncoderVisual":  # out_try's product in fp32 while the Bi-LSTM runs in bf16
        assert tmod.out_try.dtype == torch.float32 and got[0].dtype == torch.float32


# ---------------------------------------------------------------- generators


@pytest.mark.parametrize("name", NAMES)
def test_weights_carry_over_both_ways(name):
    """The flax tree loads strictly and comes back whole: the same paths and
    values through params_to_jax."""
    _, params, tm, _ = _pair(name)
    back = params_to_jax(tm.state_dict())
    flat = dict(jax.tree_util.tree_flatten_with_path(params)[0])
    back_flat = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert flat.keys() == back_flat.keys()
    for k, v in flat.items():
        np.testing.assert_array_equal(back_flat[k], np.asarray(v))


@pytest.mark.parametrize("name", NAMES)
def test_teacher_forced_logits_match(name):
    jm, params, tm, x = _pair(name)
    out = jm.apply({"params": params}, *_jax_args(name, x, x["captions"]))
    want = out if name in FRAMES_ONLY else out[0]
    with torch.no_grad():
        if name in FRAMES_ONLY:
            got = tm(_t(x["frames"]), _t(x["captions"]))
        else:
            got, *rest = tm(_t(x["frames"]), _t(x["regions"]), _t(x["captions"]))
            assert rest == [0, 0, 0] and list(out[1:]) == [0, 0, 0]  # JAX's return value
    assert got.shape == (B, tm.cfg.max_words, V)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("name", NAMES)
def test_greedy_ids_match(name):
    """make_decode_fn's greedy decode calls each generator by its own
    signature (the frames-only one with the regions ignored, or None) and
    gives the decoder's attention over the frames."""
    jm, params, tm, x = _pair(name)
    out = jm.apply({"params": params}, *_jax_args(name, x, None))
    want = out if name in FRAMES_ONLY else out[0]
    decode = make_decode_fn(tm, tm.cfg, beam_size=1, return_alpha=True, device="cpu")
    ids, alpha = decode(x["frames"], x["regions"])
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want))
    assert alpha.shape == (B, tm.cfg.max_words, tm.cfg.max_frames)
    np.testing.assert_allclose(alpha.sum(-1).numpy(), 1.0, atol=1e-5)
    if name in FRAMES_ONLY:
        np.testing.assert_array_equal(decode(x["frames"], None)[0].numpy(), ids.numpy())
        with torch.no_grad():
            np.testing.assert_array_equal(tm(_t(x["frames"])).numpy(), ids.numpy())


@pytest.mark.parametrize("fused, pallas_lstm", [("off", False), ("on", True)])
@pytest.mark.parametrize("name", NAMES)
def test_beam3_ids_match_jax(name, fused, pallas_lstm, pallas_interpret):
    """Each package's make_decode_fn, beam 3, the kernels' switches off and
    on; the attention of the emitted captions within 1e-5."""
    switches = dict(use_fused_vocab_head=fused, use_pallas_lstm=pallas_lstm)
    jm, params, tm, x = _pair(name, **switches)
    jcfg = jax_tiny(**switches)
    jdec = jax_make_decode_fn(getattr(jgen, name)(jcfg, V), jcfg, beam_size=3, return_alpha=True)
    jids, jalpha = jdec({"params": params}, x["frames"], x["regions"])
    tids, talpha = make_decode_fn(tm, tm.cfg, beam_size=3, return_alpha=True, device="cpu")(
        x["frames"], x["regions"])
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    assert talpha.shape == (B, tm.cfg.max_words, tm.cfg.max_frames)
    np.testing.assert_allclose(talpha.numpy(), np.asarray(jalpha), atol=1e-5)


@pytest.mark.parametrize("fused", ["off", "on"])
def test_capmodel_two_pass_equals_single_pass(fused):
    """CapModel encodes to (feats, None): the two-pass decode passes the
    None through (tests/test_two_pass.py:92-116 in JAX) and gives the single
    pass's ids, with a bucket of 2 rows; the same for the attention."""
    from dataclasses import replace

    _, _, tm, x = _pair("CapModel", use_fused_vocab_head=fused)
    single = make_decode_fn(tm, tm.cfg, beam_size=3, return_alpha=True, device="cpu")
    two = make_decode_fn(tm, replace(tm.cfg, decode_two_pass_t1=4, decode_two_pass_bucket=2),
                         beam_size=3, return_alpha=True, device="cpu")
    assert two.__name__ == "decode_two_pass"
    (ids1, al1), (ids2, al2) = single(x["frames"], None), two(x["frames"], None)
    np.testing.assert_array_equal(ids2.numpy(), ids1.numpy())
    finished = (ids1 == 2).any(-1)  # rows whose attention past <end> is filler in both
    np.testing.assert_allclose(al2[finished.logical_not()].numpy(),
                               al1[finished.logical_not()].numpy(), atol=1e-6)


# ---------------------------------------------------------------- CE steps


def _jax_legacy_step(cfg):
    """JAX's RunLegacy step (it has no factory of its own): the runner's."""
    vocab = jax_make_vocab()
    ds = JaxSyntheticDataset(cfg, vocab, num_videos=2, captions_per_video=1)
    runner = JaxRunLegacy(cfg, vocab, ds, ds.eval_view(), ds.references)
    assert runner.cfg == cfg  # the dataset overrides, applied below too
    return runner.ce_step, len(vocab)


@pytest.mark.parametrize("name", NAMES)
def test_ce_step_matches_jax(name, tmp_path):
    """One CE step from the same weights, dropout off, all gold words:
    the shared step (JAX's make_ce_train_step) for CapBaseline1 and
    CapBaselineModel, CapModel's own (JAX's RunLegacy step). The object
    branch of CapBaselineModel gets no gradient: it stays as it was in both
    packages and its moments are zero. The trainers' dataset overrides
    apply (RunLegacy's step closes over its model)."""
    jcfg = jax_overrides(jax_tiny(dropout=0.0, result_dir=str(tmp_path)))
    vocab_size = V
    if name in FRAMES_ONLY:
        jstep, vocab_size = _jax_legacy_step(jcfg)
    x = _inputs(jcfg, seed=21)
    x["captions"] = np.minimum(x["captions"], vocab_size - 1)
    jm = getattr(jgen, name)(jcfg, vocab_size)
    params = jm.init(jax.random.PRNGKey(5), *_jax_args(name, x, x["captions"]))["params"]
    p0 = params_from_jax(params)
    if name not in FRAMES_ONLY:
        jstep = jsteps.make_ce_train_step(jm, jcfg)
    state = joptim.TrainState.create(params, joptim.make_optimizer(LR))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax.linen.Dropout, "__call__", _identity)
        state, m = jstep(state, {k: jnp.asarray(v) for k, v in x.items()},
                         jax.random.PRNGKey(KEY), jnp.float32(1.0))

    cfg = apply_dataset_overrides(tiny_test_config(dropout=0.0))
    tm = PORT[name](cfg, vocab_size, device="cpu")
    tm.load_state_dict(p0)
    ts = toptim.TrainState.create(tm, toptim.make_optimizer(LR))
    factory = tsteps.make_legacy_ce_train_step if name in FRAMES_ONLY else tsteps.make_ce_train_step
    batch = {k: v for k, v in x.items() if name not in FRAMES_ONLY or k != "regions"}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(linear, "dropout", lambda x, rate, rng: x)
        ts, tmet = factory(tm, cfg)(ts, batch, KEY, 1.0)
    want_mu, want_params = params_from_jax(_adam_mu(state.opt_state)), params_from_jax(state.params)
    got_mu, got_params = ts.first_moments(), tm.state_dict()
    check_state(want_mu, want_params, got_mu, got_params)
    np.testing.assert_allclose(tmet["cap_loss"].numpy(), np.asarray(m["cap_loss"]), atol=1e-5)
    np.testing.assert_array_equal(tmet["sample_tokens"].numpy(), np.asarray(m["sample_tokens"]))
    assert ts.step == int(state.step) == 1 and not tm.training
    if name == "CapBaselineModel":
        unused = [k for k in p0 if k.startswith("encoder.obj_encoder.")]
        assert unused
        for k in unused:
            assert torch.equal(got_params[k], p0[k]) and not got_mu[k].any(), k
            np.testing.assert_array_equal(want_params[k].numpy(), p0[k].numpy())
            assert not want_mu[k].numpy().any()
        # while the motion branch moved
        assert all(not torch.equal(got_params[k], p0[k])
                   for k in p0 if k.startswith("encoder.motion_encoder."))


def test_the_shared_ce_step_refuses_a_frames_only_generator():
    """CapModel takes (frames, captions) and returns its logits alone: the
    shared step would pass the regions as its captions."""
    cfg = tiny_test_config()
    with pytest.raises(TypeError, match="make_legacy_ce_train_step"):
        tsteps.make_ce_train_step(CapModel(cfg, V, device="cpu"), cfg)
