"""The serving slice as a whole: dlsg_tpu_torch's make_decode_fn and Captioner
against dlsg_tpu's, same weights, same numpy inputs, tiny_test_config sizes.

Beam-3 token ids must be equal and the attention weights of the emitted
captions agree within 1e-5 (fp32 on both sides), for each combination of the
two kernel switches: the JAX side runs its Pallas kernels in interpret mode,
the port's wrappers take their plain versions on CPU tensors."""

import functools
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import dlsg_tpu.ops.pallas.lstm_scan as jax_lstm_scan_mod
from dlsg_tpu.bundle import save_bundle as jax_save_bundle
from dlsg_tpu.config import tiny_test_config as jax_tiny
from dlsg_tpu.evaluation.evaluate import make_decode_fn as jax_make_decode_fn
from dlsg_tpu.models.generator import CapGnnModel as JaxCapGnnModel
from dlsg_tpu.ops.pallas.lstm_scan import lstm_scan_pallas
from dlsg_tpu.serve import Captioner as JaxCaptioner
from dlsg_tpu.vocab import Vocabulary as JaxVocabulary
from dlsg_tpu_torch import checkpoint as ckpt
from dlsg_tpu_torch.config import tiny_test_config
from dlsg_tpu_torch.evaluation.decode import make_decode_fn
from dlsg_tpu_torch.models.generator import CapGnnModel
from dlsg_tpu_torch.serve import Captioner
from dlsg_tpu_torch.vocab import Vocabulary
from dlsg_tpu_torch.weights import params_from_jax
from test_torch_train_steps import one_torch_thread  # noqa: F401  (autouse)

V = 50
B = 4


@pytest.fixture(scope="module")
def setup():
    cfg = jax_tiny()
    rng = np.random.default_rng(5)
    frames = rng.normal(size=(B, cfg.max_frames, cfg.feature_size)).astype(np.float32)
    regions = rng.normal(
        size=(B, cfg.max_frames, cfg.num_obj, cfg.region_feature_size)
    ).astype(np.float32)
    caps = jnp.zeros((B, cfg.max_words), jnp.int32)
    params = JaxCapGnnModel(cfg, V).init(jax.random.PRNGKey(1), frames, regions, caps)["params"]
    return params, frames, regions


@pytest.fixture
def pallas_interpret(monkeypatch):
    """Run the JAX package's Pallas LSTM in interpret mode, as its own CPU
    tests do (the fused vocab head already does so off a TPU)."""
    monkeypatch.setattr(
        jax_lstm_scan_mod, "lstm_scan_pallas",
        functools.partial(lstm_scan_pallas, interpret=True),
    )


def _decoders(params, beam, **switches):
    jcfg = jax_tiny(**switches)
    tcfg = tiny_test_config(**switches)
    jdec = jax_make_decode_fn(JaxCapGnnModel(jcfg, V), jcfg, beam_size=beam, return_alpha=True)
    tm = CapGnnModel(tcfg, V, device="cpu")
    tm.load_state_dict(params_from_jax(params))
    tdec = make_decode_fn(tm, tcfg, beam_size=beam, return_alpha=True, device="cpu")
    return (lambda f, r: jdec({"params": params}, f, r)), tdec


@pytest.mark.parametrize("fused", ["off", "on"])
@pytest.mark.parametrize("pallas_lstm", [False, True])
def test_beam3_decode_matches_jax(setup, fused, pallas_lstm, pallas_interpret):
    params, frames, regions = setup
    jdec, tdec = _decoders(params, 3, use_fused_vocab_head=fused, use_pallas_lstm=pallas_lstm)
    jids, jalpha = jdec(frames, regions)
    tids, talpha = tdec(frames, regions)
    assert tids.shape == (B, jax_tiny().max_words)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(talpha.numpy(), np.asarray(jalpha), atol=1e-5)


def test_greedy_decode_matches_jax(setup):
    params, frames, regions = setup
    jdec, tdec = _decoders(params, 1)
    jids, jalpha = jdec(frames, regions)
    tids, talpha = tdec(frames, regions)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(talpha.numpy(), np.asarray(jalpha), atol=1e-5)


@pytest.mark.parametrize("stage", ["float32", "bfloat16"])
def test_jax_bundle_captions_match(setup, tmp_path, stage):
    """A bundle written by dlsg_tpu.bundle.save_bundle captions the same
    strings through both packages' Captioner.from_bundle (beam and greedy),
    including a ragged request padded to its bucket, with fp32 and bf16
    input staging."""
    params, frames, regions = setup
    cfg = replace(jax_tiny(), beam_size=3, input_stage_dtype=stage)
    vocab = JaxVocabulary.from_words(f"w{i}" for i in range(V - 4))
    path = str(tmp_path / "tiny.dlsg.npz")
    jax_save_bundle(path, cfg, vocab, params)
    jc = JaxCaptioner.from_bundle(path)
    tc = Captioner.from_bundle(path, device="cpu")
    assert tc.cfg.beam_size == 3 and tc.vocab.idx2word == vocab.idx2word
    for n in (B, 3):
        assert tc.caption(frames[:n], regions[:n]) == jc.caption(frames[:n], regions[:n])
    assert tc.caption(frames, regions, greedy=True) == jc.caption(frames, regions, greedy=True)
    assert tc.bucket_sizes() == jc.bucket_sizes()
    fast = Captioner.from_bundle(path, fast=True, device="cpu")  # exact top-k all the same
    assert fast.caption(frames, regions) == tc.caption(frames, regions)
    assert tc.warmup() == len(tc.bucket_sizes()) and tc.warm


def test_from_checkpoint_takes_fast(setup, tmp_path):
    """Captioner.from_checkpoint(fast=True), as dlsg_tpu's: the JAX
    package's approximate-top-k recall in the config, the same captions
    (this package always takes the exact top-k)."""
    params, frames, regions = setup
    words = [f"w{i}" for i in range(V - 4)]
    ckpt.save_model(str(tmp_path), "best_CIDEr", params_from_jax(params))
    cfg = replace(tiny_test_config(), beam_size=3)
    fast = Captioner.from_checkpoint(cfg, Vocabulary.from_words(words), ckpt_dir=str(tmp_path),
                                     fast=True, device="cpu")
    exact = Captioner.from_checkpoint(cfg, Vocabulary.from_words(words), ckpt_dir=str(tmp_path),
                                      device="cpu")
    jfast = JaxCaptioner(replace(jax_tiny(), beam_size=3), JaxVocabulary.from_words(words), params,
                         fast=True)
    assert fast.cfg.decode_approx_topk == jfast.cfg.decode_approx_topk == 0.95
    assert exact.cfg.decode_approx_topk == cfg.decode_approx_topk
    assert fast.caption(frames, regions) == exact.caption(frames, regions) == jfast.caption(frames, regions)
