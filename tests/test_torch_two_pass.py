"""dlsg_tpu_torch's two-pass decode against its single-pass decode and against
dlsg_tpu's two-pass decode, same weights, same numpy inputs, fp32.

As in tests/test_two_pass.py, the bias of `<end>` in the vocab head steers
where captions end: at -2 no row has finished after t1 = 4 steps (pass 2
re-decodes the whole batch), at 2 half have (pass 2 re-decodes a bucket of
3 rows), at 6 all have (no pass 2). Token ids must be equal exactly; the attention weights of
each emitted caption within 1e-6 (up to and including its `<end>`: after it
both paths emit filler)."""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlsg_tpu.config import tiny_test_config as jax_tiny
from dlsg_tpu.evaluation.evaluate import make_decode_fn as jax_make_decode_fn
from dlsg_tpu.models.generator import CapGnnModel as JaxCapGnnModel
from dlsg_tpu_torch.config import tiny_test_config
from dlsg_tpu_torch.evaluation import decode as decode_mod
from dlsg_tpu_torch.evaluation.decode import make_decode_fn
from dlsg_tpu_torch.evaluation.evaluate import evaluate
from dlsg_tpu_torch.models.generator import CapGnnModel
from dlsg_tpu_torch.serve import Captioner
from dlsg_tpu_torch.vocab import END_ID, Vocabulary
from dlsg_tpu_torch.weights import params_from_jax
from test_torch_train_steps import one_torch_thread  # noqa: F401  (autouse)

B, VOCAB = 6, 40
CFG = dict(test_batch_size=B, max_words=10, beam_size=3)
TWO_PASS = dict(decode_two_pass_t1=4, decode_two_pass_bucket=3)


def _setup(end_bias: float, **switches):
    """JAX params (PRNGKey 3) with <end>'s bias raised by `end_bias`, the
    port's model holding the same weights, and seeded clips."""
    jcfg = jax_tiny(**CFG, **switches)
    rng = np.random.RandomState(0)
    frames = rng.randn(B, jcfg.max_frames, jcfg.feature_size).astype(np.float32)
    regions = rng.randn(B, jcfg.max_frames, jcfg.num_obj, jcfg.region_feature_size).astype(
        np.float32
    )
    params = jax.device_get(
        JaxCapGnnModel(jcfg, VOCAB).init(
            jax.random.PRNGKey(3), frames, regions, jnp.zeros((B, jcfg.max_words), jnp.int32)
        )["params"]
    )
    bias = np.array(params["decoder"]["step"]["word_restore"]["bias"])
    bias[END_ID] += end_bias
    params["decoder"]["step"]["word_restore"]["bias"] = bias
    model = CapGnnModel(tiny_test_config(**CFG, **switches), VOCAB, device="cpu")
    model.load_state_dict(params_from_jax(params))
    return params, model, frames, regions


def _caption_len(row):
    ends = np.nonzero(row == END_ID)[0]
    return int(ends[0]) if ends.size else row.size


def _finished_after_t1(model, cfg, frames, regions):
    beam_feats = decode_mod._make_beam_from_feats(model, cfg, cfg.beam_size)
    with torch.inference_mode():
        obj, mot = model.encode(torch.as_tensor(frames), torch.as_tensor(regions))
        return beam_feats(obj, mot, TWO_PASS["decode_two_pass_t1"])[3].numpy()


@pytest.mark.parametrize("fused", ["off", "on"])
@pytest.mark.parametrize("end_bias", [-2.0, 2.0, 6.0])
def test_two_pass_matches_single_pass_and_jax(end_bias, fused):
    params, model, frames, regions = _setup(end_bias, use_fused_vocab_head=fused)
    cfg = tiny_test_config(**CFG, use_fused_vocab_head=fused)
    single = make_decode_fn(model, cfg, return_alpha=True, device="cpu")
    two = make_decode_fn(model, replace(cfg, **TWO_PASS), return_alpha=True, device="cpu")
    jcfg = replace(jax_tiny(**CFG, use_fused_vocab_head=fused), **TWO_PASS)
    jtwo = jax_make_decode_fn(JaxCapGnnModel(jcfg, VOCAB), jcfg, return_alpha=True)

    ids_s, al_s = (t.numpy() for t in single(frames, regions))
    ids_t, al_t = (t.numpy() for t in two(frames, regions))
    ids_j, al_j = (np.asarray(a) for a in jtwo({"params": params}, frames, regions))
    np.testing.assert_array_equal(ids_t, ids_s)
    np.testing.assert_array_equal(ids_t, ids_j)
    for b in range(B):
        e = min(_caption_len(ids_s[b]) + 1, ids_s.shape[1])
        np.testing.assert_allclose(al_t[b, :e], al_s[b, :e], atol=1e-6)
        np.testing.assert_allclose(al_t[b, :e], al_j[b, :e], atol=1e-6)


def test_the_sweep_covers_every_branch():
    """-2 leaves every row unfinished after t1 (more than the bucket: the
    full-batch pass 2), 2 leaves some but no more than the bucket (the
    compacted pass 2), 6 none (no pass 2)."""
    cfg = tiny_test_config(**CFG)
    unfinished = []
    for end_bias in (-2.0, 2.0, 6.0):
        _, model, frames, regions = _setup(end_bias)
        unfinished.append(int((~_finished_after_t1(model, cfg, frames, regions)).sum()))
    bucket = TWO_PASS["decode_two_pass_bucket"]
    assert unfinished[0] > bucket and 0 < unfinished[1] <= bucket and unfinished[2] == 0, unfinished


def test_two_pass_through_evaluate_and_captioner():
    """The two-pass decode slots into evaluate() and Captioner unchanged: the
    same captions, scores and attention weights as the single pass."""
    _, model, frames, regions = _setup(2.0)
    cfg = tiny_test_config(**CFG)
    vocab = Vocabulary.from_words(f"w{i}" for i in range(VOCAB - 4))
    batch = {"frames": frames, "regions": regions, "video_ids": np.arange(B)}
    refs = {str(v): [{"caption": "w1 w2 w3"}, {"caption": "w4 w5"}] for v in range(B)}
    outs = []
    for c in (cfg, replace(cfg, **TWO_PASS)):
        decode = make_decode_fn(model, c, return_alpha=True, device="cpu")
        outs.append(evaluate(decode, [batch], vocab, refs))
    (s1, r1, a1, _), (s2, r2, a2, _) = outs
    assert r1 == r2 and s1 == s2 and a1.shape == a2.shape == (B, cfg.max_words, 2 * cfg.num_proposals)
    params = model.state_dict()
    c1 = Captioner(cfg, vocab, params, device="cpu")
    c2 = Captioner(replace(cfg, **TWO_PASS), vocab, params, device="cpu")
    assert c2.caption(frames, regions) == c1.caption(frames, regions)
    assert c2.caption(frames[:3], regions[:3]) == c1.caption(frames[:3], regions[:3])
