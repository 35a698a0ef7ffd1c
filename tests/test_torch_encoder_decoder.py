"""dlsg_tpu_torch CapGnnModel (encoders, decoder, layers) against dlsg_tpu's
flax CapGnnModel with the same weights (weights.params_from_jax) on identical
numpy inputs, at tiny_test_config sizes.

Tolerances (fp32 on both sides, so summation order only): encoder proposals
atol 1e-4 (two LayerNorm'd graph stages, values O(1)); one decoder step's
logits, hidden output and attention weights atol 1e-5 (fed the same
proposals); greedy token ids exactly equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlsg_tpu.config import tiny_test_config as jax_tiny
from dlsg_tpu.models.generator import CapGnnModel as JaxCapGnnModel
from dlsg_tpu_torch.config import tiny_test_config
from dlsg_tpu_torch.models.decoder import expand_pre_to_beams
from dlsg_tpu_torch.models.generator import CapGnnModel
from dlsg_tpu_torch.weights import params_from_jax
from test_torch_train_steps import one_torch_thread  # noqa: F401  (autouse)

V = 50
B = 4
_CACHE = {}


def _pair(**overrides):
    """(jax model, variables, torch model, frames, regions), cached per config."""
    key = tuple(sorted(overrides.items()))
    if key not in _CACHE:
        jcfg = jax_tiny(**overrides)
        rng = np.random.default_rng(11)
        frames = rng.normal(size=(B, jcfg.max_frames, jcfg.feature_size)).astype(np.float32)
        regions = rng.normal(
            size=(B, jcfg.max_frames, jcfg.num_obj, jcfg.region_feature_size)
        ).astype(np.float32)
        caps = jnp.zeros((B, jcfg.max_words), jnp.int32)
        jm = JaxCapGnnModel(jcfg, V)
        variables = jm.init(jax.random.PRNGKey(0), frames, regions, caps)
        tm = CapGnnModel(tiny_test_config(**overrides), V, device="cpu")
        tm.load_state_dict(params_from_jax(variables["params"]))
        _CACHE[key] = (jm, variables, tm, frames, regions)
    return _CACHE[key]


def _t(x):
    return torch.tensor(np.asarray(x))


@pytest.mark.parametrize("joint", [False, True])
def test_encode_proposals_match(joint):
    jm, v, tm, frames, regions = _pair(joint_region_projection=joint)
    jo, jmo = jm.apply(v, frames, regions, method=jm.encode)
    with torch.no_grad():
        to, tmo = tm.encode(_t(frames), _t(regions))
    assert to.shape == (B, tm.cfg.num_proposals, tm.cfg.visual_hidden_size)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-4)
    np.testing.assert_allclose(tmo.numpy(), np.asarray(jmo), atol=1e-4)


def test_encode_without_object_branch():
    """Fewer than 5 objects: the object branch is skipped in both."""
    jm, v, tm, frames, regions = _pair()
    regions = regions[:, :, :3]
    jo, jmo = jm.apply(v, frames, regions, method=jm.encode)
    with torch.no_grad():
        to, tmo = tm.encode(_t(frames), _t(regions))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-4)
    np.testing.assert_allclose(tmo.numpy(), np.asarray(jmo), atol=1e-4)


def test_beam_steps_match():
    """Three beam steps on the expanded group from the same proposals:
    logits, hidden output, alpha and the recurrent state agree."""
    jm, v, tm, frames, regions = _pair()
    jo, jmo = jm.apply(v, frames, regions, method=jm.encode)
    jstate, jpre = jm.apply(v, jo, jmo, method=jm.decoder_init_beam_state)
    with torch.no_grad():
        tstate, tpre = tm.decoder_init_beam_state(_t(jo), _t(jmo))
        beam = 3
        jpre_x = {k: (jnp.repeat(a, beam, 0) if k in ("gw", "K", "V") else a)
                  for k, a in jpre.items()}
        tpre_x = expand_pre_to_beams(tpre, beam)
        jstate = jax.tree_util.tree_map(lambda a: jnp.repeat(a, beam, 0), jstate)
        tstate = {k: a.repeat_interleave(beam, 0) for k, a in tstate.items()}
        tokens = np.arange(B * beam, dtype=np.int32) % V
        for _ in range(3):
            jl, jstate, ja = jm.apply(v, tokens, jstate, jpre_x, method=jm.decoder_beam_step)
            tl, tstate, ta = tm.decoder_beam_step(_t(tokens).long(), tstate, tpre_x)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5)
            np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=1e-5)
            for k in ("qh", "qc", "lh", "lc"):
                np.testing.assert_allclose(tstate[k].numpy(), np.asarray(jstate[k]), atol=1e-5)
            jh, _, _ = jm.apply(v, tokens, jstate, jpre_x, method=jm.decoder_beam_step_hidden)
            th, _, _ = tm.decoder_beam_step_hidden(_t(tokens).long(), tstate, tpre_x)
            np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-5)
            tokens = np.asarray(jl).argmax(-1).astype(np.int32)
        jw, jb = jm.apply(v, method=jm.decoder_vocab_head)
        tw, tb = tm.decoder_vocab_head()
        np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))


def test_greedy_ids_match():
    jm, v, tm, frames, regions = _pair()
    jids, _, _, jalpha = jm.apply(v, frames, regions, None)
    with torch.no_grad():
        tids, _, _, talpha = tm(_t(frames), _t(regions))
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(talpha.numpy(), np.asarray(jalpha), atol=1e-5)


def test_bf16_compute_close():
    """compute_dtype=bfloat16 keeps the JAX dtype flow (bf16 Dense outputs,
    fp32-accumulated products, bf16 gate math): proposals and first-step
    logits stay within bf16 rounding of the JAX path (atol 5e-2; the two
    frameworks round bf16 at slightly different places)."""
    jm, v, tm, frames, regions = _pair(compute_dtype="bfloat16")
    jo, jmo = jm.apply(v, frames, regions, method=jm.encode)
    with torch.no_grad():
        to, tmo = tm.encode(_t(frames), _t(regions))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=5e-2)
    np.testing.assert_allclose(tmo.numpy(), np.asarray(jmo), atol=5e-2)
    jstate, jpre = jm.apply(v, jo, jmo, method=jm.decoder_init_beam_state)
    tokens = np.full((B,), 1, np.int32)
    jl, _, _ = jm.apply(v, tokens, jstate, jpre, method=jm.decoder_beam_step)
    with torch.no_grad():
        tstate, tpre = tm.decoder_init_beam_state(_t(jo), _t(jmo))
        tl, _, _ = tm.decoder_beam_step(_t(tokens).long(), tstate, tpre)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=5e-2)


def test_shared_layers_match():
    """AttentionShare (precompute + attend) and SelfAttention with a mask and
    the positional encoding, against the flax layers (fp32, atol 1e-5)."""
    from dlsg_tpu.models.layers import AttentionShare as JaxAttentionShare
    from dlsg_tpu.models.layers import SelfAttention as JaxSelfAttention
    from dlsg_tpu_torch.models.layers import AttentionShare, SelfAttention

    rng = np.random.default_rng(9)
    meta = rng.normal(size=(3, 5, 12)).astype(np.float32)
    hid = rng.normal(size=(3, 7)).astype(np.float32)
    jmod = JaxAttentionShare(12, 7, 10)
    p = jmod.init(jax.random.PRNGKey(0), meta, hid)["params"]
    jctx, jalpha = jmod.apply({"params": p}, meta, hid)
    tmod = AttentionShare(12, 7, 10)
    tmod.load_state_dict(params_from_jax(p))
    with torch.no_grad():
        tctx, talpha = tmod(_t(meta), _t(hid))
    np.testing.assert_allclose(tctx.numpy(), np.asarray(jctx), atol=1e-5)
    np.testing.assert_allclose(talpha.numpy(), np.asarray(jalpha), atol=1e-5)

    x = rng.normal(size=(2, 6, 8)).astype(np.float32)
    mask = (rng.random(size=(2, 6, 6)) > 0.3).astype(np.float32)
    jmod = JaxSelfAttention(8, 8, 5, get_pe=True)
    p = jmod.init(jax.random.PRNGKey(1), x, mask)["params"]
    want = jmod.apply({"params": p}, x, mask)
    tmod = SelfAttention(8, 8, 5, get_pe=True)
    tmod.load_state_dict(params_from_jax(p))
    with torch.no_grad():
        got = tmod(_t(x), _t(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
