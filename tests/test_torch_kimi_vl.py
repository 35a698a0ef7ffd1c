"""Kimi-VL-A3B on the port's beam path (models/kimi_vl.py) against the plain
reference (portbench/reference/kimi_vl.py) at a tiny config on the CPU:
prefill logits and each decode step through the latent cache against the
reference's full forward, the absorbed decode attention against the
decompressed one on one cache, the router, a beam-5 `Captioner` decode
with one prefix cache per clip against the reference's beam search over
per-hypothesis copies, the counters, and the imports.
"""

import dataclasses
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dlsg_tpu_torch.config import DLSGConfig
from dlsg_tpu_torch.models import kimi_vl
from dlsg_tpu_torch.models.kimi_vl_config import KimiVLConfig, tiny_kimi_vl_config
from dlsg_tpu_torch.serve import Captioner
from dlsg_tpu_torch.utils import profiler
from dlsg_tpu_torch.vocab import START_ID, Vocabulary
from portbench import harness
from portbench.reference import kimi_vl as ref

CFG = tiny_kimi_vl_config()
C = dataclasses.asdict(CFG)
B = 2


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    profiler.reset_counters()
    yield
    profiler.reset_counters()
    torch.set_num_threads(n)


def tiny_params(seed: int = 0, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    p = {}
    for k, s in ref.param_shapes(C).items():
        if k.endswith("norm.weight"):
            p[k] = torch.ones(s)
        elif k.endswith(("bias",)):
            std = 1e-3 if "correction" in k else 0.0
            p[k] = torch.randn(s, generator=g) * std
        else:
            p[k] = torch.randn(s, generator=g) * 0.15
    return {k: v.to(dtype) for k, v in p.items()}


def tiny_model(params):
    m = CFG.build_generator()
    m.load_state_dict(params)
    return m.eval()


def feats(seed: int = 1, n: int = B):
    g = torch.Generator().manual_seed(seed)
    return torch.randn((n, *CFG.feature_shape), generator=g)


def test_state_dict_is_the_references_layout():
    m = tiny_model(tiny_params())
    assert {k: tuple(v.shape) for k, v in m.state_dict().items()} == ref.param_shapes(C)


@torch.inference_mode()
def test_prefill_logits_match_the_full_forward():
    p = tiny_params()
    m, f = tiny_model(p), feats()
    cache, hid = m.prefill(m.embed(f), hidden=True)
    got = hid.float() @ m.lm_head.float()
    prompt = torch.tensor([CFG.prompt_ids[:-1]] * B)
    want = ref.forward(p, C, f, prompt)
    torch.testing.assert_close(got, want, atol=2e-4, rtol=2e-4)
    assert cache.shape == (CFG.num_hidden_layers, B, CFG.prefix_len, CFG.cache_width)


@torch.inference_mode()
def test_each_decode_step_through_the_cache_matches_the_full_forward():
    p = tiny_params()
    m, f = tiny_model(p), feats()
    obj, _ = m.encode(f)
    state, pre = m.decoder_init_beam_state(obj)
    toks = torch.tensor([[START_ID, 17, 250, 3, 99], [START_ID, 5, 6, 7, 8]])
    for t in range(toks.shape[1]):
        hid, state, aux = m.decoder_beam_step_hidden(toks[:, t], state, pre)
        assert state["suffix"].shape == (B, CFG.num_hidden_layers, t + 1, CFG.cache_width)
        assert aux.shape == (B, 0)
        seq = torch.cat([torch.tensor([CFG.prompt_ids[:-1]] * B), toks[:, : t + 1]], 1)
        want = ref.forward(p, C, f, seq, first=CFG.prefix_len + t)[:, 0]
        torch.testing.assert_close(hid.float() @ m.lm_head.float(), want, atol=2e-4, rtol=2e-4)


@torch.inference_mode()
def test_absorbed_attention_equals_decompressed_on_one_cache():
    """One query against a cache of S + 1 entries: W_UK absorbed into the
    query and W_UV applied after the sum, against K and V decompressed from
    the same entries."""
    torch.manual_seed(3)
    mla = tiny_model(tiny_params()).layers[1].self_attn
    S, h, nope, vd, r = 7, CFG.num_attention_heads, CFG.qk_nope_head_dim, CFG.v_head_dim, CFG.kv_lora_rank
    x = torch.randn(1, S + 1, CFG.hidden_size)
    cos, sin = kimi_vl.rope_tables(torch.arange(S + 1), CFG.qk_rope_head_dim, CFG.rope_theta, x.dtype)
    lat = mla.latent(x, cos, sin)[0]  # [S + 1, W]
    got, suffix = mla.decode(x[:, S], cos[S:], sin[S:], lat[None, :S], lat.new_empty(1, 0, lat.shape[1]))
    torch.testing.assert_close(suffix[0, 0], lat[S])
    q_nope, q_pe = mla._queries(x[0, S:], cos[S:], sin[S:])  # [1, h, .]
    k_nope, v = mla.kv_b_proj(lat[:, :r]).view(S + 1, h, nope + vd).split([nope, vd], -1)
    k = torch.cat([k_nope, lat[:, None, r:].expand(S + 1, h, -1)], -1)
    q = torch.cat([q_nope, q_pe], -1)[0]
    probs = torch.softmax(torch.einsum("hd,shd->hs", q, k) * mla.scale, -1)
    want = mla.o_proj(torch.einsum("hs,shd->hd", probs, v).reshape(1, h * vd))
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("biased", [False, True])
def test_router_picks_by_corrected_score_and_weighs_by_the_raw_one(biased):
    scores = torch.tensor([[0.9, 0.8, 0.3, 0.1, 0.6, 0.2, 0.05, 0.4]])
    logits = torch.logit(scores)
    bias = torch.zeros(8)
    if biased:
        bias[2] = 0.45  # 0.3 + 0.45 passes 0.6 + 0 and 0.8: picked, at its raw score
    idx, w = kimi_vl.route(logits, bias, 3, 2.446, True)
    order = torch.argsort(idx[0])
    ids, w = idx[0, order], w[0, order]
    want_ids = [0, 1, 2] if biased else [0, 1, 4]
    raw = scores[0, want_ids]
    assert ids.tolist() == want_ids
    torch.testing.assert_close(w, raw / raw.sum() * 2.446)
    r_idx, r_w = ref.route({"l.gate.weight": torch.eye(8), "l.gate.e_score_correction_bias": bias},
                           {**C, "num_experts_per_tok": 3}, "l", logits)
    assert sorted(r_idx[0].tolist()) == want_ids
    torch.testing.assert_close(r_w[0, torch.argsort(r_idx[0])], w)


def _captioner(params, **cfg):
    dcfg = DLSGConfig(beam_size=5, test_batch_size=4, max_words=6, use_fused_vocab_head="on", **cfg)
    vocab = Vocabulary.from_idx2word([f"w{i}" for i in range(CFG.vocab_size)])
    return Captioner.from_params(dcfg, vocab, params, device="cpu", arch=CFG), vocab


@torch.inference_mode()
def test_beam5_captioner_with_one_prefix_per_clip_matches_the_per_hypothesis_reference(monkeypatch):
    p = tiny_params()
    cap, vocab = _captioner(p)
    shapes = []
    init = kimi_vl.KimiVLGenerator.decoder_init_beam_state

    def recorded(self, obj, mot=None):
        state, pre = init(self, obj, mot)
        shapes.append((tuple(pre["prefix"].shape), tuple(state["suffix"].shape)))
        return state, pre

    monkeypatch.setattr(kimi_vl.KimiVLGenerator, "decoder_init_beam_state", recorded)
    f = feats(n=3)
    got = cap.caption(f.numpy(), None)
    # three clips in a bucket of 4: the prefix once per clip, never per beam
    L, S, W = CFG.num_hidden_layers, CFG.prefix_len, CFG.cache_width
    assert shapes == [((L, 4, S, W), (4, L, 0, W))]
    want = ref.beam_decode(p, C, f, 5, 6)
    assert got == [vocab.decode_tokens(t) for t in want.tolist()]


@torch.inference_mode()
def test_bf16_first_step_is_near_the_fp32_reference():
    """The served precision: bf16 weights and activations, the head through
    K1's plain version; its top-5 normalised values against the
    reference's log-softmax at the same ids."""
    from dlsg_tpu_torch.kernels.vocab_head import vocab_head_topk

    p = tiny_params(dtype=torch.bfloat16)
    m, f = tiny_model(p), feats()
    state, pre = m.decoder_init_beam_state(m.encode(f)[0])
    hid, _, _ = m.decoder_beam_step_hidden(torch.full((B,), START_ID), state, pre)
    assert hid.dtype == torch.bfloat16
    vals, ids = vocab_head_topk(hid, *m.decoder_vocab_head(), 5)
    seq = torch.tensor([CFG.prompt_ids] * B)
    lp = torch.log_softmax(ref.forward(p, C, f, seq, first=CFG.prefix_len)[:, 0], -1)
    gap = (vals - lp.gather(1, ids)).abs().max().item()
    assert 0 < gap < 0.1, gap


@torch.inference_mode()
def test_counters_under_a_trace_and_the_peak_load_metric():
    cap, _ = _captioner(tiny_params())
    f = feats(n=3).numpy()
    cap.caption(f, None)  # untraced: nothing counted
    assert profiler.counters() == {}
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    cap.caption(f, None)
    prof.stop()
    c = profiler.counters()
    n_moe = CFG.num_hidden_layers - CFG.first_k_dense_replace
    k, E, G = CFG.num_experts_per_tok, CFG.n_routed_experts, 4 * 5
    steps = c["beam.hyp_steps"] // G  # the beam steps after the first
    tokens = 4 * CFG.prefix_len + 4 + steps * G
    assert c["moe.assignments"] == tokens * k * n_moe
    assert c["moe.assignments"] <= c["moe.busiest"] <= c["moe.assignments"] * E / k
    names = {e.name for e in prof.events()}
    assert {"dlsg.vlm.project", "dlsg.vlm.prefill"} <= names
    entry = harness.load_json("metrics", "moe_peak_load.vlm.json")
    value = harness.load_module("readers", entry["reader"]).read({}, **entry["args"])
    assert value == pytest.approx(100 * c["moe.busiest"] / c["moe.assignments"])


def test_kimi_vl_config_takes_the_published_keys_and_checks_the_prompt():
    cfg = KimiVLConfig.from_dict({"hidden_size": 2048, "merge_kernel_size": [2, 2], "unknown": 1,
                                  "prompt_ids": [5, START_ID]})
    assert cfg.merge == 4 and cfg.feature_shape == (26, 99, 4, 1152) and cfg.prefix_len == 2575
    with pytest.raises(ValueError):
        KimiVLConfig(prompt_ids=(START_ID, 5))
    with pytest.raises(NotImplementedError):
        KimiVLConfig(q_lora_rank=1536)


@pytest.mark.parametrize("module, absent", [
    ("portbench.reference.kimi_vl", ("jax", "dlsg_tpu", "dlsg_tpu_torch")),
    ("dlsg_tpu_torch.serve", ("dlsg_tpu_torch.models.kimi_vl",)),
    ("dlsg_tpu_torch.evaluation.decode", ("dlsg_tpu_torch.models.kimi_vl",)),
])
def test_imports_leave_out(module, absent):
    code = (f"import sys, {module}; "
            f"print(sorted(m for m in sys.modules if m in {absent!r} or m.split('.')[0] in {absent!r}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
                         cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"


def test_tiny_config_keeps_every_kind_of_layer():
    assert CFG.first_k_dense_replace == 1 and CFG.num_hidden_layers - 1 >= 2
    assert isinstance(tiny_model(tiny_params()).layers[0].mlp, kimi_vl.MLP)
    assert all(isinstance(layer.mlp, kimi_vl.MoE) for layer in tiny_model(tiny_params()).layers[1:])
    assert np.prod(CFG.feature_shape) == 3 * 5 * 4 * 12
