"""Kimi-VL-A3B on the card: K1 at the model's head shapes, the model at its
published widths (one dense and two MoE layers, every expert and the whole
vocabulary, 2 frames) against the plain reference, and its beam decode with
the steps replayed from CUDA graphs against the same decode run eagerly.

Skipped without a CUDA device. The card's machine has no JAX, so this file
imports none and runs without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kimi_vl_cuda.py

Tolerances: K1 as in tests/test_torch_kernels_cuda.py (values atol 1e-4,
ids equal but at near-ties of 1e-4). The model runs in bf16, so it is held
to the precision it states: its logits' distance from the fp32 reference's
(relative Frobenius norm, and the first step's top-5 log-probabilities)
at most three times the distance of the reference itself computed with
bf16 products.
"""

import dataclasses

import numpy as np
import pytest
import torch

from dlsg_tpu_torch.kernels.vocab_head import ROUTE_LAUNCHES, vocab_head_topk, vocab_head_topk_plain
from dlsg_tpu_torch.models.kimi_vl_config import START_ID, KimiVLConfig
from portbench.reference import kimi_vl as ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("G", [32, 160])
def test_k1_bf16_at_the_vlm_head(card, G):
    H, V = 2048, 163840
    g = torch.Generator(device=card).manual_seed(G)
    h = torch.randn(G, H, device=card, generator=g).to(torch.bfloat16)
    w = (torch.randn(H, V, device=card, generator=g) * 0.02).to(torch.bfloat16)
    b = torch.zeros(V, device=card)
    before = ROUTE_LAUNCHES["wgmma"]
    vals, ids = vocab_head_topk(h, w, b, 5)
    torch.cuda.synchronize()
    assert ROUTE_LAUNCHES["wgmma"] == before + 1
    pv, pi = vocab_head_topk_plain(h, w, b, 5)
    torch.testing.assert_close(vals, pv, rtol=0, atol=1e-4)
    logits = h.float() @ w.float()
    gap = (logits.gather(1, ids) - logits.gather(1, pi)).abs()
    assert bool((gap[ids != pi] <= 1e-4).all())


def _published_widths():
    cfg = KimiVLConfig(num_hidden_layers=3, frames=2, prompt_ids=(11, 12, START_ID))
    c = dataclasses.asdict(cfg)
    return cfg, c


def _weights(c, card):
    g = torch.Generator(device=card).manual_seed(19)
    p = {}
    for k, s in ref.param_shapes(c).items():
        if k.endswith("norm.weight"):
            p[k] = torch.ones(s, device=card, dtype=torch.bfloat16)
        elif k.endswith("bias"):
            std = 1e-3 if "correction" in k else 0.0
            p[k] = (torch.randn(s, device=card, generator=g) * std).to(torch.bfloat16)
        else:
            p[k] = (torch.randn(s, device=card, generator=g) * 0.02).to(torch.bfloat16)
    return p


def _rel(a, b):
    return float((a - b).norm() / b.norm())


@torch.inference_mode()
def test_kimi_vl_at_published_widths_against_the_reference(card):
    """Prefill, then three decode steps through the latent cache, against
    the reference's full forward over the same tokens."""
    cfg, c = _published_widths()
    p = _weights(c, card)
    m = cfg.build_generator()
    m.load_state_dict(p)
    feats = torch.randn(2, *cfg.feature_shape, device=card, generator=torch.Generator(card).manual_seed(3))
    toks = torch.tensor([[START_ID, 500, 163000, 77], [START_ID, 9, 10, 11]], device=card)
    obj, _ = m.encode(feats)
    state, pre = m.decoder_init_beam_state(obj)
    got = []
    for t in range(toks.shape[1]):
        hid, state, _ = m.decoder_beam_step_hidden(toks[:, t], state, pre)
        got.append(hid.float() @ m.lm_head.float())
    got = torch.stack(got, 1)
    seq = torch.cat([torch.tensor([cfg.prompt_ids[:-1]] * 2, device=card), toks], 1)
    want = ref.forward(p, c, feats, seq, first=cfg.prefix_len)
    control = ref.forward(p, c, feats, seq, first=cfg.prefix_len, dtype=torch.bfloat16)
    err, err_control = _rel(got, want), _rel(control, want)
    vals, ids = vocab_head_topk(hid, *m.decoder_vocab_head(), 5)
    lp = torch.log_softmax(want[:, -1], -1)
    lp_control = torch.log_softmax(control[:, -1], -1)
    top = float((vals - lp.gather(1, ids)).abs().max())
    top_control = float((lp_control.gather(1, ids) - lp.gather(1, ids)).abs().max())
    print(f"logits rel err {err:.3e} (bf16 reference {err_control:.3e}); "
          f"top-5 log-prob gap {top:.3e} (bf16 reference {top_control:.3e})")
    assert err <= 3 * err_control and top <= 3 * max(top_control, 1e-3)
    assert np.isfinite(err)


@torch.inference_mode()
def test_graphed_beam_steps_equal_eager_ones(card):
    """Beam-5 decodes of 4 clips, 6 steps, twice with the steps' graphs
    (captured by the first) and once eagerly: token ids and scores bitwise.
    The suffix grows a token a step, so the beam makes no graph of its own
    (ops/beam_search.py)."""
    from dlsg_tpu_torch.config import DLSGConfig
    from dlsg_tpu_torch.evaluation.decode import _make_beam_from_feats

    cfg, c = _published_widths()
    m = cfg.build_generator()
    m.load_state_dict(_weights(c, card))
    dcfg = DLSGConfig(beam_size=5, max_words=6, use_fused_vocab_head="on")
    feats = torch.randn(4, *cfg.feature_shape, device=card, generator=torch.Generator(card).manual_seed(5))
    fn = _make_beam_from_feats(m, dcfg, 5)

    def decode():
        obj, _ = m.encode(feats)
        preds, lp, _, _ = fn(obj, None, 6)
        return preds, lp

    graphed = [decode(), decode()]
    assert len(m._graphs) == 6  # one a step, reused by the second decode
    assert fn.graphs.graphs == {}

    def eager_step(tokens, state, pre):
        hid, new = m._step(tokens, state["suffix"], pre["prefix"])
        return hid, {"suffix": new}, hid.new_zeros(hid.shape[0], 0)

    m.decoder_beam_step_hidden = eager_step
    eager = decode()
    for preds, lp in graphed:
        assert torch.equal(preds, eager[0]) and torch.equal(lp, eager[1])
