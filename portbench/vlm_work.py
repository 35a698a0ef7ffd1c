"""Model FLOPs of the Kimi-VL captioner (`portbench/configs/kimi-vl-a3b.json`):
the projector and prefill of a clip's prefix, and each beam step of a
hypothesis, from the shapes alone, counted once whatever implements them.

A product of M x K by K x N counts 2 M K N. A token's products: the
attention projections (q, the latent and its decompression, the output), its
MLP (the dense one, or the router, its experts per token and the shared
experts), and attention over the tokens it sees, 2 x heads x (qk + v
dims) a key, the least any form of MLA needs (the absorbed decode reads a
wider key, the cache, and earns no more); a causal prefill sees S (S + 1)
/ 2 keys in all. A beam step adds the head's 2 H V. Element-wise work is
left out. The card's peak is `work.PEAK_FLOPS`.
"""

from __future__ import annotations

from typing import Sequence


def _dims(c: dict):
    h = c["num_attention_heads"]
    qk = c["qk_nope_head_dim"] + c["qk_rope_head_dim"]
    return c["hidden_size"], h, qk, c["v_head_dim"], c["kv_lora_rank"]


def token_flops(c: dict) -> float:
    """One token through every layer, attention over its keys left out."""
    H, h, qk, vd, r = _dims(c)
    attn = 2 * H * (h * qk + r + c["qk_rope_head_dim"]) + 2 * r * h * (c["qk_nope_head_dim"] + vd) \
        + 2 * h * vd * H
    dense = 3 * 2 * H * c["intermediate_size"]
    I = c["moe_intermediate_size"]
    moe = 2 * H * c["n_routed_experts"] + (c["num_experts_per_tok"] + c["n_shared_experts"]) * 3 * 2 * H * I
    n_dense = c["first_k_dense_replace"]
    return c["num_hidden_layers"] * attn + n_dense * dense + (c["num_hidden_layers"] - n_dense) * moe


def key_flops(c: dict) -> float:
    """Attention of one query over one key, in every layer."""
    _, h, qk, vd, _ = _dims(c)
    return c["num_hidden_layers"] * 2 * h * (qk + vd)


def project_flops(c: dict, visual_tokens: int) -> float:
    width = c["vision_hidden_size"] * c["merge_kernel_size"][0] * c["merge_kernel_size"][1]
    return visual_tokens * (2 * width * width + 2 * width * c["hidden_size"])


def prefill_flops(c: dict, visual_tokens: int, prefix: int) -> float:
    """One clip: the projector and the prefix's prefill, causal."""
    return (project_flops(c, visual_tokens) + prefix * token_flops(c)
            + key_flops(c) * prefix * (prefix + 1) / 2)


def step_flops(c: dict, keys: int) -> float:
    """One hypothesis' beam step seeing `keys` tokens, the head included."""
    return token_flops(c) + key_flops(c) * keys + 2 * c["hidden_size"] * c["vocab_size"]


def decode_flops(c: dict, visual_tokens: int, prefix: int, words: Sequence[int], beam: int,
                 max_words: int) -> float:
    """Model FLOPs of the beam decodes whose best captions have `words`
    words each (without `<end>`): each clip's projector and prefill, then
    its first step on one hypothesis and each later one on `beam`, up to its
    caption's `<end>`."""
    total = len(words) * prefill_flops(c, visual_tokens, prefix)
    for w in words:
        total += step_flops(c, prefix + 1)
        total += beam * sum(step_flops(c, prefix + 1 + t) for t in range(1, min(w, max_words - 1) + 1))
    return total
