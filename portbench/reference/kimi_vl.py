"""Plain PyTorch reference of Kimi-VL-A3B as a captioner: Kimi-VL's
projector and the DeepSeek-V3 language model (MLA, sigmoid-routed MoE with
shared experts), its full forward pass over [visual tokens | prompt |
caption], and a beam-5 decode that recomputes that forward for every
hypothesis at every step.

This file is the benchmark's yardstick for the `kimi-vl-a3b`
configuration. It imports nothing of the measured package: it is a plain
rewrite of the published modelling code (moonshotai/Kimi-VL-A3B-Instruct,
`modeling_deepseek.py` and the multi-modal projector), with no cache, no
kernel and every routed expert run in its own loop, computed in float32
with TF32 off unless the caller asks for the control's lower precision
(`dtype`). Parameters come as a dict of tensors keyed by the measured
package's `state_dict` names (`param_shapes`; the routed experts' weights
stacked by expert, the head as [hidden, vocab]) and are upcast one layer at
a time, so the bf16 weights of the served model serve both sides. The
configuration is a dict of the published keys (`portbench/configs/
kimi-vl-a3b.json`).

Departures from the published model:
- the vision tower (MoonViT) is left out: its output, [frames, tokens, 2 x
  2 patches, 1152] a clip, is the input;
- the frames of a clip are encoded as separate images with no separator
  or placeholder tokens between them: the visual tokens are followed by the
  prompt alone;
- the vocabulary is synthetic (the benchmark's `inputs.vocab_words`), and
  the prompt's last id is its `<start>` (1), the beam's start token, and
  its `<end>` (2) ends a caption.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]
END_ID = 2


@contextlib.contextmanager
def fp32_products():
    """float32 products with TF32 off (the reference's own precision)."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def param_shapes(c: dict) -> Dict[str, tuple]:
    """Every parameter's shape by the measured package's name: Linear
    weights [out, in], the routed experts' gate and up rows stacked as
    `w13` [E, 2I, H] and their down projections as `w2` [E, H, I]."""
    H, V, h = c["hidden_size"], c["vocab_size"], c["num_attention_heads"]
    nope, rope, vd, r = c["qk_nope_head_dim"], c["qk_rope_head_dim"], c["v_head_dim"], c["kv_lora_rank"]
    vis = c["vision_hidden_size"] * c["merge_kernel_size"][0] * c["merge_kernel_size"][1]
    s: Dict[str, tuple] = {
        "projector.pre_norm.weight": (c["vision_hidden_size"],),
        "projector.pre_norm.bias": (c["vision_hidden_size"],),
        "projector.linear_1.weight": (vis, vis), "projector.linear_1.bias": (vis,),
        "projector.linear_2.weight": (H, vis), "projector.linear_2.bias": (H,),
        "embed_tokens.weight": (V, H),
    }

    def mlp(name, width):
        s.update({f"{name}.gate_proj.weight": (width, H), f"{name}.up_proj.weight": (width, H),
                  f"{name}.down_proj.weight": (H, width)})

    for i in range(c["num_hidden_layers"]):
        p = f"layers.{i}"
        s.update({f"{p}.input_layernorm.weight": (H,),
                  f"{p}.self_attn.q_proj.weight": (h * (nope + rope), H),
                  f"{p}.self_attn.kv_a_proj_with_mqa.weight": (r + rope, H),
                  f"{p}.self_attn.kv_a_layernorm.weight": (r,),
                  f"{p}.self_attn.kv_b_proj.weight": (h * (nope + vd), r),
                  f"{p}.self_attn.o_proj.weight": (H, h * vd),
                  f"{p}.post_attention_layernorm.weight": (H,)})
        if i < c["first_k_dense_replace"]:
            mlp(f"{p}.mlp", c["intermediate_size"])
        else:
            E, I = c["n_routed_experts"], c["moe_intermediate_size"]
            s.update({f"{p}.mlp.gate.weight": (E, H), f"{p}.mlp.gate.e_score_correction_bias": (E,),
                      f"{p}.mlp.experts.w13": (E, 2 * I, H), f"{p}.mlp.experts.w2": (E, H, I)})
            mlp(f"{p}.mlp.shared_experts", c["n_shared_experts"] * I)
    s["norm.weight"] = (H,)
    s["lm_head"] = (H, V)
    return s


# ---------------------------------------------------------------- blocks


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    x32 = x.float()
    return w * (x32 * torch.rsqrt(x32.pow(2).mean(-1, keepdim=True) + eps)).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """DeepSeek-V3's rotary embedding of x [..., S, d] at `positions` [S]:
    q.view(d/2, 2).transpose, then x cos + rotate_half(x) sin."""
    d = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, d, 2, device=x.device).float() / d))
    freqs = torch.outer(positions.float(), inv)
    emb = torch.cat([freqs, freqs], -1)
    cos, sin = emb.cos().to(x.dtype), emb.sin().to(x.dtype)
    x = x.reshape(*x.shape[:-1], d // 2, 2).transpose(-1, -2).reshape(x.shape)
    half = torch.cat([-x[..., d // 2:], x[..., : d // 2]], -1)
    return x * cos + half * sin


def latent(p: Params, c: dict, x: torch.Tensor, pre: str, positions: torch.Tensor) -> torch.Tensor:
    """MLA's compressed key and value of x [S, H] at `positions` [S]:
    c_kv normed by `kv_a_layernorm`, then k_pe rotated, [S, rank + rope]
    (what a decoder's latent cache holds)."""
    r = c["kv_lora_rank"]
    ckv = x @ p[f"{pre}.kv_a_proj_with_mqa.weight"].t()
    return torch.cat([rms_norm(ckv[:, :r], p[f"{pre}.kv_a_layernorm.weight"], c["rms_norm_eps"]),
                      rope(ckv[None, :, r:], positions, c["rope_theta"])[0]], -1)


def attention(p: Params, c: dict, x: torch.Tensor, pre: str) -> torch.Tensor:
    """MLA of one clip's x [S, H], K and V decompressed, causal."""
    S = x.shape[0]
    h, nope, rp, vd, r = (c["num_attention_heads"], c["qk_nope_head_dim"], c["qk_rope_head_dim"],
                          c["v_head_dim"], c["kv_lora_rank"])
    pos = torch.arange(S, device=x.device)
    q = (x @ p[f"{pre}.q_proj.weight"].t()).view(S, h, nope + rp).transpose(0, 1)
    q_nope, q_pe = q[..., :nope], q[..., nope:]
    lat = latent(p, c, x, pre, pos)
    kv = (lat[:, :r] @ p[f"{pre}.kv_b_proj.weight"].t()).view(S, h, nope + vd).transpose(0, 1)
    k_nope, v = kv[..., :nope], kv[..., nope:]
    q_pe, k_pe = rope(q_pe, pos, c["rope_theta"]), lat[None, :, r:]
    q = torch.cat([q_nope, q_pe], -1)
    k = torch.cat([k_nope, k_pe.expand(h, S, rp)], -1)
    scores = (q @ k.transpose(1, 2)) * (nope + rp) ** -0.5
    scores = scores.masked_fill(torch.ones(S, S, dtype=torch.bool, device=x.device).triu(1), -torch.inf)
    probs = torch.softmax(scores, -1, dtype=torch.float32).to(x.dtype)
    o = (probs @ v).transpose(0, 1).reshape(S, h * vd)
    return o @ p[f"{pre}.o_proj.weight"].t()


def mlp(p: Params, pre: str, x: torch.Tensor) -> torch.Tensor:
    g = x @ p[f"{pre}.gate_proj.weight"].t()
    return (F.silu(g) * (x @ p[f"{pre}.up_proj.weight"].t())) @ p[f"{pre}.down_proj.weight"].t()


def route(p: Params, c: dict, pre: str, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """noaux_tc with one group: the experts [N, k] with the best sigmoid
    score plus the correction bias, weighted by their uncorrected scores,
    normalised and scaled (fp32)."""
    scores = torch.sigmoid(x.float() @ p[f"{pre}.gate.weight"].float().t())
    biased = scores + p[f"{pre}.gate.e_score_correction_bias"].float()[None]
    idx = torch.topk(biased, c["num_experts_per_tok"], dim=-1).indices
    w = scores.gather(1, idx)
    if c["norm_topk_prob"] and c["num_experts_per_tok"] > 1:
        w = w / (w.sum(-1, keepdim=True) + 1e-20)
    return idx, w * c["routed_scaling_factor"]


def moe(p: Params, c: dict, pre: str, x: torch.Tensor,
        routes: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
    """The routed experts, each in its own loop over the tokens that chose
    it, plus the shared experts; `routes` collects the chosen experts."""
    idx, w = route(p, c, pre, x)
    if routes is not None:
        routes.append(idx)
    I = c["moe_intermediate_size"]
    y = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    w13, w2 = p[f"{pre}.experts.w13"], p[f"{pre}.experts.w2"]
    for e in range(c["n_routed_experts"]):
        rows, slot = (idx == e).nonzero(as_tuple=True)
        if len(rows) == 0:
            continue
        xe = x[rows]
        h = xe @ w13[e].t()
        out = (F.silu(h[:, :I]) * h[:, I:]) @ w2[e].t()
        y.index_add_(0, rows, out.float() * w[rows, slot][:, None])
    return y.to(x.dtype) + mlp(p, f"{pre}.shared_experts", x)


def project(p: Params, c: dict, feats: torch.Tensor) -> torch.Tensor:
    """Kimi-VL's projector: feats [n, frames, tokens, merge, vision] ->
    [n, frames x tokens, H]."""
    n = feats.shape[0]
    x = F.layer_norm(feats, (c["vision_hidden_size"],), p["projector.pre_norm.weight"],
                     p["projector.pre_norm.bias"], 1e-5)
    x = x.reshape(n, -1, x.shape[-2] * x.shape[-1])
    x = F.gelu(x @ p["projector.linear_1.weight"].t() + p["projector.linear_1.bias"])
    return x @ p["projector.linear_2.weight"].t() + p["projector.linear_2.bias"]


def _cast(p: Params, prefix: str, dtype: torch.dtype) -> Params:
    return {k: v.to(dtype) for k, v in p.items() if k.startswith(prefix)}


def forward(p: Params, c: dict, feats: torch.Tensor, tokens: torch.Tensor, first: int = 0,
            dtype: torch.dtype = torch.float32,
            routes: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
    """fp32 logits [n, L - first, V] of the sequences [visual tokens of
    feats [n, ...] | tokens [n, T]] (L their length) at positions first..L-1,
    in blocks: each layer's weights upcast once, attention one clip at a
    time. `dtype` is the products' precision (the control: bfloat16);
    `routes` collects each MoE layer's chosen experts [n x L, k]."""
    with fp32_products():
        pj = _cast(p, "projector.", dtype)
        x = torch.cat([project(pj, c, feats.to(dtype)),
                       p["embed_tokens.weight"][tokens].to(dtype)], 1)
        del pj
        n, L, H = x.shape
        eps = c["rms_norm_eps"]
        for i in range(c["num_hidden_layers"]):
            pre = f"layers.{i}"
            pl = _cast(p, f"{pre}.", dtype)
            hn = rms_norm(x, pl[f"{pre}.input_layernorm.weight"], eps)
            x = x + torch.stack([attention(pl, c, hn[j], f"{pre}.self_attn") for j in range(n)])
            hn = rms_norm(x, pl[f"{pre}.post_attention_layernorm.weight"], eps).reshape(n * L, H)
            if i < c["first_k_dense_replace"]:
                x = x + mlp(pl, f"{pre}.mlp", hn).view(n, L, H)
            else:
                x = x + moe(pl, c, f"{pre}.mlp", hn, routes).view(n, L, H)
            del pl, hn
        h = rms_norm(x[:, first:], p["norm.weight"].to(dtype), eps)
        return (h @ p["lm_head"].to(dtype)).float()


def first_layer_latents(p: Params, c: dict, tokens: torch.Tensor, first: int,
                        dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The first layer's cache entries [n, T, rank + rope] of the token ids
    [n, T] at positions first..first+T-1: a token's entries there depend on
    its embedding and its position alone, not on the tokens before it."""
    with fp32_products():
        pl = _cast(p, "layers.0.", dtype)
        x = rms_norm(p["embed_tokens.weight"][tokens].to(dtype), pl["layers.0.input_layernorm.weight"],
                     c["rms_norm_eps"])
        pos = torch.arange(first, first + tokens.shape[1], device=tokens.device)
        return torch.stack([latent(pl, c, row, "layers.0.self_attn", pos) for row in x]).float()


def _top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest along the last axis, descending, ties to the lowest
    index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def beam_decode(p: Params, c: dict, feats: torch.Tensor, beam: int, max_words: int) -> torch.Tensor:
    """The best beam's ids [n, max_words] of each clip: beam search over
    log-softmax scores, AllenNLP's semantics (first-step top-`beam`, `beam`
    candidates a hypothesis, a finished hypothesis extends only with
    `<end>` at no cost, every hypothesis ended -> `<end>` to the last step),
    each hypothesis' next distribution from the full forward over its own
    copy of the prefix. For small sizes (the CPU tests)."""
    prompt = list(c["prompt_ids"])
    first = feats.shape[1] * feats.shape[2] + len(prompt) - 1
    out = []
    for f in feats.split(1):

        def log_probs(seqs):
            rows = [forward(p, c, f, torch.tensor([prompt + s], device=f.device), first + len(s))[0, 0]
                    for s in seqs]
            return torch.log_softmax(torch.stack(rows), -1)

        vals, ids = _top_k(log_probs([[]])[0], beam)
        seqs, scores = [[int(t)] for t in ids], vals
        for _ in range(max_words - 1):
            live = [s for s in seqs if s[-1] != END_ID]
            if not live:
                seqs = [s + [END_ID] for s in seqs]
                continue
            lp = iter(log_probs(live))
            cand_v = torch.full((beam, beam), -torch.inf, device=f.device)
            cand_i = torch.full((beam, beam), END_ID, dtype=torch.int64, device=f.device)
            for j, s in enumerate(seqs):
                if s[-1] == END_ID:
                    cand_v[j, 0] = 0.0
                else:
                    cand_v[j], cand_i[j] = _top_k(next(lp), beam)
            scores, pos = _top_k((cand_v + scores[:, None]).flatten(), beam)
            seqs = [seqs[int(q) // beam] + [int(cand_i.flatten()[q])] for q in pos]
        out.append(seqs[0])
    return torch.tensor(out)
