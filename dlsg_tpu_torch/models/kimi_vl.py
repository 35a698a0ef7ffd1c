"""Kimi-VL-A3B as a video captioner on the port's beam path.

The language model is DeepSeek-V3's block at Kimi-VL-A3B's widths
(`KimiVLConfig`, models/kimi_vl_config.py), after the published modelling
code:

- RMSNorm with fp32 statistics (`F.rms_norm`); rotary embeddings on the 64 rope channels
  of each query and of the one shared key, pairs (2i, 2i+1) laid out as
  halves before `rotate_half`, cos and sin in the activations' dtype.
- MLA without query compression: `kv_a_proj_with_mqa` gives the latent
  c_kv (normed by `kv_a_layernorm`) and k_pe; `kv_b_proj` maps c_kv to each
  head's k_nope and v. The prefill decompresses K and V and runs
  `scaled_dot_product_attention`, causal. A decode step absorbs W_UK into
  the query and W_UV after the weighted sum, so it attends over the cache
  itself: c_kv and k_pe, `cache_width` values a token and layer.
- A dense MLP in the first `first_k_dense_replace` layers, then MoE:
  router logits in fp32, sigmoid scores, the experts chosen by the top-k of
  the scores plus a per-expert correction bias, weighted by their own
  scores normalised to sum 1 and scaled (noaux_tc with one group: no group
  limit, no token dropped). The routed experts run as grouped products over
  the experts' contiguous blocks of the sorted assignments; the shared
  experts are one MLP of n_shared x the expert width, added.
- Kimi-VL's projector over MoonViT's merged tokens: LayerNorm on each
  patch, the patches of a token concatenated, Linear, exact GELU, Linear.
  The visual tokens come first, then the prompt.

`KimiVLGenerator` gives `evaluation/decode.py` what it calls on a
generator. `encode` projects a clip and prefills the visual tokens and the
prompt but its last token, writing the latent cache once per clip. That
cache is the beam step's invariant (`pre`), which `expand_pre_to_beams`
leaves as it is: the hypotheses of a clip (clip-major, G = B x beam) read
their clip's cache through one batched product per clip. The beam state
that `ops/beam_search.py` gathers by backpointers is each hypothesis' own
suffix of the cache, its caption tokens so far. The prompt's last token is
`<start>`, the beam's start token.

Weights and activations take the weights' dtype (bf16 when served). The
module is built on the meta device (`on_meta`) and takes its tensors from
`load_state_dict`, never drawn on the host.

While a trace runs, `encode`'s phases are the spans `dlsg.vlm.project` and
`dlsg.vlm.prefill`; each MoE call run eagerly (the prefill's: a card's
beam steps are graph replays) adds its token-expert assignments to the
counter `moe.assignments` and n_routed_experts x its busiest expert's
assignments to `moe.busiest`, summed on the device until
`utils/profiler.py::flush_device_counts`.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from dlsg_tpu_torch.kernels.vocab_head import prepare_head
from dlsg_tpu_torch.models.kimi_vl_config import KimiVLConfig
from dlsg_tpu_torch.utils.profiler import count, count_device, span

PREFILL_ROWS = 32768  # token rows a prefill MLP or MoE call takes at once


class RMSNorm(nn.Module):
    """`F.rms_norm`: statistics in fp32 whatever x's dtype."""

    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(dim))
        self.eps = eps

    def forward(self, x):
        return F.rms_norm(x, self.weight.shape, self.weight, self.eps)


def rope_tables(positions: torch.Tensor, dim: int, theta: float,
                dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos and sin [P, dim] at `positions` [P], computed in fp32."""
    inv = 1.0 / theta ** (torch.arange(0, dim, 2, device=positions.device).float() / dim)
    freqs = positions.float()[:, None] * inv[None, :]
    emb = torch.cat([freqs, freqs], -1)
    return emb.cos().to(dtype), emb.sin().to(dtype)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [..., dim] rotated: its pairs (2i, 2i+1) laid out as halves, then
    x cos + rotate_half(x) sin (cos and sin broadcast against x)."""
    d = x.shape[-1]
    x = x.unflatten(-1, (d // 2, 2)).transpose(-1, -2).flatten(-2)
    return x * cos + torch.cat([-x[..., d // 2:], x[..., : d // 2]], -1) * sin


def attend_absorbed(q: torch.Tensor, prefix: torch.Tensor, suffix: torch.Tensor, rank: int,
                    scale: float) -> torch.Tensor:
    """Absorbed attention of q [G, h, W] (each head's latent query and its
    rotated q_pe) over its clip's prefix [B, S, W], shared by the G / B
    hypotheses of a clip, and over its own suffix [G, t, W]: the weighted
    sum of c_kv [G, h, rank]. Scores in the cache's dtype, softmax in fp32."""
    G, h, _ = q.shape
    B, S, _ = prefix.shape
    per_clip = q.reshape(B, G // B * h, -1)
    scores = torch.cat([torch.bmm(per_clip, prefix.transpose(1, 2)).view(G, h, S),
                        torch.bmm(q, suffix.transpose(1, 2))], -1)
    p = torch.softmax(scores.float() * scale, -1).to(q.dtype)
    out = torch.bmm(p[..., :S].reshape(B, G // B * h, S), prefix[..., :rank]).view(G, h, rank)
    return out + torch.bmm(p[..., S:], suffix[..., :rank])


class MLA(nn.Module):
    def __init__(self, c: KimiVLConfig):
        super().__init__()
        self.c = c
        h = c.num_attention_heads
        self.q_proj = nn.Linear(c.hidden_size, h * c.qk_head_dim, bias=False)
        self.kv_a_proj_with_mqa = nn.Linear(c.hidden_size, c.cache_width, bias=False)
        self.kv_a_layernorm = RMSNorm(c.kv_lora_rank, c.rms_norm_eps)
        self.kv_b_proj = nn.Linear(c.kv_lora_rank, h * (c.qk_nope_head_dim + c.v_head_dim),
                                   bias=False)
        self.o_proj = nn.Linear(h * c.v_head_dim, c.hidden_size, bias=False)
        self.scale = c.qk_head_dim ** -0.5

    def _queries(self, x, cos, sin):
        c = self.c
        q = self.q_proj(x).unflatten(-1, (c.num_attention_heads, c.qk_head_dim))
        q_nope, q_pe = q.split([c.qk_nope_head_dim, c.qk_rope_head_dim], -1)
        return q_nope, apply_rope(q_pe, cos.unsqueeze(-2), sin.unsqueeze(-2))

    def latent(self, x, cos, sin):
        """x's cache entries [..., cache_width]: c_kv normed, k_pe rotated."""
        c_kv, k_pe = self.kv_a_proj_with_mqa(x).split([self.c.kv_lora_rank, self.c.qk_rope_head_dim], -1)
        return torch.cat([self.kv_a_layernorm(c_kv), apply_rope(k_pe, cos, sin)], -1)

    def prefill(self, x, cos, sin):
        """x [B, S, H] at positions 0..S-1 (cos, sin [S, rope]): the output
        and the cache entries [B, S, cache_width]."""
        c = self.c
        B, S, _ = x.shape
        h, nope, rope, vd = c.num_attention_heads, c.qk_nope_head_dim, c.qk_rope_head_dim, c.v_head_dim
        q_nope, q_pe = self._queries(x, cos, sin)
        lat = self.latent(x, cos, sin)
        k_nope, v = self.kv_b_proj(lat[..., : c.kv_lora_rank]).view(B, S, h, nope + vd).split([nope, vd], -1)
        k_pe = lat[..., c.kv_lora_rank:, None].transpose(-1, -2).expand(B, S, h, rope)
        o = F.scaled_dot_product_attention(
            torch.cat([q_nope, q_pe], -1).transpose(1, 2), torch.cat([k_nope, k_pe], -1).transpose(1, 2),
            v.transpose(1, 2), is_causal=True, scale=self.scale)
        return self.o_proj(o.transpose(1, 2).reshape(B, S, h * vd)), lat

    def decode(self, x, cos, sin, prefix, suffix):
        """x [G, H], one token of each hypothesis at one position (cos, sin
        [1, rope]), against its clip's prefix [B, S, W] and its suffix [G, t,
        W]: the output and the suffix with this token [G, t + 1, W]."""
        c = self.c
        G = x.shape[0]
        h, nope, vd = c.num_attention_heads, c.qk_nope_head_dim, c.v_head_dim
        q_nope, q_pe = self._queries(x, cos, sin)
        suffix = torch.cat([suffix, self.latent(x, cos, sin)[:, None]], 1)
        w = self.kv_b_proj.weight.view(h, nope + vd, c.kv_lora_rank)
        q_lat = torch.bmm(q_nope.transpose(0, 1), w[:, :nope]).transpose(0, 1)
        o_lat = attend_absorbed(torch.cat([q_lat, q_pe], -1), prefix, suffix, c.kv_lora_rank, self.scale)
        o = torch.bmm(o_lat.transpose(0, 1), w[:, nope:].transpose(1, 2))  # [h, G, vd]
        return self.o_proj(o.transpose(0, 1).reshape(G, h * vd)), suffix


class MLP(nn.Module):
    def __init__(self, hidden: int, width: int):
        super().__init__()
        self.gate_proj = nn.Linear(hidden, width, bias=False)
        self.up_proj = nn.Linear(hidden, width, bias=False)
        self.down_proj = nn.Linear(width, hidden, bias=False)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


def route(logits: torch.Tensor, bias: torch.Tensor, k: int, scaling: float,
          norm: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """noaux_tc routing of fp32 logits [N, E]: the experts [N, k] with the
    highest sigmoid score plus `bias`, and their weights [N, k] (fp32): the
    chosen uncorrected scores, normalised to sum 1 with `norm`, times
    `scaling`."""
    scores = logits.sigmoid()
    idx = torch.topk(scores + bias.float(), k, dim=-1, sorted=False)[1]
    w = scores.gather(1, idx)
    if norm and k > 1:
        w = w / (w.sum(-1, keepdim=True) + 1e-20)
    return idx, w * scaling


def expert_mm(x: torch.Tensor, w: torch.Tensor, offs: torch.Tensor) -> torch.Tensor:
    """Rows x [M, in], sorted by expert, times each expert's w [E, out, in]:
    [M, out], expert e taking rows offs[e-1]:offs[e] (int32 ends)."""
    return torch._grouped_mm(x, w.transpose(1, 2), offs=offs)


class MoE(nn.Module):
    def __init__(self, c: KimiVLConfig):
        super().__init__()
        self.c = c
        E, I, H = c.n_routed_experts, c.moe_intermediate_size, c.hidden_size
        self.gate = nn.Module()
        self.gate.weight = nn.Parameter(torch.empty(E, H))
        self.gate.e_score_correction_bias = nn.Parameter(torch.empty(E))
        self.experts = nn.Module()
        self.experts.w13 = nn.Parameter(torch.empty(E, 2 * I, H))  # gate rows, then up rows
        self.experts.w2 = nn.Parameter(torch.empty(E, H, I))
        self.shared_experts = MLP(H, c.n_shared_experts * I)

    def forward(self, x):
        """x [N, H]."""
        c = self.c
        N, E = x.shape[0], c.n_routed_experts
        idx, w = route(F.linear(x.float(), self.gate.weight.float()), self.gate.e_score_correction_bias,
                       c.num_experts_per_tok, c.routed_scaling_factor, c.norm_topk_prob)
        k = idx.shape[1]
        flat = idx.flatten()
        order = torch.argsort(flat, stable=True)
        # counted by a scatter: bincount would wait for the device to size its output
        counts = flat.new_zeros(E).scatter_add_(0, flat, torch.ones_like(flat))
        count("moe.assignments", flat.numel())
        count_device("moe.busiest", lambda: counts.max() * E)
        offs = counts.cumsum(0).to(torch.int32)
        gate, up = expert_mm(x.index_select(0, order // k), self.experts.w13, offs).chunk(2, -1)
        # each assignment's weight on its expert's activation (the product is linear in it),
        # so the slots' outputs add as they are
        act = (F.silu(gate) * up * w.flatten()[order, None]).to(x.dtype)
        ys = expert_mm(act, self.experts.w2, offs)
        routed = torch.empty_like(ys).index_copy_(0, order, ys).view(N, k, -1).sum(1)
        return routed + self.shared_experts(x)


class Layer(nn.Module):
    def __init__(self, c: KimiVLConfig, i: int):
        super().__init__()
        self.input_layernorm = RMSNorm(c.hidden_size, c.rms_norm_eps)
        self.self_attn = MLA(c)
        self.post_attention_layernorm = RMSNorm(c.hidden_size, c.rms_norm_eps)
        self.mlp = MLP(c.hidden_size, c.intermediate_size) if i < c.first_k_dense_replace else MoE(c)

    def feed_forward(self, x):
        """The MLP sublayer of x [..., H] with its residual, PREFILL_ROWS
        tokens at a time."""
        rows = self.post_attention_layernorm(x).flatten(0, -2)
        parts = rows.split(PREFILL_ROWS)
        out = self.mlp(rows) if len(parts) == 1 else torch.cat([self.mlp(part) for part in parts])
        return x + out.view(x.shape)


class Projector(nn.Module):
    def __init__(self, c: KimiVLConfig):
        super().__init__()
        width = c.vision_hidden_size * c.merge
        self.pre_norm = nn.LayerNorm(c.vision_hidden_size, eps=c.projector_ln_eps)
        self.linear_1 = nn.Linear(width, width)
        self.linear_2 = nn.Linear(width, c.hidden_size)

    def forward(self, feats):
        """feats [B, frames, tokens, merge, vision] -> [B, frames x tokens, H]."""
        x = self.pre_norm(feats).flatten(-2).flatten(1, 2)
        return self.linear_2(F.gelu(self.linear_1(x)))


Pre = Dict[str, torch.Tensor]


class KimiVLGenerator(nn.Module):
    """The captioner: projector, language model and head, with the methods
    `evaluation/decode.py` calls on a generator (module doc)."""

    def __init__(self, cfg: KimiVLConfig):
        super().__init__()
        self.cfg = cfg
        self.projector = Projector(cfg)
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.layers = nn.ModuleList(Layer(cfg, i) for i in range(cfg.num_hidden_layers))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.lm_head = nn.Parameter(torch.empty(cfg.hidden_size, cfg.vocab_size))  # [H, V], K1's w
        self._consts: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}
        self._caches: Dict[tuple, torch.Tensor] = {}  # encode's latent cache by shape
        self._graphs: Dict[tuple, _StepGraph] = {}  # a card's beam steps by (G, t, prefix)
        self._pool = None  # the graphs' shared memory pool

    @classmethod
    def on_meta(cls, cfg: KimiVLConfig) -> "KimiVLGenerator":
        with torch.device("meta"):
            return cls(cfg)

    def load_state_dict(self, state_dict, strict: bool = True, assign: bool = True):
        """The given tensors become the parameters (`assign`), so a model
        built on the meta device takes them where they are."""
        return super().load_state_dict(state_dict, strict=strict, assign=assign)

    def _prompt_and_bias(self, device) -> Tuple[torch.Tensor, torch.Tensor]:
        """The prefilled prompt's ids and the head's zero bias on `device`."""
        if device not in self._consts:
            ids = torch.tensor(self.cfg.prompt_ids[:-1], dtype=torch.int64, device=device)
            self._consts[device] = ids, torch.zeros(self.cfg.vocab_size, device=device)
        return self._consts[device]

    def _rope(self, first: int, n: int, x: torch.Tensor):
        pos = torch.arange(first, first + n, device=x.device)
        return rope_tables(pos, self.cfg.qk_rope_head_dim, self.cfg.rope_theta, x.dtype)

    def embed(self, feats: torch.Tensor) -> torch.Tensor:
        """feats [B, *feature_shape] -> the prefix's embeddings [B, S, H]:
        the projected visual tokens, then the prompt but its last token."""
        x = self.projector(feats.to(self.lm_head.dtype))
        prompt = self.embed_tokens(self._prompt_and_bias(x.device)[0])
        return torch.cat([x, prompt.expand(x.shape[0], -1, -1)], 1)

    def prefill(self, x: torch.Tensor, hidden: bool = False, cache: Optional[torch.Tensor] = None):
        """The prefix x [B, S, H] through every layer: the latent cache [L,
        B, S, cache_width] (written into `cache` when given), and with
        `hidden` the final-normed hidden states [B, S, H] too."""
        B, S, _ = x.shape
        cos, sin = self._rope(0, S, x)
        if cache is None:
            cache = x.new_empty(len(self.layers), B, S, self.cfg.cache_width)
        for i, layer in enumerate(self.layers):
            a, cache[i] = layer.self_attn.prefill(layer.input_layernorm(x), cos, sin)
            x = layer.feed_forward(x + a)
        return (cache, self.norm(x)) if hidden else cache

    def encode(self, frames: torch.Tensor, regions=None) -> Tuple[torch.Tensor, None]:
        """Project and prefill B clips: the latent cache as [B, L, S,
        cache_width] (a clip-major view of the layer-major cache), and None
        for the second modality. The cache is one buffer per shape, which
        the next encode of that shape overwrites, so that the beam steps'
        graphs read it where they were captured."""
        with span("vlm.project"):
            x = self.embed(frames)
        with span("vlm.prefill"):
            key = (x.device, x.dtype, *x.shape[:2])
            if key not in self._caches:
                self._caches[key] = x.new_empty(len(self.layers), *x.shape[:2], self.cfg.cache_width)
            return self.prefill(x, cache=self._caches[key]).transpose(0, 1), None

    def decoder_init_beam_state(self, obj: torch.Tensor, mot=None) -> Tuple[Pre, Pre]:
        """The beam state, each hypothesis' empty suffix [B, L, 0, W], and
        the invariant, the per-clip prefix cache [L, B, S, W]."""
        B, L, _, W = obj.shape
        return {"suffix": obj.new_empty(B, L, 0, W)}, {"prefix": obj.transpose(0, 1)}

    def decoder_beam_step_hidden(self, tokens: torch.Tensor, state: Pre, pre: Pre):
        """One token of each of G hypotheses (G = B x beams, clip-major):
        the final-normed hidden state [G, H], the state with this token's
        cache entries, and an empty aux [G, 0]. On a card the step is
        replayed from a CUDA graph (`_StepGraph`): ~2 700 launches a step
        become one, so the host no longer sets the beam loop's pace."""
        prefix, suffix = pre["prefix"], state["suffix"]
        if tokens.is_cuda:
            key = (tokens.shape[0], suffix.shape[2], prefix.data_ptr(), tuple(prefix.shape))
            if key not in self._graphs:
                self._graphs[key] = _StepGraph(self, tokens, suffix, prefix)
            hid, new = self._graphs[key].replay(tokens, suffix)
        else:
            hid, new = self._step(tokens, suffix, prefix)
        return hid, {"suffix": new}, hid.new_zeros(hid.shape[0], 0)

    def _step(self, tokens: torch.Tensor, suffix: torch.Tensor, prefix: torch.Tensor):
        """The beam step's arithmetic: the hidden state and the new suffix."""
        x = self.embed_tokens(tokens)
        cos, sin = self._rope(prefix.shape[2] + suffix.shape[2], 1, x)
        new = []
        for i, layer in enumerate(self.layers):
            a, s = layer.self_attn.decode(layer.input_layernorm(x), cos, sin, prefix[i], suffix[:, i])
            new.append(s)
            x = layer.feed_forward(x + a)
        return self.norm(x), torch.stack(new, 1)

    def decoder_beam_step(self, tokens: torch.Tensor, state: Pre, pre: Pre):
        """`decoder_beam_step_hidden` with the head's fp32 logits [G, V]."""
        hid, state, aux = self.decoder_beam_step_hidden(tokens, state, pre)
        return hid.float() @ self.lm_head.float(), state, aux

    def decoder_vocab_head(self):
        """K1's w [H, V], laid out once a decode, and the zero bias [V]."""
        w = self.lm_head
        return prepare_head(w, w.dtype), self._prompt_and_bias(w.device)[1]

    def decoder_vocab_shard(self) -> Optional[Tuple[int, int]]:
        return None


class _StepGraph:
    """One beam step (`KimiVLGenerator._step`) of G hypotheses with t earlier
    caption tokens against one prefix cache, captured as a CUDA graph after
    an eager warm-up on a side stream; the generator's graphs share one
    memory pool. A replay copies the tokens and the suffix into the graph's
    own buffers; its outputs live in the pool and are overwritten by the
    next replay of any of the generator's graphs, which the beam only starts
    after reading them. The MoE counters count what runs eagerly (the
    prefill), not the replays."""

    def __init__(self, gen: KimiVLGenerator, tokens, suffix, prefix):
        self.tokens, self.suffix = tokens.clone(), suffix.clone()
        side = torch.cuda.Stream(tokens.device)
        side.wait_stream(torch.cuda.current_stream(tokens.device))
        with torch.cuda.stream(side):
            gen._step(self.tokens, self.suffix, prefix)
        torch.cuda.current_stream(tokens.device).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, pool=gen._pool):
            self.out = gen._step(self.tokens, self.suffix, prefix)
        gen._pool = self.graph.pool()

    def replay(self, tokens, suffix):
        self.tokens.copy_(tokens)
        self.suffix.copy_(suffix)
        self.graph.replay()
        return self.out
