"""Plain PyTorch reference of D-LSG: the generator's encoder and beam-5
decode, the teacher-forced training scan, the DiscV2 discriminator and the
WGAN-GP step with Adam and the adaptive lambda.

This file is the benchmark's yardstick. It imports nothing of the measured
package: it is a frozen, plain rewrite of the same mathematics (arXiv
2108.03662, reference code `models/`, `run_gun.py`), computed in float32
with every tensor-core shortcut off unless the caller asks for the control's
lower precision (`precision`). Parameters come as a dict of tensors keyed
by the measured package's `state_dict` names (`param_shapes` lists them),
so the benchmark hands both sides the same weights.

Two points follow the measured system's stated semantics rather than a
free choice:
- with `cfg["use_pallas_lstm"]` the encoder's recurrent weights are
  rounded to bfloat16, the contract of the LSTM scan kernel (and of the
  JAX package's Pallas kernel that it ports);
- a training step draws its random numbers (dropout masks, the
  scheduled-sampling coins, the penalty's mixing weights) from one
  `torch.Generator` seeded from (key, step), in the order the training
  forward visits the sites, so that both sides drop the same units.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]

PAD_ID, START_ID, END_ID = 0, 1, 2
LN_EPS = 1e-5
NEG_FILL = -9e15
D_DIM = 512
GP_WEIGHT = 10.0
ADAM_BETAS = (0.5, 0.9)
ADAM_EPS = 1e-8


@contextlib.contextmanager
def precision(mode: str = "fp32"):
    """`fp32`: float32 products with TF32 off (the reference); `tf32`: the
    same products in TF32 (the control one precision below)."""
    tf32 = mode == "tf32"
    if mode not in ("fp32", "tf32"):
        raise ValueError(f"precision is fp32 or tf32, got {mode!r}")
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


# ---------------------------------------------------------------- shapes


def param_shapes(cfg: dict, vocab_size: int) -> Tuple[Dict[str, tuple], Dict[str, tuple]]:
    """(generator shapes, discriminator shapes) by parameter name, in the
    measured package's `state_dict` layout: Dense weights [out, in], LSTM
    `w_hh` [H, 4H] with gates (i, f, g, o), Conv1d [out, in, k]."""
    vh, rp, qh, dh = (cfg["visual_hidden_size"], cfg["region_projected_size"],
                      cfg["query_hidden_size"], cfg["decode_hidden_size"])
    af, ff, rf, ws = (cfg["a_feature_size"], cfg["a_feature_size"] + cfg["m_feature_size"],
                      cfg["region_feature_size"], cfg["word_size"])
    P, V = cfg["num_proposals"], vocab_size
    g: Dict[str, tuple] = {}

    def dense(name, i, o, bias=True):
        g[f"{name}.weight"] = (o, i)
        if bias:
            g[f"{name}.bias"] = (o,)

    def ln(name, d):
        g[f"{name}.weight"] = (d,)
        g[f"{name}.bias"] = (d,)

    for br, embed in (("obj_encoder", af), ("motion_encoder", None)):
        pre = f"encoder.{br}"
        if embed:
            dense(f"{pre}.visual_embed", embed, vh)
        ln(f"{pre}.visual_norm.ln", vh)
        dense(f"{pre}.obj_embed", rf, rp)
        ln(f"{pre}.obj_norm.ln", rp)
        ln(f"{pre}.obj_visual_norm.ln", vh)
        g[f"{pre}.v2l_layer.theta"] = (P, vh)
        ln(f"{pre}.v2l_layer.ln", vh)
        if br == "obj_encoder":  # the motion pre-encoder sits between the two in order
            m = "encoder.motion_pre_encoder"
            dense(f"{m}.linear_embed", ff, vh)
            for d in ("fwd", "bwd"):
                g[f"{m}.lstm.{d}.w_hh"] = (vh, 4 * vh)
                dense(f"{m}.lstm.{d}.ih", vh, 4 * vh)
            ln(f"{m}.layernorm_lstm", 2 * vh)
            for k in ("K", "Q", "V"):
                dense(f"{m}.self_attention.{k}", 2 * vh, 2 * vh, bias=False)
            dense(f"{m}.self_attention.out", 2 * vh, vh, bias=False)
            ln(f"{m}.layernorm_sa", vh)
    s = "decoder.step"
    g[f"{s}.word_embed.embedding"] = (V, ws)
    g[f"{s}.query_lstm.w_hh"] = (qh, 4 * qh)
    dense(f"{s}.query_lstm.ih_dyn", dh + ws, 4 * qh)
    dense(f"{s}.query_lstm.ih_static", 2 * vh, 4 * qh, bias=False)
    ln(f"{s}.query_lstm_layernorm", qh)
    for a in ("context_att", "context_att_2"):
        dense(f"{s}.{a}.K", vh, vh, bias=False)
        dense(f"{s}.{a}.Q", qh, vh, bias=False)
        dense(f"{s}.{a}.V", vh, vh, bias=False)
        dense(f"{s}.{a}.out", vh, vh, bias=False)
        ln(f"{s}.{a}.ln", vh)
    g[f"{s}.lang_lstm.w_hh"] = (dh, 4 * dh)
    dense(f"{s}.lang_lstm.ih", 2 * vh + qh, 4 * dh)
    ln(f"{s}.lang_lstm_layernorm", dh)
    dense(f"{s}.word_restore", dh, V)

    gen, g = g, {}
    D = D_DIM
    g["fusion"] = (2, D)
    dense("conv1d", V, D)
    g["block.conv.weight"] = (D, D, 3)
    g["block.conv.bias"] = (D,)
    g["lstm.w_hh"] = (D, 4 * D)
    dense("lstm.ih", D, 4 * D)
    ln("layer_norm", D)
    for k in ("K", "Q", "V", "out"):
        dense(f"att.{k}", D, D, bias=False)
    ln("att_norm.ln", D)
    for h in ("obj_psl_score", "motion_psl_score"):
        dense(f"{h}.psl_embed", vh, D)
        ln(f"{h}.psl_embed_norm.ln", D)
        dense(f"{h}.att_norm_dense", D, D)
        ln(f"{h}.att_norm.ln", D)
        ln(f"{h}.psl_norm.ln", D)
        dense(f"{h}.psl_scorer.visual_embed", D, D)
        dense(f"{h}.psl_scorer.sent_embed", D, D)
        dense(f"{h}.psl_scorer.classify", D, 1)
    g["text_sum.theta"] = (1, D)
    ln("text_sum.ln", D)
    return gen, g


# ---------------------------------------------------------------- primitives


class Draws:
    """The step's random numbers: U[0, 1) blocks from one generator, in
    call order (None: deterministic, nothing is dropped)."""

    def __init__(self, gen: Optional[torch.Generator]):
        self.gen = gen

    def rand(self, shape, device) -> torch.Tensor:
        return torch.rand((1, *shape), generator=self.gen, device=device)[0]

    def dropout(self, x: torch.Tensor, rate: float) -> torch.Tensor:
        if self.gen is None or rate == 0.0:
            return x
        keep = 1.0 - rate
        mask = self.rand(x.shape, x.device) < keep
        return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def step_generator(key: int, step: int, device) -> torch.Generator:
    """The generator of training step `step` under `key`."""
    seed = np.random.SeedSequence([key, step]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(seed))


def linear(p: Params, name: str, x: torch.Tensor, bias: bool = True) -> torch.Tensor:
    y = x @ p[f"{name}.weight"].t()
    return y + p[f"{name}.bias"] if bias else y


def layer_norm(p: Params, name: str, x: torch.Tensor) -> torch.Tensor:
    mu = x.mean(-1, keepdim=True)
    var = ((x * x).mean(-1, keepdim=True) - mu * mu).clamp_min(0.0)
    return (x - mu) * (torch.rsqrt(var + LN_EPS) * p[f"{name}.weight"]) + p[f"{name}.bias"]


def tanh_ln(p: Params, name: str, x: torch.Tensor) -> torch.Tensor:
    return layer_norm(p, f"{name}.ln", torch.tanh(x))


def lstm_cell(gates: torch.Tensor, c: torch.Tensor):
    i, f, g, o = gates.chunk(4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c), c


def lstm_seq(p: Params, name: str, x: torch.Tensor, reverse: bool = False,
             bf16_recurrent: bool = False) -> torch.Tensor:
    xw = linear(p, f"{name}.ih", x)
    w = p[f"{name}.w_hh"]
    if bf16_recurrent:
        w = w.to(torch.bfloat16).float()
    B, T, _ = x.shape
    h = x.new_zeros(B, w.shape[0])
    c = torch.zeros_like(h)
    hs: List[Optional[torch.Tensor]] = [None] * T
    for n, t in enumerate(range(T - 1, -1, -1) if reverse else range(T)):
        h, c = lstm_cell(xw[:, t] + h @ w if n else xw[:, t], c)  # h_0 @ w is zero
        hs[t] = h
    return torch.stack(hs, dim=1)


def latent_psl(p: Params, name: str, x: torch.Tensor, dr: Draws) -> torch.Tensor:
    adj = torch.softmax(x @ p[f"{name}.theta"].t(), dim=1)
    out = adj.transpose(1, 2) @ x
    return dr.dropout(layer_norm(p, f"{name}.ln", torch.tanh(out)), 0.3)


def positional_encoding(T: int, d: int, device) -> torch.Tensor:
    pe = np.zeros((T, d), dtype=np.float32)
    pos = np.arange(0.0, T)[:, None]
    div = np.exp(np.arange(0.0, d, 2) * -(math.log(10000.0) / d))
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)
    return torch.from_numpy(pe).to(device)


def self_attention(p: Params, name: str, x: torch.Tensor, dr: Draws, rate: float,
                   pe: bool = False, att_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    if pe:
        x = dr.dropout(x + positional_encoding(x.shape[1], x.shape[2], x.device)[None], 0.2)
    K = linear(p, f"{name}.K", x, bias=False)
    Q = linear(p, f"{name}.Q", x, bias=False)
    Vv = linear(p, f"{name}.V", x, bias=False)
    logits = K @ Q.transpose(1, 2) / math.sqrt(K.shape[-1])
    if att_mask is not None:
        logits = torch.where(att_mask > 0, logits, torch.full_like(logits, NEG_FILL))
    out = linear(p, f"{name}.out", torch.softmax(logits, dim=-1) @ Vv, bias=False)
    return dr.dropout(out, rate)


# ---------------------------------------------------------------- generator


def _graph_branch(p: Params, cfg: dict, name: str, visual: torch.Tensor, regions: torch.Tensor,
                  dr: Draws) -> torch.Tensor:
    B, T, O, R = regions.shape
    if f"{name}.visual_embed.weight" in p:
        visual = linear(p, f"{name}.visual_embed", visual)
    visual = tanh_ln(p, f"{name}.visual_norm", visual)
    obj = tanh_ln(p, f"{name}.obj_norm", linear(p, f"{name}.obj_embed", regions))
    obj = obj.reshape(B, T * O, -1)
    adj = torch.softmax(visual @ obj.transpose(1, 2) / math.sqrt(R), dim=-1)
    fused = tanh_ln(p, f"{name}.obj_visual_norm", adj @ obj + visual)
    return latent_psl(p, f"{name}.v2l_layer", fused, dr)


def encode(p: Params, cfg: dict, frames: torch.Tensor, regions: torch.Tensor,
           dr: Optional[Draws] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(object proposals, motion proposals) [B, P, H] of frames [B, T, F]
    and regions [B, T, >= num_obj, R]."""
    dr = dr or Draws(None)
    regions = regions[:, :, : cfg["num_obj"]]
    obj = _graph_branch(p, cfg, "encoder.obj_encoder", frames[..., : cfg["a_feature_size"]],
                        regions, dr)
    m = "encoder.motion_pre_encoder"
    x = linear(p, f"{m}.linear_embed", frames)
    bf16 = bool(cfg.get("use_pallas_lstm", False))
    x = torch.cat([lstm_seq(p, f"{m}.lstm.fwd", x, False, bf16),
                   lstm_seq(p, f"{m}.lstm.bwd", x, True, bf16)], dim=-1)
    x = dr.dropout(layer_norm(p, f"{m}.layernorm_lstm", x), cfg["dropout"])
    x = layer_norm(p, f"{m}.layernorm_sa",
                   self_attention(p, f"{m}.self_attention", x, dr, cfg["dropout"], pe=True))
    mot = _graph_branch(p, cfg, "encoder.motion_encoder", x, regions, dr)
    return obj, mot


class DecoderState:
    """The decoder's loop invariants for one batch of proposals."""

    def __init__(self, p: Params, cfg: dict, obj: torch.Tensor, mot: torch.Tensor):
        s = "decoder.step"
        self.p, self.cfg = p, cfg
        glob = torch.cat([obj.mean(1), mot.mean(1)], dim=-1)
        self.gw = linear(p, f"{s}.query_lstm.ih_static", glob, bias=False)
        self.kv = [(linear(p, f"{s}.{a}.K", f, bias=False), linear(p, f"{s}.{a}.V", f, bias=False))
                   for a, f in (("context_att", obj), ("context_att_2", mot))]

    def expand(self, beam: int) -> "DecoderState":
        out = DecoderState.__new__(DecoderState)
        out.p, out.cfg = self.p, self.cfg
        out.gw = self.gw.repeat_interleave(beam, 0)
        out.kv = [(k.repeat_interleave(beam, 0), v.repeat_interleave(beam, 0)) for k, v in self.kv]
        return out

    def step(self, word_id: torch.Tensor, h: Sequence[torch.Tensor], dr: Draws):
        """logits [G, V], new (qh, qc, lh, lc), alpha [G, 2P]."""
        p, cfg, s = self.p, self.cfg, "decoder.step"
        qh, qc, lh, lc = h
        word = dr.dropout(F.embedding(word_id, p[f"{s}.word_embed.embedding"]), cfg["dropout"])
        gates = (linear(p, f"{s}.query_lstm.ih_dyn", torch.cat([lh, word], -1))
                 + qh @ p[f"{s}.query_lstm.w_hh"] + self.gw)
        qh, qc = lstm_cell(gates, qc)
        query = dr.dropout(layer_norm(p, f"{s}.query_lstm_layernorm", qh), cfg["dropout"])
        ctxs, alphas = [], []
        for a, (K, Vv) in zip(("context_att", "context_att_2"), self.kv):
            q = linear(p, f"{s}.{a}.Q", query, bias=False)
            al = torch.softmax((K @ q.unsqueeze(-1)).squeeze(-1) / math.sqrt(K.shape[-1]), dim=-1)
            c = torch.tanh(linear(p, f"{s}.{a}.out", (al.unsqueeze(1) @ Vv).squeeze(1), bias=False))
            ctxs.append(layer_norm(p, f"{s}.{a}.ln", c))
            alphas.append(al)
        ctx = dr.dropout(torch.cat(ctxs, -1), 0.1)
        gates2 = (linear(p, f"{s}.lang_lstm.ih", torch.cat([ctx, query], -1))
                  + lh @ p[f"{s}.lang_lstm.w_hh"])
        lh, lc = lstm_cell(gates2, lc)
        lh = dr.dropout(lh, cfg["dropout"])
        out = torch.tanh(layer_norm(p, f"{s}.lang_lstm_layernorm", lh))
        return linear(p, f"{s}.word_restore", out), (qh, qc, lh, lc), torch.cat(alphas, -1)


def _init_hidden(cfg: dict, n: int, device) -> Tuple[torch.Tensor, ...]:
    qh = torch.zeros(n, cfg["query_hidden_size"], device=device)
    lh = torch.zeros(n, cfg["decode_hidden_size"], device=device)
    return qh, torch.zeros_like(qh), lh, torch.zeros_like(lh)


def _top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Values descending, ties to the lowest index."""
    neg, idx = torch.sort(-x, dim=-1, stable=True)
    return -neg[..., :k], idx[..., :k]


@torch.no_grad()
def beam_decode(p: Params, cfg: dict, frames: torch.Tensor, regions: torch.Tensor,
                beam: int) -> torch.Tensor:
    """The best beam's token ids [B, max_words] (AllenNLP beam search: a
    per-node beam of `beam`, `<end>` forced with log-prob 0 once emitted,
    hypotheses ranked by summed log-probabilities)."""
    obj, mot = encode(p, cfg, frames, regions)
    B, dev, T = obj.shape[0], obj.device, cfg["max_words"]
    st = DecoderState(p, cfg, obj, mot)
    stx = st.expand(beam)
    dr = Draws(None)
    logits, h, _ = st.step(torch.full((B,), START_ID, device=dev), _init_hidden(cfg, B, dev), dr)
    last_lp, last = _top_k(torch.log_softmax(logits, -1), beam)
    h = tuple(t.repeat_interleave(beam, 0) for t in h)
    first = last
    preds, ptrs = [], []
    forced = torch.full((beam,), -torch.inf, device=dev)
    forced[0] = 0.0
    for _ in range(T - 1):
        if bool((last == END_ID).all()):
            preds.append(torch.full_like(last, END_ID))
            ptrs.append(torch.arange(beam, device=dev).expand(B, beam))
            continue
        flat = last.reshape(-1)
        logits, h_new, _ = stx.step(flat, h, dr)
        lp, ids = _top_k(torch.log_softmax(logits, -1), beam)
        ended = (flat == END_ID)[:, None]
        lp = torch.where(ended, forced[None], lp)
        ids = torch.where(ended, torch.full_like(ids, END_ID), ids)
        total = (lp + last_lp.reshape(-1, 1)).reshape(B, beam * beam)
        last_lp, pos = _top_k(total, beam)
        last = torch.gather(ids.reshape(B, beam * beam), 1, pos)
        ptr = pos // beam
        h = tuple(torch.gather(t.reshape(B, beam, -1), 1,
                               ptr[:, :, None].expand(-1, -1, t.shape[-1])).reshape(t.shape)
                  for t in h_new)
        preds.append(last)
        ptrs.append(ptr)
    cur = torch.zeros(B, 1, dtype=torch.int64, device=dev)
    out = []
    for k in range(len(preds) - 1, -1, -1):
        out.append(torch.gather(preds[k], 1, cur))
        cur = torch.gather(ptrs[k], 1, cur)
    out.append(torch.gather(first, 1, cur))
    return torch.cat(out[::-1], dim=1)


def teacher_forced(p: Params, cfg: dict, obj, mot, captions: torch.Tensor, ratio: float,
                   dr: Draws):
    """The training scan: (logits [B, T, V], alpha [B, T, 2P]). One
    scheduled-sampling coin per step for the batch, drawn up front: the
    next word is the gold one where it is true, else the argmax."""
    T, B, dev = cfg["max_words"], captions.shape[0], captions.device
    st = DecoderState(p, cfg, obj, mot)
    if dr.gen is not None:
        coins = torch.rand(T, generator=dr.gen, device=dev) < ratio
    else:
        coins = torch.ones(T, dtype=torch.bool, device=dev)
    h = _init_hidden(cfg, B, dev)
    word = torch.full((B,), START_ID, dtype=torch.int64, device=dev)
    logits_all, alphas = [], []
    for t in range(T):
        logits, h, alpha = st.step(word, h, dr)
        word = torch.where(coins[t], captions[:, t], logits.detach().argmax(-1))
        logits_all.append(logits)
        alphas.append(alpha)
    return torch.stack(logits_all, 1), torch.stack(alphas, 1)


# ---------------------------------------------------------------- discriminator


def _conv3(p: Params, name: str, x: torch.Tensor) -> torch.Tensor:
    """SAME Conv1d, kernel 3, over the time axis of [B, T, C]."""
    w = p[f"{name}.weight"]
    out_f, in_f, k = w.shape
    T = x.shape[1]
    left = (k - 1) // 2
    xp = F.pad(x, (0, 0, left, k - 1 - left))
    cols = torch.cat([xp[:, i: i + T] for i in range(k)], dim=-1)
    return cols @ w.permute(2, 1, 0).reshape(k * in_f, out_f) + p[f"{name}.bias"]


def _psl_score(p: Params, cfg: dict, name: str, psl, psl_alpha, att_out, seq_mask, dr: Draws,
               groups: int) -> torch.Tensor:
    K = cfg["num_topk"]
    h = tanh_ln(p, f"{name}.psl_embed_norm", linear(p, f"{name}.psl_embed", psl))
    if cfg["num_proposals"] > K:
        _, idx = _top_k(psl_alpha.sum(dim=1), K)
        h = torch.gather(h, 1, idx[:, :, None].expand(-1, -1, h.shape[-1]))
    a = tanh_ln(p, f"{name}.att_norm", linear(p, f"{name}.att_norm_dense", att_out))
    adj = torch.softmax(a @ h.transpose(1, 2) / math.sqrt(D_DIM), dim=1)
    adj = torch.where(seq_mask > 0, adj, torch.zeros_like(adj))
    adj_alpha = adj.sum(dim=1)
    agg = dr.dropout(tanh_ln(p, f"{name}.psl_norm", adj.transpose(1, 2) @ a), 0.3)
    s = f"{name}.psl_scorer"
    score = linear(p, f"{s}.classify", torch.tanh(linear(p, f"{s}.visual_embed", h))
                   * torch.tanh(linear(p, f"{s}.sent_embed", agg))).squeeze(-1)
    score = (score * adj_alpha).sum(-1) / adj_alpha.sum(-1)
    n = score.shape[0] // groups
    return score.reshape(groups, n).sum(dim=1) / n


def discriminator(p: Params, cfg: dict, inputs, obj, mot, att_mask, alpha_all, dr: Draws,
                  groups: int = 1) -> torch.Tensor:
    """DiscV2: a score per row [n] of a caption distribution [n, T, V];
    `groups` stacked sub-batches, each scored against its own mean."""
    P, K = cfg["num_proposals"], cfg["num_topk"]
    h = linear(p, "conv1d", inputs)
    h = torch.relu(h)
    h = h + 0.3 * _conv3(p, "block.conv", h)
    h = lstm_seq(p, "lstm", h)
    h = dr.dropout(layer_norm(p, "layer_norm", h), 0.3)
    att_out = tanh_ln(p, "att_norm", self_attention(p, "att", h, dr, 0.3, att_mask=att_mask))
    word_mask = att_mask[:, 0, :]
    alpha_all = alpha_all * word_mask[:, :, None]
    seq_mask = word_mask[:, :, None].expand(-1, -1, K)
    obj_s = _psl_score(p, cfg, "obj_psl_score", obj, alpha_all[:, :, :P], att_out, seq_mask, dr,
                       groups)
    mot_s = _psl_score(p, cfg, "motion_psl_score", mot, alpha_all[:, :, -P:], att_out, seq_mask,
                       dr, groups)
    sent = latent_psl(p, "text_sum", att_out, dr).squeeze(1)
    fusion = torch.softmax(sent @ p["fusion"].t(), dim=-1)
    n = inputs.shape[0] // groups
    obj_s = obj_s[:, None].expand(groups, n).reshape(-1)
    mot_s = mot_s[:, None].expand(groups, n).reshape(-1)
    return obj_s * fusion[:, 0] + mot_s * fusion[:, 1]


# ---------------------------------------------------------------- training


def masked_ce(logits: torch.Tensor, targets: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    mask = (torch.arange(targets.shape[1], device=targets.device)[None] < lengths[:, None]).float()
    nll = -torch.log_softmax(logits, -1).gather(-1, targets[..., None])[..., 0]
    return (nll * mask).sum() / mask.sum().clamp_min(1.0)


class Adam:
    """Adam(betas (0.5, 0.9), eps 1e-8) with an elementwise gradient clamp
    before it (0: none)."""

    def __init__(self, params: Params, lr: float, clip: float = 0.0):
        self.p, self.lr, self.clip, self.t = params, lr, clip, 0
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.first_grads: Optional[Params] = None

    @torch.no_grad()
    def update(self, grads: Params) -> None:
        b1, b2 = ADAM_BETAS
        self.t += 1
        if self.clip > 0:
            grads = {k: g.clamp(-self.clip, self.clip) for k, g in grads.items()}
        if self.first_grads is None:
            self.first_grads = {k: g.clone() for k, g in grads.items()}
        c1, c2 = 1 - b1 ** self.t, math.sqrt(1 - b2 ** self.t)
        for k, g in grads.items():
            self.m[k].mul_(b1).add_(g, alpha=1 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            self.p[k].sub_(self.lr / c1 * self.m[k] / (self.v[k].sqrt() / c2 + ADAM_EPS))


class GanLambda:
    """The adaptive GAN weight: a 200-step window of caption losses; while
    stable, lambda stays at its start value; a rise of the later half's mean
    by more than 4% over the earlier half's starts a 500-step half-sine
    down to 0.006 and back."""

    def __init__(self, start: float, window: int = 200, counter: int = 500, low: float = 0.006):
        self.start, self.window, self.counter, self.low = start, window, counter, low
        self.losses: List[float] = []
        self.state, self.sched, self.current = 0, 0, start
        base = (start - low) / 2.0
        xs = np.arange(int(counter * 1.5))[int(counter * 0.5):]
        self.table = (np.sin(np.pi * xs / counter) * base + base + low).tolist()

    def update(self, cap_loss: float) -> float:
        self.losses = (self.losses + [cap_loss])[-self.window - 1:]
        if len(self.losses) > self.window:
            self.losses = self.losses[-self.window:]
            half = self.window // 2
            if self.state == 0:
                if np.mean(self.losses[half:]) > np.mean(self.losses[:half]) * 1.04:
                    self.state = 1
            elif self.sched == self.counter - 1:
                self.state, self.sched = 0, 0
        if self.state:
            self.current = self.table[self.sched]
            self.sched += 1
        return self.current


def _grads(loss: torch.Tensor, params: Params) -> Params:
    keys = list(params)
    gs = torch.autograd.grad(loss, [params[k] for k in keys], allow_unused=True)
    return {k: torch.zeros_like(params[k]) if g is None else g for k, g in zip(keys, gs)}


def gan_step(gp: Params, dp: Params, g_opt: Adam, d_opt: Adam, lam: GanLambda, cfg: dict,
             batch: Dict[str, torch.Tensor], key: int, step: int, epsilon: float
             ) -> Dict[str, float]:
    """One WGAN-GP step (run_gun.py:147-234): a generator forward whose
    outputs D sees detached; `num_D_visual` D updates on f - r + 10 gp; the
    generator update on CE + lambda * (-D(fake)). Updates the parameter
    dicts in place; returns the losses."""
    frames, regions, captions, lengths = (batch[k] for k in ("frames", "regions", "captions",
                                                             "lengths"))
    captions = captions.long()
    dev, B, V = frames.device, captions.shape[0], dp["conv1d.weight"].shape[1]
    dr = Draws(step_generator(key, step, dev))
    seq = (captions > 0).float()
    att_mask = seq[:, :, None] * seq[:, None, :]
    real = F.one_hot(captions, V).float()
    for t in (*gp.values(), *dp.values()):
        t.requires_grad_(True)
    obj, mot = encode(gp, cfg, frames, regions, dr)
    out, alpha = teacher_forced(gp, cfg, obj, mot, captions, epsilon, dr)
    fake, obj_d, mot_d, alpha_d = (t.detach() for t in (out, obj, mot, alpha))
    cat2 = [torch.cat([t, t], 0) for t in (obj_d, mot_d, att_mask, alpha_d)]
    stats = []
    for _ in range(cfg["num_D_visual"]):
        eps = dr.rand((B, 1, 1), dev)
        scores = discriminator(dp, cfg, torch.cat([real, fake], 0), *cat2, dr, groups=2)
        r_loss, f_loss = scores[:B].sum() / B, scores[B:].sum() / B
        mixed = (real * eps + fake * (1.0 - eps)).requires_grad_(True)
        d_mixed = discriminator(dp, cfg, mixed, obj_d, mot_d, att_mask, alpha_d, dr)
        (g_in,) = torch.autograd.grad(d_mixed.sum(), mixed, create_graph=True)
        gpen = ((g_in.reshape(B, -1).norm(dim=1) - 1.0) ** 2).sum() / B
        loss_d = f_loss - r_loss + GP_WEIGHT * gpen
        d_opt.update(_grads(loss_d, dp))
        stats.append([float(loss_d.detach()), float((r_loss - f_loss).detach()), float(gpen.detach())])
    cap_loss = masked_ce(out, captions, lengths)
    loss_g = -discriminator(dp, cfg, out, obj_d, mot_d, att_mask, alpha_d, dr).sum() / B
    lam_v = lam.update(float(cap_loss.detach()))
    g_opt.update(_grads(cap_loss + lam_v * loss_g, gp))
    for t in (*gp.values(), *dp.values()):
        t.requires_grad_(False)
    s = np.mean(np.array(stats), axis=0)
    return {"cap_loss": float(cap_loss.detach()), "loss_G": float(loss_g.detach()), "loss_D": float(s[0]),
            "wasserstein": float(s[1]), "grad_penalty": float(s[2]), "gan_lambda": lam_v}
