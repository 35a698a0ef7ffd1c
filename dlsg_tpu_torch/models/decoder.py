"""Two-LSTM attentional decoder (counterpart of `dlsg_tpu/models/decoder.py`).

Per step: a query LSTMCell over [lang_h, word | global_feat], single-query
attention over the object proposals and over the motion proposals, a
language LSTMCell over [context, context2, query, lang_h], and
tanh(LN(lang_h)) -> vocab logits (reference models/layer.py:569-602).

As in the JAX package, all loop-invariant work runs once per sequence in
`DecoderStep.precompute`: the attention K/V projections, the global-feature
slice of the query LSTM's input projection, and the fused per-step weight
stacks, so a step runs a few large matmuls. Beam search decodes all B*beam
hypotheses in one batched step.

With `cfg.decode_quant="int8"` the inference paths (greedy decode and the
beam state) quantize the fused LSTM stacks `Wq`, `Wl` and the vocab
projection `Wv` once per decode (`precompute(quant=True)`) and run their
products through `ops/quant.py::qmatmul`; the teacher-forced scan never
quantizes, as in JAX. `Wq` and `Wl` are quantized from the compute-dtype
stacks and `Wv` from the fp32 master kernel, JAX's sources.

Training runs the teacher-forced scan (`Decoder.forward` with captions):
one scheduled-sampling coin per step for the whole batch, and dropout at
the JAX sites: `cfg.dropout` on the word embedding, the query LayerNorm's
output and lang_h (before it becomes the recurrent state, so the dropped
lang_h feeds the logits and the next step); 0.1 (`context_att.drop`) as one
mask over both branches' concatenated context. Greedy decoding and the beam
step are always deterministic.

With the vocab projection split over a mesh's model axis
(`parallel/mesh.py`), each rank projects onto its columns and the logits are
all-gathered, so every caller (the scan, its scheduled-sampling argmax, the
losses, greedy and beam decode) sees whole [.., V] logits, as under XLA's
all-gather in the JAX package; the fused head's sharded form is in
`evaluation/decode.py`.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from dlsg_tpu_torch.config import DLSGConfig
from dlsg_tpu_torch.models.layers import AttentionShare
from dlsg_tpu_torch.ops import quant as quant_ops
from dlsg_tpu_torch.ops.linear import LN_EPS, Dense, Dropout, Embed, LayerNorm, matmul_f32
from dlsg_tpu_torch.ops.lstm import LSTMCell, SplitInputLSTMCell, lstm_gates
from dlsg_tpu_torch.ops.quant import QuantWeight, quantize_weight
from dlsg_tpu_torch.parallel.dist import copy_to_model, gather_from_model
from dlsg_tpu_torch.vocab import START_ID

# `pre` keys with a leading batch axis (expanded to [B*beam] for beam search);
# every other key is a fused weight shared by all hypotheses
BATCH_PRE_KEYS = ("gw", "K", "V")

Pre = Dict[str, torch.Tensor]
State = Dict[str, torch.Tensor]


def expand_pre_to_beams(pre: Pre, beam_size: int) -> Pre:
    """Repeat only the batch-axis entries of `pre` for each beam."""
    return {
        k: (v.repeat_interleave(beam_size, dim=0) if k in BATCH_PRE_KEYS else v)
        for k, v in pre.items()
    }


class DecoderStep(nn.Module):
    """One decoding step; holds all per-step parameters."""

    def __init__(self, cfg: DLSGConfig, vocab_size: int, multi_modal: bool = True):
        super().__init__()
        self.cfg = cfg
        self.multi_modal = multi_modal
        cd = cfg.cdtype
        vh, qh, dh = cfg.visual_hidden_size, cfg.query_hidden_size, cfg.decode_hidden_size
        nb = 2 if multi_modal else 1
        self.word_embed = Embed(vocab_size, cfg.word_size)
        self.word_drop = Dropout(cfg.dropout)
        # query LSTM input = [lang_h, word | global_feat]: the global part is
        # loop-invariant and projected once per sequence
        self.query_lstm = SplitInputLSTMCell(dh + cfg.word_size, nb * vh, qh, dtype=cd)
        self.query_lstm_layernorm = LayerNorm(qh)
        self.query_drop = Dropout(cfg.dropout)
        self.context_att = AttentionShare(vh, qh, vh, dtype=cd)
        if multi_modal:
            self.context_att_2 = AttentionShare(vh, qh, vh, dtype=cd)
        self.lang_lstm = LSTMCell(nb * vh + qh, dh, dtype=cd)
        self.lang_lstm_layernorm = LayerNorm(dh)
        self.lang_drop = Dropout(cfg.dropout)
        self.word_restore = Dense(dh, vocab_size, dtype=cd, kernel_init="xavier_normal")

    def _atts(self):
        return [self.context_att, self.context_att_2] if self.multi_modal else [self.context_att]

    def precompute(self, feats, feats2, global_feat, quant: bool = False) -> Pre:
        """All loop-invariant work, once per sequence: attention K/V of both
        branches stacked as [B, NB, P, VH], the static query-LSTM projection,
        `[W_ih; W_hh]` stacks of both cells, the branches' Q kernels side by
        side, out kernels and LayerNorm affines stacked on a branch axis, and
        the vocab projection in compute dtype. With `quant` the two stacks
        and the vocab projection (this rank's columns of it) become
        `QuantWeight`s (module doc)."""
        cd = self.cfg.cdtype
        atts = self._atts()
        pre = {"gw": self.query_lstm.project_static(global_feat)}
        kv = [atts[0].precompute(feats)]
        if self.multi_modal:
            kv.append(atts[1].precompute(feats2))
        pre["K"] = torch.stack([k for k, _ in kv], dim=1)
        pre["V"] = torch.stack([v for _, v in kv], dim=1)
        pre["Wq"], pre["bq"] = self.query_lstm.fused_weights()
        pre["Wl"], pre["bl"] = self.lang_lstm.fused_weights()
        if quant:
            pre["Wq"], pre["Wl"] = quantize_weight(pre["Wq"]), quantize_weight(pre["Wl"])
        sw = [a.step_weights() for a in atts]
        pre["WQ"] = torch.cat([w[0] for w in sw], dim=1).to(cd).contiguous()  # [QH, NB*VH]
        pre["WO"] = torch.stack([w[1] for w in sw], dim=0).to(cd)  # [NB, VH, VH]
        pre["ln_scale"] = torch.stack([w[2] for w in sw], dim=0)  # [NB, VH]
        pre["ln_bias"] = torch.stack([w[3] for w in sw], dim=0)
        # [Hd, V], or this rank's columns; quantized from the fp32 master
        wr = self.word_restore
        pre["Wv"] = quantize_weight(wr.kernel()) if quant else wr.kernel(cd)
        pre["bv"] = self.word_restore.bias.float()
        return pre

    def _mm(self, x: torch.Tensor, w) -> torch.Tensor:
        """fp32 x @ w: a `QuantWeight` takes `qmatmul` on x as it is (JAX's
        `_mm` quantizes the uncast x), a kernel the compute-dtype product."""
        if isinstance(w, QuantWeight):
            return quant_ops.qmatmul(x, w.qt, w.s)
        return matmul_f32(x.to(self.cfg.cdtype), w)

    def vocab_logits(self, out: torch.Tensor, pre: Pre) -> torch.Tensor:
        """fp32 logits [B, V] of `out` [B, Hd]. With the head split over the
        model axis, this rank's columns, then gathered (module doc)."""
        if self.word_restore.out_shard is None:
            return self._mm(out, pre["Wv"]) + pre["bv"]
        return gather_from_model(self._mm(copy_to_model(out), pre["Wv"]) + pre["bv"])

    def decode_hidden(self, word, query_h, query_c, lang_h, lang_c, pre: Pre,
                      rng: Optional[torch.Generator] = None):
        """The step chain up to (not including) the vocab projection; dropout
        in training mode when given `rng`.

        Returns (decoder_output [B, Hd], q_h, q_c, l_h, l_c, alpha [B, NB*P])."""
        cd = self.cfg.cdtype
        vh = self.cfg.visual_hidden_size
        x = torch.cat([lang_h, word, query_h], dim=-1)
        gates = self._mm(x, pre["Wq"]) + pre["bq"] + pre["gw"].float()
        q_h, q_c = lstm_gates(gates, query_c, cd)
        query_current = self.query_drop(self.query_lstm_layernorm(q_h), rng)

        q12 = matmul_f32(query_current.to(cd), pre["WQ"])
        ctxs, alphas = [], []
        for n in range(pre["K"].shape[1]):
            qn = q12[:, n * vh : (n + 1) * vh]
            Kn, Vn = pre["K"][:, n], pre["V"][:, n]
            scores = matmul_f32(Kn, qn.unsqueeze(-1)).squeeze(-1) / math.sqrt(vh)
            an = torch.softmax(scores, dim=-1)  # over proposals
            cn = matmul_f32(an.to(Vn.dtype).unsqueeze(1), Vn).squeeze(1)
            cn = torch.tanh(matmul_f32(cn.to(cd), pre["WO"][n]))
            # the JAX step's hand-written LayerNorm: E[x^2] - mu^2, clamped
            mu = cn.mean(-1, keepdim=True)
            var = ((cn * cn).mean(-1, keepdim=True) - mu * mu).clamp_min(0.0)
            cn = (cn - mu) * torch.rsqrt(var + LN_EPS)
            ctxs.append(cn * pre["ln_scale"][n][None] + pre["ln_bias"][n][None])
            alphas.append(an)
        ctx = torch.cat(ctxs, dim=-1)
        alpha = torch.cat(alphas, dim=-1)
        ctx = self._atts()[0].drop(ctx, rng)  # one mask over both branches

        lang_x = torch.cat([ctx, query_current, lang_h], dim=-1)
        gates2 = self._mm(lang_x, pre["Wl"]) + pre["bl"]
        l_h, l_c = lstm_gates(gates2, lang_c, cd)
        l_h = self.lang_drop(l_h, rng)  # the dropped l_h is also the next state
        decoder_output = torch.tanh(self.lang_lstm_layernorm(l_h))
        return decoder_output, q_h, q_c, l_h, l_c, alpha

    def decode(self, word, query_h, query_c, lang_h, lang_c, pre: Pre,
               rng: Optional[torch.Generator] = None):
        """`decode_hidden` plus the vocab projection: logits [B, V] first."""
        out, q_h, q_c, l_h, l_c, alpha = self.decode_hidden(
            word, query_h, query_c, lang_h, lang_c, pre, rng
        )
        return self.vocab_logits(out, pre), q_h, q_c, l_h, l_c, alpha


class Decoder(nn.Module):
    """Sequence-level decoder: the teacher-forced training scan or greedy
    inference; beam search drives `beam_step` / `beam_step_hidden` from
    `ops.beam_search`."""

    def __init__(self, cfg: DLSGConfig, vocab_size: int, multi_modal: bool = True):
        super().__init__()
        self.cfg = cfg
        self.step = DecoderStep(cfg, vocab_size, multi_modal)

    @staticmethod
    def _global_feat(feats, feats2):
        """Mean over proposals; both branches concatenated when multi-modal."""
        g = feats.mean(dim=1)
        if feats2 is not None:
            g = torch.cat([g, feats2.mean(dim=1)], dim=-1)
        return g

    def _precompute(self, feats, feats2, quant: bool = False) -> Pre:
        global_feat = self._global_feat(feats, feats2)
        if feats2 is None:
            feats2 = feats.new_zeros(feats.shape[0], 1, self.cfg.visual_hidden_size)
        return self.step.precompute(feats, feats2, global_feat, quant)

    def _quant(self) -> bool:
        """Whether inference quantizes (`decode_quant`; training never does)."""
        return self.cfg.decode_quant == "int8"

    def _init_state(self, feats) -> State:
        cfg = self.cfg
        B = feats.shape[0]
        qh = feats.new_zeros(B, cfg.query_hidden_size, dtype=torch.float32)
        lh = feats.new_zeros(B, cfg.decode_hidden_size, dtype=torch.float32)
        return {"qh": qh, "qc": torch.zeros_like(qh), "lh": lh, "lc": torch.zeros_like(lh)}

    def forward(
        self,
        feats,
        captions: Optional[torch.Tensor] = None,
        teacher_forcing_ratio: float = 1.0,
        feats2=None,
        rng: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Teacher-forced scan (captions given): (logits [B, T, V] fp32,
        alpha [B, T, NB*P]). Greedy decode (captions None): (token ids [B, T]
        int64, alpha)."""
        if captions is not None:
            return self._teacher_forced(feats, captions, teacher_forcing_ratio, feats2, rng)
        pre = self._precompute(feats, feats2, self._quant())
        st = self._init_state(feats)
        qh, qc, lh, lc = st["qh"], st["qc"], st["lh"], st["lc"]
        word_id = torch.full((feats.shape[0],), START_ID, dtype=torch.int64, device=feats.device)
        ids, alphas = [], []
        for _ in range(self.cfg.max_words):
            word = self.step.word_embed(word_id)
            logits, qh, qc, lh, lc, alpha = self.step.decode(word, qh, qc, lh, lc, pre)
            word_id = logits.argmax(dim=-1)  # first maximum, as jnp.argmax
            ids.append(word_id)
            alphas.append(alpha)
        return torch.stack(ids, dim=1), torch.stack(alphas, dim=1)

    def _teacher_forced(self, feats, captions, ratio: float, feats2, rng):
        """The training scan (JAX `Decoder.__call__` with captions). In
        training mode with `rng`: one coin per step for the whole batch,
        true with probability `ratio`, drawn up front on the device; the
        step's next word is the gold word where the coin is true, else the
        argmax of its logits. Otherwise every coin is true."""
        T = self.cfg.max_words
        B = feats.shape[0]
        pre = self._precompute(feats, feats2)
        st = self._init_state(feats)
        qh, qc, lh, lc = st["qh"], st["qc"], st["lh"], st["lc"]
        gold = captions[:, :T].long()
        if self.training and rng is not None:
            coins = torch.rand(T, generator=rng, device=feats.device) < ratio
        else:
            coins = torch.ones(T, dtype=torch.bool, device=feats.device)
        word_id = torch.full((B,), START_ID, dtype=torch.int64, device=feats.device)
        logits_all, alphas = [], []
        for t in range(T):
            word = self.step.word_drop(self.step.word_embed(word_id), rng)
            logits, qh, qc, lh, lc, alpha = self.step.decode(word, qh, qc, lh, lc, pre, rng)
            word_id = torch.where(coins[t], gold[:, t], logits.detach().argmax(dim=-1))
            logits_all.append(logits)
            alphas.append(alpha)
        return torch.stack(logits_all, dim=1), torch.stack(alphas, dim=1)

    def beam_step(self, word_id, state: State, pre: Pre):
        """One beam step over the flattened group: (raw logits [G, V],
        new_state, alpha [G, NB*P])."""
        word = self.step.word_embed(word_id)
        logits, qh, qc, lh, lc, alpha = self.step.decode(
            word, state["qh"], state["qc"], state["lh"], state["lc"], pre
        )
        return logits, {"qh": qh, "qc": qc, "lh": lh, "lc": lc}, alpha

    def beam_step_hidden(self, word_id, state: State, pre: Pre):
        """Like `beam_step` but stops before the vocab projection:
        (decoder_output [G, Hd], new_state, alpha); the fused vocab head
        consumes decoder_output directly."""
        word = self.step.word_embed(word_id)
        out, qh, qc, lh, lc, alpha = self.step.decode_hidden(
            word, state["qh"], state["qc"], state["lh"], state["lc"], pre
        )
        return out, {"qh": qh, "qc": qc, "lh": lh, "lc": lc}, alpha

    def vocab_head_weights(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(kernel [Hd, V] in compute dtype, bias [V] fp32) for the fused head,
        fetched once per decode; this rank's columns when the head is split
        over the model axis (`vocab_head_shard`)."""
        wr = self.step.word_restore
        return wr.kernel(self.cfg.cdtype), wr.bias.float()

    def vocab_head_shard(self) -> Optional[Tuple[int, int]]:
        """(first column, whole vocabulary) of this rank's split of the
        head, or None when it holds the whole head."""
        return self.step.word_restore.out_shard

    def init_beam_state(self, feats, feats2) -> Tuple[State, Pre]:
        """Initial (state, pre) for beam search."""
        return self._init_state(feats), self._precompute(feats, feats2, self._quant())
