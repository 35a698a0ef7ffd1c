"""Sentence discriminator DiscV2 and its proposal scoring heads (counterpart
of `dlsg_tpu/models/discriminator.py`; reference models/model.py:110-168,
models/layer.py:605-715).

The reference's Conv1d(vocab -> 512, kernel 1) over a caption distribution
is a Dense over the feature axis, in compute dtype. Its LSTM is the plain
recurrence under autograd (no kernel switch, as in the JAX package): the
gradient penalty differentiates through it twice.

Kept reference quirk: PSLScore2 ends with a mean over the batch of an
already per-sample score, and DiscV2 broadcasts the two scalar head scores
back through the per-sample fusion weights. With `groups > 1` the batch is
that many independent sub-batches stacked (real | fake in one pass) and the
mean is taken per sub-batch. Under a process group (parallel/dist.py) the
batch is the global one, as under the JAX package's mesh: the row sum goes
through `global_sum`, whose backward all-reduces the upstream gradient, so
the gradient at a rank's rows is that of the global batch's.

Dropout (0.3 at every site, hard-coded as in the JAX package) runs in
training mode when the forward is given a generator `rng`.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from dlsg_tpu_torch.config import DLSGConfig
from dlsg_tpu_torch.device import DeviceLike, resolve_device
from dlsg_tpu_torch.models.layers import (
    NEG_FILL,
    TANH_GAIN,
    JointEmbedVideoModel2,
    LatentPSL,
    ResBlock,
    SelfAttention,
    TanhLayerNorm,
    xavier_uniform_gain_,
)
from dlsg_tpu_torch.ops.linear import Dense, Dropout, LayerNorm, init_parameters
from dlsg_tpu_torch.ops.lstm import LSTMSequence
from dlsg_tpu_torch.ops.topk import top_k
from dlsg_tpu_torch.parallel.dist import global_rows, global_sum


class _PSLHead(nn.Module):
    """What PSLScore2 and PSLScore share: the proposal and sentence
    embeddings, the top-k proposals by decoder attention mass, and the
    scorer. `psl_size` and `att_size` are the input widths of the proposals
    and of the sentence encoding."""

    def __init__(self, num_psl: int, num_top: int, psl_size: int, att_size: int, dim: int = 512):
        super().__init__()
        self.num_psl, self.num_top, self.dim = num_psl, num_top, dim
        self.psl_embed = Dense(psl_size, dim)
        self.psl_embed_norm = TanhLayerNorm(dim)
        self.att_norm_dense = Dense(att_size, dim)
        self.att_norm = TanhLayerNorm(dim)
        self.psl_norm = TanhLayerNorm(dim)
        self.drop = Dropout(0.3)
        self.psl_scorer = JointEmbedVideoModel2(dim, dim, dim)

    def embed(self, psl, psl_alpha, att_out):
        """(top-k proposal embeddings [B, K, dim], sentence embedding [B, T, dim])."""
        h = self.psl_embed_norm(self.psl_embed(psl))
        if self.num_psl > self.num_top:
            # top-k by attention mass with lax.top_k's tie order
            _, idx = top_k(psl_alpha.sum(dim=1), self.num_top)  # [B, K]
            h = torch.gather(h, 1, idx[:, :, None].expand(-1, -1, h.shape[-1]))
        a = self.att_norm(self.att_norm_dense(att_out))
        return h, a

    def score(self, psl_topk, a, adj, rng):
        """Scorer over the aggregated sentence: [B, K]."""
        psl_agg = torch.matmul(adj.transpose(1, 2), a)  # [B, K, dim]
        psl_agg = self.drop(self.psl_norm(psl_agg), rng)
        return self.psl_scorer(psl_topk, psl_agg).squeeze(-1)


class PSLScore2(_PSLHead):
    """Scores a sentence encoding against latent proposals, post-softmax
    masking (reference layer.py:661-715): the adjacency is softmaxed over the
    words and then zeroed at padded positions; the per-proposal scores are
    weighted by the adjacency mass. Returns the batch mean (a scalar), or one
    mean per sub-batch ([groups]) when `groups > 1`."""

    def forward(self, psl, psl_alpha, att_out, seq_mask, rng: Optional[torch.Generator] = None,
                groups: int = 1):
        psl_topk, a = self.embed(psl, psl_alpha, att_out)
        adj = torch.matmul(a, psl_topk.transpose(1, 2)) / math.sqrt(self.dim)  # [B, T, K]
        adj = torch.softmax(adj, dim=1)  # over words
        adj = torch.where(seq_mask > 0, adj, torch.zeros_like(adj))
        adj_alpha = adj.sum(dim=1)  # [B, K]
        score = self.score(psl_topk, a, adj, rng)
        score = (score * adj_alpha).sum(-1) / adj_alpha.sum(-1)  # [B]
        # the mean over the global batch, group by group: group g of the
        # global batch is the g-th block of every rank
        n = score.shape[0] // groups
        mean = global_sum(score.reshape(groups, n).sum(dim=1)) / global_rows(n)  # [groups]
        return mean if groups > 1 else mean[0]


class PSLScore(_PSLHead):
    """Pre-softmax masking variant (reference layer.py:605-658): -9e15 fill
    before the softmax, unweighted mean over proposals. Returns [B]."""

    def forward(self, psl, psl_alpha, att_out, seq_mask, rng: Optional[torch.Generator] = None):
        psl_topk, a = self.embed(psl, psl_alpha, att_out)
        adj = torch.matmul(a, psl_topk.transpose(1, 2)) / math.sqrt(self.dim)
        adj = torch.where(seq_mask > 0, adj, torch.full_like(adj, NEG_FILL))
        adj = torch.softmax(adj, dim=1)
        return self.score(psl_topk, a, adj, rng).mean(dim=-1)


class DiscV2(nn.Module):
    """WGAN caption/proposal discriminator (reference models/model.py:110-168).

    forward(inputs [B, T, V] caption distribution (one-hot for real
    captions, the generator's raw logits for fake ones), obj and motion
    proposals [B, P, H], att_mask [B, T, T], alpha_all [B, T, 2P]) -> a
    score per row [B]. `groups > 1` scores that many stacked sub-batches in
    one pass; each row's score equals the one of a separate call on its
    sub-batch.

    Weights are drawn from `generator` (default: seeded with `cfg.seed`)
    and the module is moved to `device` (default `cuda`). It starts in eval
    mode, as CapGnnModel does."""

    def __init__(
        self,
        cfg: DLSGConfig,
        vocab_size: int,
        dim: int = 512,
        *,
        generator: Optional[torch.Generator] = None,
        device: DeviceLike = None,
    ):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.vocab_size = vocab_size
        self.dim = dim
        P, K, H = cfg.num_proposals, cfg.num_topk, cfg.visual_hidden_size
        cd = cfg.cdtype
        self.conv1d = Dense(vocab_size, dim, dtype=cd)
        self.block = ResBlock(dim)
        self.lstm = LSTMSequence(dim, dim, dtype=cd)
        self.layer_norm = LayerNorm(dim)
        self.drop = Dropout(0.3)
        self.att = SelfAttention(dim, dim, dim, dtype=cd, dropout=0.3)
        self.att_norm = TanhLayerNorm(dim)
        self.obj_psl_score = PSLScore2(P, K, H, dim, dim)
        self.motion_psl_score = PSLScore2(P, K, H, dim, dim)
        self.text_sum = LatentPSL(dim, 1)
        self.fusion = nn.Parameter(torch.empty(2, dim))
        init_parameters(self, generator or torch.Generator().manual_seed(cfg.seed))
        self.eval()
        self.to(device)

    def reset_parameters(self, generator=None) -> None:
        xavier_uniform_gain_(self.fusion.data, TANH_GAIN, generator)

    def forward(
        self,
        inputs,
        obj_proposals,
        motion_proposals,
        att_mask,
        alpha_all,
        groups: int = 1,
        rng: Optional[torch.Generator] = None,
    ):
        if self.training and rng is None:
            raise ValueError("a training-mode forward needs rng, a torch.Generator on the model's device")
        P, K = self.cfg.num_proposals, self.cfg.num_topk
        h = self.conv1d(inputs).float()  # Conv1d(V -> dim, k=1) as a Dense
        h = self.block(h)
        h = self.lstm(h)
        h = self.drop(self.layer_norm(h), rng)
        att_out = self.att_norm(self.att(h, att_mask, rng))

        # word-validity mask from row 0 of att_mask (reference model.py:158-160)
        word_mask = att_mask[:, 0, :]  # [B, T]
        alpha_all = alpha_all * word_mask[:, :, None]
        seq_mask = word_mask[:, :, None].expand(-1, -1, K)  # [B, T, K]
        obj_score = self.obj_psl_score(
            obj_proposals, alpha_all[:, :, :P], att_out, seq_mask, rng, groups
        )
        motion_score = self.motion_psl_score(
            motion_proposals, alpha_all[:, :, -P:], att_out, seq_mask, rng, groups
        )
        sent_sum = self.text_sum(att_out, rng).squeeze(1)  # [B, dim]
        fusion_score = torch.softmax(sent_sum @ self.fusion.t(), dim=-1)  # [B, 2]
        if groups > 1:
            # each sub-batch's mean score over its rows; an expand, whose
            # backward is a sum (repeat_interleave's adds atomically on a
            # card, in an order that changes from run to run)
            n_per = inputs.shape[0] // groups
            obj_score = obj_score[:, None].expand(groups, n_per).reshape(-1)
            motion_score = motion_score[:, None].expand(groups, n_per).reshape(-1)
        return obj_score * fusion_score[:, 0] + motion_score * fusion_score[:, 1]
