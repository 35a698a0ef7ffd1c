"""Decode functions (counterpart of the decode half of
`dlsg_tpu/evaluation/evaluate.py`): greedy and beam search over any
generator of `models/generator.py`, with the fused vocab-head kernel behind
`use_fused_vocab_head`. Both go through the generator's `encode`, which
gives the decoder's (feats, feats2): feats2 is None for the single-modal
generators, whose decoder attends over the T frames, so their attention
weights are [B, T_words, T_frames] where CapGnnModel's are [B, T_words, 2P].

Scoring is `evaluation/evaluate.py::evaluate`. With `0 <
decode_two_pass_t1 < max_words` the beam decode runs in two passes
(`_make_two_pass_fn`).

With the vocab head split over a mesh's model axis (`parallel/mesh.py`),
every model peer decodes the same rows. The plain head gathers whole
logits (models/decoder.py). The fused head runs the kernel on this rank's
columns (`normalize=False, return_lse=True`), offsets its ids, all-gathers
the [G, k] values and ids and the [G] logsumexp over the model group and
merges them (`merge_shard_topk`): the same top-k and normalization as the
whole head. The JAX package drops its kernel under a mesh instead (a
Mosaic call cannot be partitioned); the function is the same. The merged
values are equal on every peer, so the beam's per-step early exit and the
two-pass decode's unfinished count, read from them, keep the peers in step
through every collective.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from dlsg_tpu_torch.config import DLSGConfig
from dlsg_tpu_torch.device import DeviceLike, resolve_device
from dlsg_tpu_torch.kernels.vocab_head import vocab_head_topk
from dlsg_tpu_torch.models.decoder import expand_pre_to_beams
from dlsg_tpu_torch.ops.beam_search import beam_search
from dlsg_tpu_torch.ops.topk import top_k
from dlsg_tpu_torch.parallel import dist
from dlsg_tpu_torch.vocab import END_ID, START_ID


def _use_fused_head(cfg: DLSGConfig) -> bool:
    """'on' routes each beam step's vocab projection + top-k + logsumexp to
    the vocab_head kernel; 'auto' resolves to off, as in the JAX package."""
    return cfg.use_fused_vocab_head == "on"


def merge_shard_topk(
    vals: torch.Tensor, ids: torch.Tensor, lse: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The whole head's normalized top-k from the shards': vals and ids
    [G, n, k] (each shard's raw top-k, descending, ids already offset to
    whole-vocabulary columns), lse [G, n]. The k best of the n*k candidates
    by value descending, then id ascending (`lax.top_k`'s tie rule across a
    shard boundary: shards are in column order and each lists its ties by
    id, so position order among equal values is id order), minus the
    logsumexp of the shards' logsumexps."""
    G, n, kk = vals.shape
    best, pos = top_k(vals.reshape(G, n * kk), k)
    row_lse = torch.logsumexp(lse, dim=-1, keepdim=True)
    return best - row_lse, torch.gather(ids.reshape(G, n * kk), 1, pos)


def sharded_vocab_head_topk(
    h: torch.Tensor, w: torch.Tensor, b: torch.Tensor, k: int, first_col: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """`vocab_head_topk(h, w_whole, b_whole, k, normalize=True)` of a head
    split over the model axis, from this rank's columns w [H, V/n] (from
    `first_col`) and b: the kernel on the shard, one all-gather of its
    top-k and logsumexp over the model group, `merge_shard_topk`."""
    vals, ids, lse = vocab_head_topk(h, w, b, k, normalize=False, return_lse=True)
    group = dist.current_mesh().model_group
    vals_g, ids_g, lse_g = dist.all_gather_tensors([vals, ids + first_col, lse], group)
    return merge_shard_topk(vals_g.transpose(0, 1), ids_g.transpose(0, 1), lse_g.t(), k)


def make_decode_fn(
    model,
    cfg: DLSGConfig,
    beam_size: Optional[int] = None,
    return_alpha: bool = False,
    device: DeviceLike = None,
) -> Callable:
    """Build decode(frames, regions) -> token ids [B, T] on `device`.

    The model is moved to `device` (default `cuda`). beam_size None/1 ->
    greedy; else beam search returning the top beam. With `return_alpha` the
    decode also returns the decoder's attention weights over the emitted
    caption (module doc: [B, T, 2P], or [B, T, T_frames] for a single-modal
    generator; for beam search, reconstructed through the backpointers).
    Inputs may be numpy arrays or tensors; they are moved to `device`. The
    frames-only generators ignore `regions`, which may be None."""
    device = resolve_device(device)
    model.to(device)
    beam = beam_size if beam_size is not None else cfg.beam_size

    def _inputs(frames, regions):
        return (torch.as_tensor(frames, device=device),
                None if regions is None else torch.as_tensor(regions, device=device))

    if beam <= 1:

        @torch.inference_mode()
        def decode_greedy(frames, regions):
            ids, alpha = model.greedy_decode(*_inputs(frames, regions))
            return (ids, alpha) if return_alpha else ids

        return decode_greedy

    beam_feats = _make_beam_from_feats(model, cfg, beam)
    t1 = cfg.decode_two_pass_t1
    if 0 < t1 < cfg.max_words:
        return _make_two_pass_fn(model, cfg, return_alpha, beam_feats, t1, _inputs)

    @torch.inference_mode()
    def decode_beam(frames, regions):
        obj, mot = model.encode(*_inputs(frames, regions))
        preds, _, alphas, _ = beam_feats(obj, mot, cfg.max_words)
        if return_alpha:
            return preds[:, 0, :], alphas[:, 0]
        return preds[:, 0, :]

    return decode_beam


def _make_two_pass_fn(
    model, cfg: DLSGConfig, return_alpha: bool, beam_feats: Callable, t1: int, inputs: Callable
) -> Callable:
    """Per-sequence early exit in two passes (JAX's `_make_two_pass_fn`).

    Pass 1 beam-decodes every row for t1 steps. Rows whose beams have all
    emitted `<end>` by then can never change (a forced `<end>` adds log-prob
    0), so only the others are decoded again, from the encoder outputs, at
    full length: compacted by a stable argsort of the finished mask into a
    bucket of `decode_two_pass_bucket` (default B // 4) rows and scattered
    back. When more rows than the bucket are unfinished, the whole batch is
    decoded again instead.

    JAX picks the branch with a `lax.cond` on the device. Here one host read
    of the unfinished count picks it (the beam already syncs once a step for
    its early exit), and with no unfinished row pass 2 is skipped, which
    JAX's masked scatter leaves the same."""
    T = cfg.max_words

    def pass2(obj, mot):
        preds, _, alphas, _ = beam_feats(obj, mot, T)
        return preds[:, 0, :], alphas[:, 0]

    @torch.inference_mode()
    def decode_two_pass(frames, regions):
        obj, mot = model.encode(*inputs(frames, regions))
        B = obj.shape[0]
        bucket = max(1, min(B, cfg.decode_two_pass_bucket or B // 4))
        preds1, _, alphas1, fin = beam_feats(obj, mot, t1)
        ids = torch.cat([preds1[:, 0, :], preds1.new_full((B, T - t1), END_ID)], dim=1)
        al1 = alphas1[:, 0]
        alphas = torch.cat([al1, al1.new_zeros((B, T - t1) + al1.shape[2:])], dim=1)
        unfin = ~fin
        n_unfin = int(unfin.sum())  # the one host read that picks the branch
        if 0 < n_unfin <= bucket < B:
            # unfinished rows first, in their order, then finished ones
            idx = torch.argsort(fin.to(torch.int8), stable=True)[:bucket]
            ids2, al2 = pass2(obj[idx], None if mot is None else mot[idx])
            mask = unfin[idx]
            ids[idx] = torch.where(mask[:, None], ids2, ids[idx])
            alphas[idx] = torch.where(mask[:, None, None], al2, alphas[idx])
        elif n_unfin:
            ids2, al2 = pass2(obj, mot)
            ids = torch.where(unfin[:, None], ids2, ids)
            alphas = torch.where(unfin[:, None, None], al2, alphas)
        return (ids, alphas) if return_alpha else ids

    return decode_two_pass


def _make_beam_from_feats(model, cfg: DLSGConfig, beam: int) -> Callable:
    """The encoder outputs -> beam-decode core: fn(obj, mot, max_steps) ->
    (preds [B, beam, T], log_probs [B, beam], alphas [B, beam, T, P'],
    finished [B]), P' the attention's width (module doc); `mot` is None
    for a single-modal generator."""
    fused = _use_fused_head(cfg)

    def beam_from_feats(obj, mot, max_steps: int):
        state, pre = model.decoder_init_beam_state(obj, mot)
        B = obj.shape[0]
        # the batch-axis invariants expanded to [B*beam] once, not per step
        pre_x = expand_pre_to_beams(pre, beam)

        if fused:
            wv, bv = model.decoder_vocab_head()
            shard = model.decoder_vocab_shard()

            def step_fn(tokens, st):
                # the first step runs un-expanded on [B]
                p = pre if tokens.shape[0] == B else pre_x
                hid, new_st, alpha = model.decoder_beam_step_hidden(tokens, st, p)
                if shard is None:
                    vals, ids = vocab_head_topk(hid, wv, bv, beam, normalize=True)
                else:
                    vals, ids = sharded_vocab_head_topk(hid, wv, bv, beam, shard[0])
                return vals, ids, new_st, alpha

        else:

            def step_fn(tokens, st):
                p = pre if tokens.shape[0] == B else pre_x
                return model.decoder_beam_step(tokens, st, p)

        start = torch.full((B,), START_ID, dtype=torch.int64, device=obj.device)
        return beam_search(
            start,
            state,
            step_fn,
            end_id=END_ID,
            max_steps=max_steps,
            beam_size=beam,
            normalize=True,  # beam_step returns raw logits
            sparse_step=fused,
            # exact for logits in (-88, 80), which this model's tanh(LN) @ W
            # head guarantees; the fused head computes the exact lse itself
            fast_lse=cfg.decode_fast_lse and cfg.decode_quant == "none",
            approx_topk_recall=cfg.decode_approx_topk,
            return_finished=True,
        )

    return beam_from_feats
