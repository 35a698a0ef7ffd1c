"""Batched beam search (counterpart of `dlsg_tpu/ops/beam_search.py`).

Semantics of the vendored AllenNLP BeamSearch (reference
models/allennlp_beamsearch.py:19-294): first-step top-k expansion, per-node
beam, end-token forcing after a beam emits `<end>`, backpointer state
reordering and backpointer sequence reconstruction. Each step calls `step_fn`
once over the flattened [B*beam] group.

Every top-k here is exact, with `lax.top_k`'s order (ties to the lowest
index, `ops.topk.top_k`): `approx_topk_recall` is accepted for signature
parity and does not change the result.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from dlsg_tpu_torch.ops.topk import top_k
from dlsg_tpu_torch.utils.profiler import count


def _lse(lp: torch.Tensor, fast: bool) -> torch.Tensor:
    """Row logsumexp. `fast` is the JAX package's one-pass clipped sumexp,
    exact while logits lie in (-88, 80) fp32; else the max-shifted form."""
    if fast:
        return torch.log(torch.exp(lp.clamp_max(80.0)).sum(dim=-1) + 1e-37)
    return torch.logsumexp(lp, dim=-1)


def _gather_beams(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """t [B, beam, ...] gathered along the beam axis by idx [B, beam]."""
    idx = idx.reshape(*idx.shape, *([1] * (t.dim() - 2))).expand(*idx.shape, *t.shape[2:])
    return torch.gather(t, 1, idx)


def beam_search(
    start_tokens: torch.Tensor,
    init_state: Dict[str, torch.Tensor],
    step_fn: Callable,
    *,
    end_id: int,
    max_steps: int,
    beam_size: int,
    per_node_beam_size: int | None = None,
    normalize: bool = False,
    sparse_step: bool = False,
    fast_lse: bool = False,
    approx_topk_recall: float = 0.0,
    return_finished: bool = False,
    early_exit: bool = True,
):
    """Run beam search.

    Args:
      start_tokens: [B] int64 start token per sequence.
      init_state: dict of tensors with leading axis B.
      step_fn: (tokens [G], state) -> (log_probs [G, V], state[, aux [G, ...]]).
        With `normalize=True` it may return raw logits. With
        `sparse_step=True` it returns (top_vals [G, pnbs], top_ids [G, pnbs],
        state[, aux]) already log-softmax-normalized and sorted descending
        (the vocab_head kernel's contract); pnbs must be >= beam_size.
      normalize: top-k runs on the raw logits and only the selected values
        have the row logsumexp subtracted.
      fast_lse: use the one-pass clipped sumexp for that logsumexp.
      early_exit: once every hypothesis has emitted `<end>`, the remaining
        steps are not run: they would emit `<end>` with unchanged scores and
        zero aux. This reads the number of live hypotheses (last token not
        `<end>`) on the host before each step until none is left; while a
        trace runs, each step that runs adds B*beam to the counter
        `beam.hyp_steps` and that number to `beam.live_hyp_steps`
        (utils/profiler.py).

    Returns:
      predictions [B, beam, max_steps] (best first), log_probs [B, beam],
      aux [B, beam, max_steps, ...] when step_fn emits aux, and, with
      `return_finished`, finished [B] bool (all of the row's beams ended).
    """
    del approx_topk_recall  # exact top-k for every value
    pnbs = per_node_beam_size or beam_size
    B = start_tokens.shape[0]
    dev = start_tokens.device

    # ---- first step: B -> B*beam expansion ----
    out0 = step_fn(start_tokens, init_state)
    if sparse_step:
        vals0, ids0, state = out0[0], out0[1], out0[2]
        has_aux = len(out0) > 3
        aux0 = out0[3] if has_aux else None
        pnbs = vals0.shape[-1]
        if pnbs < beam_size:
            raise ValueError("a sparse step must return >= beam_size candidates")
        start_lp, start_ids = vals0[:, :beam_size], ids0[:, :beam_size]
    else:
        lp0, state = out0[0], out0[1]
        has_aux = len(out0) > 2
        aux0 = out0[2] if has_aux else None  # [B, ...], shared by the first beams
        V = lp0.shape[-1]
        start_lp, start_ids = top_k(lp0, beam_size)
        if normalize:
            start_lp = start_lp - _lse(lp0, fast_lse)[:, None]
        after_end_row = torch.full((V,), -torch.inf, device=dev, dtype=lp0.dtype)
        after_end_row[end_id] = 0.0
    state = {k: v.repeat_interleave(beam_size, dim=0) for k, v in state.items()}

    # top-k image of the forced-<end> row on the normalize/sparse paths
    forced_vals = torch.full((pnbs,), -torch.inf, device=dev)
    forced_vals[0] = 0.0
    forced_ids = torch.full((pnbs,), end_id, device=dev, dtype=torch.int64)
    identity_ptr = torch.arange(beam_size, device=dev).expand(B, beam_size)

    last_preds, last_lp = start_ids, start_lp
    preds_seq, backptr_seq, aux_seq = [], [], []
    done = False
    for _ in range(max_steps - 1):
        if early_exit and not done:
            live = int((last_preds != end_id).sum())  # the step's one host read
            done = live == 0
            if not done:
                count("beam.hyp_steps", B * beam_size)
                count("beam.live_hyp_steps", live)
        if done:
            preds_t = torch.full((B, beam_size), end_id, device=dev, dtype=torch.int64)
            preds_seq.append(preds_t)
            backptr_seq.append(identity_ptr)
            if has_aux:
                aux_seq.append(aux0.new_zeros(B, beam_size, *aux0.shape[1:]))
            continue
        flat_preds = last_preds.reshape(B * beam_size)
        out = step_fn(flat_preds, state)
        ended = (flat_preds == end_id)[:, None]
        if sparse_step:
            vals, top_ids, new_state = out[0], out[1], out[2]
            aux = out[3] if has_aux else None
            top_lp = torch.where(ended, forced_vals[None, :], vals)
            top_ids = torch.where(ended, forced_ids[None, :], top_ids)
        elif normalize:
            lp, new_state = out[0], out[1]
            aux = out[2] if has_aux else None
            vals, top_ids = top_k(lp, pnbs)
            vals = vals - _lse(lp, fast_lse)[:, None]
            top_lp = torch.where(ended, forced_vals[None, :], vals)
            top_ids = torch.where(ended, forced_ids[None, :], top_ids)
        else:
            lp, new_state = out[0], out[1]
            aux = out[2] if has_aux else None
            cleaned = torch.where(ended, after_end_row[None, :], lp)
            top_lp, top_ids = top_k(cleaned, pnbs)
        summed = top_lp + last_lp.reshape(B * beam_size, 1)
        beam_lp, beam_idx = top_k(summed.reshape(B, beam_size * pnbs), beam_size)
        preds_t = torch.gather(top_ids.reshape(B, beam_size * pnbs), 1, beam_idx)
        backptr = beam_idx // pnbs  # ancestor beam
        state = {
            k: _gather_beams(v.reshape(B, beam_size, *v.shape[1:]), backptr).reshape(v.shape)
            for k, v in new_state.items()
        }
        preds_seq.append(preds_t)
        backptr_seq.append(backptr)
        if has_aux:
            # aux is indexed by the PARENT beam row (the row that was expanded)
            aux_seq.append(aux.reshape(B, beam_size, *aux.shape[1:]))
        last_preds, last_lp = preds_t, beam_lp

    # ---- reconstruction: walk the backpointers from the last step ----
    cur_ptr = identity_ptr
    tail_tokens, tail_aux = [], []
    for k in range(len(preds_seq) - 1, -1, -1):
        tail_tokens.append(torch.gather(preds_seq[k], 1, cur_ptr))
        cur_ptr = torch.gather(backptr_seq[k], 1, cur_ptr)
        if has_aux:
            # the step-k aux of the surviving beam came from its parent row
            tail_aux.append(_gather_beams(aux_seq[k], cur_ptr))
    tail_tokens.reverse()
    tail_aux.reverse()
    first_tokens = torch.gather(start_ids, 1, cur_ptr)
    predictions = torch.stack([first_tokens, *tail_tokens], dim=-1)  # [B, beam, T]
    finished = (last_preds == end_id).all(dim=1)
    result = [predictions, last_lp]
    if has_aux:
        first_aux = aux0[:, None].expand(B, beam_size, *aux0.shape[1:])
        result.append(torch.stack([first_aux, *tail_aux], dim=2))  # [B, beam, T, ...]
    if return_finished:
        result.append(finished)
    return tuple(result)
