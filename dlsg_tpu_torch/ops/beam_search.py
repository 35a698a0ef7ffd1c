"""Batched beam search (counterpart of `dlsg_tpu/ops/beam_search.py`).

Semantics of the vendored AllenNLP BeamSearch (reference
models/allennlp_beamsearch.py:19-294): first-step top-k expansion, per-node
beam, end-token forcing after a beam emits `<end>`, backpointer state
reordering and backpointer sequence reconstruction. Each step calls `step_fn`
once over the flattened [B*beam] group.

Every top-k here is exact, with `lax.top_k`'s order (ties to the lowest
index, `ops.topk.top_k`): `approx_topk_recall` is accepted for signature
parity and does not change the result.

A later step (`_later_step`: step_fn, the forced-`<end>` masking, the summed
scores, both top-ks, the backpointer, the preds' gather and the state's
reorder) is replayed from one CUDA graph (utils/cuda_graph.py) where the
caller keeps its step's graphs (`StepGraphs`), hands step_fn the tensors
it reads besides its tokens and state (`invariants`), and passes the
graphs only for a step that runs no collective and no host read (the
caller's rule), and where `graph_engaged` holds: on a card, where step_fn
returned its state in the shapes it was given. The first later step of a
new key runs eagerly and shows that; the graph's buffers are filled right
after it, the next step runs eagerly on the graph's stream as its warm-up
and is captured, and the steps after it replay. So every step runs once,
and each launch that the kernels' counters count is a step's. A key whose
graph exists replays from the first later step on. The graph reads its
own buffers: each decode copies its invariants, state, preds and scores
into them before its first graphed step, and each step writes the new
preds, scores and state back into them; its preds, backpointer and aux
are copied out, since the next replay overwrites them. The host keeps the early exit's
read of the live count, one a step, so a later step costs it one read and
one replay. The numbers are the eager loop's, bitwise: the same kernels run
in the same order.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Hashable, Optional

import torch

from dlsg_tpu_torch.kernels.vocab_head import PreparedHead
from dlsg_tpu_torch.ops.topk import top_k
from dlsg_tpu_torch.utils.cuda_graph import Graph
from dlsg_tpu_torch.utils.profiler import count

State = Dict[str, torch.Tensor]


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


def _layout(tree) -> Any:
    """What a graph bakes in of a tree of dicts, tensors and
    `PreparedHead`s: each tensor's shape, strides, dtype and device."""
    if isinstance(tree, torch.Tensor):
        return (tuple(tree.shape), tree.stride(), tree.dtype, tree.device)
    if isinstance(tree, PreparedHead):
        return ("head", _layout(tree.w), _layout(tree.parts))
    if isinstance(tree, dict):
        return tuple((k, _layout(v)) for k, v in sorted(tree.items()))
    if tree is None:
        return None
    raise TypeError(f"a graphed beam step reads no {type(tree).__name__}")


def _buffers(tree, shared: Dict[tuple, Any], path: tuple = ()) -> Any:
    """Storage of its own for each tensor and head of `tree`, in its layout:
    one buffer per (path, layout) in `shared`, so that what two keys' trees
    hold alike (the weights) is held once."""
    if isinstance(tree, dict):
        return {k: _buffers(v, shared, path + (k,)) for k, v in tree.items()}
    if tree is None:
        return None
    key = (path, _layout(tree))
    if key not in shared:
        shared[key] = (tree.empty_like() if isinstance(tree, PreparedHead) else
                       torch.empty_strided(tree.shape, tree.stride(), dtype=tree.dtype,
                                           device=tree.device))
    return shared[key]


def _load(dst, src) -> None:
    """Copy the tree `src` into `dst`, `_buffers` of its layout."""
    if isinstance(src, dict):
        for k, v in src.items():
            _load(dst[k], v)
    elif src is not None:
        dst.copy_(src)


def graph_engaged(device, given: State, returned: State) -> bool:
    """Whether a decode's later steps replay from one CUDA graph, of a step
    whose caller hands over its graphs (module doc): on a card, where
    step_fn returned its state in the shapes and dtypes it was given (a
    state that grows, such as a cache of the caption's tokens, needs a
    graph a step)."""
    return (torch.device(device).type == "cuda"
            and {k: (v.shape, v.dtype) for k, v in given.items()}
            == {k: (v.shape, v.dtype) for k, v in returned.items()})


class _StepGraph:
    """One key's later beam step as a CUDA graph (module doc): the preds
    [B, beam], scores [B, beam], state and fixed inputs it reads, in buffers
    of its own (the fixed ones shared with the key's siblings), written
    back by each step. Its first step runs eagerly on the graph's stream as
    the warm-up, which the capture then records; every later one replays."""

    def __init__(self, preds, lp, state: State, fixed, owner: "StepGraphs"):
        def own(t):
            return torch.empty_like(t, memory_format=torch.contiguous_format)

        self.preds, self.lp = own(preds), own(lp)
        self.state = {k: own(v) for k, v in state.items()}
        self.fixed = _buffers(fixed, owner.buffers)
        self.owner = owner
        self.graph: Optional[Graph] = None
        self.load(preds, lp, state, fixed)

    def _step(self, later: Callable):
        preds, backptr, lp, state, aux = later(self.preds, self.lp, self.state, self.fixed)
        self.preds.copy_(preds)
        self.lp.copy_(lp)
        for k, v in state.items():
            self.state[k].copy_(v)
        return preds, backptr, aux

    def load(self, preds, lp, state: State, fixed=None) -> None:
        """A decode's preds, scores, state and (given) fixed inputs into the
        graph's buffers."""
        self.preds.copy_(preds)
        self.lp.copy_(lp)
        for k, v in state.items():
            self.state[k].copy_(v)
        if fixed is not None:
            _load(self.fixed, fixed)

    @property
    def captured(self) -> bool:
        return self.graph is not None

    def step(self, later: Callable):
        """One later step, `later` run by the warm-up and recorded by the
        capture if this is the first: copies of its preds, backpointer and
        aux (or None); the scores stay in `lp`."""
        if self.graph is None:
            graph = Graph(self.preds.device, pool=self.owner.pool)
            out = graph.warm_up(lambda: self._step(later))
            graph.capture(lambda: self._step(later))  # runs nothing: the buffers hold the warm-up's
            self.graph, self.owner.pool = graph, graph.pool
        else:
            out = self.graph.replay()
        preds, backptr, aux = out
        return preds.clone(), backptr.clone(), None if aux is None else aux.clone()


class StepGraphs:
    """A step function's later-step graphs, kept by its caller across
    decodes (module doc): one a key, in one memory pool, the buffers of
    their fixed inputs shared by path and layout. `owner()` names what the
    step reads besides its tokens, state and invariants (a model's
    parameters by address, say); a new owner drops the graphs."""

    def __init__(self, owner: Callable[[], Hashable] = tuple) -> None:
        self.owner = owner
        self.graphs: Dict[tuple, _StepGraph] = {}
        self.buffers: Dict[tuple, Any] = {}
        self.pool = None
        self._owner_key: Optional[Hashable] = None

    def claim(self) -> None:
        """Drop the graphs if their owner has changed."""
        owner = self.owner()
        if owner != self._owner_key:
            if self.graphs:
                self.graphs.clear()
                self.buffers.clear()
                self.pool = None
                torch.cuda.empty_cache()  # the dropped pool comes back only so
            self._owner_key = owner


def _later_step(step_fn: Callable, preds, lp, state: State, fixed, *, B: int, beam_size: int,
                pnbs: int, end_id: int, sparse_step: bool, normalize: bool, fast_lse: bool,
                has_aux: bool):
    """One step after the first, from the last preds and scores [B, beam]
    and the state: (preds [B, beam], backpointer [B, beam], scores [B,
    beam], the reordered state, aux [B, beam, ...] or None). `fixed` holds
    step_fn's invariants (or None: step_fn takes tokens and state alone) and
    the forced-`<end>` rows."""
    flat_preds = preds.reshape(B * beam_size)
    inv = fixed["invariants"]
    out = step_fn(flat_preds, state) if inv is None else step_fn(flat_preds, state, inv)
    ended = (flat_preds == end_id)[:, None]
    forced_vals, forced_ids = fixed["forced_vals"], fixed["forced_ids"]
    if sparse_step:
        vals, top_ids, new_state = out[0], out[1], out[2]
        aux = out[3] if has_aux else None
        top_lp = torch.where(ended, forced_vals[None, :], vals)
        top_ids = torch.where(ended, forced_ids[None, :], top_ids)
    elif normalize:
        lp_v, new_state = out[0], out[1]
        aux = out[2] if has_aux else None
        vals, top_ids = top_k(lp_v, pnbs)
        vals = vals - _lse(lp_v, fast_lse)[:, None]
        top_lp = torch.where(ended, forced_vals[None, :], vals)
        top_ids = torch.where(ended, forced_ids[None, :], top_ids)
    else:
        lp_v, new_state = out[0], out[1]
        aux = out[2] if has_aux else None
        cleaned = torch.where(ended, fixed["after_end_row"][None, :], lp_v)
        top_lp, top_ids = top_k(cleaned, pnbs)
    summed = top_lp + lp.reshape(B * beam_size, 1)
    beam_lp, beam_idx = top_k(summed.reshape(B, beam_size * pnbs), beam_size)
    preds_t = torch.gather(top_ids.reshape(B, beam_size * pnbs), 1, beam_idx)
    backptr = beam_idx // pnbs  # ancestor beam
    new_state = {
        k: _gather_beams(v.reshape(B, beam_size, *v.shape[1:]), backptr).reshape(v.shape)
        for k, v in new_state.items()
    }
    if has_aux:
        # aux is indexed by the PARENT beam row (the row that was expanded)
        aux = aux.reshape(B, beam_size, *aux.shape[1:])
    return preds_t, backptr, beam_lp, new_state, aux


def _graph_key(graphs: StepGraphs, dev, rule: dict, lp, state: State, fixed) -> tuple:
    """What a later step's graph bakes in: the step's rule, the shapes of
    its scores and state, its fixed inputs' layouts. `graphs` is claimed
    for the step's owner first."""
    graphs.claim()
    return (dev, tuple(sorted(rule.items())), tuple(lp.shape), lp.dtype,
            tuple((k, tuple(v.shape), v.dtype) for k, v in sorted(state.items())), _layout(fixed))


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
    invariants: Optional[Dict[str, Any]] = None,
    graphs: Optional[StepGraphs] = None,
):
    """Run beam search.

    Args:
      start_tokens: [B] int64 start token per sequence.
      init_state: dict of tensors with leading axis B.
      step_fn: (tokens [G], state) -> (log_probs [G, V], state[, aux [G, ...]]),
        or (tokens, state, invariants) when `invariants` is given.
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
      invariants: a tree (dicts, tensors, `PreparedHead`s) of what
        step_fn reads besides its tokens and state, handed to each call; a
        graphed later step hands over its own copy (module doc).
      graphs: the caller's `StepGraphs` for this step function, to replay
        the later steps from; needs `invariants`, and a step_fn that runs
        no collective and reads nothing on the host. While a trace runs, with
        the early exit on, `beam.steps` counts each later step that runs
        and `beam.steps_graphed` each replay (not the graph's warm-up).

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
    if graphs is not None and invariants is None:
        raise ValueError("graphed beam steps need the step's invariants")
    if invariants is None:
        out0 = step_fn(start_tokens, init_state)
    else:
        out0 = step_fn(start_tokens, init_state, invariants)
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
    fixed = {"invariants": invariants, "forced_vals": forced_vals, "forced_ids": forced_ids,
             "after_end_row": None if sparse_step else after_end_row}
    rule = dict(B=B, beam_size=beam_size, pnbs=pnbs, end_id=end_id, sparse_step=sparse_step,
                normalize=normalize, fast_lse=fast_lse, has_aux=has_aux)

    def later(preds, lp, st, fx):
        return _later_step(step_fn, preds, lp, st, fx, **rule)

    # a key whose graph exists replays from the decode's first later step;
    # a new key's first later step runs eagerly and shows whether one serves
    key = None if graphs is None else _graph_key(graphs, dev, rule, start_lp, state, fixed)
    graph = None if key is None else graphs.graphs.get(key)
    if graph is not None:
        graph.load(start_ids, start_lp, state, fixed)
    check = key is not None and graph is None
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
        if early_exit:
            count("beam.steps")
            count("beam.steps_graphed", int(graph is not None and graph.captured))
        if graph is not None:
            preds_t, backptr, aux = graph.step(later)
        else:
            given = state
            preds_t, backptr, last_lp, state, aux = later(last_preds, last_lp, state, fixed)
            if check:
                check = False
                if graph_engaged(dev, given, state):
                    graph = graphs.graphs[key] = _StepGraph(preds_t, last_lp, state, fixed, graphs)
        preds_seq.append(preds_t)
        backptr_seq.append(backptr)
        if has_aux:
            aux_seq.append(aux)
        last_preds = preds_t
    if graph is not None:
        last_lp = graph.lp.clone()

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
