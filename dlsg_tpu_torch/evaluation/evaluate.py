"""Evaluation (counterpart of `evaluate()` in `dlsg_tpu/evaluation/evaluate.py`;
reference `evaluate.py:56-134`): decode the eval set batch by batch, turn the
tokens into strings, score them with the COCO scorer, and return
(scores, {vid: caption}, alpha_all, inference seconds) as the reference does.

The decode function comes from `evaluation/decode.py::make_decode_fn`; it
reads the model's parameters as they are when it is called, so the trainer
passes no parameters.

Data parallelism: each data index decodes its shard (`eval_batches(...,
shard_index=data_rank, num_shards=data_size)`) on its own card, so the
fused vocab head and the per-step early exit stay on (the JAX package drops
both under a mesh, whose decode is one sharded program); with a model axis,
the model peers of a data index decode the same shard with the head split
between them (evaluation/decode.py). The gather then merges the shards
over the data axis on every rank (parallel/dist.py::gather_eval), and
every rank scores the whole set.
"""

from __future__ import annotations

import time
from collections import OrderedDict
from typing import Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from dlsg_tpu_torch.data.prefetch import stage_cast
from dlsg_tpu_torch.metrics.scorer import COCOScorer
from dlsg_tpu_torch.parallel.dist import gather_eval
from dlsg_tpu_torch.vocab import Vocabulary


def _numpy(t) -> np.ndarray:
    if torch.is_tensor(t):
        t = t.detach()
        return (t.float() if t.is_floating_point() else t).cpu().numpy()
    return np.asarray(t)


def evaluate(
    decode_fn: Callable,
    eval_iter: Iterable[dict],
    vocab: Vocabulary,
    reference: Dict,
    scorer: Optional[COCOScorer] = None,
    stage_dtype: Optional[torch.dtype] = None,
) -> Tuple[Dict[str, float], "OrderedDict[str, str]", Optional[np.ndarray], float]:
    """Decode every batch of `eval_iter` with `decode_fn(frames, regions)` and
    score the captions of the rows its `valid` mask keeps against
    `reference` ({vid: [{"caption": ...}]}, or plain strings).

    alpha_all is the decoder's attention, [N, T, 2P] fp32 (CapGnnModel) or
    [N, T, T_frames] (a single-modal generator), when decode_fn returns
    (ids, alpha) (built with return_alpha=True), else None. Batch k+1's
    decode is launched before batch k's tokens are copied to the host;
    results are consumed in order.
    `stage_dtype` is the input_stage_dtype policy (cfg.stage_dtype).

    Inside a process group (the JAX package's `cross_host_gather`),
    `eval_iter` is this rank's shard, and the decoded shards are merged
    across the ranks before scoring, so every rank returns the same scores
    and captions (an empty shard still joins the gather). Without a group
    the gather is the identity."""
    ids_chunks, vid_chunks, alpha_chunks = [], [], []
    start = time.time()

    def _consume(out, batch):
        if isinstance(out, tuple):
            ids, alphas = out
            alphas = _numpy(alphas)
        else:
            ids, alphas = out, None
        ids = _numpy(ids)  # the host sync
        valid = np.asarray(batch.get("valid", np.ones(ids.shape[0], bool)))
        vids = np.asarray([int(v) for v in batch["video_ids"]])
        ids_chunks.append(ids[valid])
        vid_chunks.append(vids[valid])
        if alphas is not None:
            alpha_chunks.append(alphas[valid])

    pending = None
    for batch in eval_iter:
        out = decode_fn(stage_cast(batch["frames"], stage_dtype),
                        stage_cast(batch["regions"], stage_dtype))
        if pending is not None:
            _consume(*pending)
        pending = (out, batch)
    if pending is not None:
        _consume(*pending)
    if ids_chunks:
        ids_all = np.concatenate(ids_chunks, axis=0)
        vids_all = np.concatenate(vid_chunks, axis=0)
        alpha_all = np.concatenate(alpha_chunks, axis=0) if alpha_chunks else None
    else:
        ids_all = np.zeros((0, 0), np.int64)
        vids_all = np.zeros((0,), np.int64)
        alpha_all = None
    ids_all, vids_all, alpha_all = gather_eval(ids_all, vids_all, alpha_all)
    infer_time = time.time() - start

    result: "OrderedDict[str, str]" = OrderedDict(
        (str(int(v)), vocab.decode_tokens(t)) for v, t in zip(vids_all, ids_all)
    )
    pred_json = {k: [{"video_id": k, "caption": v}] for k, v in result.items()}
    scorer = scorer or COCOScorer()
    refs = {str(k): v for k, v in reference.items()}
    scores, _ = scorer.score(refs, pred_json, list(pred_json.keys()))
    return scores, result, alpha_all, infer_time
