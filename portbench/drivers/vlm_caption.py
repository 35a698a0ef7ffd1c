"""One client in a closed loop captioning clips with the Kimi-VL-A3B
generator (`portbench/configs/kimi-vl-a3b.json`): each request is
`request_clips` host float32 clips of MoonViT output (of a pool of
`pool_clips` distinct ones, which the requests partition) handed to
`Captioner.caption(frames, None)`; the next is sent when it returns.

The weights are drawn tensor by tensor in bfloat16 on the card from the
traffic's `weights_seed` (one served model, so each seed asks the same work
of it): normal with the configuration's `initializer_range`, RMSNorm and
LayerNorm scales 1, biases 0, the router's correction bias normal with
`correction_bias_std`. The clips and the prompt (`prompt_words` ids, the
last `<start>`) come from `--seed`.

Traffic keys: request_clips; pool_clips, a multiple of it; check_requests
and check_clips (of each); weights_seed; prompt_words; host_memory `pinned` (page-locked, as a
DataLoader with `pin_memory=True` hands them) or `pageable`. End-to-end:
captions_per_s, the captions returned over the window, which ends when the
first request that finishes after `--seconds` returns. Under `--trace 1`
the same loop runs a window untraced before the traced one: its counters
(`plain_*`) give the rates that the profiler would slow.

The check (`check`): after the window, the first `check_requests`
requests served again through the beam decode's own functions, for their
best beams' ids and summed log-probabilities, their first step's top-k and
the first layer's cache entries that the beam steps write for the served
tokens; the ids must equal what the window returned, so the other numbers
are those of the served captions. The reference's full forward over
`check_clips` clips of each (all of them in the cell), teacher-forced on
the captions that the window returned for them.
"""

from __future__ import annotations

import time
from typing import Dict, List, Tuple

import numpy as np

from portbench import inputs, vlm_work
from portbench.harness import Check, Outcome, Run, free, peak_bytes, quarters, sync
from portbench.reference import kimi_vl as ref
from portbench.trace import Tracer

START_ID = 1


def architecture(r: Run) -> dict:
    """The configuration as the reference reads it: the published keys,
    the vision side and the seed's prompt."""
    c = dict(r.config)
    words = r.traffic["prompt_words"]
    prompt = inputs.rng(r.seed, "captions").integers(len(inputs.SPECIAL_WORDS), c["vocab_size"],
                                                     words - 1).tolist()
    c["prompt_ids"] = prompt + [START_ID]
    return c


def draw_weights(c: dict, seed: int, device) -> Dict[str, "torch.Tensor"]:
    import torch

    g = inputs.generator(seed, "generator", device)
    out = {}
    for k, s in ref.param_shapes(c).items():
        if k.endswith("norm.weight"):
            out[k] = torch.ones(s, device=device, dtype=torch.bfloat16)
        elif k.endswith("e_score_correction_bias"):
            out[k] = torch.randn(s, generator=g, device=device, dtype=torch.bfloat16).mul_(
                c["correction_bias_std"])
        elif k.endswith("bias"):
            out[k] = torch.zeros(s, device=device, dtype=torch.bfloat16)
        else:
            out[k] = torch.randn(s, generator=g, device=device, dtype=torch.bfloat16).mul_(
                c["initializer_range"])
    return out


def serving_config(r: Run):
    from dlsg_tpu_torch.config import DLSGConfig

    return DLSGConfig(**r.config["serving"])


def make_captioner(r: Run, c: dict, device):
    """The program's Captioner over the seeded weights, the architecture
    handed in as a KimiVLConfig."""
    from dlsg_tpu_torch.models.kimi_vl_config import KimiVLConfig
    from dlsg_tpu_torch.serve import Captioner
    from dlsg_tpu_torch.vocab import Vocabulary

    params = draw_weights(c, int(r.traffic["weights_seed"]), device)
    vocab = Vocabulary.from_idx2word(inputs.vocab_words(c["vocab_size"]))
    return Captioner.from_params(serving_config(r), vocab, params, device=device,
                                 arch=KimiVLConfig.from_dict(c))


def clip_requests(r: Run, c: dict, device) -> List[np.ndarray]:
    """The pool's requests as host arrays [request_clips, *feature_shape],
    drawn on the card one request at a time."""
    import torch

    tr = r.traffic
    B, n = tr["request_clips"], tr["pool_clips"] // tr["request_clips"]
    shape = (c["frames"], c["tokens_per_frame"], c["merge_kernel_size"][0] * c["merge_kernel_size"][1],
             c["vision_hidden_size"])
    order = inputs.rng(r.seed, "schedule").permutation(tr["pool_clips"])
    pinned = tr["host_memory"] == "pinned" and device.type == "cuda"
    out = []
    for q in range(n):
        # each clip its own stream, so a clip is the same whichever request holds it
        rows = torch.stack([torch.randn(shape, generator=inputs.generator(r.seed, "clips", device, int(i)),
                                        device=device) for i in np.sort(order[q * B:(q + 1) * B])])
        h = torch.empty(rows.shape, dtype=rows.dtype, pin_memory=pinned)
        out.append(h.copy_(rows).numpy())
        del rows
    return out


def run(r: Run) -> Outcome:
    import torch

    from dlsg_tpu_torch.models import kimi_vl_config  # noqa: F401  (a program without the model stops here)

    dev = r.device
    torch.empty(0, device=dev)
    r.log("card ready")
    tr, sc = r.traffic, r.config["serving"]
    c = architecture(r)
    requests = clip_requests(r, c, dev)
    free(dev)
    peak_bytes(dev, reset=True)
    r.log(f"built {len(requests)} requests of {tr['request_clips']} clips in {tr['host_memory']} host memory")
    captioner = make_captioner(r, c, dev)
    sync(dev)
    r.log("captioner built")
    for q in requests[:2]:  # the cell's one shape, twice: kernels built, libraries warm
        captioner.caption(q, None)
    sync(dev)
    r.log("warm")
    peak_setup = peak_bytes(dev, reset=True)

    visual = c["frames"] * c["tokens_per_frame"]
    prefix = visual + tr["prompt_words"] - 1
    served, which, spans, ends = [], [], [], []

    def serve(seconds: float, tracer: Tracer):
        start, t0 = len(served), time.perf_counter()
        while True:
            q = len(served) % len(requests)
            s = time.perf_counter()
            with tracer.span("portbench.request"):
                caps = captioner.caption(requests[q], None)
            spans.append(time.perf_counter() - s)
            ends.append(s + spans[-1])
            served.append(caps)
            which.append(q)
            if time.perf_counter() - t0 >= seconds:
                break
        window = time.perf_counter() - t0
        r.log(f"window {window:.3f}s: {len(served) - start} requests; request seconds by "
              f"quarter of the run {quarters(ends[start:], t0)}")
        return window, [len(t.split()) for caps in served[start:] for t in caps]

    def flops(words):
        return vlm_work.decode_flops(c, visual, prefix, words, sc["beam_size"], sc["max_words"])

    tracer = Tracer(bool(r.args.trace), dev)
    r.window_started()
    counters = {}
    if r.args.trace:  # the same window untraced first: the profiler slows the host
        plain_s, plain_words = serve(r.window_seconds(), Tracer(False))
        counters.update(plain_window_s=plain_s, plain_model_flops=flops(plain_words))
        del spans[:]
    start = len(served)
    tracer.start()
    window, words = serve(r.window_seconds(), tracer)
    tracer.stop()
    peak = max(peak_setup, peak_bytes(dev))
    i = len(served) - start
    n_caps = sum(len(x) for x in served[start:])
    counters.update(requests=i, captions=n_caps, window_s=window, model_flops=flops(words),
                    median_words=float(np.median(words)))
    records = {
        "counters": counters,
        "decodes": {"rows": tr["request_clips"], "count": i, "beam": sc["beam_size"],
                    "H": c["hidden_size"], "w_bytes": 2, "V": c["vocab_size"]},
        "spans": {"request_s": spans},
    }
    batches = [(requests[q], served[which.index(q)]) for q in range(tr["check_requests"])]
    checks, extra = check(r, c, captioner, batches, dev)
    counters.update(extra)
    del captioner
    free(dev)
    return Outcome(attempted=len(served), failed=0, e2e={"captions_per_s": n_caps / window},
                   records=records, checks=checks, memory_peak_bytes=peak, trace=tracer.summary())


def served_ids(text: str, max_words: int) -> List[int]:
    """A returned caption's ids as the beam emitted them: its words, then
    `<end>` where it ended before `max_words`."""
    ids = inputs.caption_ids(text)[:max_words]
    return ids + [inputs.END_ID] * (max_words - len(ids))


def program_scores(captioner, frames, served: "torch.Tensor"):
    """The program's beam decode of host clips through its own functions:
    the best beams' ids [B, T] and summed log-probabilities [B], the first
    step's normalised top-k values and ids [B, k], and the first layer's
    cache entries [B, T, W] that its beam steps write for the served
    captions' ids `served` [B, T], fed to them as the beam feeds its own."""
    import torch

    from dlsg_tpu_torch.evaluation.decode import _make_beam_from_feats
    from dlsg_tpu_torch.kernels.vocab_head import vocab_head_topk

    model, cfg = captioner.model, captioner.cfg
    with torch.inference_mode():
        obj, _ = model.encode(torch.as_tensor(frames, device=captioner.device))
        preds, lp, _, _ = _make_beam_from_feats(model, cfg, cfg.beam_size)(obj, None, cfg.max_words)
        state, pre = model.decoder_init_beam_state(obj)
        start = torch.full((obj.shape[0],), START_ID, dtype=torch.int64, device=obj.device)
        hid, state, _ = model.decoder_beam_step_hidden(start, state, pre)
        vals, ids = vocab_head_topk(hid, *model.decoder_vocab_head(), cfg.beam_size)
        for t in range(served.shape[1] - 1):
            _, state, _ = model.decoder_beam_step_hidden(served[:, t], state, pre)
        latents = state["suffix"][:, 0].float()
    return preds[:, 0], lp[:, 0], vals, ids, latents


def routing_disagreement(captioner, feats, theirs: List["torch.Tensor"]) -> float:
    """% of (prefix token, MoE layer) pairs whose chosen experts differ
    between the program's prefill of host clips `feats` and the reference's
    forward over them (`theirs`, its routes of every position; logged: a
    near tie in the router flips on rounding)."""
    import torch

    from dlsg_tpu_torch.models import kimi_vl

    mine: List[torch.Tensor] = []
    route = kimi_vl.route

    def recording(*a, **k):
        out = route(*a, **k)
        mine.append(out[0])
        return out

    kimi_vl.route = recording
    try:
        with torch.inference_mode():
            captioner.model.prefill(captioner.model.embed(feats))
    finally:
        kimi_vl.route = route
    n, layers = feats.shape[0], len(theirs)
    mine_all = torch.cat(mine)  # a layer's rows may come in several prefill chunks
    S = mine_all.shape[0] // (n * layers)
    differ = 0
    for a, b in zip(mine_all.view(layers, n, S, -1), theirs):
        a = a.sort(-1).values
        b = b.view(n, -1, b.shape[-1])[:, :S].sort(-1).values
        differ += int((a != b).any(-1).sum()) if a.shape == b.shape else n * S
    return 100.0 * differ / (n * S * layers)


def check(r: Run, c: dict, captioner, batches, device,
          dtype=None) -> Tuple[List[Check], Dict[str, float]]:
    """The module doc's check of `batches`, pairs of host clips and the
    captions the window returned for them: `seq_logprob_gap`, each sampled
    clip's summed log-probability from the program's beam against the
    reference's over the served tokens, |p - r| / max(|r|, 1), their mean;
    `first_step_gap`, the first step's normalised top-k against the
    reference's log-softmax at the same ids, the mean |difference| in nats;
    `decode_latent_gap`, the first layer's cache entries of the served
    tokens as the beam steps wrote them against the reference's, ‖p - r‖ /
    ‖r‖ of the worst clip; and `rerun_token_mismatch_pct`, the % of token
    positions where the rerun's best beams differ from the served captions.
    Means for the first two, not the worst clip: with random weights the
    bf16 model is chaotic (two fifths of the router's choices flip against
    fp32), so one clip's gap is mostly that chance and the worst of a few
    clips does not separate a fault from rounding (PERF.md §2); the worst
    are logged. The first layer's entries depend on a token and its
    position alone, before any router, so the decode path's rotation and
    positions show there as they cannot through the ~2 600 prefix keys.
    `dtype` puts the reference's products in another precision (the
    control)."""
    import torch

    dtype = dtype or torch.float32
    T = captioner.cfg.max_words
    params = dict(captioner.model.state_dict())
    seq_gaps, first_gaps, latent_gaps, mismatch, extra = [], [], [], [], {}
    for q, (frames, served) in enumerate(batches):
        served_tokens = torch.tensor([served_ids(t, T) for t in served], device=device)
        ids, lp, vals, top, latents = program_scores(captioner, frames, served_tokens)
        mismatch.append(float((served_tokens != ids).float().mean()))
        sample = np.sort(inputs.rng(r.seed, "captions").choice(len(served), r.traffic["check_clips"],
                                                               replace=False))
        idx = torch.as_tensor(sample, device=device)
        caps = served_tokens[idx]
        prompt = torch.tensor([c["prompt_ids"]] * len(sample), device=device)
        feats = torch.as_tensor(frames[sample], device=device)
        first = prompt.shape[1] - 1 + feats.shape[1] * feats.shape[2]
        routes: List[torch.Tensor] = []
        with torch.inference_mode():
            steps_in = torch.cat([prompt[:, -1:], caps[:, :-1]], 1)
            want = ref.first_layer_latents(params, c, steps_in, first, dtype=dtype)
            logp = torch.log_softmax(ref.forward(
                params, c, feats, torch.cat([prompt, caps[:, :-1]], 1), first=first, dtype=dtype,
                routes=routes), -1)
        latent_gaps.append(((latents[idx] - want).flatten(1).norm(dim=1) / want.flatten(1).norm(dim=1)))
        for k, j in enumerate(sample.tolist()):
            toks = caps[k].tolist()
            n = toks.index(inputs.END_ID) + 1 if inputs.END_ID in toks else T
            rv = float(logp[k, torch.arange(n, device=device), caps[k, :n]].sum())
            seq_gaps.append(abs(float(lp[j]) - rv) / max(abs(rv), 1.0))
        first_gaps.append((vals[idx] - logp[:, 0].gather(1, top[idx])).abs().flatten())
        if q == 0:
            extra["routing_disagree_pct"] = routing_disagreement(captioner, feats, routes)
    first_gap = torch.cat(first_gaps)
    extra.update(checked_clips=len(seq_gaps), seq_logprob_gap_worst=max(seq_gaps),
                 first_step_gap_worst=float(first_gap.max()))
    limits = r.config["limits"]
    return [Check("seq_logprob_gap", float(np.mean(seq_gaps)), limits["seq_logprob_gap"]),
            Check("first_step_gap", float(first_gap.mean()), limits["first_step_gap"]),
            Check("decode_latent_gap", float(torch.cat(latent_gaps).max()), limits["decode_latent_gap"]),
            Check("rerun_token_mismatch_pct", 100.0 * max(mismatch),
                  limits["rerun_token_mismatch_pct"])], extra
