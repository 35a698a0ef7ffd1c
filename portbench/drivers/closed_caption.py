"""One client in a closed loop: each request is a batch of host float32
clips (`request_clips` of a pool of `pool_clips` distinct ones, which the
requests partition)
handed to `Captioner.caption`; the next is sent when it returns.

Traffic keys: request_clips; pool_clips, a multiple of it, split into
that many distinct requests; boxes; check_clips; weights_seed (optional,
`serving.weights_seed`); host_memory, `pageable`
(numpy arrays as a feature file reads them) or `pinned` (page-locked, as
a DataLoader with `pin_memory=True` hands them). End-to-end:
captions_per_s, the captions returned over the window, which ends when
the first request that finishes after `--seconds` returns. Under
`--trace 1` the same loop runs a window untraced before the traced one:
its counters (`plain_*`) give the rates that the profiler would slow.
"""

from __future__ import annotations

import time

import numpy as np

from portbench import inputs, serving, work
from portbench.harness import Outcome, Run, free, peak_bytes, quarters, sync
from portbench.trace import Tracer


def run(r: Run) -> Outcome:
    import torch

    dev = r.device
    torch.empty(0, device=dev)
    r.log("card ready")
    tr, md = r.traffic, r.model_dict("serving")
    T, B, beam = md["max_frames"], tr["request_clips"], md["beam_size"]
    frames_shape = (T, md["a_feature_size"] + md["m_feature_size"])
    regions_shape = (T, tr["boxes"], md["region_feature_size"])

    fr, rg = inputs.clip_pool(tr["pool_clips"], frames_shape, regions_shape, r.seed, dev)
    sync(dev)
    r.log("clips drawn on the card")
    order = inputs.rng(r.seed, "schedule").permutation(tr["pool_clips"])
    picks = [np.sort(order[k * B:(k + 1) * B]) for k in range(tr["pool_clips"] // B)]
    pinned = tr["host_memory"] == "pinned" and dev.type == "cuda"

    def host(t):
        """A device tensor as the host array a client hands over."""
        if not pinned:
            return t.cpu().numpy()
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        return h.copy_(t).numpy()

    requests = [(host(fr[idx]), host(rg[idx])) for idx in
                (torch.as_tensor(p, device=dev) for p in picks)]
    del fr, rg
    free(dev)
    peak_bytes(dev, reset=True)  # the program's peak from here on
    r.log(f"built {len(requests)} requests of {B} clips in {tr['host_memory']} host memory")
    captioner = serving.make_captioner(r, dev)
    r.log("captioner built")
    for q in requests[:2]:  # the cell's one shape, twice: kernels built, libraries warm
        captioner.caption(*q)
    sync(dev)
    r.log("warm")
    peak_setup = peak_bytes(dev, reset=True)

    served, which, spans, ends = [], [], [], []

    def serve(seconds: float, tracer: Tracer):
        """Requests back to back for `seconds`, the first request to finish
        after them included: (the window's seconds, its words a caption)."""
        start, t0 = len(served), time.perf_counter()
        while True:
            q = len(served) % len(requests)
            s = time.perf_counter()
            with tracer.span("portbench.request"):
                caps = captioner.caption(*requests[q])
            spans.append(time.perf_counter() - s)
            ends.append(s + spans[-1])
            served.append(caps)
            which.append(q)
            if time.perf_counter() - t0 >= seconds:
                break
        window = time.perf_counter() - t0
        r.log(f"window {window:.3f}s: {len(served) - start} requests; request seconds by "
              f"quarter of the run {quarters(ends[start:], t0)}")
        return window, [w for caps in served[start:] for w in serving.word_counts(caps)]

    V = serving.vocab_size(r)
    tracer = Tracer(bool(r.args.trace), dev)
    r.window_started()
    counters = {}
    if r.args.trace:  # the same window untraced first: the profiler slows the host
        plain_s, plain_words = serve(r.window_seconds(), Tracer(False))
        counters.update(plain_window_s=plain_s,
                        plain_model_flops=work.decode_flops(md, V, plain_words, beam))
        del spans[:]
    start = len(served)
    tracer.start()
    window, words = serve(r.window_seconds(), tracer)
    tracer.stop()
    peak = max(peak_setup, peak_bytes(dev))
    i = len(served) - start

    n_caps = sum(len(c) for c in served[start:])
    counters.update(requests=i, captions=n_caps, window_s=window,
                    model_flops=work.decode_flops(md, V, words, beam),
                    median_words=float(np.median(words)))
    records = {
        "counters": counters,
        "decodes": {"rows": B, "count": i, "beam": beam, "H": md["decode_hidden_size"],
                    "w_bytes": 2 if md["compute_dtype"] == "bfloat16" else 4,
                    "V": V, "T": T, "lstm_H": md["visual_hidden_size"]},
        "spans": {"request_s": spans},
    }

    del captioner
    free(dev)
    # the check: a sample of the distinct clips served, the longest caption's among them
    first = {}
    for k, caps in enumerate(served):
        for j, c in enumerate(caps):
            first.setdefault((which[k], j), c)
    keys = list(first)
    pick = serving.sample_with_longest(inputs.rng(r.seed, "captions"),
                                       [len(first[k].split()) for k in keys], tr["check_clips"])
    texts = [first[keys[n]] for n in pick]
    frames = np.stack([requests[keys[n][0]][0][keys[n][1]] for n in pick])
    regions = np.stack([requests[keys[n][0]][1][keys[n][1]] for n in pick])
    check, extra = serving.check_captions(r, texts, frames, regions, dev)
    records["counters"].update(extra)
    r.log(f"checked {len(texts)} captions, {extra['tokens_compared']} tokens")
    return Outcome(attempted=len(served), failed=0, e2e={"captions_per_s": n_caps / window},
                   records=records, checks=[check], memory_peak_bytes=peak,
                   trace=tracer.summary())
