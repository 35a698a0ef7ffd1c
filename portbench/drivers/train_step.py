"""The WGAN-GP train step in a closed loop: `make_gan_train_step` at batch
`batch`, fed by `prefetch_to_device` from a pool of `distinct_batches`
host batches (seeded features and captions of about the configuration's
`mean_caption_words`), as `RunGAN` feeds it.

Set-up builds the one train step object with its models and Adam states
from the seed's weights and drives it through its first `first_steps`
steps, through the window's own call and feed, on batches whose rows all
differ. Those steps are what the reference follows. End-to-end:
train_clips_per_s, the clips of the steps finished in the window (the
device synchronised at its end) over its seconds. Under `--trace 1` the
same loop runs a window untraced before the traced one: its counters
(`plain_*`) give the rates that the profiler would slow.
"""

from __future__ import annotations

import itertools
import time
from types import SimpleNamespace
from typing import Dict, List

import numpy as np

from portbench import inputs, training, work
from portbench.harness import Outcome, Run, free, peak_bytes, quarters, sync
from portbench.trace import Tracer


def host_batches(r: Run, device) -> List[Dict[str, np.ndarray]]:
    """The pool of host batches: frames, regions, captions, lengths."""
    tr, md = r.traffic, r.model_dict("training")
    B, n, T = tr["batch"], tr["distinct_batches"], md["max_frames"]
    fr, rg = inputs.clip_pool(B * n, (T, md["a_feature_size"] + md["m_feature_size"]),
                              (T, md["num_obj"], md["region_feature_size"]), r.seed, device)
    out = []
    for i in range(n):
        caps, lens = inputs.caption_batch(B, md["max_words"], r.config["vocab_size"],
                                          r.config["mean_caption_words"], r.seed, i)
        out.append({"frames": fr[i * B:(i + 1) * B].cpu().numpy(),
                    "regions": rg[i * B:(i + 1) * B].cpu().numpy(),
                    "captions": caps, "lengths": lens})
    del fr, rg
    free(device)
    return out


def prepare(r: Run) -> SimpleNamespace:
    """Set-up: the host batches, the one train step object, its feed, and
    its first steps through that feed, recorded for the check."""
    from dlsg_tpu_torch.data.prefetch import prefetch_to_device

    dev = r.device
    tr, md = r.traffic, r.model_dict("training")
    cfg = r.program_config("training")
    batches = host_batches(r, dev)
    prog = training.Program(r, cfg, dev)
    feed = prefetch_to_device(itertools.cycle(batches), dev, stage_dtype=cfg.stage_dtype)
    key, eps = r.seed, md["epsilon"]

    first = []
    for i in range(tr["first_steps"]):
        m = prog.step(next(feed), key, eps)
        first.append({k: float(v) for k, v in m.items() if k != "sample_tokens"})
        if i == 0:
            prog.record_first_grads()
    prog.record_changes()
    sync(dev)
    r.log(f"first steps: {first}")
    return SimpleNamespace(batches=batches[: tr["first_steps"]], prog=prog, feed=feed,
                           first=first, key=key, eps=eps)


def run(r: Run) -> Outcome:
    dev = r.device
    tr, md = r.traffic, r.model_dict("training")
    st = prepare(r)
    prog, feed, key, eps = st.prog, st.feed, st.key, st.eps
    peak_setup = peak_bytes(dev, reset=True)

    waits: List[float] = []
    ends: List[float] = []
    pending = None

    def train(seconds: float, tracer: Tracer):
        """Steps back to back for `seconds`, the device synchronised at the
        end: (the window's seconds, its steps)."""
        nonlocal pending
        start, t0 = len(ends), time.perf_counter()
        while True:
            s = time.perf_counter()
            with tracer.span("portbench.next_batch"):
                batch = next(feed)
            waits.append(time.perf_counter() - s)
            with tracer.span("portbench.train_step"):
                m = prog.step(batch, key, eps)
                if pending is not None:  # the trainer's lagged read of the step before
                    float(pending["cap_loss"])
            pending = m
            ends.append(time.perf_counter())
            if time.perf_counter() - t0 >= seconds:
                break
        float(pending["cap_loss"])
        sync(dev)
        window = time.perf_counter() - t0
        r.log(f"window {window:.3f}s: {len(ends) - start} steps; step seconds by quarter of "
              f"the run {quarters(ends[start:], t0)}")
        return window, len(ends) - start

    B, V = tr["batch"], r.config["vocab_size"]
    step_flops = work.gan_step_flops(md, B, V)
    tracer = Tracer(bool(r.args.trace), dev)
    r.window_started()
    counters = {}
    if r.args.trace:  # the same window untraced first: the profiler slows the host
        plain_s, plain_steps = train(r.window_seconds(), Tracer(False))
        counters.update(plain_window_s=plain_s, plain_model_flops=step_flops * plain_steps)
        del waits[:]
    tracer.start()
    window, steps = train(r.window_seconds(), tracer)
    tracer.stop()
    window_peak = peak_bytes(dev)
    feed.close()

    counters.update(steps=steps, clips=steps * B, window_s=window,
                    model_flops=step_flops * steps, peak_mem_gb=window_peak / 1e9)
    records = {
        "counters": counters,
        "spans": {"batch_wait_s": waits},
    }
    program_view = prog.view(st.first)
    del prog, feed, st.prog, st.feed
    free(dev)
    checks = training.check(r, st.batches, program_view, key, eps, dev)
    return Outcome(attempted=len(ends), failed=0, e2e={"train_clips_per_s": steps * B / window},
                   records=records, checks=checks,
                   memory_peak_bytes=max(peak_setup, window_peak), trace=tracer.summary())
