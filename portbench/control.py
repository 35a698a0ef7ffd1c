"""The readings that each cell's limits are set from, read with the same
numbers as a run, one JSON line a seed with every number and its limit:

    python3 portbench/control.py --workload <name> --seeds <n> [<n> ...] [--mode M]

On the card, at the cell's own sizes; the benchmark's own runs never run
this. Modes:
- `tf32` (the control): the plain reference put in the program's place
  one precision below the configuration's (TF32 products for its float32
  with TF32 off). For a caption cell, the clips a run would check (the
  cell's request pool from the seed) decoded by the reference in TF32 and
  compared with its float32 decode; for a training cell, the reference's
  first steps in TF32 against its float32 ones;
- `fp32`: the reference against itself;
- training cells only: `program`, the program's set-up and first steps as
  a run drives them, against the reference (a run's check without its
  window, for the lower readings of many seeds in one process); `half`,
  the fault of half the batch left out, planted in the reference put in
  the program's place; `d_half` and `no_penalty`, the program with the
  discriminator's Wasserstein term taken over half its batch, or with its
  gradient penalty left out (`FAULTS`).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from portbench import harness, inputs, serving, training  # noqa: E402


def caption_clips(r: harness.Run):
    """`check_clips` distinct clips of the cell's request pool, as host
    arrays."""
    tr, md = r.traffic, r.model_dict("serving")
    T, n = md["max_frames"], tr["check_clips"]
    fr, rg = inputs.clip_pool(tr["pool_clips"], (T, md["a_feature_size"] + md["m_feature_size"]),
                              (T, tr["boxes"], md["region_feature_size"]), r.seed, r.device)
    idx = np.sort(inputs.rng(r.seed, "captions").choice(tr["pool_clips"], min(n, tr["pool_clips"]),
                                                        replace=False))
    return fr[idx].cpu().numpy(), rg[idx].cpu().numpy()


def _half_share(x):
    n = x.shape[0] // 2
    return x[:n].sum() / n


def _no_penalty(d_fn, real, fake, eps):
    return real.new_zeros(())


# faults of the discriminator's substeps, planted in the program's train step
FAULTS = {"d_half": ("batch_share", _half_share), "no_penalty": ("gradient_penalty", _no_penalty)}


@contextlib.contextmanager
def planted(fault: str):
    """The program's train step with `fault` (FAULTS) planted, or as it is."""
    from dlsg_tpu_torch.train import steps

    if fault not in FAULTS:
        yield
        return
    name, fn = FAULTS[fault]
    orig = getattr(steps, name)
    setattr(steps, name, fn)
    try:
        yield
    finally:
        setattr(steps, name, orig)


def program_view(r: harness.Run, fault: str = ""):
    """A run's set-up and first steps, with `fault` planted: the host
    batches and the program's view of them."""
    drv = harness.load_module("drivers", "train_step")
    with planted(fault):
        st = drv.prepare(r)
    st.feed.close()
    view = st.prog.view(st.first)
    del st.prog, st.feed
    harness.free(r.device)
    return st.batches, view


def halved(batches):
    """The fault of half the batch left out: each batch's first half."""
    return [{k: v[: len(v) // 2] for k, v in b.items()} for b in batches]


def control(r: harness.Run, mode: str = "tf32") -> dict:
    limits = r.config["limits"]
    if r.traffic["driver"] == "train_step":
        key, eps = r.seed, r.model_dict("training")["epsilon"]
        if mode in ("program", *FAULTS):
            batches, low = program_view(r, mode)
        else:
            drv = harness.load_module("drivers", "train_step")
            batches = drv.host_batches(r, r.device)[: r.traffic["first_steps"]]
        base = training.reference_view(r, batches, key, eps, r.device, "fp32")
        if mode == "half":  # the fault, planted in the reference put in the program's place
            low = training.reference_view(r, halved(batches), key, eps, r.device, "fp32")
        elif mode in ("tf32", "fp32"):
            low = training.reference_view(r, batches, key, eps, r.device, mode)
        nums = training.compare(low, base)
        nums.update((k, v) for k, v in training.diagnostics(low, base).items()
                    if isinstance(v, float))
    else:
        fr, rg = caption_clips(r)
        base = serving.reference_captions(r, fr, rg, r.device, "fp32")
        low = serving.reference_captions(r, fr, rg, r.device, mode)
        words = serving.ids_to_text(low, r.config["vocab_size"])
        pct, n = serving.token_mismatch(words, base, r.config["model"]["max_words"])
        nums = {"token_mismatch_pct": pct, "tokens_compared": n}
    return {k: {"value": v, "limit": limits.get(k)} for k, v in nums.items()}


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--mode", default="tf32",
                   choices=("tf32", "fp32", "program", "half", *FAULTS), help="module doc")
    args = p.parse_args(argv)
    spec = harness.benchmark()
    cell = harness.cell_of(spec, args.workload)
    for seed in args.seeds:
        t = time.perf_counter()
        r = harness.Run(SimpleNamespace(seed=seed, seconds=0, trace=0), spec, cell, t)
        out = control(r, args.mode)
        print(json.dumps({"workload": args.workload, "seed": seed, "mode": args.mode,
                          "seconds": time.perf_counter() - t, "numbers": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
