"""The readings that the Kimi-VL cell's limits are set from: a run's check
(`drivers/vlm_caption.py::check`) without its window, one JSON line a seed
with every number and its limit:

    python3 portbench/vlm_control.py --seeds <n> [<n> ...] [--modes M [M ...]]

On the card, at the cell's own sizes, one served model for every seed (the
traffic's weights); each seed draws its clips and prompt, serves the
requests a run checks and checks them, in each mode in turn. The benchmark's own runs
never run this. Modes:
- `program`: the program as it is (the lower readings);
- `bf16`: the same, checked against the reference computed with bfloat16
  products (the control);
- a planted fault (`FAULTS`): `k_pe_unrotated`, the decode path's new
  cache entries without their rotation; `top5`, one expert fewer a token;
  `no_shared`, the shared experts left out; `window2048`, decode attention
  over the last 2048 prefix tokens only; `e4m3`, the expert products' inputs
  rounded to float8 e4m3, a precision below the configuration's.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from portbench import harness  # noqa: E402

CELL = "kimivl-caption-b32"


@contextlib.contextmanager
def _patched(obj, name, make):
    orig = getattr(obj, name)
    setattr(obj, name, make(orig))
    try:
        yield
    finally:
        setattr(obj, name, orig)


def _unrotated(orig):
    import torch

    def latent(self, x, cos, sin):
        if x.dim() == 2:  # a decode step's tokens [G, H]
            cos, sin = torch.ones_like(cos), torch.zeros_like(sin)
        return orig(self, x, cos, sin)
    return latent


def _one_fewer(orig):
    return lambda logits, bias, k, scaling, norm: orig(logits, bias, k - 1, scaling, norm)


def _without_shared(orig):
    return lambda self, x: orig(self, x) - self.shared_experts(x)


def _last_2048(orig):
    return lambda q, prefix, suffix, rank, scale: orig(q, prefix[:, -2048:], suffix, rank, scale)


def _e4m3(orig):
    import torch

    def rounded(x, w, offs):
        f8 = torch.float8_e4m3fn
        return orig(x.to(f8).to(x.dtype), w.to(f8).to(w.dtype), offs)
    return rounded


def fault(name: str):
    """A context in which the program runs with the fault `name`."""
    from dlsg_tpu_torch.models import kimi_vl

    return {"k_pe_unrotated": lambda: _patched(kimi_vl.MLA, "latent", _unrotated),
            "top5": lambda: _patched(kimi_vl, "route", _one_fewer),
            "no_shared": lambda: _patched(kimi_vl.MoE, "forward", _without_shared),
            "window2048": lambda: _patched(kimi_vl, "attend_absorbed", _last_2048),
            "e4m3": lambda: _patched(kimi_vl, "expert_mm", _e4m3)}[name]()


FAULTS = ("k_pe_unrotated", "top5", "no_shared", "window2048", "e4m3")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--modes", nargs="+", default=["program"], choices=("program", "bf16") + FAULTS)
    args = p.parse_args(argv)
    harness.cache_env()
    import torch

    spec = harness.benchmark()
    cell = {"name": CELL, "config": "kimi-vl-a3b", "traffic": "vlm-caption-b32", "chips": 1}
    cell = next((w for w in spec["workloads"] if w["name"] == CELL), cell)
    drv = harness.load_module("drivers", "vlm_caption")
    dev = torch.device("cuda", 0)
    params = None
    from dlsg_tpu_torch.models.kimi_vl_config import KimiVLConfig
    from dlsg_tpu_torch.serve import Captioner
    from dlsg_tpu_torch.vocab import Vocabulary

    for mode in args.modes:
        for seed in args.seeds:
            t0 = time.perf_counter()
            r = harness.Run(SimpleNamespace(workload=CELL, seed=seed, seconds=0, trace=0), spec, cell, t0)
            c = drv.architecture(r)
            requests = drv.clip_requests(r, c, dev)[: r.traffic["check_requests"]]
            if params is None:
                params = drv.draw_weights(c, int(r.traffic["weights_seed"]), dev)
            vocab = Vocabulary.from_idx2word(drv.inputs.vocab_words(c["vocab_size"]))
            cap = Captioner.from_params(drv.serving_config(r), vocab, params, device=dev,
                                        arch=KimiVLConfig.from_dict(c))
            planted = fault(mode) if mode in FAULTS else contextlib.nullcontext()
            dtype = torch.bfloat16 if mode == "bf16" else torch.float32
            with planted:
                batches = [(q, cap.caption(q, None)) for q in requests]
                checks, extra = drv.check(r, c, cap, batches, dev, dtype=dtype)
            line = {"mode": mode, "seed": seed, "seconds": round(time.perf_counter() - t0, 2),
                    **{ch.name: {"value": ch.value, "limit": ch.limit} for ch in checks}, **extra,
                    "device": torch.cuda.get_device_name(0)}
            print(json.dumps(line), flush=True)
            del cap
            harness.free(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
