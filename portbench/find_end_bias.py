"""Find a configuration's `end_bias` (`length_model` in its file, see
portbench/inputs.py): the `<end>` bias under which the reference's fp32
beam-5 decode of seeded clips gives captions of the configuration's
`mean_caption_words` words at the median.

    python3 portbench/find_end_bias.py dlsg-msrvtt [--clips 64] [--seeds 3]

Runs the plain reference on the card at the configuration's widths; prints
the median caption length at each bias of a grid and the chosen bias, the
middle of the span whose median is the target. Run once; the result is
written into the configuration file by hand.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from portbench import harness, inputs  # noqa: E402
from portbench.reference import model as ref  # noqa: E402


def lengths(md: dict, V: int, model: dict, clips, seed: int, device) -> np.ndarray:
    shapes, _ = ref.param_shapes(md, V)
    p = inputs.make_params(shapes, seed, "generator", device, model)
    with ref.precision("fp32"):
        ids = ref.beam_decode(p, md, *clips, md["beam_size"]).cpu().numpy()
    out = []
    for row in ids.tolist():
        out.append(row.index(inputs.END_ID) if inputs.END_ID in row else len(row))
    return np.asarray(out)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("configs", nargs="+")
    p.add_argument("--clips", type=int, default=64)
    p.add_argument("--seeds", type=int, default=3)
    p.add_argument("--grid", type=float, nargs=3, default=(-30.0, 0.0, 0.5))
    p.add_argument("--end_weight", type=float, default=None)
    args = p.parse_args(argv)
    import torch

    dev = torch.device("cuda", 0)
    grid = np.arange(args.grid[0], args.grid[1] + 1e-9, args.grid[2])
    for name in args.configs:
        cfg = harness.load_json("configs", f"{name}.json")
        md = {**cfg["model"], **cfg["serving"]}
        V, target = cfg["vocab_size"], cfg["mean_caption_words"]
        model = dict(cfg["length_model"])
        if args.end_weight is not None:
            model["end_weight"] = args.end_weight
        T = md["max_frames"]
        medians = []
        for b in grid:
            lens = []
            for s in range(args.seeds):
                clips = inputs.clip_pool(args.clips, (T, md["a_feature_size"] + md["m_feature_size"]),
                                         (T, md["num_obj"], md["region_feature_size"]), 1000 + s, dev)
                lens.append(lengths(md, V, {**model, "end_bias": float(b)}, clips, 1000 + s, dev))
            lens = np.concatenate(lens)
            medians.append(float(np.median(lens)))
            print(json.dumps({"config": name, "end_weight": model["end_weight"], "end_bias": float(b),
                              "median_words": medians[-1], "mean_words": float(lens.mean()),
                              "empty": float((lens == 0).mean()),
                              "unended": float((lens == md["max_words"]).mean()),
                              "quartiles": np.percentile(lens, [25, 75]).tolist()}), flush=True)
        hit = [b for b, m in zip(grid, medians) if m == target]
        chosen = float(np.mean([min(hit), max(hit)])) if hit else None
        print(json.dumps({"config": name, "chosen_end_bias": chosen}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
