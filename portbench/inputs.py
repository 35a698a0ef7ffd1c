"""What the benchmark hands the system and the reference alike, made from
`--seed`: the weights, the vocabulary, feature clips, caption batches and
the arrival schedule of an open loop.

Everything is drawn on the device with a `torch.Generator` in a few large
calls, so set-up stays short; the same seed on the same kind of device
gives the same tensors. The weights are the benchmark's own draw, not the
package's initializers: Dense, Conv and recurrent weights are normal with
variance 1 / fan-in, embeddings with variance 1 / width, LayerNorm scales
are 1 and biases 0; over the generator's lies the configuration's
`length_model`, so that captions end at realistic lengths.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

END_ID = 2
SPECIAL_WORDS = ("<pad>", "<start>", "<end>", "<unk>")
HEAD_BIAS = "decoder.step.word_restore.bias"

# salts, so that each kind of input has a stream of its own under one seed
SALT = {"generator": 1, "discriminator": 2, "clips": 3, "captions": 4, "schedule": 5}


def generator(seed: int, salt: str, device, index: int = 0) -> torch.Generator:
    """The stream of `salt` under `seed` (any whole number >= 0); `index`
    numbers streams of one kind."""
    mixed = np.random.SeedSequence([int(seed), SALT[salt], index]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(mixed) & ((1 << 63) - 1))


def rng(seed: int, salt: str) -> np.random.Generator:
    """A host stream of `salt` under `seed`, for orders and schedules."""
    return np.random.default_rng([int(seed), SALT[salt]])


def _std(name: str, shape: Sequence[int]) -> float:
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "w_hh":  # [H, 4H], the JAX layout: fan-in H
        return 1.0 / math.sqrt(shape[0])
    if leaf == "embedding":
        return 1.0 / math.sqrt(shape[1])
    if len(shape) == 3:  # Conv1d [out, in, k]
        return 1.0 / math.sqrt(shape[1] * shape[2])
    return 1.0 / math.sqrt(shape[-1])  # Dense [out, in], theta, fusion


def make_params(shapes: Dict[str, tuple], seed: int, salt: str, device,
                lengths: Optional[dict] = None) -> Dict[str, torch.Tensor]:
    """fp32 parameters of `shapes` (name -> shape) from one normal draw,
    the generator's with `lengths` (`length_model`) laid over them."""
    mats = {k: s for k, s in shapes.items() if not k.endswith("bias") and len(s) > 1}
    total = sum(math.prod(s) for s in mats.values())
    flat = torch.randn(total, generator=generator(seed, salt, device), device=device)
    out, at = {}, 0
    for k, s in shapes.items():
        if k in mats:
            n = math.prod(s)
            out[k] = flat[at: at + n].view(s).mul_(_std(k, s))
            at += n
        elif k.endswith("bias"):
            out[k] = torch.zeros(s, device=device)
        else:  # LayerNorm scales
            out[k] = torch.ones(s, device=device)
    if lengths and HEAD_BIAS in out:
        length_model(out, **lengths)
    return out


def length_model(p: Dict[str, torch.Tensor], head_scale: float, counter_units: int,
                 counter_rate: float, end_weight: float, end_bias: float) -> None:
    """Give random weights a trained captioner's two habits, so that beam
    search ends captions at realistic lengths: confident words (the vocab
    head scaled by `head_scale`, so a step's best word costs about a nat
    or two, not log V), and an `<end>` logit that rises with the caption's
    length. The language LSTM's first `counter_units` units count steps:
    their gates are cut from every input and biased open, and their cell
    grows by `counter_rate` a step; the head's `<end>` row reads them with
    `end_weight` each, and `end_bias` places the rise."""
    s = "decoder.step"
    w, b = p[f"{s}.word_restore.weight"], p[HEAD_BIAS]
    dh = w.shape[1]
    w.mul_(head_scale)
    w[END_ID].div_(head_scale)
    units = torch.arange(counter_units, device=w.device)
    w[END_ID, units] = end_weight
    b[END_ID] = end_bias
    ih_w, ih_b, w_hh = (p[f"{s}.lang_lstm.ih.weight"], p[f"{s}.lang_lstm.ih.bias"],
                        p[f"{s}.lang_lstm.w_hh"])
    for gate, bias in enumerate((10.0, 10.0, math.atanh(counter_rate), 10.0)):  # i, f, g, o
        rows = gate * dh + units
        ih_w[rows] = 0.0
        w_hh[:, rows] = 0.0
        ih_b[rows] = bias


def vocab_words(size: int) -> List[str]:
    """The vocabulary's words by id: the four special tokens, then w4.."""
    return list(SPECIAL_WORDS) + [f"w{i}" for i in range(len(SPECIAL_WORDS), size)]


def caption_ids(text: str) -> List[int]:
    """A returned caption back to its token ids (the words of `vocab_words`
    are unique), without the `<end>` the caption stopped at."""
    special = {w: i for i, w in enumerate(SPECIAL_WORDS)}
    return [special[w] if w in special else int(w[1:]) for w in text.split()]


def clip_pool(n: int, frames_shape: Tuple[int, int], regions_shape: Tuple[int, int, int],
              seed: int, device, index: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """`n` distinct feature clips on the device: frames [n, T, F] and
    regions [n, T, O, R], non-negative as CNN features are; `index`
    numbers pools under one seed."""
    g = generator(seed, "clips", device, index)
    fr = torch.randn((n, *frames_shape), generator=g, device=device).abs_()
    rg = torch.randn((n, *regions_shape), generator=g, device=device).abs_()
    return fr, rg


def caption_batch(n: int, max_words: int, vocab_size: int, mean_words: float,
                  seed: int, index: int) -> Tuple[np.ndarray, np.ndarray]:
    """Captions [n, max_words] int64 and lengths [n]: `mean_words` words on
    average (Poisson, clipped to 2..max_words-1), ids of real words, then
    `<end>` and padding; the length counts the `<end>`."""
    r = np.random.default_rng([int(seed), SALT["captions"], index])
    words = np.clip(r.poisson(mean_words, n), 2, max_words - 1)
    caps = np.zeros((n, max_words), np.int64)
    for i, w in enumerate(words):
        caps[i, :w] = r.integers(len(SPECIAL_WORDS), vocab_size, w)
        caps[i, w] = END_ID
    return caps, (words + 1).astype(np.int64)

