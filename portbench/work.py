"""The yardstick's arithmetic: operations and bytes of each kernel's
function, and the model FLOPs of a beam-5 decode and of a GAN step.

Each function's work is counted once, whatever implements it, from the
shapes alone: a kernel that splits, repeats or recomputes does not earn
more. Operations are taken at the card's highest dense rate below fp8 and
bytes at its memory rate, so no implementation of the same work can read
over 100% of a bound computed here. Model FLOPs count the products
(2 x M x K x N each) that the result needs, as
`torch.utils.flop_counter.FlopCounterMode` counts them; element-wise work
is left out.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, List, Sequence, Tuple

# NVIDIA H100 SXM data sheet, dense: bf16 / fp16 tensor rate, int8, HBM3
PEAK_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_BYTES = 3.35e12


@dataclass(frozen=True)
class Work:
    flops: float
    bytes: float
    peak_flops: float = PEAK_FLOPS

    def bound_s(self) -> float:
        """The least time the card could take: operations at the peak rate
        or bytes at the memory rate, whichever is longer."""
        return max(self.flops / self.peak_flops, self.bytes / PEAK_BYTES)

    def __add__(self, other: "Work") -> "Work":
        if self.peak_flops != other.peak_flops:
            raise ValueError("work at different peaks does not add")
        return Work(self.flops + other.flops, self.bytes + other.bytes, self.peak_flops)

    def __mul__(self, n: float) -> "Work":
        return Work(self.flops * n, self.bytes * n, self.peak_flops)


def k1(G: int, H: int, V: int, k: int = 5, w_bytes: int = 4) -> Work:
    """The vocab head's function: fp32 logits of h [G, H] @ w [H, V] + b,
    their top-k and logsumexp. h, w (in the dtype the configuration stores
    it: 4 bytes at fp32, 2 at bf16), b and the outputs (k fp32 values and
    k int64 ids a row) once."""
    return Work(2.0 * G * H * V, G * H * 4 + H * V * w_bytes + V * 4 + G * k * 12)


def tf32_split(H: int, V: int) -> Work:
    """What the fp32 head's TF32 route reads and writes beside the
    function, once a decode: w read, its hi and lo parts written [2, V,
    ceil4(H)]. Not part of `k1`'s bound."""
    return Work(0.0, H * V * 4 + 2 * V * (-(-H // 4) * 4) * 4)


def k2(B: int, T: int, H: int) -> Work:
    """One LSTM direction over a pre-projected xw [B, T, 4H]: the recurrent
    product 2 B H 4H for T - 1 steps (h_0 is zero); xw (fp32), W_hh (bf16,
    the kernel's contract) and hs [B, T, H] (fp32) once."""
    return Work(2.0 * B * H * 4 * H * (T - 1), B * T * 4 * H * 4 + H * 4 * H * 2 + B * T * H * 4)


def qmatmul(G: int, K: int, N: int, x_bytes: int = 4) -> Work:
    """The int8 product x [G, K] @ w [K, N] with row and column scales, at
    the int8 rate: x in its dtype, the int8 weight, its scales and the
    fp32 output once."""
    return Work(2.0 * G * K * N, G * K * x_bytes + N * K + N * 4 + G * N * 4, PEAK_INT8_OPS)


# ---------------------------------------------------------------- model FLOPs
#
# A product is (M, K, N, how many operands need a gradient): 2 M K N FLOPs
# forward, and 2 M K N more for each operand whose gradient is needed.


Product = Tuple[float, float, float, int]


def _flops(products: Iterable[Product], backward: bool = False) -> float:
    return sum(2.0 * m * k * n * (1 + (g if backward else 0)) for m, k, n, g in products)


def _dims(c: dict) -> Dict[str, int]:
    return dict(T=c["max_frames"], W=c["max_words"], O=c["num_obj"], R=c["region_feature_size"],
                af=c["a_feature_size"], ff=c["a_feature_size"] + c["m_feature_size"],
                vh=c["visual_hidden_size"], rp=c["region_projected_size"],
                qh=c["query_hidden_size"], dh=c["decode_hidden_size"], ws=c["word_size"],
                P=c["num_proposals"], K=c["num_topk"])


def encode_products(c: dict, B: int) -> List[Product]:
    """The encoder's products for B clips; the gradient flags are those of
    training (the features need none)."""
    d = _dims(c)
    T, O, R, vh, rp, P = d["T"], d["O"], d["R"], d["vh"], d["rp"], d["P"]
    out: List[Product] = []
    for embedded in (True, False):  # the object branch, then the motion branch's graph
        if embedded:
            out.append((B * T, d["af"], vh, 1))
        out += [(B * T * O, R, rp, 1),  # obj_embed
                (B * T, vh, T * O, 2), (B * T, T * O, rp, 2),  # adjacency, aggregation
                (B * T, vh, P, 2), (B * P, T, vh, 2)]  # LatentPSL
    h2 = 2 * vh
    out += [(B * T, d["ff"], vh, 1)]  # linear_embed
    out += [(B * T, vh, 4 * vh, 2), (B * (T - 1), vh, 4 * vh, 2)] * 2  # two directions
    out += [(B * T, h2, h2, 2)] * 3 + [(B * T, h2, T, 2), (B * T, T, h2, 2), (B * T, h2, vh, 2)]
    return out


def precompute_products(c: dict, B: int) -> List[Product]:
    """The decoder's loop invariants: the global feature's query-LSTM
    projection and both branches' attention K and V."""
    d = _dims(c)
    return [(B, 2 * d["vh"], 4 * d["qh"], 2)] + [(B * d["P"], d["vh"], d["vh"], 2)] * 4


def step_products(c: dict, G: int, V: int) -> List[Product]:
    """One decoder step over G hypotheses, vocab head included."""
    d = _dims(c)
    vh, qh, dh, P = d["vh"], d["qh"], d["dh"], d["P"]
    out = [(G, dh + d["ws"], 4 * qh, 2), (G, qh, 4 * qh, 2)]
    out += [(G, qh, vh, 2), (G * P, vh, 1, 2), (G, P, vh, 2), (G, vh, vh, 2)] * 2
    out += [(G, 2 * vh + qh, 4 * dh, 2), (G, dh, 4 * dh, 2), (G, dh, V, 2)]
    return out


def decode_flops(c: dict, V: int, words: Sequence[int], beam: int) -> float:
    """Model FLOPs of the beam decodes whose best captions have `words`
    words each (without `<end>`): the encoder, the loop invariants, and
    each clip's hypotheses stepped up to its caption's `<end>` (the first
    step on one hypothesis, every later one on `beam`), the least any
    implementation must run for those captions."""
    n = len(words)
    steps = sum(1 + beam * min(w, c["max_words"] - 1) for w in words)
    return (_flops(encode_products(c, n)) + _flops(precompute_products(c, n))
            + _flops(step_products(c, 1, V)) * steps)


def generator_products(c: dict, B: int, V: int) -> List[Product]:
    """The teacher-forced generator forward at batch B."""
    return (encode_products(c, B) + precompute_products(c, B)
            + step_products(c, B, V) * c["max_words"])


def discriminator_products(c: dict, n: int, V: int, dim: int = 512,
                           input_grad: bool = False) -> List[Product]:
    """DiscV2 on n rows; `input_grad`: whether the caption distribution
    itself needs a gradient (the penalty's mix, the generator's logits)."""
    d = _dims(c)
    W, P, K, vh = d["W"], d["P"], d["K"], d["vh"]
    out = [(n * W, V, dim, 2 if input_grad else 1), (n * W, 3 * dim, dim, 2),
           (n * W, dim, 4 * dim, 2), (n * (W - 1), dim, 4 * dim, 2)]
    out += [(n * W, dim, dim, 2)] * 3 + [(n * W, dim, W, 2), (n * W, W, dim, 2),
                                         (n * W, dim, dim, 2)]
    for _ in range(2):  # the object and motion heads
        out += [(n * P, vh, dim, 1), (n * W, dim, dim, 2), (n * W, dim, K, 2), (n * K, W, dim, 2),
                (n * K, dim, dim, 2), (n * K, dim, dim, 2), (n * K, dim, 1, 2)]
    out += [(n * W, dim, 1, 2), (n, W, dim, 2), (n, dim, 2, 2)]
    return out


def gan_step_flops(c: dict, B: int, V: int) -> float:
    """Model FLOPs of one WGAN-GP step at batch B: the generator's forward
    and backward; per D substep the real | fake pass with its backward, and
    the penalty's pass with the input gradient and that gradient's own
    backward (counted as twice the forward and input-gradient work: each
    product of the input gradient's graph is differentiated against both of
    its operands); then D on the fake captions, differentiated back into the
    generator only."""
    g = generator_products(c, B, V)
    d2 = discriminator_products(c, 2 * B, V)
    dp = discriminator_products(c, B, V, input_grad=True)
    g_fwd_bwd = _flops(g, backward=True)
    real_fake = _flops(d2, backward=True)
    first = _flops(dp) * 2  # forward and the input gradient
    penalty = first * 2 + first
    g_phase = _flops(dp) * 2
    return g_fwd_bwd + c["num_D_visual"] * (real_fake + penalty) + g_phase
