"""dlsg_tpu_torch fused vocab head (kernels/vocab_head.py) against dlsg_tpu's
Pallas kernel in interpret mode, on identical numpy inputs, over the cases of
tests/test_vocab_head.py.

ids must be equal. vals: both sides compute fp32 sums of the same
(w.dtype-rounded) products, so they differ by summation order only: atol
1e-5, bf16 weights included (tests/test_vocab_head.py allows 0.15 there
because it compares bf16 against fp32 weights).

The card's fp32 form (csrc/vocab_head.cu, route "wgmma_tf32") runs on the
CPU nowhere, so its precision argument is held here in a numpy emulation at
K1's operands (h = tanh(N(0, 1)), w xavier-normal, H = 1536): operands
split into TF32 hi + lo, three TF32 products, summed as the kernel sums
them, within 2e-6 of float64 where one TF32 pass is not. The split itself
has a plain version (`tf32_split_plain`, the kernel's integer rounding),
held bitwise to a float64 emulation of round-half-away to 11 significant
bits over every class of float, and the split head, fed to the plain
version as hi + lo, picks the head's own top-k."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlsg_tpu.ops.pallas.vocab_head import vocab_head_topk as jax_vocab_head_topk
from dlsg_tpu_torch.config import tiny_test_config
from dlsg_tpu_torch.kernels.vocab_head import (
    LIBRARY,
    ROUTE_LAUNCHES,
    PreparedHead,
    prepare_head,
    split_head,
    tf32_split_plain,
    vocab_head_topk,
    vocab_head_topk_plain,
)
from dlsg_tpu_torch.models.generator import CapGnnModel

ATOL = 1e-5


def _mats(G, H, V, seed=0):
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(G, H)).astype(np.float32)
    w = (rng.normal(size=(H, V)) / np.sqrt(H)).astype(np.float32)
    b = rng.normal(size=(V,)).astype(np.float32)
    return h, w, b


def _both(h, w, b, k, normalize, block_v=512, bf16=False):
    jw = jnp.asarray(w, jnp.bfloat16) if bf16 else jnp.asarray(w)
    jv, ji = jax_vocab_head_topk(
        jnp.asarray(h), jw, jnp.asarray(b), k, normalize=normalize, block_v=block_v,
        interpret=True,
    )
    tw = torch.from_numpy(w)
    if bf16:
        tw = tw.to(torch.bfloat16)
    tv, ti = vocab_head_topk_plain(torch.from_numpy(h), tw, torch.from_numpy(b), k,
                                   normalize=normalize)
    return (tv.numpy(), ti.numpy()), (np.asarray(jv), np.asarray(ji))


@pytest.mark.parametrize(
    "G,H,V,k,normalize",
    [
        (8, 128, 1000, 5, True),
        (16, 256, 2048, 5, True),
        (8, 128, 512, 1, True),
        (8, 128, 768, 5, False),
        (8, 128, 700, 5, True),  # V not a multiple of the tile width
    ],
)
def test_plain_matches_pallas(G, H, V, k, normalize):
    (tv, ti), (jv, ji) = _both(*_mats(G, H, V, seed=V + k), k, normalize)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(tv, jv, atol=ATOL)
    assert ti.max() < V


def test_ties_go_to_lowest_id():
    h = np.zeros((4, 8), np.float32)
    w = np.zeros((8, 256), np.float32)  # every logit equals its bias
    b = np.zeros((256,), np.float32)
    b[[17, 200]] = 1.0
    (tv, ti), (jv, ji) = _both(h, w, b, 3, False, block_v=128)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(ti[0], [17, 200, 0])
    np.testing.assert_allclose(tv, jv)


def test_bf16_weights():
    (tv, ti), (jv, ji) = _both(*_mats(8, 256, 1024, seed=7), 5, True, bf16=True)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(tv, jv, atol=ATOL)


def test_wrapper_takes_plain_version_on_cpu():
    h, w, b = (torch.from_numpy(a) for a in _mats(6, 64, 300, seed=1))
    before = LIBRARY.launches
    got = vocab_head_topk(h, w, b, 4)
    want = vocab_head_topk_plain(h, w, b, 4)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert LIBRARY.launches == before



# ---- the TF32x3 split of the card's fp32 form, emulated in numpy ----

F64_FLOOR = 2e-6  # chip_smoke.py's floor for the fp32 form against float64


def _tf32(x):
    """x rounded to TF32 (10 fraction bits), half away from zero, as fp32:
    cvt.rna.tf32.f32 with the 13 dropped bits zeroed."""
    u = np.asarray(x, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _split(x):
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _round_toward_zero(x):
    """float64 -> fp32, rounded toward zero (a tensor-core mma's fp32 sum)."""
    f = x.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(x)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f


def _k1_operands(G=16, H=1536, V=1000, seed=3):
    rng = np.random.default_rng(seed)
    h = np.tanh(rng.normal(size=(G, H))).astype(np.float32)
    w = (rng.normal(size=(H, V)) * np.sqrt(2.0 / (H + 10000))).astype(np.float32)
    return h, w, h.astype(np.float64) @ w.astype(np.float64)


def _mma_sums(h, w, k_tile):
    """h @ w as the kernel runs it: per 8-deep k-step the mma's hi*lo, lo*hi
    and hi*hi, each mma's fp32 sum rounded toward zero, into fresh sums every
    `k_tile` of depth that are added to the accumulator round-to-nearest
    (k_tile = H: one accumulator for all the mma)."""
    (hh, hl), (wh, wl) = _split(h), _split(w)
    terms = [(a.astype(np.float64), b.astype(np.float64)) for a, b in ((hh, wl), (hl, wh), (hh, wh))]
    acc = np.zeros((h.shape[0], w.shape[1]), np.float32)
    for k0 in range(0, h.shape[1], k_tile):
        part = np.zeros_like(acc)
        for k in range(k0, k0 + k_tile, 8):
            for a, b in terms:
                part = _round_toward_zero(part + a[:, k:k + 8] @ b[k:k + 8])
        acc = acc + part
    return acc


def test_tf32_split_carries_22_bits():
    """hi and lo are TF32 (13 low bits zero), x - hi is exact in fp32, and
    hi + lo is within 2^-22 |x| of x; the rounding is half away from zero."""
    x = np.random.default_rng(0).normal(size=4096).astype(np.float32) * 10.0 ** np.arange(-4, 4).repeat(512)
    hi, lo = _split(x)
    assert not (hi.view(np.uint32) & 0x1FFF).any() and not (lo.view(np.uint32) & 0x1FFF).any()
    rest = x.astype(np.float64) - hi - lo
    assert (np.abs(rest) <= 2.0**-22 * np.abs(x)).all()
    tie = np.array([1 + 2**-11, -(1 + 2**-11), 1 + 3 * 2**-11], np.float32)  # halfway cases
    np.testing.assert_array_equal(_tf32(tie), [1 + 2**-10, -(1 + 2**-10), 1 + 2 * 2**-10])


def test_three_tf32_products_keep_fp32_accuracy():
    """At H = 1536 the three products, summed exactly, are within 2e-6 of a
    float64 product (as close as a plain fp32 product); one TF32 pass is
    not."""
    h, w, want = _k1_operands()
    (hh, hl), (wh, wl) = _split(h), _split(w)
    f64 = lambda a, b: a.astype(np.float64) @ b.astype(np.float64)  # noqa: E731
    three = f64(hh, wh) + f64(hh, wl) + f64(hl, wh)
    plain = (h @ w).astype(np.float64)
    assert np.abs(three - want).max() <= max(np.abs(plain - want).max(), F64_FLOOR)
    assert np.abs(f64(hh, wh) - want).max() > 100 * F64_FLOOR


def test_kernel_summation_keeps_fp32_accuracy():
    """Summed as the kernel sums them (32-deep k-tile sums added round-to-
    nearest) the three products stay within 2e-6 of float64, though every
    mma rounds toward zero; all 576 mma into one accumulator do not."""
    h, w, want = _k1_operands()
    assert np.abs(_mma_sums(h, w, k_tile=32) - want).max() <= F64_FLOOR
    assert np.abs(_mma_sums(h, w, k_tile=h.shape[1]) - want).max() > F64_FLOOR


# ---- the TF32 split's plain version (the split kernel's, bitwise) ----


def _tf32_f64(x):
    """fp32 x rounded to 11 significant bits, half away from zero, in
    float64 arithmetic (an emulation independent of the bit trick): the
    quantum 2^(e - 10) of x's binade, 2^-136 below the normal range (fp32's
    subnormal quantum 2^-149 times the 13 dropped bits); overflow to inf, inf
    kept, a NaN as 0x7fffe000."""
    x = np.asarray(x, np.float32)
    with np.errstate(invalid="ignore"):
        a = np.abs(x.astype(np.float64))
    _, ex = np.frexp(np.where(np.isfinite(a), a, 1.0))
    q = np.ldexp(1.0, np.maximum(ex - 11, -136))
    with np.errstate(over="ignore", invalid="ignore"):
        r = np.copysign(np.floor(a / q + 0.5) * q, x.astype(np.float64)).astype(np.float32)
    r = np.where(np.isinf(x), x, r)
    return np.where(np.isnan(x), np.uint32(0x7FFFE000).view(np.float32), r)


def _special_floats():
    bits = np.array([0x00000000, 0x80000000,  # +-0
                     0x00000001, 0x80000001, 0x00001000, 0x00001FFF, 0x007FFFFF, 0x807FF000,  # subnormal
                     0x00800000, 0x3F801000, 0xBF801000, 0x3F803000, 0x3F800FFF,  # ties and below
                     0x7F7FEFFF, 0x7F7FF000, 0x7F7FFFFF, 0xFF7FFFFF,  # the largest: to inf
                     0x7F800000, 0xFF800000,  # +-inf
                     0x7FC00000, 0x7FFFFFFF, 0xFFC00001, 0x7F800001], np.uint32)  # NaNs
    rng = np.random.default_rng(5)
    normal = (rng.normal(size=4000) * 10.0 ** rng.integers(-40, 38, size=4000)).astype(np.float32)
    return np.concatenate([bits.view(np.float32), normal])


def test_tf32_split_plain_is_round_half_away_bitwise():
    """The split's plain version against the float64 emulation, bit for bit,
    over +-0, subnormals, ties, the largest floats (which round to inf),
    +-inf, NaNs of several payloads and normal numbers of every scale: hi =
    tf32(x), lo = tf32(x - hi), lo = 0 where hi is inf or NaN; hi + lo
    within 2^-22 |x| of a finite x (2^-137 below lo's normal range)."""
    x = _special_floats()
    H = 7  # a row of 7: padded to 8 with zeros
    w = torch.from_numpy(np.resize(x, (H, -(-x.size // H))).copy())
    parts = tf32_split_plain(w)
    V = w.shape[1]
    assert parts.shape == (2, V, 8) and parts.dtype == torch.float32
    assert not parts[:, :, H:].view(torch.int32).any()
    xs = w.t().numpy()
    hi = _tf32_f64(xs)
    with np.errstate(invalid="ignore", over="ignore"):
        lo = np.where(np.isfinite(hi), _tf32_f64(xs - hi), np.float32(0))
    np.testing.assert_array_equal(parts[0, :, :H].numpy().view(np.uint32), hi.view(np.uint32))
    np.testing.assert_array_equal(parts[1, :, :H].numpy().view(np.uint32), lo.view(np.uint32))
    finite = np.isfinite(hi)
    rest = xs[finite].astype(np.float64) - hi[finite] - lo[finite]
    # 2^-22 |x| where lo is normal; below, lo's quantum is 2^-136
    assert (np.abs(rest) <= np.maximum(2.0**-22 * np.abs(xs[finite]), 2.0**-137)).all()


def test_split_head_on_the_cpu_is_the_plain_split():
    """`split_head` of a CPU tensor: the plain split of w in any strides (the
    decoder's head is a transposed view), no launch counted; the CPU wrapper
    and the plain version read a PreparedHead's source w."""
    h, w, b = (torch.from_numpy(a) for a in _mats(6, 61, 300, seed=2))
    before = dict(ROUTE_LAUNCHES)
    for src in (w, w.t().contiguous().t()):
        head = split_head(src)
        assert isinstance(head, PreparedHead) and head.map is None and head.shape == (61, 300)
        assert head.dtype == torch.float32 and head.device == w.device
        assert torch.equal(head.parts, tf32_split_plain(w))
        for got, want in zip(vocab_head_topk(h, head, b, 5, return_lse=True),
                             vocab_head_topk_plain(h, w, b, 5, return_lse=True)):
            assert torch.equal(got, want)
    assert ROUTE_LAUNCHES == before
    with pytest.raises(ValueError):
        split_head(w.to(torch.bfloat16))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_prepare_head_on_the_cpu_is_the_plain_head(dtype):
    """`prepare_head` of a CPU tensor (the decoder's head, a transposed
    view): the plain [H, V] tensor w.to(dtype), bf16 in rows TMA reads,
    fp32 contiguous; no launch counted, and the wrapper gives the plain
    version's result on it."""
    h, w, b = (torch.from_numpy(a) for a in _mats(6, 61, 301, seed=3))
    before = dict(ROUTE_LAUNCHES)
    head = prepare_head(w.t().contiguous().t(), dtype)
    assert isinstance(head, torch.Tensor) and torch.equal(head, w.to(dtype))
    if dtype == torch.float32:
        assert head.is_contiguous()
    else:
        assert head.stride() == (304, 1)
    for got, want in zip(vocab_head_topk(h, head, b, 5, return_lse=True),
                         vocab_head_topk_plain(h, w.to(dtype), b, 5, return_lse=True)):
        assert torch.equal(got, want)
    assert ROUTE_LAUNCHES == before
    with pytest.raises(ValueError, match="bf16 or fp32"):
        prepare_head(w, torch.float16)


def test_split_head_carries_the_heads_function():
    """The split head, fed to the plain version as hi + lo (what the three
    TF32 products approximate), gives the same top-k ids as the head itself
    on tiny_test_config weights, and values within 2^-22 of max |w| x H."""
    cfg = tiny_test_config()
    model = CapGnnModel(cfg, 37, generator=torch.Generator().manual_seed(3), device="cpu")
    w, b = (t.detach() for t in model.decoder_vocab_head())
    H = w.shape[0]
    parts = split_head(w).parts
    joined = (parts[0] + parts[1])[:, :H].t()
    h = torch.tanh(torch.from_numpy(np.random.default_rng(4).normal(size=(40, H)).astype(np.float32)))
    for normalize in (True, False):
        got = vocab_head_topk_plain(h, joined, b, 5, normalize=normalize)
        want = vocab_head_topk_plain(h, w, b, 5, normalize=normalize)
        assert torch.equal(got[1], want[1])
        torch.testing.assert_close(got[0], want[0], rtol=0, atol=2.0**-22 * float(w.abs().max()) * H + 1e-6)
