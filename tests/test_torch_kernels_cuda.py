"""dlsg_tpu_torch CUDA kernels against their plain PyTorch versions on the card.

Skipped without a CUDA device. The card's machine has no JAX, so this file
imports none and runs without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels_cuda.py

Tolerances: the kernels sum fp32 products in another order than cuBLAS (the
LSTM kernel's three bf16 terms of h, and the vocab head's three TF32 products
of hi/lo-split fp32 operands, give the fp32 product up to that order): atol
1e-4 on LSTM states and top-k values; vocab ids equal except near-ties within
1e-4 of each other. The fp32 vocab head is also held to fp32 accuracy: within
max(3 x the plain fp32 product's error, 2e-6) of a float64 product, which one
TF32 pass (about 4.6e-4) fails. The train path runs no kernel; its card-only
tests hold matmul_f32's gradients (bf16 operands, cast back to bf16: one
bf16 ulp, rtol 2^-7) and one tiny GAN step's Adam moments (fp32, 1e-4 of
each tensor's max-abs) against the CPU. The trainer's prefetcher (pinned
host slots, side-stream copies) must deliver every batch bitwise. The
two-pass decode (fp32, both kernels) gives the single pass's token ids.
The int8 product (qmatmul) is exact in its integer part and correctly
rounded elsewhere, so it equals its plain version bitwise (NaN where the
plain version has NaN), and the int8 decode on the card gives the CPU's
token ids. Remat (ops/remat.py) on the card: a generator rebuilt from a
snapshot draws bitwise the same, remat's gradients equal the unwrapped
function's bitwise, and a tiny bf16 GAN step under each remat field equals
the step without (metrics rtol 1e-5, tensors atol 2e-5)."""

from dataclasses import replace

import numpy as np
import pytest
import torch

from dlsg_tpu_torch.config import tiny_test_config
from dlsg_tpu_torch.evaluation.decode import _make_beam_from_feats, make_decode_fn
from dlsg_tpu_torch.kernels.lstm_scan import LIBRARY as LSTM_LIB
from dlsg_tpu_torch.kernels.qmatmul import LIBRARY as QMM_LIB
from dlsg_tpu_torch.kernels.qmatmul import BLOCK_NS, K_ALIGN, qmatmul_plan
from dlsg_tpu_torch.kernels.lstm_scan import lstm_scan, lstm_scan_plain, lstm_scan_plan, max_hidden
from dlsg_tpu_torch.kernels import lstm_scan as lstm_scan_mod
from dlsg_tpu_torch.kernels import vocab_head as vocab_head_mod
from dlsg_tpu_torch.kernels.vocab_head import LIBRARY as VOCAB_LIB
from dlsg_tpu_torch.kernels.vocab_head import (
    ROUTE_LAUNCHES,
    WGMMA_BLOCK_NS,
    vocab_head_plan,
    vocab_head_topk,
    vocab_head_topk_plain,
)
from dlsg_tpu_torch.models.discriminator import DiscV2
from dlsg_tpu_torch.models.generator import CapGnnModel
from dlsg_tpu_torch.ops import linear
from dlsg_tpu_torch.ops.linear import matmul_f32
from dlsg_tpu_torch.ops.quant import qmatmul, qmatmul_plain, quantize_weight
from dlsg_tpu_torch.train.gan_lambda import init_lambda_state
from dlsg_tpu_torch.train.optim import TrainState, make_optimizer
from dlsg_tpu_torch.train.steps import make_gan_train_step
from dlsg_tpu_torch.vocab import END_ID

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rand(*shape, seed=0, scale=1.0):
    return torch.from_numpy(
        np.random.default_rng(seed).normal(size=shape).astype(np.float32) * scale
    )


def _n_sm(card):
    return torch.cuda.get_device_properties(card).multi_processor_count


def _check_lstm_scan(card, B, T, H, reverse, scale=0.3):
    xw = _rand(B, T, 4 * H, seed=B + H).to(card)
    w = _rand(H, 4 * H, seed=H, scale=scale).to(card)
    before = LSTM_LIB.launches
    got = lstm_scan(xw, w, reverse=reverse)
    torch.cuda.synchronize()
    assert LSTM_LIB.launches == before + 1
    torch.testing.assert_close(got, lstm_scan_plain(xw, w, reverse=reverse), rtol=0, atol=1e-4)


@pytest.mark.parametrize("reverse", [False, True])
def test_lstm_scan_kernel_matches_plain(card, reverse):
    """Ragged batch and hidden size (37 rows, 40 units: not block multiples)."""
    xw = _rand(37, 9, 160, seed=1).to(card)
    w = _rand(40, 160, seed=2, scale=0.3).to(card)
    before = LSTM_LIB.launches
    got = lstm_scan(xw, w, reverse=reverse)
    torch.cuda.synchronize()
    assert LSTM_LIB.launches == before + 1
    torch.testing.assert_close(got, lstm_scan_plain(xw, w, reverse=reverse), rtol=0, atol=1e-4)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize(
    "B,T,H",
    [(128, 4, 1024),  # the encoder Bi-LSTM's widths, a short sequence
     (130, 3, 36),  # two row tiles; H not a multiple of 8 or 16
     (640, 2, 1024),  # five row tiles; the 2-chunk ring (c fills shared memory)
     (5, 4, 21)],  # H odd: h_{t-1} rows are not 16-byte aligned
)
def test_lstm_scan_kernel_shapes(card, B, T, H, reverse):
    _check_lstm_scan(card, B, T, H, reverse, scale=1.0 / H**0.5)


def test_lstm_scan_is_bitwise_repeatable(card):
    """The encoder's shapes (B = 128, T = 26, H = 1024), both directions, ten
    runs each: every run equals the first bitwise. h_t is written by
    ordinary stores and read on the next step by TMA (the async proxy), so
    a missing proxy fence or a grid barrier that lets a block run ahead
    shows as a stale h_{t-1}, now and then and at this size, not at small
    ones."""
    B, T, H = 128, 26, 1024
    xw = (_rand(B, T, 4 * H, seed=5) * 0.5).to(card)
    w = torch.from_numpy(np.linalg.qr(np.random.default_rng(6).normal(size=(4 * H, H)))[0].T
                         .astype(np.float32)).to(card)
    for reverse in (False, True):
        first = lstm_scan(xw, w, reverse=reverse)
        for _ in range(9):
            assert torch.equal(lstm_scan(xw, w, reverse=reverse), first)
        torch.testing.assert_close(first, lstm_scan_plain(xw, w, reverse=reverse), rtol=0, atol=1e-4)


@pytest.mark.parametrize("units,groups,boxes", [(8, 1, 2), (16, 1, 2), (16, 2, 2), (16, 2, 1)])
def test_lstm_scan_forced_plans_agree(card, monkeypatch, units, groups, boxes):
    """Each launch the breakdown times computes the same function: one group
    reading the whole batch or two reading 64 rows each, stages of one or
    two chunks (the plan `_ring` makes, in place of the plan's choice)."""
    monkeypatch.setattr(lstm_scan_mod, "lstm_scan_plan",
                        lambda B, H, **kw: lstm_scan_mod._ring(B, H, units, groups, boxes))
    xw = _rand(128, 6, 4096, seed=3).to(card)
    w = _rand(1024, 4096, seed=4, scale=1.0 / 32).to(card)
    before = LSTM_LIB.launches
    got = lstm_scan(xw, w)
    torch.cuda.synchronize()
    assert LSTM_LIB.launches == before + 1
    torch.testing.assert_close(got, lstm_scan_plain(xw, w), rtol=0, atol=1e-4)


def test_lstm_scan_largest_hidden_size(card):
    """The largest H the plan accepts runs (16 units a block, 227 KB of
    shared memory); one above it raises ValueError."""
    H = max_hidden(8, n_sm=_n_sm(card))
    assert lstm_scan_plan(8, H, n_sm=_n_sm(card)).units == 16
    _check_lstm_scan(card, 8, 3, H, reverse=False, scale=1.0 / H**0.5)
    xw = torch.zeros(8, 3, 4 * (H + 1), device=card)
    before = LSTM_LIB.launches
    with pytest.raises(ValueError, match="largest H"):
        lstm_scan(xw, torch.zeros(H + 1, 4 * (H + 1), device=card))
    assert LSTM_LIB.launches == before


def test_plans_state_the_kernels_shared_memory(card):
    """The Python plans and the compiled sources agree on shared memory."""
    lstm = LSTM_LIB.load()
    for B, H in [(128, 1024), (37, 40), (130, 36), (640, 1024), (8, 1552), (8, 1600), (2048, 1024)]:
        plan = lstm_scan_plan(B, H, n_sm=_n_sm(card))
        assert lstm.lstm_scan_smem_bytes(B, H, plan.units, plan.groups, plan.stages,
                                         plan.boxes) == plan.smem_bytes
    vocab = VOCAB_LIB.load()
    for dtype in (torch.bfloat16, torch.float32):
        tf32 = int(dtype == torch.float32)
        ragged = vocab_head_plan(130, 200, 2177, dtype)
        assert vocab.vocab_head_wgmma_smem_bytes(ragged.block_n, tf32) == ragged.smem_bytes
        for bn in WGMMA_BLOCK_NS:
            plan = vocab_head_mod._wgmma_plan(640, 10000, bn, _n_sm(card), dtype)
            assert vocab.vocab_head_wgmma_smem_bytes(bn, tf32) == plan.smem_bytes


@pytest.mark.parametrize(
    "G,H,V,k,dtype",
    [(70, 96, 1000, 1, torch.float32), (130, 200, 2177, 8, torch.bfloat16),
     (5, 64, 130, 5, torch.bfloat16),
     (640, 1536, 10000, 5, torch.bfloat16),  # the beam step's shapes
     (640, 1536, 10000, 5, torch.float32),
     (200, 72, 1000, 3, torch.bfloat16),  # aligned rows; G, H, V off every tile edge
     (130, 200, 2177, 8, torch.float32),  # w rows not 16-byte aligned (V = 2177)
     (5, 72, 130, 1, torch.float32)],
)
def test_vocab_head_kernel_matches_plain(card, G, H, V, k, dtype):
    """bf16 w takes the persistent wgmma kernel (rows TMA cannot read
    copied into rows it can), fp32 w its TF32 route (split in the call). Off the tile edges:
    G = 130, 5, 200 (tile 128), H = 200, 72 (k-tiles 32 and 64), V = 2177,
    130, 1000 (tiles 64 and 128); V = 2177 has w rows that are not 16-byte
    aligned (bf16 and fp32), V = 130 neither (bf16)."""
    h = _rand(G, H, seed=G).to(card)
    w = (_rand(H, V, seed=H) / H**0.5).to(card, dtype)
    b = _rand(V, seed=V).to(card)
    route = vocab_head_plan(G, H, V, dtype, n_sm=_n_sm(card)).route
    for normalize in (True, False):
        before, route_before = VOCAB_LIB.launches, ROUTE_LAUNCHES[route]
        vals, ids = vocab_head_topk(h, w, b, k, normalize=normalize)
        torch.cuda.synchronize()
        assert VOCAB_LIB.launches == before + 1
        assert ROUTE_LAUNCHES[route] == route_before + 1
        pv, pi = vocab_head_topk_plain(h, w, b, k, normalize=normalize)
        torch.testing.assert_close(vals, pv, rtol=0, atol=1e-4)
        logits = h.to(dtype).float() @ w.float() + b
        gap = (logits.gather(1, ids) - logits.gather(1, pi)).abs()
        assert bool((gap[ids != pi] <= 1e-4).all())


def _vocab_head_on_route(card, h, w, b, k, route, head=None, **kw):
    """One call on `head` (w's prepared head) or else w, which must launch
    once on `route`, held to the plain version on w: values within 1e-4,
    ids equal but at near-ties (1e-4)."""
    before, on_route = VOCAB_LIB.launches, ROUTE_LAUNCHES[route]
    out = vocab_head_topk(h, w if head is None else head, b, k, **kw)
    torch.cuda.synchronize()
    assert (VOCAB_LIB.launches, ROUTE_LAUNCHES[route]) == (before + 1, on_route + 1)
    want = vocab_head_topk_plain(h, w, b, k, **kw)
    torch.testing.assert_close(out[0], want[0], rtol=0, atol=1e-4)
    logits = h.to(w.dtype).float() @ w.float() + b
    gap = (logits.gather(1, out[1]) - logits.gather(1, want[1])).abs()
    assert bool((gap[out[1] != want[1]] <= 1e-4).all())
    if kw.get("return_lse"):
        torch.testing.assert_close(out[2], want[2], rtol=0, atol=1e-4)
    return out


@pytest.mark.parametrize("block_n", WGMMA_BLOCK_NS)
@pytest.mark.parametrize("V", [10000, 5000, 264])
@pytest.mark.parametrize("G", [1, 128, 130, 640])
def test_vocab_head_persistent_walk(card, monkeypatch, G, V, block_n):
    """The persistent kernel at each tile width: one row tile (G = 1, 128),
    a ragged second one (130) and five (640, the beam step), against V =
    10 000 (the head: 79 or 157 vocab tiles, several waves of blocks), 5 000
    (a rank's half of it) and 264 (fewer tiles than SMs, the last one ragged),
    with the row logsumexp returned."""
    monkeypatch.setattr(vocab_head_mod, "vocab_head_plan",
                        lambda G, H, V, dt, n_sm=132: vocab_head_mod._wgmma_plan(G, V, block_n, n_sm))
    H = 1536
    plan = vocab_head_mod.vocab_head_plan(G, H, V, torch.bfloat16, n_sm=_n_sm(card))
    assert (plan.route, plan.block_n) == ("wgmma", block_n)
    assert plan.blocks == min(plan.tiles[0] * plan.tiles[1], _n_sm(card))
    h = torch.tanh(_rand(G, H, seed=G + V)).to(card)
    w = (_rand(H, V, seed=V) * (2.0 / (H + V)) ** 0.5).to(card, torch.bfloat16)
    b = (_rand(V, seed=V + 1) * 0.01).to(card)
    _vocab_head_on_route(card, h, w, b, 5, "wgmma", return_lse=True)


@pytest.mark.parametrize(
    "G,H,V,dtype,route",
    [(640, 1536, 10000, torch.bfloat16, "wgmma"),  # the beam step
     (128, 1536, 10000, torch.bfloat16, "wgmma"),  # the first beam step, greedy
     (640, 1536, 5000, torch.bfloat16, "wgmma"),  # one rank's columns on the model axis
     (640, 1536, 9999, torch.bfloat16, "wgmma"),  # the beam step, a vocabulary of any size
     (130, 200, 2177, torch.bfloat16, "wgmma"),  # w rows not 16-byte aligned
     (5, 60, 136, torch.bfloat16, "wgmma"),  # h rows not 16-byte aligned
     (640, 1536, 10000, torch.float32, "wgmma_tf32"),  # the fp32 beam step
     (128, 1536, 10000, torch.float32, "wgmma_tf32"),
     (640, 1536, 5000, torch.float32, "wgmma_tf32"),
     (130, 200, 2177, torch.float32, "wgmma_tf32"),
     (5, 61, 136, torch.float32, "wgmma_tf32")],  # h rows not 16-byte aligned
)
def test_vocab_head_route_by_shape(card, G, H, V, dtype, route):
    """The plan picks the route from w's dtype, and the launch goes there:
    every shape on the persistent kernel (TMA reads 16-byte row pitches: h
    and bf16 w whose rows are not are copied into such rows; an fp32 w is
    split into K-major rows of ceil4(H))."""
    assert vocab_head_plan(G, H, V, dtype, n_sm=_n_sm(card)).route == route
    h = _rand(G, H, seed=7).to(card)
    w = (_rand(H, V, seed=8) / H**0.5).to(card, dtype)
    _vocab_head_on_route(card, h, w, _rand(V, seed=9).to(card), 5, route)


def test_vocab_head_wgmma_takes_unaligned_views(card):
    """h and w views that start off a 16-byte boundary (TMA reads from
    aligned addresses) are copied, not refused, and give the same result."""
    G, H, V = 64, 256, 1000
    hbuf = _rand(G * H + 1, seed=3).to(card, torch.bfloat16)
    wbuf = (_rand(H * V + 3, seed=4) / H**0.5).to(card, torch.bfloat16)
    h, w = hbuf[1:].view(G, H), wbuf[3:].view(H, V)
    assert h.data_ptr() % 16 and w.data_ptr() % 16
    b = _rand(V, seed=5).to(card)
    vals, ids = _vocab_head_on_route(card, h, w, b, 8, "wgmma")
    v2, i2 = vocab_head_topk(h.clone(), w.clone(), b, 8)
    assert torch.equal(vals, v2) and torch.equal(ids, i2)


@pytest.mark.parametrize("G,V", [(640, 9999), (128, 9999), (640, 4999), (130, 2177)])
def test_vocab_head_reads_the_decoders_pitched_w(card, G, V):
    """w as `Decoder.vocab_head_weights` lays it out (`aligned_rows`: a
    [H, V] view of rows ceil8(V) long) runs on its own rows, no copy: its
    TMA map is keyed by its pitch; the result equals the contiguous w's
    bitwise (which is copied into such rows on each call), and that of its
    prepared head (`prepare_head`, which the decoder hands the kernel:
    such rows with their map)."""
    H = 1536
    h = torch.tanh(_rand(G, H, seed=G + V)).to(card)
    w = (_rand(H, V, seed=V) * (2.0 / (H + V)) ** 0.5).to(card, torch.bfloat16)
    b = (_rand(V, seed=V + 1) * 0.01).to(card)
    wp = vocab_head_mod.aligned_rows(w)
    assert wp.stride(0) == -(-V // 8) * 8 and not wp.is_contiguous()
    got = _vocab_head_on_route(card, h, wp, b, 5, "wgmma", return_lse=True)
    assert (wp.data_ptr(), H, V, wp.stride(0)) in vocab_head_mod.WEIGHT_MAPS
    for a, c in zip(got, vocab_head_topk(h, w, b, 5, return_lse=True)):
        assert torch.equal(a, c)
    head = vocab_head_mod.prepare_head(w, torch.bfloat16)
    assert head.parts is None and head.w.stride(0) == wp.stride(0) and torch.equal(head.w, w)
    prepared = _vocab_head_on_route(card, h, w, b, 5, "wgmma", head=head, return_lse=True)
    assert all(torch.equal(a, c) for a, c in zip(got, prepared))


def test_vocab_head_wgmma_ties_go_to_lowest_id(card):
    """Ties on the persistent kernel's route: equal logits in one thread's
    columns, across the 4 threads of a quad, across vocab tiles and at
    zero; the lowest id wins everywhere, as lax.top_k."""
    G, H, V = 130, 64, 1024
    h = torch.zeros(G, H, device=card, dtype=torch.bfloat16)
    w = torch.zeros(H, V, device=card, dtype=torch.bfloat16)
    b = torch.zeros(V, device=card)
    b[[900, 6, 7, 2, 200, 129]] = 1.0
    vals, ids = _vocab_head_on_route(card, h, w, b, 8, "wgmma", normalize=False)
    assert ids.tolist() == [[2, 6, 7, 129, 200, 900, 0, 1]] * G
    assert vals[0].tolist() == [1.0] * 6 + [0.0, 0.0]


def _k1_operands(G, H, V, seed):
    """K1's operand distributions: h = tanh(N(0, 1)), w xavier-normal, a
    small bias."""
    rng = np.random.default_rng(seed)
    h = torch.from_numpy(np.tanh(rng.normal(size=(G, H))).astype(np.float32))
    w = torch.from_numpy((rng.normal(size=(H, V)) * (2.0 / (H + V)) ** 0.5).astype(np.float32))
    b = torch.from_numpy((rng.normal(size=V) * 0.01).astype(np.float32))
    return h, w, b


@pytest.mark.parametrize("G,V", [(640, 10000), (128, 10000), (640, 5000), (640, 9999), (130, 2177)])
def test_vocab_head_fp32_keeps_fp32_accuracy(card, G, V):
    """fp32 w at the beam step's shapes (G = 640; 128 at its first step; a
    rank's 5 000 columns; ragged V and G) and K1's operand distributions:
    the kernel's top-k logits lie within max(3 x the plain fp32 product's
    error, 2e-6) of a float64 product's. One TF32 pass misses by about
    4.6e-4."""
    H, k = 1536, 5
    h, w, b = (t.to(card) for t in _k1_operands(G, H, V, seed=11 + G + V))
    want = torch.topk(h.double() @ w.double() + b.double(), k).values
    vals, _ = _vocab_head_on_route(card, h, w, b, k, "wgmma_tf32", normalize=False)
    plain, _ = vocab_head_topk_plain(h, w, b, k, normalize=False)
    plain_err = float((plain.double() - want).abs().max())
    err = float((vals.double() - want).abs().max())
    assert err <= max(3 * plain_err, 2e-6), (err, plain_err)


def test_tf32_split_kernel_equals_plain_bitwise(card):
    """The split kernel against `tf32_split_plain`, bit for bit: w [H, V]
    row-major (the bare fp32 w) and as the decoder's transposed view of
    [V, H], H not a multiple of 4 (rows padded with zeros), with +-0,
    subnormals, ties, floats that round to inf, +-inf and NaNs of several
    payloads among normal numbers; one launch counted each."""
    H, V = 1539, 1000
    w = _rand(H, V, seed=21, scale=3.0)
    special = torch.tensor([0x00000000, 0x80000000, 0x00000001, 0x807FF000, 0x3F801000,
                            0xBF801000, 0x7F7FF000, 0xFF7FFFFF, 0x7F800000, 0xFF800000,
                            0x7FC00000, 0x7FFFFFFF, 0xFFC00001], dtype=torch.int64)
    special = (special - ((special >> 31) << 32)).to(torch.int32).view(torch.float32)
    w.view(-1)[:: w.numel() // special.numel()][: special.numel()] = special
    w.view(-1)[7::97] *= 2.0**-130  # subnormal
    for src in (w.to(card), w.t().contiguous().to(card).t()):
        before = ROUTE_LAUNCHES["tf32_split"]
        head = vocab_head_mod.split_head(src)
        torch.cuda.synchronize()
        assert ROUTE_LAUNCHES["tf32_split"] == before + 1
        want = vocab_head_mod.tf32_split_plain(w)
        assert head.parts.shape == (2, V, 1540)
        assert torch.equal(head.parts.view(torch.int32).cpu(), want.view(torch.int32))


def test_vocab_head_split_head_equals_bare_fp32_w(card):
    """A prepared head (split once, as the decoder does) and the bare fp32 w it
    came from (split in the call) give bitwise the same outputs, with the
    row logsumexp; the head's call launches no split."""
    h, w, b = (t.to(card) for t in _k1_operands(640, 1536, 10000, seed=5))
    head = vocab_head_mod.prepare_head(w, torch.float32)
    splits = ROUTE_LAUNCHES["tf32_split"]
    got = _vocab_head_on_route(card, h, w, b, 5, "wgmma_tf32", head=head, return_lse=True)
    assert ROUTE_LAUNCHES["tf32_split"] == splits
    bare = _vocab_head_on_route(card, h, w, b, 5, "wgmma_tf32", return_lse=True)
    assert ROUTE_LAUNCHES["tf32_split"] == splits + 1
    for a, c in zip(got, bare):
        assert torch.equal(a, c)


def test_vocab_head_fp32_is_bitwise_repeatable(card):
    """Ten runs of the fp32 route at the beam step's shape, bitwise equal:
    the ring's barriers, not timing, order every read of a stage."""
    h, w, b = (t.to(card) for t in _k1_operands(640, 1536, 10000, seed=6))
    head = vocab_head_mod.split_head(w)
    first = vocab_head_topk(h, head, b, 5, return_lse=True)
    for _ in range(9):
        again = vocab_head_topk(h, head, b, 5, return_lse=True)
        assert all(torch.equal(a, c) for a, c in zip(first, again))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("G,H,V,k", [(640, 1536, 5000, 5), (130, 200, 2177, 8)])
def test_vocab_head_returns_the_row_logsumexp(card, G, H, V, k, dtype):
    """`return_lse`: the merge launch writes each row's logsumexp, as
    `torch.logsumexp` of the plain logits, on both tile forms (V = 5000 is
    one rank's columns of the 10 000-word head split over 2); the values and
    ids are those of the call without it, and it is one launch."""
    h = _rand(G, H, seed=G + 1).to(card)
    w = (_rand(H, V, seed=H + 1) / H**0.5).to(card, dtype)
    b = _rand(V, seed=V + 1).to(card)
    logits = h.to(dtype).float() @ w.float() + b
    for normalize in (True, False):
        before = VOCAB_LIB.launches
        vals, ids, lse = vocab_head_topk(h, w, b, k, normalize=normalize, return_lse=True)
        torch.cuda.synchronize()
        assert VOCAB_LIB.launches == before + 1 and lse.shape == (G,) and lse.dtype == torch.float32
        torch.testing.assert_close(lse, torch.logsumexp(logits, dim=-1), rtol=0, atol=1e-4)
        v2, i2 = vocab_head_topk(h, w, b, k, normalize=normalize)
        assert torch.equal(vals, v2) and torch.equal(ids, i2)
        pv, pi, plse = vocab_head_topk_plain(h, w, b, k, normalize=normalize, return_lse=True)
        torch.testing.assert_close(lse, plse, rtol=0, atol=1e-4)


def test_vocab_head_ties_go_to_lowest_id(card):
    h = torch.zeros(4, 8, device=card)
    w = torch.zeros(8, 300, device=card)
    b = torch.zeros(300, device=card)
    b[[17, 200, 290]] = 1.0
    vals, ids = vocab_head_topk(h, w, b, 4, normalize=False)
    assert ids.tolist() == [[17, 200, 290, 0]] * 4
    assert vals[0].tolist() == [1.0, 1.0, 1.0, 0.0]


def test_wrappers_reject_what_the_kernels_do_not_take(card):
    h, w, b = torch.zeros(4, 8, device=card), torch.zeros(8, 20, device=card), torch.zeros(20, device=card)
    with pytest.raises(ValueError):
        vocab_head_topk(h, w, b, 9)  # k above the kernel's 8
    with pytest.raises(ValueError):
        vocab_head_topk(h, w.to(torch.float16), b, 3)
    with pytest.raises(ValueError):
        vocab_head_topk(h.t(), torch.zeros(4, 20, device=card), b, 3)  # non-contiguous h
    with pytest.raises(ValueError):  # bf16 w whose rows are not contiguous
        vocab_head_topk(h, torch.zeros(20, 8, device=card, dtype=torch.bfloat16).t(), b, 3)
    with pytest.raises(ValueError):
        lstm_scan(torch.zeros(2, 3, 16, device=card, dtype=torch.bfloat16), torch.zeros(4, 16, device=card))
    with pytest.raises(ValueError):
        lstm_scan(torch.zeros(2, 3, 16, device=card), torch.zeros(4, 12, device=card))


@pytest.mark.parametrize("N", [4096, 10000, 39])
@pytest.mark.parametrize("K", [2860, 4608, 1536, 40])
@pytest.mark.parametrize("G", [1, 13, 128, 640])
def test_qmatmul_kernel_equals_plain_bitwise(card, G, K, N):
    """The int8 decode's shapes (G = B or B x beam rows; K x N of Wq 2860 x
    4096, Wl 4608 x 6144, Wv 1536 x 10000) and ragged ones: K = 2860 and 40
    are no multiple of K_ALIGN, N = 39 and 10000 no multiple of the tile."""
    x = _rand(G, K, seed=G + K).to(card)
    qw = quantize_weight((_rand(K, N, seed=N) / K**0.5).to(card))
    before = QMM_LIB.launches
    got = qmatmul(x, *qw)
    torch.cuda.synchronize()
    assert QMM_LIB.launches == before + 1
    assert torch.equal(got, qmatmul_plain(x, *qw))


def test_qmatmul_scales_rows_of_any_range(card):
    """Rows of zeros (scale floor 1e-12), tiny and huge magnitudes and a bf16
    x (cast to fp32 first, as the plain version)."""
    x = _rand(6, 300, seed=1).to(card)
    x[1] = 0.0
    x[2] *= 1e-30
    x[3] *= 1e30
    qw = quantize_weight(_rand(300, 77, seed=2).to(card))
    assert torch.equal(qmatmul(x, *qw), qmatmul_plain(x, *qw))
    xb = x[:, :].to(torch.bfloat16)
    xb[3] = 1.0
    assert torch.equal(qmatmul(xb, *qw), qmatmul_plain(xb, *qw))


def test_qmatmul_wrapper_refusals_and_constants(card):
    qw = quantize_weight(torch.ones(40, 8, device=card))
    x = torch.ones(3, 40, device=card)
    assert QMM_LIB.load().qmatmul_k_align() == K_ALIGN
    for block_n in BLOCK_NS:
        plan = qmatmul_plan(640, 2860, 4096, _n_sm(card), block_n=block_n)
        assert QMM_LIB.load().qmatmul_smem_bytes(block_n) == plan.smem_bytes <= 232_448
    assert QMM_LIB.load().qmatmul_smem_bytes(80) == -1
    with pytest.raises(NotImplementedError):
        qmatmul(x.requires_grad_(), *qw)
    x = x.detach()
    with pytest.raises(ValueError):
        qmatmul(x, qw.qt[:, 1:], qw.s)  # not padded to K_ALIGN
    unaligned = torch.zeros(8 * 64 + 1, dtype=torch.int8, device=card)[1:].view(8, 64)
    with pytest.raises(ValueError):
        qmatmul(x, unaligned, qw.s)  # 16-byte alignment
    with pytest.raises(ValueError):
        qmatmul(x, qw.qt.t().contiguous().t(), qw.s)  # not contiguous
    with pytest.raises(ValueError):
        qmatmul(x, qw.qt.cpu(), qw.s)  # devices differ


def _qmatmul_equals_plain(x, qw):
    before = QMM_LIB.launches
    got = qmatmul(x, *qw)
    torch.cuda.synchronize()
    assert QMM_LIB.launches == before + 1
    want = qmatmul_plain(x, *qw)
    assert torch.equal(got.isnan(), want.isnan())
    assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(want))
    return got


@pytest.mark.parametrize(
    "G,N,waves",
    [(640, 4096, "below"),  # 130 tiles of 128 x 160
     (128, 8448, "at"),  # 132 tiles of 128 x 64
     (640, 10000, "above")],  # 395 tiles of 128 x 128 over 132 blocks
)
@pytest.mark.parametrize("K", [1536, 2860, 9000])  # a multiple of 128, not, a long row
def test_qmatmul_persistent_walk(card, G, N, waves, K):
    """Tile counts below, at and above the SM count (each block walks
    several tiles above it), K a multiple of the 128-byte stage and not,
    and rows longer than the quantize launch keeps in registers (8192)."""
    n_sm = _n_sm(card)
    plan = qmatmul_plan(G, K, N, n_sm)
    tiles = plan.tiles[0] * plan.tiles[1]
    assert {"below": tiles < n_sm, "at": tiles == n_sm, "above": tiles > n_sm}[waves]
    assert plan.blocks == min(tiles, n_sm)
    x = _rand(G, K, seed=G + K).to(card)
    _qmatmul_equals_plain(x, quantize_weight((_rand(K, N, seed=N) / K**0.5).to(card)))


def test_qmatmul_nan_and_zero_rows(card):
    """A row holding a NaN gives a NaN row (its scale is NaN, as torch's
    amax keeps it); an all-zero row gives zeros (scale floor 1e-12)."""
    x = _rand(130, 2860, seed=3).to(card)
    x[5, 17] = float("nan")
    x[64] = 0.0
    x[129] = float("nan")
    got = _qmatmul_equals_plain(x, quantize_weight((_rand(2860, 300, seed=4) / 53).to(card)))
    assert bool(got[5].isnan().all()) and bool(got[129].isnan().all())
    assert bool((got[64] == 0).all()) and not bool(got[[0, 63, 65, 128]].isnan().any())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_qmatmul_reads_rows_as_they_are(card, dtype):
    """fp32 and bf16 x go into the quantize launch without a cast (bf16
    widened exactly there), in 16-byte loads or one by one: 16-byte aligned
    or not, K a multiple of the 16-byte width or not."""
    for K in (2860, 37):
        qw = quantize_weight(_rand(K, 200, seed=K).to(card))
        x = _rand(65, K, seed=5).to(card).to(dtype)
        _qmatmul_equals_plain(x, qw)
        off = torch.empty(65 * K + 1, device=card, dtype=dtype)[1:].view(65, K)
        off.copy_(x)  # contiguous, one element off 16-byte alignment
        _qmatmul_equals_plain(off, qw)


def test_qmatmul_weight_maps_are_cached_by_address(card):
    """One TMA map per (pointer, N, Kp): reused on the next call, reused
    when the weight is re-quantized in place (the map holds no data), a new
    one for a weight at another address."""
    from dlsg_tpu_torch.kernels import qmatmul as qmm

    x = _rand(640, 1536, seed=6).to(card)
    qw = quantize_weight((_rand(1536, 4096, seed=7) / 40).to(card))
    _qmatmul_equals_plain(x, qw)
    key = (qw.qt.data_ptr(), 4096, 1536)
    first = qmm.WEIGHT_MAPS[key]
    _qmatmul_equals_plain(x, qw)
    assert qmm.WEIGHT_MAPS[key] is first
    other = quantize_weight((_rand(1536, 4096, seed=8) / 40).to(card))
    qw.qt.copy_(other.qt)
    qw.s.copy_(other.s)
    got = _qmatmul_equals_plain(x, qw)
    assert qmm.WEIGHT_MAPS[key] is first
    assert torch.equal(got, qmatmul_plain(x, *other))
    _qmatmul_equals_plain(x, other)
    assert qmm.WEIGHT_MAPS[(other.qt.data_ptr(), 4096, 1536)] is not first


@pytest.mark.parametrize("fused", ["off", "on"])
def test_tiny_int8_decode_on_card_matches_cpu(card, fused):
    """fp32 beam-3 and greedy int8 decodes on the card (qmatmul, both
    kernels) give the CPU decode's token ids from the same seeded weights."""
    cfg = tiny_test_config(use_pallas_lstm=True, use_fused_vocab_head=fused, decode_quant="int8")
    rng = np.random.default_rng(4)
    frames = rng.normal(size=(4, cfg.max_frames, cfg.feature_size)).astype(np.float32)
    regions = rng.normal(size=(4, cfg.max_frames, cfg.num_obj, cfg.region_feature_size)).astype(np.float32)
    for beam in (3, 1):
        cpu = make_decode_fn(CapGnnModel(cfg, 50, device="cpu"), cfg, beam_size=beam, device="cpu")
        gpu = make_decode_fn(CapGnnModel(cfg, 50, device=card), cfg, beam_size=beam, device=card)
        before = QMM_LIB.launches
        ids = gpu(frames, regions)
        per_step = 3 if beam == 1 or fused == "off" else 2
        assert QMM_LIB.launches - before >= per_step  # Wq, Wl (and Wv) each step
        assert ids.cpu().tolist() == cpu(frames, regions).tolist()


@pytest.mark.parametrize("fused", ["off", "on"])
def test_tiny_decode_on_card_matches_cpu(card, fused):
    """fp32 beam-3 decode with both kernels on the card gives the CPU
    decode's token ids (same seeded weights)."""
    cfg = tiny_test_config(use_pallas_lstm=True, use_fused_vocab_head=fused)
    rng = np.random.default_rng(4)
    frames = rng.normal(size=(4, cfg.max_frames, cfg.feature_size)).astype(np.float32)
    regions = rng.normal(size=(4, cfg.max_frames, cfg.num_obj, cfg.region_feature_size)).astype(np.float32)
    cpu = make_decode_fn(CapGnnModel(cfg, 50, device="cpu"), cfg, beam_size=3, device="cpu")
    gpu = make_decode_fn(CapGnnModel(cfg, 50, device=card), cfg, beam_size=3, device=card)
    before = LSTM_LIB.launches
    ids = gpu(frames, regions)
    assert LSTM_LIB.launches == before + 2
    assert ids.cpu().tolist() == cpu(frames, regions).tolist()


def test_two_pass_decode_on_card_matches_single_pass(card):
    """fp32, both kernels on: as <end>'s bias rises, no row, some rows (the
    compacted pass 2) or all rows finish within t1 = 4 steps; the two-pass
    decode gives the single pass's token ids in every case."""
    cfg = tiny_test_config(use_pallas_lstm=True, use_fused_vocab_head="on", test_batch_size=8,
                           max_words=10, beam_size=3)
    model = CapGnnModel(cfg, 50, device=card)
    rng = np.random.default_rng(6)
    fr = torch.from_numpy(rng.normal(size=(8, cfg.max_frames, cfg.feature_size)).astype(np.float32)).to(card)
    rg = torch.from_numpy(rng.normal(size=(8, cfg.max_frames, cfg.num_obj, cfg.region_feature_size))
                          .astype(np.float32)).to(card)
    single = make_decode_fn(model, cfg, device=card)
    two = make_decode_fn(model, replace(cfg, decode_two_pass_t1=4, decode_two_pass_bucket=4), device=card)
    beam_feats = _make_beam_from_feats(model, cfg, cfg.beam_size)
    bias = model.get_parameter("decoder.step.word_restore.bias")
    base = float(bias.detach()[END_ID])
    branches = set()
    for added in np.linspace(0.0, 12.0, 25):
        with torch.no_grad():
            bias[END_ID] = base + float(added)
        with torch.inference_mode():
            unfinished = int((~beam_feats(*model.encode(fr, rg), 4)[3]).sum())
        branches.add("none" if unfinished == 0 else "bucket" if unfinished <= 4 else "full batch")
        assert torch.equal(two(fr, rg), single(fr, rg)), (added, unfinished)
    assert branches == {"none", "bucket", "full batch"}, branches


@pytest.mark.parametrize("shapes", [((12, 24), (24, 8)), ((3, 12, 24), (3, 24, 8))])
def test_matmul_f32_gradients_match_cpu(card, shapes):
    """bf16 operands: the product (tensor cores on the card), its gradient
    and a gradient of that gradient (the penalty's double backward) agree
    with the CPU, where the product is the upcast one."""
    a0 = _rand(*shapes[0], seed=1).to(torch.bfloat16)
    b0 = _rand(*shapes[1], seed=2).to(torch.bfloat16)

    def run(device):
        a, b = a0.to(device).requires_grad_(True), b0.to(device).requires_grad_(True)
        out = matmul_f32(a, b)
        assert out.dtype == torch.float32 and out.grad_fn is not None
        w = _rand(*out.shape, seed=3).to(device)
        ga, gb = torch.autograd.grad((out * w).sum(), (a, b), create_graph=True)
        assert ga.dtype == gb.dtype == torch.bfloat16
        gga, ggb = torch.autograd.grad((ga.float() ** 2).sum() + (gb.float() ** 2).sum(), (a, b))
        return [t.detach().float().cpu() for t in (out, ga, gb, gga, ggb)]

    for got, want in zip(run(card), run("cpu")):
        assert float(want.abs().max()) > 0
        torch.testing.assert_close(got, want, rtol=2**-7, atol=1e-4 * float(want.abs().max()))


def test_tiny_gan_step_on_card_matches_cpu(card, monkeypatch):
    """One fp32 GAN step at tiny dims from the same weights, dropout off,
    fixed penalty weights: the same Adam first moments on both devices, and
    no tensor with a moment on one device only (a lost gradient)."""
    monkeypatch.setattr(linear, "dropout", lambda x, rate, rng: x)
    cfg = tiny_test_config()
    rng = np.random.default_rng(6)
    n, V = 4, 50
    lengths = rng.integers(2, cfg.max_words + 1, size=n)
    batch = {
        "frames": rng.normal(size=(n, cfg.max_frames, cfg.feature_size)).astype(np.float32),
        "regions": rng.normal(size=(n, cfg.max_frames, cfg.num_obj, cfg.region_feature_size)).astype(np.float32),
        "captions": np.where(np.arange(cfg.max_words)[None] < lengths[:, None],
                             rng.integers(4, V, size=(n, cfg.max_words)), 0),
        "lengths": lengths,
    }
    eps_gp = torch.from_numpy(rng.uniform(size=(cfg.num_D_visual, n)))
    moments = []
    for device in ("cpu", card):
        g, d = CapGnnModel(cfg, V, device=device), DiscV2(cfg, V, device=device)
        # a learning rate too small for D's sign-like first Adam updates to
        # feed rounding-level differences back into its later substeps
        gs, ds = TrainState.create(g, make_optimizer(1e-7)), TrainState.create(d, make_optimizer(1e-7))
        gs, ds, _, _ = make_gan_train_step(g, d, cfg)(
            gs, ds, init_lambda_state(0.01, device=device), batch, 3, 1.0, eps_gp=eps_gp
        )
        moments.append({**{f"G.{k}": v.cpu() for k, v in gs.first_moments().items()},
                        **{f"D.{k}": v.cpu() for k, v in ds.first_moments().items()}})
    want, got = moments
    for name, w in want.items():
        scale = float(w.abs().max())
        assert (scale == 0) == (float(got[name].abs().max()) == 0), name
        torch.testing.assert_close(got[name], w, rtol=0, atol=1e-4 * scale, msg=name)


def test_prefetch_to_device_on_the_card(card):
    """More batches than pinned slots, each consumed by a long kernel chain
    on the default stream while the next copies run on the side stream:
    every batch arrives whole, in order, cast where asked, and its tensors
    stay valid after the generator moves on."""
    from dlsg_tpu_torch.data.prefetch import BUFFER_SIZE, prefetch_to_device

    def host(n):
        rng = np.random.default_rng(5)
        for i in range(n):
            yield {
                "frames": rng.normal(size=(64, 26, 512)).astype(np.float32),
                "regions": rng.normal(size=(64, 26, 8, 256)).astype(np.float32),
                "captions": rng.integers(0, 50, size=(64, 26)).astype(np.int32),
                "lengths": np.full(64, 26, np.int32),
                "video_ids": np.arange(64, dtype=np.int32) + 64 * i,
            }

    n = 3 * BUFFER_SIZE + 1
    want = list(host(n))
    seen, kept = 0, []
    for got, ref in zip(prefetch_to_device(host(n), card, stage_dtype=torch.bfloat16), want):
        a = got["frames"].float()
        for _ in range(20):  # keep the default stream busy
            a = torch.tanh(a @ a.transpose(1, 2)[:, :, :512] * 1e-3)
        assert got["regions"].dtype == torch.bfloat16 and got["captions"].dtype == torch.int32
        torch.testing.assert_close(got["regions"].cpu(), torch.from_numpy(ref["regions"]).bfloat16())
        np.testing.assert_array_equal(got["captions"].cpu().numpy(), ref["captions"])
        np.testing.assert_array_equal(got["video_ids"], ref["video_ids"])
        kept.append((got["frames"], ref["frames"]))
        seen += 1
    assert seen == n
    torch.cuda.synchronize()
    for dev, ref in kept:  # nothing was overwritten by a later batch
        torch.testing.assert_close(dev.cpu(), torch.from_numpy(ref).bfloat16())


def test_cuda_generator_snapshot_replays_bitwise(card):
    """What ops/remat.py's replay rests on, on the card: a generator built
    on the card from another's `get_state()` (Philox seed and offset) draws
    bitwise what the other drew from that state, through the dropout draw
    (`rank_block_rand`), and ends in the same state."""
    from dlsg_tpu_torch.parallel.dist import rank_block_rand

    gen = torch.Generator(device=card).manual_seed(5)
    torch.rand(3, generator=gen, device=card)  # a state past the seed's
    snapshot = gen.get_state()
    first = [rank_block_rand((7, 1000), gen, card), torch.rand(33, generator=gen, device=card)]
    local = torch.Generator(device=card)
    local.set_state(snapshot)
    again = [rank_block_rand((7, 1000), local, card), torch.rand(33, generator=local, device=card)]
    for a, b in zip(first, again):
        assert torch.equal(a, b)
    assert torch.equal(local.get_state(), gen.get_state())


@pytest.mark.parametrize("policy", ["dots", "full"])
def test_remat_on_card_equals_the_unwrapped_function(card, policy, monkeypatch):
    """A bf16 product (matmul_f32: the tensor cores, fp32 out) under
    dropout from a card generator: remat's gradients equal the unwrapped
    function's bitwise, and the caller's generator ends where one forward
    leaves it. Under "dots" the policy keeps the card's products (the
    `mm` of `torch.mm(..., out_dtype=float32)`), so the backward uses the
    products the forward made."""
    from dlsg_tpu_torch.ops import remat as remat_mod

    saved = []
    real_policy = remat_mod._save_dots

    def recording(ctx, func, *args, **kwargs):
        decision = real_policy(ctx, func, *args, **kwargs)
        if decision == remat_mod.CheckpointPolicy.MUST_SAVE:
            saved.append(str(func))
        return decision

    monkeypatch.setattr(remat_mod, "_save_dots", recording)
    rs = np.random.default_rng(8)
    x = torch.tensor(rs.normal(size=(64, 96)), dtype=torch.bfloat16, device=card, requires_grad=True)
    w = torch.tensor(rs.normal(size=(96, 80)), dtype=torch.bfloat16, device=card, requires_grad=True)

    def fn(a, rng=None):
        return torch.tanh(linear.dropout(matmul_f32(a, w), 0.3, rng)) ** 2

    gen = torch.Generator(device=card).manual_seed(9)
    want = torch.autograd.grad(fn(x, rng=gen).sum(), (x, w))
    after = gen.get_state()
    gen = torch.Generator(device=card).manual_seed(9)
    got = torch.autograd.grad(remat_mod.remat(fn, policy, gen)(x).sum(), (x, w))
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert torch.equal(gen.get_state(), after)
    if policy == "dots":
        assert saved and all(s.startswith("aten.mm") for s in saved), saved


@pytest.mark.parametrize("fields", [{"decoder_remat": "dots"}, {"decoder_remat": "full"},
                                    {"disc_remat": "dots"}, {"disc_remat": "full"}])
def test_tiny_gan_step_with_remat_on_card_equals_none(card, fields):
    """One bf16 GAN step at tiny dims on the card, dropout 0.3 and a
    teacher-forcing ratio of 0.5 (masks and coins drawn from a card
    generator), under each remat field against the same step without:
    metrics rtol 1e-5, parameters and Adam first moments atol 2e-5
    (tests/test_torch_remat.py's tolerances). D's Adam is capturable on
    both sides: without D's remat the step replays D's substeps from a CUDA
    graph, which takes it (train/steps.py), and its on-device bias
    correction rounds otherwise than the host's."""
    rng = np.random.default_rng(6)
    n, V = 4, 50
    cfg = tiny_test_config(compute_dtype="bfloat16")
    lengths = rng.integers(2, cfg.max_words + 1, size=n)
    batch = {
        "frames": rng.normal(size=(n, cfg.max_frames, cfg.feature_size)).astype(np.float32),
        "regions": rng.normal(size=(n, cfg.max_frames, cfg.num_obj, cfg.region_feature_size)).astype(np.float32),
        "captions": np.where(np.arange(cfg.max_words)[None] < lengths[:, None],
                             rng.integers(4, V, size=(n, cfg.max_words)), 0),
        "lengths": lengths,
    }
    runs = []
    for c in (cfg, replace(cfg, **fields)):
        g, d = CapGnnModel(c, V, device=card), DiscV2(c, V, device=card)
        gs, ds = TrainState.create(g, make_optimizer(1e-4)), TrainState.create(d, make_optimizer(1e-4))
        ds.set_capturable(True)
        gs, ds, _, m = make_gan_train_step(g, d, c)(
            gs, ds, init_lambda_state(0.01, device=card), batch, 3, 0.5)
        runs.append(({k: float(v) for k, v in m.items() if k != "sample_tokens"},
                     {**{f"G.{k}": v for k, v in g.state_dict().items()},
                      **{f"D.{k}": v for k, v in d.state_dict().items()},
                      **{f"G.mu.{k}": v for k, v in gs.first_moments().items()},
                      **{f"D.mu.{k}": v for k, v in ds.first_moments().items()}}))
    (wm, wt), (gm, gt) = runs
    for k, v in wm.items():
        assert gm[k] == pytest.approx(v, rel=1e-5), k
    for k, v in wt.items():
        torch.testing.assert_close(gt[k], v, rtol=0, atol=2e-5, msg=k)
