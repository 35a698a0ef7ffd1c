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
rounded elsewhere, so it equals its plain version bitwise, and the int8
decode on the card gives the CPU's token ids."""

from dataclasses import replace

import numpy as np
import pytest
import torch

from dlsg_tpu_torch.config import tiny_test_config
from dlsg_tpu_torch.evaluation.decode import _make_beam_from_feats, make_decode_fn
from dlsg_tpu_torch.kernels.lstm_scan import LIBRARY as LSTM_LIB
from dlsg_tpu_torch.kernels.qmatmul import LIBRARY as QMM_LIB
from dlsg_tpu_torch.kernels.qmatmul import K_ALIGN
from dlsg_tpu_torch.kernels.lstm_scan import lstm_scan, lstm_scan_plain, lstm_scan_plan, max_hidden
from dlsg_tpu_torch.kernels.vocab_head import LIBRARY as VOCAB_LIB
from dlsg_tpu_torch.kernels.vocab_head import (
    ROUTE_LAUNCHES,
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
    for B, H in [(128, 1024), (37, 40), (130, 36), (640, 1024), (8, 1552)]:
        plan = lstm_scan_plan(B, H, n_sm=_n_sm(card))
        assert lstm.lstm_scan_smem_bytes(B, H, plan.units, plan.stages) == plan.smem_bytes
    vocab = VOCAB_LIB.load()
    assert vocab.vocab_head_tc_smem_bytes() == vocab_head_plan(640, 10000, torch.bfloat16).smem_bytes
    assert vocab.vocab_head_tf32x3_smem_bytes() == vocab_head_plan(640, 10000, torch.float32).smem_bytes


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
    """bf16 w takes the bf16 tensor-core tiles, fp32 w the TF32x3 tiles. Off
    the tile edges: G = 130, 5, 200 (tile 128), H = 200, 72 (k-tile 32), V =
    2177, 130, 1000 (tile 128); V = 2177 has w rows that are not 16-byte
    aligned (bf16 and fp32), H = 200 h rows that are not (bf16)."""
    h = _rand(G, H, seed=G).to(card)
    w = (_rand(H, V, seed=H) / H**0.5).to(card, dtype)
    b = _rand(V, seed=V).to(card)
    route = vocab_head_plan(G, V, dtype).route
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


def test_vocab_head_fp32_keeps_fp32_accuracy(card):
    """fp32 w at the beam step's shapes and K1's operand distributions (h =
    tanh(N(0, 1)), w xavier-normal): the kernel's top-k logits lie within
    max(3 x the plain fp32 product's error, 2e-6) of a float64 product's. One
    TF32 pass misses by about 4.6e-4."""
    G, H, V, k = 640, 1536, 10000, 5
    rng = np.random.default_rng(11)
    h = torch.from_numpy(np.tanh(rng.normal(size=(G, H))).astype(np.float32)).to(card)
    w = torch.from_numpy((rng.normal(size=(H, V)) * (2.0 / (H + V)) ** 0.5).astype(np.float32)).to(card)
    b = torch.from_numpy((rng.normal(size=V) * 0.01).astype(np.float32)).to(card)
    want = torch.topk(h.double() @ w.double() + b.double(), k).values
    vals, _ = vocab_head_topk(h, w, b, k, normalize=False)
    plain, _ = vocab_head_topk_plain(h, w, b, k, normalize=False)
    plain_err = float((plain.double() - want).abs().max())
    err = float((vals.double() - want).abs().max())
    assert err <= max(3 * plain_err, 2e-6), (err, plain_err)


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
    assert QMM_LIB.load().qmatmul_smem_bytes() <= 232_448
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
