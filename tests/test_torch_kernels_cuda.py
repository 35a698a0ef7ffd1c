"""dlsg_tpu_torch CUDA kernels against their plain PyTorch versions on the card.

Skipped without a CUDA device. The card's machine has no JAX, so this file
imports none and runs without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels_cuda.py

Tolerances: the kernels sum fp32 products in another order than cuBLAS:
atol 1e-4 on LSTM states and top-k values; vocab ids equal except near-ties
within 1e-4 of each other."""

import numpy as np
import pytest
import torch

from dlsg_tpu_torch.config import tiny_test_config
from dlsg_tpu_torch.evaluation.decode import make_decode_fn
from dlsg_tpu_torch.kernels.lstm_scan import LIBRARY as LSTM_LIB
from dlsg_tpu_torch.kernels.lstm_scan import lstm_scan, lstm_scan_plain
from dlsg_tpu_torch.kernels.vocab_head import LIBRARY as VOCAB_LIB
from dlsg_tpu_torch.kernels.vocab_head import vocab_head_topk, vocab_head_topk_plain
from dlsg_tpu_torch.models.generator import CapGnnModel

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


@pytest.mark.parametrize(
    "G,H,V,k,dtype",
    [(70, 96, 1000, 1, torch.float32), (130, 200, 2177, 8, torch.bfloat16),
     (5, 64, 130, 5, torch.bfloat16)],
)
def test_vocab_head_kernel_matches_plain(card, G, H, V, k, dtype):
    h = _rand(G, H, seed=G).to(card)
    w = (_rand(H, V, seed=H) / H**0.5).to(card, dtype)
    b = _rand(V, seed=V).to(card)
    for normalize in (True, False):
        before = VOCAB_LIB.launches
        vals, ids = vocab_head_topk(h, w, b, k, normalize=normalize)
        torch.cuda.synchronize()
        assert VOCAB_LIB.launches == before + 1
        pv, pi = vocab_head_topk_plain(h, w, b, k, normalize=normalize)
        torch.testing.assert_close(vals, pv, rtol=0, atol=1e-4)
        logits = h.to(dtype).float() @ w.float() + b
        gap = (logits.gather(1, ids) - logits.gather(1, pi)).abs()
        assert bool((gap[ids != pi] <= 1e-4).all())


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
