"""Launch plans of the dlsg_tpu_torch kernels (kernels/lstm_scan.py,
kernels/vocab_head.py), on the CPU: how each shape is cut into blocks, and
that every block fits one H100 SM (227 KB of shared memory, and for the
LSTM scan's grid barrier at most 132 blocks, all resident at once).
tests/test_torch_kernels_cuda.py holds the plans against the compiled
sources on the card."""

import pytest
import torch

from dlsg_tpu_torch.kernels.lstm_scan import N_SM, SMEM_LIMIT, lstm_scan_plan, max_hidden
from dlsg_tpu_torch.kernels.vocab_head import TILE_V, vocab_head_plan


@pytest.mark.parametrize(
    "B,H,units",
    [(128, 1024, 8),  # the encoder Bi-LSTM (visual_hidden_size 1024)
     (37, 40, 8),  # the card tests' ragged case
     (130, 36, 8),  # two row tiles
     (1, 1056, 8),  # 132 blocks of 8 units
     (128, 1057, 16),  # one block too many at 8 units
     (128, 1552, 16)],  # the largest H at B = 128
)
def test_lstm_scan_plan_fits_the_card(B, H, units):
    plan = lstm_scan_plan(B, H)
    assert plan.units == units
    assert plan.blocks == -(-H // units) <= N_SM
    assert plan.blocks * plan.units >= H
    assert plan.smem_bytes <= SMEM_LIMIT


def test_lstm_scan_plan_main_path_shared_memory():
    """B = 128, H = 1024: 128 blocks, each a 64 KB bf16 W_hh slice, a ring
    of four [128 x 72] fp32 h chunks and c [128 x 8] fp32."""
    plan = lstm_scan_plan(128, 1024)
    assert (plan.blocks, plan.chunk_k, plan.stages) == (128, 64, 4)
    assert plan.smem_bytes == 1024 * 32 * 2 + 4 * 128 * 72 * 4 + 128 * 8 * 4


def test_lstm_scan_plan_shortens_the_ring_for_a_large_batch():
    """B = 640 at H = 1024: c [640 x 8] no longer fits beside four chunks."""
    plan = lstm_scan_plan(640, 1024)
    assert (plan.units, plan.stages) == (8, 2)
    assert plan.smem_bytes <= SMEM_LIMIT


@pytest.mark.parametrize("B", [1, 37, 128, 256, 1024])
def test_lstm_scan_max_hidden_is_the_edge(B):
    H = max_hidden(B)
    assert H >= 1024  # every config of the repo (visual_hidden_size 1024)
    assert lstm_scan_plan(B, H).smem_bytes <= SMEM_LIMIT
    with pytest.raises(ValueError, match=f"largest H for this batch is {H}"):
        lstm_scan_plan(B, H + 1)


def test_lstm_scan_plan_follows_the_card():
    """Fewer SMs lower the largest H; a batch whose c does not fit raises."""
    assert max_hidden(128, n_sm=64) == 1024  # 64 blocks of 16 units
    assert lstm_scan_plan(128, 1024, n_sm=64).units == 16
    with pytest.raises(ValueError):
        lstm_scan_plan(128, 1025, n_sm=64)
    with pytest.raises(ValueError):
        lstm_scan_plan(8192, 1024)


@pytest.mark.parametrize(
    "G,V,dtype,route,grid",
    [(640, 10000, torch.bfloat16, "tensor_cores", (5, 79)),  # the beam step
     (130, 2177, torch.bfloat16, "tensor_cores", (2, 18)),
     (5, 130, torch.bfloat16, "tensor_cores", (1, 2)),
     (640, 10000, torch.float32, "tf32x3", (5, 79)),
     (70, 1000, torch.float32, "tf32x3", (1, 8))],
)
def test_vocab_head_plan(G, V, dtype, route, grid):
    plan = vocab_head_plan(G, V, dtype)
    assert (plan.route, plan.grid) == (route, grid)
    n_row, n_col = grid
    assert n_row * plan.block_m >= G and n_col * TILE_V >= V
    assert plan.smem_bytes <= SMEM_LIMIT


def test_vocab_head_plan_tensor_core_tiles():
    """bf16: 4 stages of [128 x 40] h + [32 x 136] w bf16 (75,776 B), more than
    the [128 x 130] fp32 logits tile it is reused for; two blocks fit an SM."""
    plan = vocab_head_plan(640, 10000, torch.bfloat16)
    assert (plan.block_m, plan.block_k, plan.stages) == (128, 32, 4)
    assert plan.smem_bytes == 4 * (128 * 40 + 32 * 136) * 2 == 75776
    assert 2 * plan.smem_bytes <= SMEM_LIMIT


def test_vocab_head_plan_tf32x3_tiles():
    """fp32: 4 stages of [128 x 36] h + [32 x 136] w fp32 (143,360 B, rows
    padded against bank conflicts of the scalar fragment loads), more than
    the [128 x 130] fp32 logits tile it is reused for; one block fits an SM."""
    plan = vocab_head_plan(640, 10000, torch.float32)
    assert (plan.block_m, plan.block_k, plan.stages) == (128, 32, 4)
    assert plan.smem_bytes == 4 * (128 * 36 + 32 * 136) * 4 == 143360
    assert plan.smem_bytes > 128 * 130 * 4
    assert plan.smem_bytes <= SMEM_LIMIT < 2 * plan.smem_bytes


def test_vocab_head_plan_rejects_other_dtypes():
    with pytest.raises(ValueError):
        vocab_head_plan(8, 100, torch.float16)
