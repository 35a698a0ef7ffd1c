"""Launch plans of the dlsg_tpu_torch kernels (kernels/lstm_scan.py,
kernels/vocab_head.py, kernels/qmatmul.py), on the CPU: how each shape is
cut into blocks, and that every block fits one H100 SM (227 KB of shared
memory, and for the LSTM scan's grid barrier at most 132 blocks, all
resident at once; qmatmul's persistent blocks at most one per SM, walking
every output tile once).
tests/test_torch_kernels_cuda.py holds the plans against the compiled
sources on the card."""

import pytest
import torch

from dlsg_tpu_torch.kernels.lstm_scan import N_SM, SMEM_LIMIT, lstm_scan_plan, max_hidden
from dlsg_tpu_torch.kernels.qmatmul import BLOCK_NS
from dlsg_tpu_torch.kernels.qmatmul import K_MAX as QMM_K_MAX
from dlsg_tpu_torch.kernels.qmatmul import qmatmul_plan
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


def _check_qmatmul_plan(plan, G, N, n_sm=N_SM):
    n_row, n_col = plan.tiles
    assert n_row == -(-G // plan.block_m) and n_col == -(-N // plan.block_n)
    assert plan.block_n in BLOCK_NS and plan.block_m == 128 and plan.block_k == 128
    assert plan.smem_bytes <= SMEM_LIMIT
    assert plan.blocks == min(n_row * n_col, n_sm) <= n_sm
    walked = [t for b in range(plan.blocks) for t in plan.walk(b)]
    assert sorted(walked) == [(r, c) for r in range(n_row) for c in range(n_col)]


@pytest.mark.parametrize(
    "G,K,N,block_n,tiles,blocks",
    [(640, 2860, 4096, 160, (5, 26), 130),  # Wq after the first beam step: one wave
     (640, 4608, 6144, 256, (5, 24), 120),  # Wl: one wave
     (640, 1536, 10000, 128, (5, 79), 132),  # Wv: 3 waves of 128 beat 2 of 256
     (128, 2860, 4096, 64, (1, 64), 64),  # the first beam step and greedy: narrow tiles
     (128, 4608, 6144, 64, (1, 96), 96),
     (128, 1536, 10000, 96, (1, 105), 105)],
)
def test_qmatmul_plan_decode_shapes(G, K, N, block_n, tiles, blocks):
    plan = qmatmul_plan(G, K, N)
    assert (plan.block_n, plan.tiles, plan.blocks) == (block_n, tiles, blocks)
    _check_qmatmul_plan(plan, G, N)


@pytest.mark.parametrize("N", [39, 10000])
@pytest.mark.parametrize("K", [40, 2860])
@pytest.mark.parametrize("G", [1, 13, 64, 65, 129])
def test_qmatmul_plan_tiny_and_ragged(G, K, N):
    """Rows, depth and columns that fill no tile: the walk still covers
    every output tile once, within one block per SM and 227 KB."""
    _check_qmatmul_plan(qmatmul_plan(G, K, N), G, N)


@pytest.mark.parametrize(
    "block_n,stages", [(256, 4), (224, 4), (192, 4), (160, 5), (128, 6), (96, 6), (64, 8)]
)
def test_qmatmul_plan_ring(block_n, stages):
    """A 192 KB ring of [128 + block_n, 128] int8 stages (at most 8), then
    the staged epilogue (two warpgroups x 64 x 40 fp32) with each
    warpgroup's 256 column scales, the barriers and 1 KB to align the ring
    for the 128-byte swizzle."""
    plan = qmatmul_plan(640, 2860, 4096, block_n=block_n)
    assert plan.stages == stages
    assert plan.smem_bytes == 1024 + stages * (128 + block_n) * 128 + 2 * 64 * 40 * 4 + 2048 + 128
    assert plan.smem_bytes <= SMEM_LIMIT


@pytest.mark.parametrize("n_sm", [1, 7, 132, 1000])
def test_qmatmul_plan_follows_the_card(n_sm):
    """Any SM count: at most one block each, every tile walked once; the
    row tiles of one column tile run next to each other."""
    plan = qmatmul_plan(640, 1536, 10000, n_sm=n_sm)
    _check_qmatmul_plan(plan, 640, 10000, n_sm)
    n_row = plan.tiles[0]
    firsts = [plan.walk(b)[0] for b in range(min(plan.blocks, n_row))]
    assert firsts == [(r, 0) for r in range(len(firsts))]


@pytest.mark.parametrize(
    "shape", [(0, 40, 8), (4, 0, 8), (4, 40, 0), (4, QMM_K_MAX + 1, 8), (-1, 40, 8)]
)
def test_qmatmul_plan_refuses(shape):
    with pytest.raises(ValueError):
        qmatmul_plan(*shape)
    with pytest.raises(ValueError):
        qmatmul_plan(4, 40, 8, n_sm=0)


def test_qmatmul_plan_takes_the_largest_exact_k():
    """127^2 K_MAX fits an int32: the integer sum stays exact up to K_MAX."""
    assert 127**2 * QMM_K_MAX < 2**31 <= 127**2 * (QMM_K_MAX + 1)
    _check_qmatmul_plan(qmatmul_plan(8, QMM_K_MAX, 8), 8, 8)


@pytest.mark.parametrize("block_n", [64, 96, 128, 160, 192, 224, 256])
def test_qmatmul_plan_forced_width(block_n):
    """A forced tile width (the breakdown times each) keeps the plan whole."""
    plan = qmatmul_plan(640, 1536, 10000, block_n=block_n)
    assert plan.block_n == block_n
    _check_qmatmul_plan(plan, 640, 10000)
    with pytest.raises(ValueError):
        qmatmul_plan(640, 1536, 10000, block_n=80)
