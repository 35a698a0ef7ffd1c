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

from dlsg_tpu_torch.kernels.lstm_scan import N_SM, SMEM_LIMIT, _ring, lstm_scan_plan, max_hidden
from dlsg_tpu_torch.kernels.qmatmul import BLOCK_NS
from dlsg_tpu_torch.kernels.qmatmul import K_MAX as QMM_K_MAX
from dlsg_tpu_torch.kernels.qmatmul import qmatmul_plan
from dlsg_tpu_torch.kernels.vocab_head import (
    WGMMA_BLOCK_NS, _tma_rows, _wgmma_plan, aligned_rows, vocab_head_plan, vocab_head_topk,
)


@pytest.mark.parametrize(
    "B,H,units,groups",
    [(128, 1024, 16, 2),  # the encoder Bi-LSTM (visual_hidden_size 1024): two 64-row groups
     (37, 40, 8, 1),  # the card tests' ragged case
     (130, 36, 8, 3),  # three row tiles, one group each
     (1, 1056, 8, 1),  # 132 blocks of 8 units
     (128, 1057, 16, 1),  # one block too many at 8 units
     (128, 1552, 16, 1)],  # the old kernel's largest H at B = 128
)
def test_lstm_scan_plan_fits_the_card(B, H, units, groups):
    plan = lstm_scan_plan(B, H)
    assert (plan.units, plan.groups) == (units, groups)
    assert plan.blocks == groups * -(-H // units) <= N_SM
    assert plan.blocks // plan.groups * plan.units >= H
    assert 2 <= plan.stages <= 8 and plan.boxes in (1, 2)
    assert plan.smem_bytes <= SMEM_LIMIT


def test_lstm_scan_plan_main_path_shared_memory():
    """B = 128, H = 1024: 2 groups x 64 blocks of 16 units, so a block reads
    64 rows of h_{t-1} a step; each holds a 128 KB bf16 W_hh slice, a ring of
    five stages of two [64 x 32] fp32 h chunks, c [64 x 16] fp32, the
    barriers and 1 KB to align the swizzled ring."""
    plan = lstm_scan_plan(128, 1024)
    assert (plan.units, plan.groups, plan.blocks, plan.stages, plan.boxes) == (16, 2, 128, 5, 2)
    assert plan.smem_bytes == 1024 + 5 * 2 * 64 * 32 * 4 + 1024 * 64 * 2 + 64 * 16 * 4 + 128


def test_lstm_scan_plan_shortens_the_ring_for_a_large_batch():
    """B = 2048 at H = 1024: each block keeps c for 16 row tiles (64 KB), and
    the ring shortens to the two stages of two chunks that still fit; at
    H = 1552 (B = 128) the W_hh slice leaves room for two single chunks."""
    plan = lstm_scan_plan(2048, 1024)
    assert (plan.units, plan.groups, plan.stages, plan.boxes) == (16, 2, 2, 2)
    assert plan.smem_bytes <= SMEM_LIMIT
    plan = lstm_scan_plan(128, 1552)
    assert (plan.units, plan.groups, plan.stages, plan.boxes) == (16, 1, 2, 1)
    assert plan.smem_bytes <= SMEM_LIMIT


@pytest.mark.parametrize("B", [1, 37, 128, 256, 1024])
def test_lstm_scan_max_hidden_is_the_edge(B):
    H = max_hidden(B)
    assert H >= 1024  # every config of the repo (visual_hidden_size 1024)
    assert lstm_scan_plan(B, H).smem_bytes <= SMEM_LIMIT
    with pytest.raises(ValueError, match=f"largest H for this batch is {H}"):
        lstm_scan_plan(B, H + 1)


@pytest.mark.parametrize(
    "B,old", [(1, 1552), (8, 1552), (37, 1552), (64, 1552), (128, 1552), (256, 1488),
              (640, 1296), (1024, 1104)])
def test_lstm_scan_max_hidden_does_not_fall(B, old):
    """The largest H per batch is at least the mma.sync kernel's (its
    plan: 1552 up to B = 128): the W_hh slice is padded to 64 k, not 16, but
    the ring of 64-row chunks is smaller than its 128-row one."""
    assert max_hidden(B) >= old


def test_lstm_scan_plan_follows_the_card():
    """Fewer SMs lower the largest H; a batch whose c does not fit raises."""
    assert max_hidden(128, n_sm=64) == 1024  # 64 blocks of 16 units
    assert lstm_scan_plan(128, 1024, n_sm=64).units == 16
    with pytest.raises(ValueError):
        lstm_scan_plan(128, 1025, n_sm=64)
    with pytest.raises(ValueError):
        lstm_scan_plan(8192, 1024)


@pytest.mark.parametrize("B,H", [(128, 1024), (640, 1024), (37, 40), (5, 21)])
def test_lstm_scan_plan_groups_and_co_residency(B, H):
    """Every block resident at once (the grid barrier): at most one per SM;
    the groups split the 64-row tiles evenly to within one; the plans the
    breakdown forces in place of the choice (`_ring` at either unit count,
    one group, stages of one or two chunks) fit as well."""
    plan = lstm_scan_plan(B, H)
    n_rt = -(-B // 64)
    assert plan.groups <= n_rt and plan.blocks <= N_SM
    assert plan == _ring(B, H, plan.units, plan.groups)
    for units in (8, 16):
        for boxes in (1, 2):
            forced = _ring(B, H, units, 1, boxes)
            assert (forced.units, forced.groups, forced.boxes) == (units, 1, boxes)
            assert forced.blocks == -(-H // units) <= N_SM
            assert 2 <= forced.stages <= 8 and forced.smem_bytes <= SMEM_LIMIT


@pytest.mark.parametrize(
    "G,H,V,dtype,route,tiles",
    [(640, 1536, 10000, torch.bfloat16, "wgmma", (5, 79)),  # the beam step
     (130, 200, 2177, torch.bfloat16, "wgmma", (2, 35)),  # rows TMA reads only once copied
     (5, 64, 130, torch.bfloat16, "wgmma", (1, 3)),
     (640, 1536, 9999, torch.bfloat16, "wgmma", (5, 79)),  # a vocabulary of any size
     (640, 1536, 10000, torch.float32, "wgmma_tf32", (5, 79)),
     (70, 96, 1000, torch.float32, "wgmma_tf32", (1, 16))],
)
def test_vocab_head_plan(G, H, V, dtype, route, tiles):
    plan = vocab_head_plan(G, H, V, dtype)
    assert (plan.route, plan.tiles) == (route, tiles)
    n_row, n_col = tiles
    assert n_row * plan.block_m >= G and n_col * plan.block_n >= V
    assert plan.smem_bytes <= SMEM_LIMIT


def test_vocab_head_plan_tensor_core_tiles():
    """bf16 whose rows are not 16-byte multiples (H = 200, V = 2177) takes
    the persistent tensor-core kernel as every bf16 shape: 35 tiles of 64
    columns for each of the 2 row tiles (the cheaper width in one wave),
    the 8-stage ring of [128 x 64] h + [64 x 64] w, one block a tile here
    (fewer tiles than SMs)."""
    plan = vocab_head_plan(130, 200, 2177, torch.bfloat16)
    assert (plan.route, plan.block_m, plan.block_n, plan.block_k, plan.stages) == ("wgmma", 128, 64, 64, 8)
    assert plan.tiles == (2, 35) and plan.blocks == 70
    assert plan.smem_bytes == 1024 + 8 * (128 + 64) * 64 * 2 + 2 * 128 * 4 + 2 * 8 * 8 <= SMEM_LIMIT


def test_vocab_head_plan_tf32x3_tiles():
    """fp32 (three TF32 products) runs the persistent kernel too: 4 stages
    of [128 x 32] h + hi and lo [32 x 128] of the split w, fp32 (48 KB a
    stage, the 192 KB ring), the bias tiles, the barriers and 1 KB to align
    the ring; one block fits an SM, 132 of them walk the 5 x 79 tiles."""
    plan = vocab_head_plan(640, 1536, 10000, torch.float32)
    assert (plan.route, plan.block_m, plan.block_n, plan.block_k, plan.stages) == (
        "wgmma_tf32", 128, 128, 32, 4)
    assert plan.smem_bytes == 1024 + 4 * (128 + 2 * 128) * 32 * 4 + 2 * 128 * 4 + 2 * 8 * 8 == 198784
    assert plan.smem_bytes <= SMEM_LIMIT < 2 * plan.smem_bytes
    assert plan.tiles == (5, 79) and plan.blocks == N_SM


@pytest.mark.parametrize(
    "G,H,V,block_n,stages",
    [(640, 1536, 10000, 128, 4),  # the fp32 beam step
     (128, 1536, 10000, 128, 4),  # its first step: one row tile, 79 blocks in one wave
     (640, 1536, 5000, 128, 4),  # a rank's columns on the model axis: 2 waves
     (128, 1536, 5000, 64, 6),  # ... at the first step: 79 tiles of 64 in one wave
     (130, 200, 2177, 64, 6),  # ragged G, H and V
     (5, 61, 130, 64, 6)],  # H not a multiple of 4 (h copied into 16-byte rows)
)
def test_vocab_head_plan_fp32_route(G, H, V, block_n, stages):
    """The fp32 plan (route "wgmma_tf32") at the decode's shapes: the tile
    width by bf16's wave cost, the deepest ring of its 128-byte-deep stages
    (h, hi, lo) that fits, at most one block per SM, every tile covered."""
    plan = vocab_head_plan(G, H, V, torch.float32)
    assert (plan.route, plan.block_n, plan.block_k, plan.stages) == ("wgmma_tf32", block_n, 32, stages)
    assert plan == _wgmma_plan(G, V, block_n, N_SM, torch.float32)
    assert plan.block_n == vocab_head_plan(G, H, V, torch.bfloat16).block_n
    assert plan.smem_bytes <= SMEM_LIMIT
    assert plan.stages * (128 + 2 * block_n) * 128 <= 196608
    assert plan.tiles == (-(-G // 128), -(-V // block_n))
    assert plan.blocks == min(plan.tiles[0] * plan.tiles[1], N_SM) <= N_SM


def test_vocab_head_plan_rejects_other_dtypes():
    with pytest.raises(ValueError):
        vocab_head_plan(8, 64, 100, torch.float16)


@pytest.mark.parametrize("V", [10000, 5000, 2177, 130])
@pytest.mark.parametrize("G", [1, 128, 640])
def test_vocab_head_plan_persistent_tiles(G, V):
    """bf16 at the decode's rows (1: greedy at batch 1; 128: the first beam
    step; 640: the others) and vocabularies (the head, a rank's half, and
    two the card tests use), all on the persistent kernel whatever their row
    pitch (a w whose rows TMA cannot read is laid out in rows it can). Its
    blocks, at most one per SM, cover its tiles; the tile width is the
    cheapest: 128 at 10 000 columns (3 waves of 132 blocks at G = 640, one
    of 79 at G <= 128), 128 for a rank's 5 000 at G = 640 (2 waves) and 64
    at one row tile (79 tiles of 64 in one wave); 64 wherever the vocabulary
    fills one wave at either width (130 columns, or 2177 at one row tile)."""
    plan = vocab_head_plan(G, 1536, V, torch.bfloat16)
    assert plan.smem_bytes <= SMEM_LIMIT
    want_bn = 128 if V == 10000 or (G == 640 and V in (5000, 2177)) else 64
    assert (plan.route, plan.block_n, plan.block_m, plan.block_k) == ("wgmma", want_bn, 128, 64)
    assert plan.tiles == (-(-G // 128), -(-V // want_bn))
    assert plan.blocks == min(plan.tiles[0] * plan.tiles[1], N_SM)


@pytest.mark.parametrize("V", [10000, 9999, 5000, 2177, 130, 1])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_aligned_rows_lays_out_rows_tma_reads(V, dtype):
    """`aligned_rows` (the decoder's bf16 head weights, the wrapper's h and
    any other w): a [H, V] view of rows whose pitch is the least multiple
    of 16 bytes at least V long, 16-byte aligned, holding x.to(dtype), the
    padding zero; a row-aligned tensor needs no copy."""
    x = torch.randn(24, V, generator=torch.Generator().manual_seed(V))
    y = aligned_rows(x, dtype)
    step = 16 // dtype.itemsize
    assert y.shape == (24, V) and y.dtype == dtype
    assert y.stride() == (-(-V // step) * step, 1) and y.data_ptr() % 16 == 0
    assert _tma_rows(y) and _tma_rows(x.to(dtype)) == (V % step == 0)
    assert torch.equal(y, x.to(dtype))
    assert not y.as_strided((24, y.stride(0)), (y.stride(0), 1))[:, V:].any()


def test_vocab_head_plain_reads_pitched_rows():
    """On the CPU the wrapper takes the plain version whatever w's row
    pitch: the decoder's pitched bf16 w gives the contiguous w's result."""
    g = torch.Generator().manual_seed(1)
    h, w, b = torch.randn(6, 40, generator=g), torch.randn(40, 2177, generator=g), torch.randn(2177, generator=g)
    wp = aligned_rows(w, torch.bfloat16)
    assert not wp.is_contiguous()
    for got, want in zip(vocab_head_topk(h, wp, b, 5, return_lse=True),
                         vocab_head_topk(h, w.to(torch.bfloat16), b, 5, return_lse=True)):
        assert torch.equal(got, want)


@pytest.mark.parametrize("block_n,stages", [(128, 6), (64, 8)])
def test_vocab_head_plan_persistent_ring(block_n, stages):
    """A 192 KB ring of [128 x 64] h + [64 x block_n] w bf16 stages (at most
    8), then each consumer warpgroup's 128 bias values, the barriers and 1 KB
    to align the ring for the 128-byte swizzle; a forced width (the
    breakdown's `_wgmma_plan`) keeps it, and the kernel has no other."""
    plan = _wgmma_plan(640, 10000, block_n, N_SM)
    assert (plan.block_n, plan.stages) == (block_n, stages)
    assert plan.smem_bytes == 1024 + stages * (128 + block_n) * 64 * 2 + 2 * 128 * 4 + 2 * 8 * 8
    assert plan.smem_bytes <= SMEM_LIMIT
    G, V = (640, 10000) if block_n == 128 else (128, 5000)  # where the plan picks this width
    assert vocab_head_plan(G, 1536, V, torch.bfloat16) == _wgmma_plan(G, V, block_n, N_SM)
    with pytest.raises(ValueError):
        _wgmma_plan(640, 10000, 96, N_SM)


@pytest.mark.parametrize("n_sm", [1, 7, 132, 1000])
def test_vocab_head_plan_follows_the_card(n_sm):
    """Any SM count: at most one persistent block each, never more blocks
    than tiles; an empty shape or no SM raises."""
    plan = vocab_head_plan(640, 1536, 10000, torch.bfloat16, n_sm=n_sm)
    assert plan.route == "wgmma"
    assert plan.blocks == min(plan.tiles[0] * plan.tiles[1], n_sm)
    for shape in [(0, 1536, 10000), (640, 0, 10000), (640, 1536, 0)]:
        with pytest.raises(ValueError):
            vocab_head_plan(*shape, torch.bfloat16, n_sm=n_sm)
    with pytest.raises(ValueError):
        vocab_head_plan(640, 1536, 10000, torch.bfloat16, n_sm=0)


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


@pytest.mark.parametrize("compute_dtype", ["bfloat16", "float32"])
def test_decoder_head_weights_suit_the_kernel(compute_dtype):
    """The decoder fetches its head once per decode in the layout the vocab
    head kernel reads without a copy: at bf16, rows TMA can read for any
    vocabulary (37 words here, not a multiple of 8), at fp32 contiguous;
    the values are the kernel [Hd, V] in compute dtype either way."""
    from dlsg_tpu_torch.config import tiny_test_config
    from dlsg_tpu_torch.models.generator import CapGnnModel

    cfg = tiny_test_config(compute_dtype=compute_dtype)
    model = CapGnnModel(cfg, 37, generator=torch.Generator().manual_seed(0), device="cpu")
    w, b = model.decoder_vocab_head()
    want = model.decoder.step.word_restore.kernel(cfg.cdtype)
    assert torch.equal(w, want) and b.dtype == torch.float32 and b.shape == (37,)
    if compute_dtype == "bfloat16":
        assert _tma_rows(w) and w.stride(0) == 40
    else:
        assert w.is_contiguous()
