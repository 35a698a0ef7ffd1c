"""The yardstick's arithmetic (portbench/work.py) against what
`FlopCounterMode` counts over the plain reference at tiny widths, and the
kernel bounds' independence of the route that runs them."""

from __future__ import annotations

import dataclasses
import inspect

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import inputs, work
from portbench.reference import model as ref

V, B = 60, 3


@pytest.fixture(scope="module")
def tiny():
    from dlsg_tpu_torch.config import tiny_test_config

    c = dataclasses.asdict(tiny_test_config(num_proposals=5, num_obj=8))
    gs, ds = ref.param_shapes(c, V)
    gp = inputs.make_params(gs, 1, "generator", "cpu")
    dp = inputs.make_params(ds, 1, "discriminator", "cpu")
    fr, rg = inputs.clip_pool(B, (c["max_frames"], c["a_feature_size"] + c["m_feature_size"]),
                              (c["max_frames"], c["num_obj"], c["region_feature_size"]), 1, "cpu")
    caps, lens = inputs.caption_batch(B, c["max_words"], V, 4, 1, 0)
    return c, gp, dp, fr, rg, torch.from_numpy(caps), torch.from_numpy(lens)


def counted(fn) -> int:
    with FlopCounterMode(display=False) as m:
        fn()
    return m.get_total_flops()


def test_forward_pieces_match_the_flop_counter(tiny):
    c, gp, dp, fr, rg, caps, _ = tiny
    obj, mot = ref.encode(gp, c, fr, rg)
    st = ref.DecoderState(gp, c, obj, mot)
    h = ref._init_hidden(c, B, "cpu")
    assert counted(lambda: ref.encode(gp, c, fr, rg)) == work._flops(work.encode_products(c, B))
    assert counted(lambda: ref.DecoderState(gp, c, obj, mot)) == work._flops(
        work.precompute_products(c, B))
    assert counted(lambda: st.step(torch.ones(B, dtype=torch.long), h, ref.Draws(None))) == \
        work._flops(work.step_products(c, B, V))
    assert counted(lambda: ref.teacher_forced(gp, c, *ref.encode(gp, c, fr, rg), caps, 1.0,
                                              ref.Draws(None))) == \
        work._flops(work.generator_products(c, B, V))
    seq = (caps > 0).float()
    att = seq[:, :, None] * seq[:, None, :]
    _, alpha = ref.teacher_forced(gp, c, obj, mot, caps, 1.0, ref.Draws(None))
    real = torch.nn.functional.one_hot(caps, V).float()
    assert counted(lambda: ref.discriminator(dp, c, real, obj, mot, att, alpha, ref.Draws(None))) \
        == work._flops(work.discriminator_products(c, B, V))


def test_gan_step_flops_near_the_counter(tiny):
    """The GAN step by its convention (module doc of work.gan_step_flops)
    within 2% of what autograd runs in the reference."""
    c, gp, dp, fr, rg, caps, lens = tiny
    gp = {k: v.clone() for k, v in gp.items()}
    dp = {k: v.clone() for k, v in dp.items()}
    batch = {"frames": fr, "regions": rg, "captions": caps, "lengths": lens}
    n = counted(lambda: ref.gan_step(gp, dp, ref.Adam(gp, 1e-4, 10), ref.Adam(dp, 1e-4),
                                     ref.GanLambda(0.01), c, batch, 5, 0, 0.9))
    assert abs(work.gan_step_flops(c, B, V) / n - 1) < 0.02


def test_decode_flops_follow_the_captions_not_the_steps(tiny):
    c = tiny[0]
    one = work.decode_flops(c, V, [3], 5)
    assert work.decode_flops(c, V, [3, 3], 5) == pytest.approx(2 * one)
    assert work.decode_flops(c, V, [4], 5) - one == pytest.approx(
        5 * work._flops(work.step_products(c, 1, V)))
    # a caption without <end> runs max_words tokens, never more
    assert work.decode_flops(c, V, [c["max_words"]], 5) == work.decode_flops(
        c, V, [c["max_words"] - 1], 5)


@pytest.mark.parametrize("G,H,V_", [(640, 1536, 10000), (128, 1536, 10000), (40, 1024, 5000)])
def test_kernel_bounds_do_not_depend_on_the_route(G, H, V_):
    """K1's and K2's work is a function of shapes and the stored dtype
    alone, and the function's bound lies at or under each design's own
    (fp32 K1: three TF32 passes at 495 TFLOP/s; bf16: one pass at 989), so
    no route reads over 100%."""
    for fn in (work.k1, work.k2):
        assert "route" not in inspect.signature(fn).parameters
    fp32 = work.k1(G, H, V_, 5, 4)
    split = work.tf32_split(H, V_)
    assert split.flops == 0
    assert fp32.bound_s() <= max(3 * 2 * G * H * V_ / 495e12,
                                 (fp32.bytes + split.bytes) / work.PEAK_BYTES)
    assert work.k1(G, H, V_, 5, 2).bound_s() <= fp32.bound_s()  # a bf16 head reads less
    k2 = work.k2(128, 26, 1024)
    assert k2.flops == 2 * 128 * 1024 * 4096 * 25  # h_0 is zero: T - 1 steps
    assert work.qmatmul(G, H, V_).peak_flops == work.PEAK_INT8_OPS


def test_work_adds_only_at_one_peak():
    assert (work.k1(8, 16, 32) + work.k2(8, 4, 16)).flops == work.k1(8, 16, 32).flops + \
        work.k2(8, 4, 16).flops
    with pytest.raises(ValueError):
        work.k1(8, 16, 32) + work.qmatmul(8, 16, 32)
