"""The plain reference against the port at tiny widths on the CPU, on the
same weights: parameter layout, encoder, beam decode, teacher-forced
scan, discriminator and three WGAN-GP steps with the same random draws.

Run: JAX_PLATFORMS=cpu python -m pytest portbench/tests -q -p no:cacheprovider
"""

from __future__ import annotations

import dataclasses

import pytest
import torch

from portbench import inputs
from portbench.reference import model as ref

V = 60


def tiny_cfg(**kw):
    from dlsg_tpu_torch.config import tiny_test_config

    base = dict(num_proposals=5, num_obj=8, num_topk=3, beam_size=5)
    base.update(kw)
    return tiny_test_config(**base)


@pytest.fixture(scope="module")
def world():
    cfg = tiny_cfg(use_pallas_lstm=True, use_fused_vocab_head="on")
    c = dataclasses.asdict(cfg)
    gs, ds = ref.param_shapes(c, V)
    gp = inputs.make_params(gs, 7, "generator", "cpu")
    dp = inputs.make_params(ds, 7, "discriminator", "cpu")
    fr, rg = inputs.clip_pool(6, (cfg.max_frames, cfg.feature_size),
                              (cfg.max_frames, 10, cfg.region_feature_size), 7, "cpu")
    return cfg, c, gs, ds, gp, dp, fr, rg


def _models(cfg, gp, dp):
    from dlsg_tpu_torch.models.discriminator import DiscV2
    from dlsg_tpu_torch.models.generator import CapGnnModel

    gen = CapGnnModel(cfg, V, device="cpu")
    gen.load_state_dict(gp)
    disc = DiscV2(cfg, V, device="cpu")
    disc.load_state_dict(dp)
    return gen, disc


def test_param_shapes_are_the_ports(world):
    cfg, c, gs, ds, gp, dp, fr, rg = world
    gen, disc = _models(cfg, gp, dp)
    assert {k: tuple(v.shape) for k, v in gen.state_dict().items()} == gs
    assert {k: tuple(v.shape) for k, v in disc.state_dict().items()} == ds


def test_encoder(world):
    cfg, c, gs, ds, gp, dp, fr, rg = world
    gen, _ = _models(cfg, gp, dp)
    with torch.no_grad():
        o1, m1 = gen.encode(fr, rg[:, :, : cfg.num_obj])
    o2, m2 = ref.encode(gp, c, fr, rg)
    torch.testing.assert_close(o2, o1, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(m2, m1, rtol=1e-5, atol=1e-5)


LENGTHS = {"head_scale": 6.0, "counter_units": 4, "counter_rate": 0.05, "end_weight": 5.0}


@pytest.mark.parametrize("lengths", [None, {**LENGTHS, "end_bias": -10.0},
                                     {**LENGTHS, "end_bias": -14.0}])
def test_beam_decode(world, lengths):
    from dlsg_tpu_torch.evaluation.decode import make_decode_fn

    cfg, c, gs, ds, _, dp, fr, rg = world
    gp = inputs.make_params(gs, 7, "generator", "cpu", lengths)
    gen, _ = _models(cfg, gp, dp)
    ids = make_decode_fn(gen, cfg, beam_size=5, device="cpu")(fr, rg[:, :, : cfg.num_obj])
    assert torch.equal(ref.beam_decode(gp, c, fr, rg, 5), ids)


def test_teacher_forced_scan_and_discriminator(world):
    cfg, c, gs, ds, gp, dp, fr, rg = world
    cfg = dataclasses.replace(cfg, use_pallas_lstm=False)
    c = dataclasses.asdict(cfg)
    gen, disc = _models(cfg, gp, dp)
    caps, _ = inputs.caption_batch(6, cfg.max_words, V, 4, 7, 0)
    caps = torch.from_numpy(caps)
    with torch.no_grad():
        logits, obj, mot, alpha = gen(fr, rg[:, :, : cfg.num_obj], caps)
        o2, m2 = ref.encode(gp, c, fr, rg)
        l2, a2 = ref.teacher_forced(gp, c, o2, m2, caps, 1.0, ref.Draws(None))
        torch.testing.assert_close(l2, logits, rtol=1e-5, atol=1e-5)
        seq = (caps > 0).float()
        att = seq[:, :, None] * seq[:, None, :]
        real = torch.nn.functional.one_hot(caps, V).float()
        s1 = disc(real, obj, mot, att, alpha)
        s2 = ref.discriminator(dp, c, real, obj, mot, att, alpha, ref.Draws(None))
    torch.testing.assert_close(s2, s1, rtol=1e-5, atol=1e-6)


def test_three_gan_steps_follow_the_port(world):
    from dlsg_tpu_torch.train.gan_lambda import init_lambda_state
    from dlsg_tpu_torch.train.optim import TrainState, make_optimizer
    from dlsg_tpu_torch.train.steps import make_gan_train_step

    cfg, c, gs, ds, gp, dp, fr, rg = world
    cfg = dataclasses.replace(cfg, use_pallas_lstm=False)
    c = dataclasses.asdict(cfg)
    gen, disc = _models(cfg, gp, dp)
    g_state = TrainState.create(gen, make_optimizer(cfg.learning_rate, cfg.grad_clip))
    d_state = TrainState.create(disc, make_optimizer(cfg.learning_rate))
    lam_state = init_lambda_state(cfg.lambda_D_visual, device="cpu")
    step = make_gan_train_step(gen, disc, cfg)
    gr = {k: v.clone() for k, v in gp.items()}
    dr = {k: v.clone() for k, v in dp.items()}
    g_opt, d_opt = ref.Adam(gr, cfg.learning_rate, cfg.grad_clip), ref.Adam(dr, cfg.learning_rate)
    lam = ref.GanLambda(cfg.lambda_D_visual)
    for i in range(3):
        caps, lens = inputs.caption_batch(4, cfg.max_words, V, 4, 7, i)
        batch = {"frames": fr[:4], "regions": rg[:4, :, : cfg.num_obj],
                 "captions": torch.from_numpy(caps), "lengths": torch.from_numpy(lens)}
        g_state, d_state, lam_state, m = step(g_state, d_state, lam_state, batch, 99, 0.8)
        r = ref.gan_step(gr, dr, g_opt, d_opt, lam, c, batch, 99, i, 0.8)
        for k in ("cap_loss", "loss_G", "loss_D", "wasserstein", "grad_penalty", "gan_lambda"):
            assert abs(float(m[k]) - r[k]) <= 1e-4 * max(abs(r[k]), 0.1), k
    # G moves by Adam's steps of lr; round-off flips the sign of a few
    # near-zero D gradients, which moves those elements by up to 2 lr
    lr = cfg.learning_rate
    sd = gen.state_dict()
    assert max((sd[k] - gr[k]).abs().max().item() for k in gr) < 0.1 * lr
    sd = disc.state_dict()
    assert max((sd[k] - dr[k]).abs().max().item() for k in dr) <= 6 * lr + 1e-7


def test_precision_context_restores_flags():
    before = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    with ref.precision("tf32"):
        assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
    with ref.precision("fp32"):
        assert not torch.backends.cuda.matmul.allow_tf32
    assert (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) == before
    with pytest.raises(ValueError):
        with ref.precision("bf16"):
            pass


def test_reference_imports_nothing_of_the_program():
    import ast
    from pathlib import Path

    for path in Path(ref.__file__).parent.glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for n in names:
                assert n.split(".")[0] not in ("dlsg_tpu_torch", "dlsg_tpu", "jax", "jaxlib",
                                               "flax", "portbench"), (path, n)
