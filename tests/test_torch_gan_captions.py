"""Captions after one GAN step at MSR-VTT widths, in both packages.

On the card, RunGAN's evals after its first GAN step (MSR-VTT widths, 10 000
words, seeded random weights) decoded empty captions: every beam ended at
step 2. This test asks whether the JAX package does the same. Both packages
start from the same weights (the port's seeded init, carried to JAX), take
one GAN step at the config's learning rate on the same 2 synthetic
captions with dropout off, epsilon 1 and JAX's penalty mixing weights, then
beam-5 decode 4 clips. fp32. The tokens must agree (>= 99%: random weights
leave near-tied beams), and a clip's caption is empty in one package
exactly when it is in the other.

Slow (a JAX GAN step and beam decode compiled at full width on the CPU):
    JAX_PLATFORMS=cpu python -m pytest -s -m slow tests/test_torch_gan_captions.py
"""

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlsg_tpu.config import DLSGConfig as JaxConfig
from dlsg_tpu.config import apply_dataset_overrides as jax_overrides
from dlsg_tpu.evaluation.evaluate import make_decode_fn as jax_make_decode_fn
from dlsg_tpu.models.discriminator import DiscV2 as JaxDiscV2
from dlsg_tpu.models.generator import CapGnnModel as JaxCapGnnModel
from dlsg_tpu.train import gan_lambda as jgl
from dlsg_tpu.train import optim as joptim
from dlsg_tpu.train import steps as jsteps
from dlsg_tpu_torch.config import DLSGConfig, apply_dataset_overrides
from dlsg_tpu_torch.data.synthetic import SyntheticDataset, make_vocab
from dlsg_tpu_torch.evaluation import make_decode_fn
from dlsg_tpu_torch.models import CapGnnModel, DiscV2
from dlsg_tpu_torch.ops import linear
from dlsg_tpu_torch.train.gan_lambda import init_lambda_state
from dlsg_tpu_torch.train.optim import TrainState, make_optimizer
from dlsg_tpu_torch.train.steps import make_gan_train_step
from dlsg_tpu_torch.vocab import END_ID
from dlsg_tpu_torch.weights import params_from_jax, params_to_jax
from test_torch_train_steps import KEY, _identity
from test_torch_train_steps import one_torch_thread  # noqa: F401  (autouse)

pytestmark = pytest.mark.slow

V = 10000
B = 2
CLIPS = 4


def _eps_gp(num_d, n):
    rng_d = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(KEY), 0), 3)[1]
    return np.stack([
        np.asarray(jax.random.uniform(jax.random.split(sub)[0], (n, 1, 1))).reshape(n)
        for sub in jax.random.split(rng_d, num_d)
    ])


def _empty(ids):
    """[N] bool: the caption ends before its first word."""
    return np.asarray(ids)[:, 0] == END_ID


def test_one_gan_step_at_msr_vtt_widths_decodes_as_in_jax():
    cfg = apply_dataset_overrides(DLSGConfig(dataset="msr-vtt", dropout=0.0))
    jcfg = jax_overrides(JaxConfig(dataset="msr-vtt", dropout=0.0))
    vocab = make_vocab(extra_words=V - len(make_vocab()))
    ds = SyntheticDataset(cfg, vocab, num_videos=CLIPS, captions_per_video=1)
    samples = [ds[i] for i in range(B)]
    batch = {
        "frames": np.stack([s["frames"] for s in samples]),
        "regions": np.stack([s["regions"] for s in samples])[:, :, : cfg.num_obj],
        "captions": np.stack([s["captions"] for s in samples])[:, : cfg.max_words],
        "lengths": np.stack([s["lengths"] for s in samples]),
    }
    frames, regions = ds.frames, ds.regions[:, :, : cfg.num_obj]

    g, d = CapGnnModel(cfg, V, device="cpu"), DiscV2(cfg, V, device="cpu")
    # copies: the arrays of params_to_jax share the CPU tensors' memory,
    # which the port's step updates in place
    gp, dp = (params_to_jax({k: v.clone() for k, v in m.state_dict().items()}) for m in (g, d))
    gs = TrainState.create(g, make_optimizer(cfg.learning_rate))
    dstate = TrainState.create(d, make_optimizer(cfg.learning_rate))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(linear, "dropout", lambda x, rate, rng: x)
        gs, dstate, _, tm = make_gan_train_step(g, d, cfg)(
            gs, dstate, init_lambda_state(cfg.lambda_D_visual, device="cpu"), batch, KEY, 1.0,
            eps_gp=torch.from_numpy(_eps_gp(cfg.num_D_visual, B)),
        )
    port_ids = make_decode_fn(g, cfg, beam_size=5, device="cpu")(frames, regions).numpy()

    jgen = JaxCapGnnModel(jcfg, V)
    jg = joptim.TrainState.create(gp, joptim.make_optimizer(jcfg.learning_rate))
    jd = joptim.TrainState.create(dp, joptim.make_optimizer(jcfg.learning_rate))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax.linen.Dropout, "__call__", _identity)
        jg, jd, _, jm = jsteps.make_gan_train_step(jgen, JaxDiscV2(jcfg, V), jcfg)(
            jg, jd, jgl.init_lambda_state(jcfg.lambda_D_visual),
            {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(KEY), jnp.float32(1.0),
        )
    jax_ids = np.asarray(jax_make_decode_fn(jgen, jcfg, beam_size=5)({"params": jg.params}, frames, regions))

    np.testing.assert_allclose(float(tm["cap_loss"]), float(jm["cap_loss"]), rtol=1e-5)
    jax_params = params_from_jax(jg.params)
    worst = max(float((t - jax_params[k]).abs().max()) for k, t in g.state_dict().items())
    print(f"\nafter one GAN step: max |param diff| {worst:.3g}")
    for name, ids in (("jax", jax_ids), ("port", port_ids)):
        print(f"{name}: empty {int(_empty(ids).sum())}/{CLIPS}",
              [vocab.decode_tokens(row) for row in ids])
    assert float((port_ids == jax_ids).mean()) >= 0.99
    np.testing.assert_array_equal(_empty(port_ids), _empty(jax_ids))
