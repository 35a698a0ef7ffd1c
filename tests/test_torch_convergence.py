"""Convergence evidence beyond memorization in the port, as
tests/test_convergence.py holds the JAX package to, with its data, step
counts and thresholds, from the JAX package's initial weights (carried
across by weights.py); the port draws its own dropout masks:

(a) held-out generalization on StructuredSyntheticDataset, and the int8
    decode (decode_quant="int8", a model built with that config and the
    trained weights) of the unseen draws on par with the unquantized one:
    Bleu_1 within 0.1, CIDEr within 0.5;
(b) the WGAN-GP dynamics (the Wasserstein estimate climbs, the gradient
    penalty stays in (0.01, 5)) and GAN captions no worse than CE-only.

Slow (outside Tier-1):
    JAX_PLATFORMS=cpu python -m pytest -s -m slow tests/test_torch_convergence.py
"""

import pytest

from dlsg_tpu.config import tiny_test_config as jax_tiny
from dlsg_tpu.data.synthetic import StructuredSyntheticDataset as JaxStructured
from dlsg_tpu.data.synthetic import make_vocab as jax_make_vocab
from dlsg_tpu_torch.train import learning
from test_torch_learning import JAX_DIMS, jax_init
from test_torch_train_steps import one_torch_thread  # noqa: F401  (autouse)

pytestmark = pytest.mark.slow


def _init(seed):
    jcfg = jax_tiny(**JAX_DIMS)
    return jax_init(jcfg, JaxStructured(jcfg, jax_make_vocab(), num_classes=4, train_per_class=4,
                                        heldout_per_class=2, noise=0.3, seed=seed))


def test_heldout_generalization_ce():
    g, _ = _init(learning.HELDOUT_SEED)
    r = learning.heldout_ce(learning.learning_config(), "cpu", g)
    print(f"\nheld-out Bleu_1 {r['before']['Bleu_1']:.3f} -> {r['held_after']['Bleu_1']:.3f} "
          f"(int8 {r['held_int8']['Bleu_1']:.3f}), CIDEr {r['before']['CIDEr']:.3f} -> "
          f"{r['held_after']['CIDEr']:.3f} (int8 {r['held_int8']['CIDEr']:.3f}); "
          f"training videos' Bleu_1 {r['train_after']['Bleu_1']:.3f}")
    learning.check_heldout_ce(r)


def test_gan_dynamics_and_ce_ablation():
    g, d = _init(learning.DYNAMICS_SEED)
    r = learning.gan_dynamics(learning.learning_config(), "cpu", g, d)
    print(f"\nwasserstein {r['ws_head']:.3f} -> {r['ws_tail']:.3f}, gp tail {r['gp_tail']:.3f}; "
          f"CIDEr GAN {r['gan_scores']['CIDEr']:.3f} CE {r['ce_scores']['CIDEr']:.3f}, "
          f"Bleu_1 GAN {r['gan_scores']['Bleu_1']:.3f}")
    learning.check_gan_dynamics(r)
