"""The GAN system fits synthetic data in the port, as tests/test_learning.py
holds the JAX package to: 60 CE + WGAN-GP steps on 8 videos with fixed
captions, the same data, step count and thresholds, from the JAX package's
initial weights (carried across by weights.py), so that a failure points at
the port and not at the draw. The port draws its own dropout masks.

Slow (outside Tier-1):
    JAX_PLATFORMS=cpu python -m pytest -s -m slow tests/test_torch_learning.py
"""

import jax
import jax.numpy as jnp
import pytest

from dlsg_tpu.data.loader import train_batches as jax_train_batches
from dlsg_tpu.data.synthetic import SyntheticDataset as JaxSyntheticDataset
from dlsg_tpu.data.synthetic import make_vocab as jax_make_vocab
from dlsg_tpu.models.discriminator import DiscV2 as JaxDiscV2
from dlsg_tpu.models.generator import CapGnnModel as JaxCapGnnModel
from dlsg_tpu.train.steps import make_masks as jax_make_masks
from dlsg_tpu.config import tiny_test_config as jax_tiny
from dlsg_tpu_torch.train import learning
from dlsg_tpu_torch.weights import params_from_jax
from test_torch_train_steps import one_torch_thread  # noqa: F401  (autouse)

pytestmark = pytest.mark.slow

JAX_DIMS = dict(train_batch_size=8, test_batch_size=8, beam_size=2, visual_hidden_size=64,
                region_projected_size=64, query_hidden_size=64, decode_hidden_size=64, word_size=32)


def jax_init(jcfg, ds):
    """The JAX tests' generator and discriminator init (PRNGKeys 0 and 1 on
    the first training batch), as the port's state dicts."""
    V = len(jax_make_vocab())
    b0 = next(jax_train_batches(ds, jcfg.train_batch_size, seed=0, epoch=0))
    frames, regions, captions = (jnp.asarray(b0[k]) for k in ("frames", "regions", "captions"))
    g = JaxCapGnnModel(jcfg, V).init(jax.random.PRNGKey(0), frames, regions, captions)["params"]
    _, att = jax_make_masks(captions)
    B, T, P, H = jcfg.train_batch_size, jcfg.max_words, jcfg.num_proposals, jcfg.visual_hidden_size
    obj = jnp.zeros((B, P, H))
    d = JaxDiscV2(jcfg, V).init(jax.random.PRNGKey(1), jax.nn.one_hot(captions, V), obj, obj, att,
                                jnp.ones((B, T, 2 * P)))["params"]
    return params_from_jax(g), params_from_jax(d)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_gan_training_fits_synthetic_data(compute_dtype):
    jcfg = jax_tiny(compute_dtype=compute_dtype, **JAX_DIMS)
    g, d = jax_init(jcfg, JaxSyntheticDataset(jcfg, jax_make_vocab(), num_videos=8,
                                              captions_per_video=1, seed=learning.FIT_SEED))
    r = learning.gan_fit(learning.learning_config(compute_dtype=compute_dtype), "cpu", g, d)
    print(f"\n{compute_dtype}: cap loss {r['first_loss']:.3f} -> {r['last_loss']:.3f}; "
          f"Bleu_1 {r['before']['Bleu_1']:.3f} -> {r['after']['Bleu_1']:.3f}, "
          f"CIDEr {r['before']['CIDEr']:.3f} -> {r['after']['CIDEr']:.3f}")
    learning.check_gan_fit(r)
