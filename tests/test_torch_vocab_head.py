"""dlsg_tpu_torch fused vocab head (kernels/vocab_head.py) against dlsg_tpu's
Pallas kernel in interpret mode, on identical numpy inputs, over the cases of
tests/test_vocab_head.py.

ids must be equal. vals: both sides compute fp32 sums of the same
(w.dtype-rounded) products, so they differ by summation order only: atol
1e-5, bf16 weights included (tests/test_vocab_head.py allows 0.15 there
because it compares bf16 against fp32 weights)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlsg_tpu.ops.pallas.vocab_head import vocab_head_topk as jax_vocab_head_topk
from dlsg_tpu_torch.kernels.vocab_head import (
    LIBRARY,
    vocab_head_topk,
    vocab_head_topk_plain,
)

ATOL = 1e-5


def _mats(G, H, V, seed=0):
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(G, H)).astype(np.float32)
    w = (rng.normal(size=(H, V)) / np.sqrt(H)).astype(np.float32)
    b = rng.normal(size=(V,)).astype(np.float32)
    return h, w, b


def _both(h, w, b, k, normalize, block_v=512, bf16=False):
    jw = jnp.asarray(w, jnp.bfloat16) if bf16 else jnp.asarray(w)
    jv, ji = jax_vocab_head_topk(
        jnp.asarray(h), jw, jnp.asarray(b), k, normalize=normalize, block_v=block_v,
        interpret=True,
    )
    tw = torch.from_numpy(w)
    if bf16:
        tw = tw.to(torch.bfloat16)
    tv, ti = vocab_head_topk_plain(torch.from_numpy(h), tw, torch.from_numpy(b), k,
                                   normalize=normalize)
    return (tv.numpy(), ti.numpy()), (np.asarray(jv), np.asarray(ji))


@pytest.mark.parametrize(
    "G,H,V,k,normalize",
    [
        (8, 128, 1000, 5, True),
        (16, 256, 2048, 5, True),
        (8, 128, 512, 1, True),
        (8, 128, 768, 5, False),
        (8, 128, 700, 5, True),  # V not a multiple of the tile width
    ],
)
def test_plain_matches_pallas(G, H, V, k, normalize):
    (tv, ti), (jv, ji) = _both(*_mats(G, H, V, seed=V + k), k, normalize)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(tv, jv, atol=ATOL)
    assert ti.max() < V


def test_ties_go_to_lowest_id():
    h = np.zeros((4, 8), np.float32)
    w = np.zeros((8, 256), np.float32)  # every logit equals its bias
    b = np.zeros((256,), np.float32)
    b[[17, 200]] = 1.0
    (tv, ti), (jv, ji) = _both(h, w, b, 3, False, block_v=128)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(ti[0], [17, 200, 0])
    np.testing.assert_allclose(tv, jv)


def test_bf16_weights():
    (tv, ti), (jv, ji) = _both(*_mats(8, 256, 1024, seed=7), 5, True, bf16=True)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(tv, jv, atol=ATOL)


def test_wrapper_takes_plain_version_on_cpu():
    h, w, b = (torch.from_numpy(a) for a in _mats(6, 64, 300, seed=1))
    before = LIBRARY.launches
    got = vocab_head_topk(h, w, b, 4)
    want = vocab_head_topk_plain(h, w, b, 4)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert LIBRARY.launches == before

