"""dlsg_tpu_torch beam search (ops/beam_search.py) against dlsg_tpu's, fed the
same recorded step outputs.

The step function reads a recorded table indexed by (step, last token); its
values are multiples of 1/8, so sums of log-probs are exact in fp32 and the
tables hold exact ties (whole rows of equal values, duplicated rows). Both
searches must pick identical predictions; log-probs agree within 1e-6 (the
normalized paths subtract a logsumexp that the two frameworks round
differently by a few ulps)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlsg_tpu.ops.beam_search import beam_search as jax_beam_search
from dlsg_tpu_torch.ops.beam_search import beam_search
from dlsg_tpu_torch.ops.topk import top_k

V, END, START = 9, 2, 1
B, BEAM, STEPS = 3, 3, 7


def _tables(seed, end_from=4):
    rng = np.random.default_rng(seed)
    L = rng.integers(-32, 1, size=(STEPS, V, V)).astype(np.float32) / 8.0
    L[:, :, 0] = -8.0  # <pad> never wins
    L[0, START] = 0.0  # adversarial: a whole row of ties at the first step
    L[1, 5] = L[1, 6]  # duplicated rows: equal sums across parent beams
    L[end_from:, :, END] = 0.5  # <end> wins late, so every beam ends early
    A = rng.integers(0, 8, size=(STEPS, V, 4)).astype(np.float32) / 8.0
    return L, A


def _sparse_tables(L, pnbs):
    """Recorded sparse-step outputs: normalized top-pnbs values and ids of
    every table row, ties to the lowest id."""
    lse = np.log(np.exp(L.astype(np.float64)).sum(-1, keepdims=True))
    order = np.argsort(-L, axis=-1, kind="stable")[..., :pnbs]
    vals = (np.take_along_axis(L, order, -1) - lse).astype(np.float32)
    return vals, order.astype(np.int32)


def _run(mod, xp, mode, L, A, early_exit, pnbs):
    """Run one beam_search (mod is jnp or torch) over the recorded tables."""
    if xp == "jax":
        arr, ints = jnp.asarray, (lambda a: jnp.asarray(a, jnp.int32))
        start = jnp.full((B,), START, jnp.int32)
        state = {"t": jnp.zeros((B,), jnp.int32), "h": jnp.zeros((B, 2))}
    else:
        arr, ints = torch.tensor, (lambda a: torch.tensor(a, dtype=torch.int64))
        start = torch.full((B,), START, dtype=torch.int64)
        state = {"t": torch.zeros(B, dtype=torch.int64), "h": torch.zeros(B, 2)}
    Lx, Ax = arr(L), arr(A)
    SV, SI = _sparse_tables(L, pnbs)
    SVx, SIx = arr(SV), ints(SI)

    def step(tokens, st):
        t = st["t"]
        new = {"t": t + 1, "h": st["h"] + 1.0}
        if mode == "sparse":
            return SVx[t, tokens], SIx[t, tokens], new, Ax[t, tokens]
        return Lx[t, tokens], new, Ax[t, tokens]

    out = mod(
        start, state, step, end_id=END, max_steps=STEPS, beam_size=BEAM,
        per_node_beam_size=pnbs if mode != "sparse" else None,
        normalize=mode.startswith("normalize"), sparse_step=mode == "sparse",
        fast_lse=mode == "normalize_fast", return_finished=True, early_exit=early_exit,
    )
    return [np.asarray(o) for o in out]


@pytest.mark.parametrize("mode", ["dense", "normalize", "normalize_fast", "sparse"])
@pytest.mark.parametrize("early_exit", [True, False])
@pytest.mark.parametrize("seed,end_from,pnbs", [(0, 4, 3), (1, 2, 4), (2, 9, 3)])
def test_matches_jax(mode, early_exit, seed, end_from, pnbs):
    L, A = _tables(seed, end_from)
    jp, jl, ja, jf = _run(jax_beam_search, "jax", mode, L, A, early_exit, pnbs)
    tp, tl, ta, tf = _run(beam_search, "torch", mode, L, A, early_exit, pnbs)
    assert tp.shape == (B, BEAM, STEPS) and ta.shape == (B, BEAM, STEPS, 4)
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_allclose(tl, jl, atol=1e-6)
    np.testing.assert_array_equal(ta, ja)
    np.testing.assert_array_equal(tf, jf)
    if end_from < STEPS:
        assert tf.all()


def test_top_k_tie_order_matches_lax():
    import jax

    x = np.array([[1.0, 3.0, 3.0, 2.0, 3.0, -np.inf], [0.0] * 6], np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(x), 4)
    tv, ti = top_k(torch.from_numpy(x), 4)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
