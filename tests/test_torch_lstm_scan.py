"""dlsg_tpu_torch LSTM scan (kernels/lstm_scan.py) and LSTM modules
(ops/lstm.py) against dlsg_tpu's Pallas kernel (interpret mode) and flax
modules, on identical numpy inputs.

Tolerances: fp32 on both sides, so differences are summation order only:
atol 1e-5 on hidden states bounded by 1."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dlsg_tpu.ops.pallas.lstm_scan as jax_lstm_scan_mod
from dlsg_tpu.ops.lstm import BiLSTM as JaxBiLSTM
from dlsg_tpu.ops.lstm import LSTMCell as JaxLSTMCell
from dlsg_tpu.ops.lstm import SplitInputLSTMCell as JaxSplitInputLSTMCell
from dlsg_tpu.ops.lstm import LSTMSequence as JaxLSTMSequence
from dlsg_tpu.ops.pallas.lstm_scan import lstm_scan_pallas
from dlsg_tpu_torch.kernels.lstm_scan import LIBRARY, lstm_scan, lstm_scan_plain
from dlsg_tpu_torch.ops.lstm import BiLSTM, LSTMCell, LSTMSequence, SplitInputLSTMCell
from dlsg_tpu_torch.weights import params_from_jax

ATOL = 1e-5


@pytest.fixture
def pallas_interpret(monkeypatch):
    """The JAX modules call lstm_scan_pallas without `interpret`, which runs
    only on a TPU; on the CPU run it as the JAX tests do, in interpret mode."""
    monkeypatch.setattr(
        jax_lstm_scan_mod, "lstm_scan_pallas",
        functools.partial(lstm_scan_pallas, interpret=True),
    )


def _xw(B, T, H, seed):
    rng = np.random.default_rng(seed)
    xw = rng.normal(size=(B, T, 4 * H)).astype(np.float32)
    w = (rng.normal(size=(H, 4 * H)) * 0.3).astype(np.float32)
    return xw, w


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("B,block", [(4, 4), (5, 4)])  # (5, 4): ragged batch
def test_plain_matches_pallas_interpret(reverse, B, block):
    xw, w = _xw(B, 6, 16, seed=B + 10 * reverse)
    want = lstm_scan_pallas(
        jnp.asarray(xw), jnp.asarray(w), reverse=reverse, block_batch=block, interpret=True
    )
    got = lstm_scan_plain(torch.from_numpy(xw), torch.from_numpy(w), reverse=reverse)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_wrapper_takes_plain_version_on_cpu():
    xw, w = _xw(3, 5, 8, seed=1)
    before = LIBRARY.launches
    got = lstm_scan(torch.from_numpy(xw), torch.from_numpy(w), reverse=True)
    want = lstm_scan_plain(torch.from_numpy(xw), torch.from_numpy(w), reverse=True)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert LIBRARY.launches == before  # no kernel launch for a CPU tensor


def _run_both(jax_mod, torch_mod, x):
    params = jax_mod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    want = jax_mod.apply({"params": params}, jnp.asarray(x))
    torch_mod.load_state_dict(params_from_jax(params))
    got = torch_mod(torch.from_numpy(x))
    return got.detach().numpy(), np.asarray(want)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("reverse", [False, True])
def test_lstm_sequence_matches_jax(use_pallas, reverse, pallas_interpret):
    x = np.random.default_rng(2).normal(size=(3, 7, 10)).astype(np.float32)
    got, want = _run_both(
        JaxLSTMSequence(12, reverse=reverse, use_pallas=use_pallas),
        LSTMSequence(10, 12, reverse=reverse, use_pallas=use_pallas),
        x,
    )
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_bilstm_matches_jax(use_pallas, pallas_interpret):
    x = np.random.default_rng(3).normal(size=(5, 6, 9)).astype(np.float32)
    got, want = _run_both(
        JaxBiLSTM(8, use_pallas=use_pallas), BiLSTM(9, 8, use_pallas=use_pallas), x
    )
    assert got.shape == (5, 6, 16)
    np.testing.assert_allclose(got, want, atol=ATOL)



def test_cells_match_jax():
    """One step of LSTMCell and SplitInputLSTMCell, and their fused [W_ih;
    W_hh] stacks, against the flax cells."""
    rng = np.random.default_rng(4)
    x, xs = (rng.normal(size=(3, n)).astype(np.float32) for n in (6, 5))
    h, c = (rng.normal(size=(3, 7)).astype(np.float32) for _ in range(2))
    jcell = JaxLSTMCell(7)
    p = jcell.init(jax.random.PRNGKey(0), x, h, c)["params"]
    cell = LSTMCell(6, 7)
    cell.load_state_dict(params_from_jax(p))
    for got, want in zip(
        cell(*map(torch.from_numpy, (x, h, c))), jcell.apply({"params": p}, x, h, c)
    ):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL)
    jw, jb = jcell.apply({"params": p}, 6, method=jcell.fused_weights)
    tw, tb = cell.fused_weights()
    np.testing.assert_array_equal(tw.detach().numpy(), np.asarray(jw))
    np.testing.assert_array_equal(tb.detach().numpy(), np.asarray(jb))

    jsplit = JaxSplitInputLSTMCell(7)

    def jstep(mod, x_dyn, x_static, h, c):
        return mod(x_dyn, mod.project_static(x_static), h, c)

    p = jsplit.init(jax.random.PRNGKey(1), x, xs, h, c, method=jstep)["params"]
    split = SplitInputLSTMCell(6, 5, 7)
    split.load_state_dict(params_from_jax(p))
    want = jsplit.apply({"params": p}, x, xs, h, c, method=jstep)
    xw_static = split.project_static(torch.from_numpy(xs))
    got = split(torch.from_numpy(x), xw_static, torch.from_numpy(h), torch.from_numpy(c))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), atol=ATOL)
