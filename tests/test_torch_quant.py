"""The int8 decode (`decode_quant="int8"`): dlsg_tpu_torch's ops/quant.py and
the quantized decoder against dlsg_tpu's on the same numpy inputs and
weights, tiny_test_config sizes, on the CPU (the port's `qmatmul` takes its
plain version; JAX's vocab head runs its Pallas kernel in interpret mode
off a TPU).

JAX's decode runs jitted, and under `jit` XLA turns the source's division by
127 into a product with 1/127 in fp32, which the port computes; so the JAX
side is held jitted. Tolerances: `quantize_per_col` bitwise (q and s);
`qmatmul` bitwise (found: the port's plain version equals jitted JAX's on
every element, the int32 product being exact and every other step correctly
rounded on both sides); decoded token ids equal (at bf16 from the same
encoder outputs: test_int8_decode_ids_equal_jax); one beam step's raw logits
within 1e-5 (the unquantized ops around the products, fp32 on both sides).
The accuracy and round-trip bounds are tests/test_quant.py's."""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlsg_tpu.config import tiny_test_config as jax_tiny
from dlsg_tpu.evaluation.evaluate import _make_beam_from_feats as jax_beam_from_feats
from dlsg_tpu.evaluation.evaluate import make_decode_fn as jax_make_decode_fn
from dlsg_tpu.models.generator import CapGnnModel as JaxCapGnnModel
from dlsg_tpu.ops import quant as jax_quant
from dlsg_tpu_torch.config import tiny_test_config
from dlsg_tpu_torch.evaluation.decode import _make_beam_from_feats, make_decode_fn
from dlsg_tpu_torch.models.generator import CapGnnModel
from dlsg_tpu_torch.ops import quant as quant_mod
from dlsg_tpu_torch.ops.quant import (
    QuantWeight,
    padded_k,
    qmatmul,
    qmatmul_plain,
    quantize_per_col,
    quantize_weight,
)
from dlsg_tpu_torch.serve import Captioner
from dlsg_tpu_torch.train.optim import TrainState, make_optimizer
from dlsg_tpu_torch.train.steps import make_ce_train_step
from dlsg_tpu_torch.vocab import END_ID, Vocabulary
from dlsg_tpu_torch.weights import params_from_jax
from test_torch_train_steps import one_torch_thread  # noqa: F401  (autouse)

V = 50
B = 4
INT8 = {"decode_quant": "int8"}


def _normal(*shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _bf16_rounded(a: np.ndarray) -> np.ndarray:
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


@pytest.fixture(scope="module")
def setup():
    cfg = jax_tiny()
    rng = np.random.default_rng(5)
    frames = rng.normal(size=(B, cfg.max_frames, cfg.feature_size)).astype(np.float32)
    regions = rng.normal(size=(B, cfg.max_frames, cfg.num_obj, cfg.region_feature_size)).astype(np.float32)
    caps = jnp.zeros((B, cfg.max_words), jnp.int32)
    params = JaxCapGnnModel(cfg, V).init(jax.random.PRNGKey(1), frames, regions, caps)["params"]
    return params, frames, regions


def _port_model(params, **switches):
    cfg = tiny_test_config(**switches)
    model = CapGnnModel(cfg, V, device="cpu")
    model.load_state_dict(params_from_jax(params))
    return model, cfg


# ---------------------------------------------------------------- ops/quant.py


@pytest.mark.parametrize("source", ["float32", "bfloat16"])
def test_quantize_per_col_is_jax_bitwise(source):
    """From fp32 and from bf16-rounded weights (the compute-dtype LSTM stacks
    under bf16); one all-zero column takes the 1e-12 floor."""
    w = _normal(300, 70, seed=1, scale=0.05)
    w[:, 3] = 0.0
    if source == "bfloat16":
        w = _bf16_rounded(w)
    jq, js = jax.jit(jax_quant.quantize_per_col)(jnp.asarray(w, source))
    tq, ts = quantize_per_col(torch.from_numpy(w).to(getattr(torch, source)))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("G,K,N", [(16, 256, 128), (13, 2860 // 20, 39), (1, 40, 50), (7, 33, 5)])
def test_qmatmul_plain_matches_jax(G, K, N):
    x = _normal(G, K, seed=G + K)
    x[0, :3] = [0.5, -0.5, 2.5]  # rounding ties, half to even in both
    w = _normal(K, N, seed=N, scale=0.05)
    jq, js = jax.jit(jax_quant.quantize_per_col)(jnp.asarray(w))
    want = np.asarray(jax.jit(jax_quant.qmatmul)(jnp.asarray(x), jq, js))
    qw = quantize_weight(torch.from_numpy(w))
    assert qw.qt.shape == (N, padded_k(K)) and not qw.qt[:, K:].any()
    got = qmatmul_plain(torch.from_numpy(x), qw.qt, qw.s)
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(qmatmul(torch.from_numpy(x), *qw), got)  # the wrapper on a CPU tensor


def test_qmatmul_accuracy():
    """tests/test_quant.py::test_qmatmul_accuracy through the port."""
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(16, 256)).astype(np.float32))
    w = torch.from_numpy((np.random.default_rng(0).normal(size=(256, 128)) * 0.05).astype(np.float32))
    ref = (x @ w).numpy()
    out = qmatmul(x, *quantize_weight(w)).numpy()
    rel = np.abs(out - ref) / (np.abs(ref).mean() + 1e-9)
    assert rel.mean() < 0.02, rel.mean()
    assert rel.max() < 0.2, rel.max()


def test_quantize_round_trip_bound():
    """tests/test_quant.py::test_quantize_round_trip_bound through the port:
    symmetric int8 is at most half a scale off per column."""
    w = torch.from_numpy(np.random.default_rng(1).normal(size=(64, 32)).astype(np.float32))
    q, s = quantize_per_col(w)
    deq = q.float() * s[None, :]
    assert float((deq - w).abs().max()) <= float(s.max()) / 2 + 1e-6
    assert q.dtype == torch.int8


def test_qmatmul_refuses_gradients_and_other_devices():
    qw = quantize_weight(torch.ones(8, 4))
    x = torch.ones(2, 8, requires_grad=True)
    with pytest.raises(NotImplementedError):
        qmatmul(x, *qw)
    with torch.no_grad():
        qmatmul(x, *qw)  # inference: fine
    with pytest.raises(ValueError):
        qmatmul(torch.ones(2, 8, device="meta"), qw.qt.to("meta"), qw.s.to("meta"))
    with pytest.raises(ValueError):
        qmatmul(torch.ones(2, 8), qw.qt[:, :8], qw.s)  # qt not padded to K_ALIGN
    with pytest.raises(ValueError):
        qmatmul(torch.ones(2, 8), qw.qt.float(), qw.s)


# ---------------------------------------------------------------- the decoder


def _jax_decode_from_feats(params, jcfg, beam, obj, mot):
    """JAX's int8 decode of the given encoder outputs: the greedy scan or the
    beam core of make_decode_fn, top beam."""
    jm = JaxCapGnnModel(jcfg, V)
    v = {"params": params}
    if beam == 1:
        return jax.jit(lambda o, m: jm.apply(v, o, None, 1.0, m, method=lambda g, *a: g.decoder(*a))[0])(
            obj, mot)
    core = jax_beam_from_feats(jm, jcfg, beam)
    return jax.jit(lambda o, m: core(v, o, m, jcfg.max_words)[0][:, 0])(obj, mot)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("beam,fused", [(1, "off"), (3, "off"), (3, "on")])
def test_int8_decode_ids_equal_jax(setup, beam, fused, compute_dtype):
    """Greedy and beam-3 decodes, the fused head on and off: the same token
    ids as the JAX package's int8 decode of the same weights. At fp32 the
    whole decode from the clips. At bf16 the decoder from the port's encoder
    outputs: the two encoders' fp32 outputs differ in their last bits (8e-7),
    rounding them to bf16 for the decoder's static projection flips whole
    rows of it by a bf16 ulp, and a beam or greedy step near a tie then
    moves a token in either package's unquantized decode as well; the
    decoders themselves, quantization included, are held to equal ids."""
    params, frames, regions = setup
    switches = dict(INT8, compute_dtype=compute_dtype, use_fused_vocab_head=fused)
    jcfg = jax_tiny(**switches)
    model, cfg = _port_model(params, **switches)
    if compute_dtype == "float32":
        jids = jax_make_decode_fn(JaxCapGnnModel(jcfg, V), jcfg, beam_size=beam)(
            {"params": params}, frames, regions)
        tids = make_decode_fn(model, cfg, beam_size=beam, device="cpu")(frames, regions)
    else:
        with torch.inference_mode():
            obj, mot = model.encode(torch.from_numpy(frames), torch.from_numpy(regions))
            if beam == 1:
                tids = model.decoder(obj, None, 1.0, mot)[0]
            else:
                tids = _make_beam_from_feats(model, cfg, beam)(obj, mot, cfg.max_words)[0][:, 0]
        jids = _jax_decode_from_feats(params, jcfg, beam, obj.numpy(), mot.numpy())
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))


def _first_beam_step(model, frames, regions):
    """(raw logits [B, V], pre) of the first beam step from <start> (id 4 as
    tests/test_quant.py's), eval mode."""
    with torch.inference_mode():
        obj, mot = model.encode(torch.from_numpy(frames), torch.from_numpy(regions))
        state, pre = model.decoder_init_beam_state(obj, mot)
        logits, _, _ = model.decoder_beam_step(torch.full((B,), 4), state, pre)
    return logits, pre


def test_int8_beam_step_matches_jax_and_tracks_fp32(setup):
    """One beam step: the quantized weights are QuantWeights, the raw logits
    within 1e-5 of JAX's int8 step, and correlated > 0.999 with the
    unquantized step's (tests/test_quant.py:39-77's criterion)."""
    params, frames, regions = setup
    jcfg = jax_tiny(**INT8)
    jmod = JaxCapGnnModel(jcfg, V)
    v = {"params": params}
    state, pre = jmod.apply(v, *jmod.apply(v, frames, regions, method=jmod.encode),
                            method=jmod.decoder_init_beam_state)
    jlogits, _, _ = jax.jit(lambda t, s, p: jmod.apply(v, t, s, p, method=jmod.decoder_beam_step))(
        jnp.full((B,), 4, jnp.int32), state, pre)
    q8, _ = _port_model(params, **INT8)
    fp, _ = _port_model(params)
    lq, pre_q = _first_beam_step(q8, frames, regions)
    lf, _ = _first_beam_step(fp, frames, regions)
    assert all(isinstance(pre_q[k], QuantWeight) for k in ("Wq", "Wl", "Wv"))
    np.testing.assert_allclose(lq.numpy(), np.asarray(jlogits), rtol=0, atol=1e-5)
    corr = np.corrcoef(lf.numpy().ravel(), lq.numpy().ravel())[0, 1]
    assert corr > 0.999, corr


def test_precompute_quantizes_jax_sources(setup):
    """Under bf16, Wq and Wl are quantized from the bf16 stacks and Wv from
    the fp32 master kernel (JAX's sources); training's scan never quantizes."""
    params, frames, regions = setup
    model, _ = _port_model(params, compute_dtype="bfloat16", **INT8)
    _, pre = _first_beam_step(model, frames, regions)
    step = model.decoder.step
    for key, w in (("Wq", step.query_lstm.fused_weights()[0]),
                   ("Wl", step.lang_lstm.fused_weights()[0]),
                   ("Wv", step.word_restore.kernel())):
        want = quantize_weight(w.detach())
        assert torch.equal(pre[key].qt, want.qt) and torch.equal(pre[key].s, want.s), key
    assert step.query_lstm.fused_weights()[0].dtype == torch.bfloat16
    assert step.word_restore.kernel().dtype == torch.float32


def test_ce_step_under_int8_equals_the_step_without(setup):
    """Training with decode_quant='int8' is training without it: one CE step
    gives the same loss and parameters bitwise."""
    params, *_ = setup
    cfg = tiny_test_config(dropout=0.0)
    rng = np.random.default_rng(9)
    batch = {
        "frames": rng.normal(size=(B, cfg.max_frames, cfg.feature_size)).astype(np.float32),
        "regions": rng.normal(size=(B, cfg.max_frames, cfg.num_obj, cfg.region_feature_size))
        .astype(np.float32),
        "captions": rng.integers(4, V, size=(B, cfg.max_words)).astype(np.int64),
        "lengths": np.full((B,), cfg.max_words, np.int64),
    }
    out = {}
    for quant in ("none", "int8"):
        model, qcfg = _port_model(params, dropout=0.0, decode_quant=quant)
        state = TrainState.create(model, make_optimizer(1e-3))
        state, m = make_ce_train_step(model, qcfg)(state, batch, 2, 0.5)
        out[quant] = (m["cap_loss"], model.state_dict())
    assert torch.equal(out["none"][0], out["int8"][0])
    for k, t in out["none"][1].items():
        assert torch.equal(t, out["int8"][1][k]), k


def test_two_pass_int8_decode_equals_single_pass(setup):
    """As <end>'s bias rises, all rows, some rows (the compacted pass 2:
    a bias found by bisection) or no row stay unfinished after t1 = 3
    steps; the two-pass int8 decode gives the single pass's ids in each."""
    params, frames, regions = setup
    model, cfg = _port_model(params, use_fused_vocab_head="on", **INT8)
    single = make_decode_fn(model, cfg, device="cpu")
    two = make_decode_fn(model, replace(cfg, decode_two_pass_t1=3, decode_two_pass_bucket=2),
                         device="cpu")
    beam_feats = _make_beam_from_feats(model, cfg, cfg.beam_size)
    bias = model.get_parameter("decoder.step.word_restore.bias")
    base = float(bias.detach()[END_ID])
    fr, rg = torch.from_numpy(frames), torch.from_numpy(regions)

    def unfinished(added: float) -> int:
        with torch.no_grad():
            bias[END_ID] = base + added
        with torch.inference_mode():
            return int((~beam_feats(*model.encode(fr, rg), 3)[3]).sum())

    lo, hi = 0.0, 12.0
    assert unfinished(lo) == B and unfinished(hi) == 0
    for _ in range(30):
        mid = (lo + hi) / 2
        n = unfinished(mid)
        if 1 <= n <= 2:
            break
        lo, hi = (mid, hi) if n > 2 else (lo, mid)
    for added, want in ((0.0, B), (mid, n), (12.0, 0)):
        assert 1 <= n <= 2 and unfinished(added) == want
        assert torch.equal(two(fr, rg), single(fr, rg)), added


def test_captioner_serves_int8(setup, monkeypatch):
    """Captioner reads decode_quant from its config: its beam and greedy
    captions are the int8 decode's, and every decoder product of them goes
    through qmatmul."""
    params, frames, regions = setup
    vocab = Vocabulary.from_words(f"w{i}" for i in range(V - 4))
    cfg = tiny_test_config(**INT8)
    calls = []
    def counting(x, qt, s):
        calls.append(tuple(qt.shape))
        return qmatmul_plain(x, qt, s)

    monkeypatch.setattr(quant_mod, "qmatmul", counting)
    cap = Captioner.from_params(cfg, vocab, params_from_jax(params), device="cpu")
    model, _ = _port_model(params, **INT8)
    for greedy, beam in ((False, cfg.beam_size), (True, 1)):
        calls.clear()
        ids = make_decode_fn(model, cfg, beam_size=beam, device="cpu")(frames, regions)
        want = [vocab.decode_tokens(row) for row in ids.tolist()]
        assert cap.caption(frames, regions, greedy=greedy) == want
        assert {s[0] for s in calls} == {4 * cfg.query_hidden_size, 4 * cfg.decode_hidden_size, V}
