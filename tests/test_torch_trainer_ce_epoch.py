"""dlsg_tpu_torch's RunGAN against dlsg_tpu's over one real epoch: the
CE-only trainer (use_visual_gan=False) from the JAX trainer's initial
parameters, fp32, with dropout switched off on both sides (the configured
rate by `dropout=0.0`, every hard-coded rate by patching flax's
`Dropout.__call__` and the port's one `dropout` function) and every
scheduled-sampling coin gold: ss_factor 1e9 puts epsilon at 1 - 1e-9, which
is 1.0 in fp32 on both sides. At lr 1e-7 the 4 Adam updates keep the
parameters near their start, so the first moments compare the gradients.

Tolerances: the final parameters and moments by `check_state` of
test_torch_train_steps.py; the eval captions identical; the scores within
1e-9 (JAX's METEOR runs its C++ aligner); the cap_loss scalars within 1e-5.
"""

import json
import os

import flax.linen
import numpy as np
import pytest

import dlsg_tpu.train.trainer as jtrainer
import dlsg_tpu_torch.train.trainer as ttrainer
from dlsg_tpu.config import tiny_test_config as jax_tiny
from dlsg_tpu.data.synthetic import SyntheticDataset as JaxSyntheticDataset
from dlsg_tpu.data.synthetic import make_vocab as jax_make_vocab
from dlsg_tpu_torch.config import tiny_test_config
from dlsg_tpu_torch.data.synthetic import SyntheticDataset, make_vocab
from dlsg_tpu_torch.ops import linear
from dlsg_tpu_torch.weights import params_from_jax
from test_torch_train_steps import _adam_mu, _identity, check_state, one_torch_thread  # noqa: F401

CFG = dict(dropout=0.0, use_visual_gan=False, ss_factor=10**9, learning_rate=1e-7,
           epoch_num=1, train_batch_size=4, test_batch_size=4, beam_size=2)


def _record(trainer_mod, runner, monkeypatch):
    """Record the epsilon of every CE step and the output of every eval."""
    epsilons, evals = [], []
    step = runner.ce_step

    def ce_step(state, batch, key, epsilon):
        epsilons.append(np.float32(epsilon))
        return step(state, batch, key, epsilon)

    runner.ce_step = ce_step
    evaluate = trainer_mod.evaluate

    def recording(*args, **kw):
        out = evaluate(*args, **kw)
        evals.append((out[0], dict(out[1])))
        return out

    monkeypatch.setattr(trainer_mod, "evaluate", recording)
    return epsilons, evals


def _cap_losses(runner):
    path = os.path.join(runner.cfg.result_dir, runner.base_name, "logs", "scalars.jsonl")
    rows = [json.loads(ln) for ln in open(path)]
    return [(r["step"], r["value"]) for r in rows if r["tag"] == "Loss/cap_loss"]


def test_ce_epoch_matches_jax_trainer(tmp_path, monkeypatch):
    jcfg = jax_tiny(result_dir=str(tmp_path / "jax"), **CFG)
    jvocab = jax_make_vocab()
    jds = JaxSyntheticDataset(jcfg, jvocab, num_videos=8, captions_per_video=2)
    jr = jtrainer.RunGAN(jcfg, jvocab, jds, jds.eval_view(), jds.references)
    cfg = tiny_test_config(result_dir=str(tmp_path / "port"), **CFG)
    vocab = make_vocab()
    ds = SyntheticDataset(cfg, vocab, num_videos=8, captions_per_video=2)
    pr = ttrainer.RunGAN(cfg, vocab, ds, ds.eval_view(), ds.references, device="cpu")
    pr.gen_model.load_state_dict(params_from_jax(jr.gen_state.params))

    j_eps, j_evals = _record(jtrainer, jr, monkeypatch)
    p_eps, p_evals = _record(ttrainer, pr, monkeypatch)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax.linen.Dropout, "__call__", _identity)
        mp.setattr(linear, "dropout", lambda x, rate, rng: x)
        jr.train()
        pr.train()

    assert j_eps == p_eps == [np.float32(1.0)] * 4
    assert pr.gen_state.step == int(jr.gen_state.step) == 4
    check_state(
        params_from_jax(_adam_mu(jr.gen_state.opt_state)), params_from_jax(jr.gen_state.params),
        pr.gen_state.first_moments(), pr.gen_model.state_dict(), updates=4,
    )
    assert len(p_evals) == len(j_evals) == 2
    for (p_scores, p_caps), (j_scores, j_caps) in zip(p_evals, j_evals):
        assert p_caps == j_caps and len(j_caps) == 8
        assert set(p_scores) == set(j_scores)
        for k, v in j_scores.items():
            assert p_scores[k] == pytest.approx(v, abs=1e-9), k
    p_loss, j_loss = _cap_losses(pr), _cap_losses(jr)
    assert [s for s, _ in p_loss] == [s for s, _ in j_loss] == [1, 2, 3, 4]
    np.testing.assert_allclose([v for _, v in p_loss], [v for _, v in j_loss], atol=1e-5)
