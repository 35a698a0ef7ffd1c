"""dlsg_tpu_torch's baseline trainers, `Run` (CE over CapBaseline1) and
`RunLegacy` (frames-only CapModel), and their commands `cli train-base` and
`cli train-legacy`.

- Schedule parity with dlsg_tpu's Run and RunLegacy, exact: both trainers
  on the same synthetic data with their CE step and decode function
  replaced by recording fakes (tests/test_torch_trainer.py's), over 2
  epochs: the same learning rates, epsilons, batches, eval points, log
  lines, scalars.jsonl lines and result CSVs, and no save.
- One real epoch of each on the CPU: result files, finite scores, no
  checkpoint directory; `resume_epoch` refused.
- The commands on the CPU exit 0; with --resume they exit 2 with the JAX
  package's message.
- Run over two gloo ranks (tests/helpers/torch_dp_worker.py's `run` job)
  on a (data 2) mesh against one process on the global batch, at the job's
  RUN_CFG (dropout off, every coin gold, lr 1e-7: the moments compare the
  gradients): G's Adam moments within 1e-4 of each tensor's max-abs and its
  parameters as check_state holds them after 4 updates; the two ranks
  bitwise equal. And one CE step of CapBaselineModel over two ranks (the
  worker's `baseline_ce` job) against JAX's step on the global batch: the
  object branch, which the loss does not reach, gets zero gradients
  through the all-reduce, as under jax.grad.
"""

import json
import os
import shutil

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dlsg_tpu.cli as jcli
import dlsg_tpu.train.trainer as jtrainer
import dlsg_tpu_torch.train.trainer as ttrainer
from dlsg_tpu.config import tiny_test_config as jax_tiny
from dlsg_tpu.data.synthetic import SyntheticDataset as JaxSyntheticDataset
from dlsg_tpu.data.synthetic import make_vocab as jax_make_vocab
from dlsg_tpu.models.generator import CapBaselineModel as JaxCapBaselineModel
from dlsg_tpu.train import optim as joptim
from dlsg_tpu.train import steps as jsteps
from dlsg_tpu_torch.cli import main
from dlsg_tpu_torch.config import tiny_test_config
from dlsg_tpu_torch.data.synthetic import SyntheticDataset, make_vocab
from dlsg_tpu_torch.models import CapBaseline1, CapBaselineModel, CapModel
from dlsg_tpu_torch.ops import linear
from dlsg_tpu_torch.weights import params_from_jax, params_to_jax
from helpers.torch_dp_worker import RUN_CFG
from test_torch_cli import PORT_FLAGS, SCORES
from test_torch_parallel import LENGTHS, _global_batch, collect_ranks, launch_ranks
from test_torch_train_steps import KEY, LR, V, _adam_mu, _identity, check_state
from test_torch_train_steps import one_torch_thread  # noqa: F401  (autouse)
from test_torch_trainer import TIMING, TINY, _Fakes

TRAINERS = ["Run", "RunLegacy"]
COMMANDS = {"Run": "train-base", "RunLegacy": "train-legacy"}


def _run_with_fakes(runner, trainer_mod, ds, monkeypatch, capsys, jax_side):
    """The trainer's epochs with a fake CE step and decode; (fakes, saves,
    log lines without times, scalars without time stamps, result CSVs)."""
    fakes = _Fakes(ds, len(runner.vocab), runner.cfg.max_words, runner.cfg.num_proposals)
    saves = []
    monkeypatch.setattr(trainer_mod.ckpt, "save_model", lambda *a, **k: saves.append("model"))
    monkeypatch.setattr(trainer_mod.ckpt, "save_train", lambda *a, **k: saves.append("train"))
    if jax_side:
        def ce_step(state, batch, rng, eps):
            return state, fakes.step(state.opt_state.hyperparams["learning_rate"], 0.0, batch, eps)

        runner.decode_fn = lambda variables, frames, regions: fakes.decode(frames)[0]
    else:
        def ce_step(state, batch, key, eps):
            assert key == runner.cfg.seed
            return state, fakes.step(state.optimizer.param_groups[0]["lr"], 0.0, batch, eps)

        runner.decode_fn = lambda frames, regions: fakes.decode(frames)[0]
    runner.ce_step = ce_step
    capsys.readouterr()
    runner.train()
    log = [ln for ln in capsys.readouterr().out.splitlines() if not TIMING.search(ln)]
    root = os.path.join(runner.cfg.result_dir, runner.base_name)
    with open(os.path.join(root, "logs", "scalars.jsonl")) as f:
        scalars = [{k: v for k, v in json.loads(ln).items() if k != "t"} for ln in f]
    csvs = {}
    for dirpath, _, files in os.walk(root):
        for name in files:
            if name.endswith(".csv"):
                with open(os.path.join(dirpath, name)) as f:
                    csvs[os.path.relpath(os.path.join(dirpath, name), root)] = f.read()
    return fakes, saves, log, scalars, csvs


@pytest.mark.parametrize("trainer", TRAINERS)
def test_schedule_matches_jax_trainer(trainer, tmp_path, monkeypatch, capsys):
    kw = dict(TINY, epoch_num=2, log_every=1)
    jcfg = jax_tiny(result_dir=str(tmp_path / "jax"), **kw)
    jds = JaxSyntheticDataset(jcfg, jax_make_vocab(), num_videos=8, captions_per_video=2)
    jr = getattr(jtrainer, trainer)(jcfg, jax_make_vocab(), jds, jds.eval_view(), jds.references,
                                    is_debug=False)
    want = _run_with_fakes(jr, jtrainer, jds, monkeypatch, capsys, jax_side=True)

    cfg = tiny_test_config(result_dir=str(tmp_path / "port"), **kw)
    ds = SyntheticDataset(cfg, make_vocab(), num_videos=8, captions_per_video=2)
    pr = getattr(ttrainer, trainer)(cfg, make_vocab(), ds, ds.eval_view(), ds.references,
                                    is_debug=False, device="cpu")
    got = _run_with_fakes(pr, ttrainer, ds, monkeypatch, capsys, jax_side=False)

    (gf, gsaves, glog, gscalars, gcsv), (wf, wsaves, wlog, wscalars, wcsv) = got, want
    assert len(wf.steps) == 8 and len(wf.evals) == 8  # 4 steps and 2 evals an epoch
    assert [s[:4] for s in gf.steps] == [s[:4] for s in wf.steps]  # lr, -, epsilon, video ids
    assert [s[4] for s in gf.steps] == [s[4] for s in wf.steps]  # captions
    assert wf.steps[0][0] == wf.steps[-1][0] and wf.steps[0][2] != wf.steps[-1][2]
    assert gf.evals == wf.evals
    assert gsaves == wsaves == []  # the baseline trainers save nothing
    assert glog == wlog and any(ln.startswith("Epoch [1/2], Step [4/4]") for ln in wlog)
    assert [(s["tag"], s["step"]) for s in gscalars] == [(s["tag"], s["step"]) for s in wscalars]
    for g, w in zip(gscalars, wscalars):
        assert g["value"] == pytest.approx(w["value"], abs=1e-9), w
    assert gcsv == wcsv and "metrics.csv" in wcsv and "captioning/CIDEr_2.csv" in wcsv


@pytest.mark.parametrize("trainer", TRAINERS)
def test_one_epoch_on_the_cpu(trainer, tmp_path):
    """A real epoch: 4 CE steps, 2 beam evals, result files and finite
    scores, and no checkpoint directory, also with saving on."""
    cfg = tiny_test_config(result_dir=str(tmp_path), epoch_num=1, **TINY)
    vocab = make_vocab()
    ds = SyntheticDataset(cfg, vocab, num_videos=8, captions_per_video=2)
    runner = getattr(ttrainer, trainer)(cfg, vocab, ds, ds.eval_view(), ds.references,
                                        is_debug=False, device="cpu")
    assert isinstance(runner.gen_model, CapBaseline1 if trainer == "Run" else CapModel)
    before = {k: v.clone() for k, v in runner.gen_model.state_dict().items()}
    handler = runner.train()
    assert runner.gen_state.step == 4
    assert any(not torch.equal(v, before[k]) for k, v in runner.gen_model.state_dict().items())
    assert np.isfinite(handler.best("CIDEr"))
    root = tmp_path / runner.base_name
    assert (root / "captioning" / "CIDEr_2.csv").exists() and (root / "metrics.csv").exists()
    with open(root / "logs" / "scalars.jsonl") as f:
        tags = {json.loads(ln)["tag"] for ln in f}
    assert "Loss/cap_loss" in tags and {f"results/{t}" for t in ("CIDEr", "METEOR")} <= tags
    assert not os.path.exists(runner.cfg.checkpoint_dir) and not (root / "images").exists()
    with pytest.raises(ValueError, match="no training checkpoints"):
        getattr(ttrainer, trainer)(cfg, vocab, ds, ds.eval_view(), ds.references,
                                   resume_epoch="latest", device="cpu")


@pytest.mark.parametrize("trainer", TRAINERS)
def test_command_on_the_cpu(trainer, tmp_path, capsys):
    args = [COMMANDS[trainer], "--synthetic", "--synthetic_videos", "4", "--device", "cpu",
            "--no_debug", "--epoch_num", "1", "--result_dir", str(tmp_path)] + PORT_FLAGS
    assert main(args) == 0
    out = capsys.readouterr().out
    assert "Epoch-0 lr: 0.00016" in out and "CIDEr: " in out
    assert not (tmp_path / "checkpoints").exists()


@pytest.mark.parametrize("trainer", TRAINERS)
def test_command_refuses_resume_with_the_jax_message(trainer, tmp_path, capsys):
    """Before any data is read or any device is asked for."""
    for flag in (["--resume"], ["--resume_epoch", "0"]):
        args = [COMMANDS[trainer], "--synthetic", "--result_dir", str(tmp_path)] + flag
        assert main(args) == 2
        err = capsys.readouterr().err
        assert jcli.main(args + PORT_FLAGS) == 2
        assert err == capsys.readouterr().err and "only supported by `train`" in err


# ---------------------------------------------------------------- two ranks


@pytest.fixture(scope="module")
def run_ranks(tmp_path_factory):
    """(rank 0's, rank 1's) and the one process's results of the worker's
    `run` job: Run for one epoch, 16 captions, 2 rows a rank (4 in the one
    process), at RUN_CFG."""
    work = tmp_path_factory.mktemp("dp_run")
    procs = launch_ranks("run", work)
    with pytest.MonkeyPatch.context() as mp:  # one process at the global batch, meanwhile
        mp.setattr(linear, "dropout", lambda x, rate, rng: x)
        cfg = tiny_test_config(train_batch_size=4, result_dir=str(work / "one"), **RUN_CFG)
        vocab = make_vocab()
        ds = SyntheticDataset(cfg, vocab, num_videos=8, captions_per_video=2)
        run = ttrainer.Run(cfg, vocab, ds, ds.eval_view(), ds.references, device="cpu")
        run.train()
    one = {"g_mu": run.gen_state.first_moments(), "g_params": run.gen_model.state_dict(),
           "step": run.gen_state.step}
    yield collect_ranks(procs, "run", work, timeout=300), one
    shutil.rmtree(work, ignore_errors=True)  # the one process's run (collect_ranks)


def test_run_over_two_ranks_matches_one_process(run_ranks):
    (r0, _), one = run_ranks
    assert r0["step"] == one["step"] == 4
    check_state(one["g_mu"], one["g_params"], r0["g_mu"], r0["g_params"], updates=4)
    assert set(r0["scores"]) == set(SCORES) and all(np.isfinite(list(r0["scores"].values())))


def test_run_ranks_end_bitwise_equal(run_ranks):
    (r0, r1), _ = run_ranks
    for part in ("g_mu", "g_params"):
        for name, t in r0[part].items():
            assert torch.equal(t, r1[part][name]), (part, name)
    assert r0["scores"] == r1["scores"] and r0["trained"] != r1["trained"]


def test_baseline_ce_step_over_two_ranks_matches_jax(tmp_path):
    cfg = tiny_test_config(dropout=0.0)
    weights = CapBaselineModel(cfg, V, device="cpu").state_dict()
    torch.save(weights, tmp_path / "weights.pt")
    batch = _global_batch(cfg, LENGTHS["uneven"], seed=4)
    np.savez(tmp_path / "batch.npz", **batch)
    procs = launch_ranks("baseline_ce", tmp_path)
    jcfg = jax_tiny(dropout=0.0)
    state = joptim.TrainState.create(params_to_jax(weights), joptim.make_optimizer(LR))
    with pytest.MonkeyPatch.context() as mp:  # while the ranks run
        mp.setattr(flax.linen.Dropout, "__call__", _identity)
        state, m = jsteps.make_ce_train_step(JaxCapBaselineModel(jcfg, V), jcfg)(
            state, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(KEY),
            jnp.float32(1.0))
    want_mu, want_params = params_from_jax(_adam_mu(state.opt_state)), params_from_jax(state.params)
    ranks = collect_ranks(procs, "baseline_ce", tmp_path, timeout=300)
    unused = [k for k in weights if k.startswith("encoder.obj_encoder.")]
    assert unused
    for r in ranks:
        check_state(want_mu, want_params, r["g_mu"], r["g_params"])
        np.testing.assert_allclose(r["metrics"]["cap_loss"].numpy(), np.asarray(m["cap_loss"]),
                                   atol=1e-5)
        for k in unused:
            assert torch.equal(r["g_params"][k], weights[k]) and not r["g_mu"][k].any(), k
    for part in ("g_mu", "g_params"):
        for name, t in ranks[0][part].items():
            assert torch.equal(t, ranks[1][part][name]), (part, name)
