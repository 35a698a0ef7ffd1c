"""dlsg_tpu_torch's RunGAN.

- Schedule parity with dlsg_tpu's RunGAN, exact: both trainers on the same
  synthetic data with their train step and decode function replaced by
  recording fakes (the fakes answer alike in both), over 2 epochs of msvd
  and of msr-vtt. Same learning rates, epsilons, batches, eval points, log
  lines, scalars.jsonl lines (apart from the time stamp), result CSVs and
  checkpoint saves.
- Resume continuity (the port alone): 2 epochs straight against 1 epoch,
  then resume_epoch="latest", then 1 more.
- One real GAN epoch on the CPU: logs, the heatmap, epoch_0/ and a best_*
  model that Captioner.from_checkpoint loads to the same captions.
- Options that need unported parts raise, naming their ROADMAP item; the
  profile_dir trace and the Stopwatch spans.

The one-epoch CE run against JAX's trainer is in
test_torch_trainer_ce_epoch.py, so that xdist spreads the JAX compiles.
"""

import csv
import json
import os
import re

import numpy as np
import pytest
import torch

import dlsg_tpu.train.trainer as jtrainer
import dlsg_tpu_torch.train.trainer as ttrainer
from dlsg_tpu.config import tiny_test_config as jax_tiny
from dlsg_tpu.data.synthetic import SyntheticDataset as JaxSyntheticDataset
from dlsg_tpu.data.synthetic import make_vocab as jax_make_vocab
from dlsg_tpu_torch.config import tiny_test_config
from dlsg_tpu_torch.data.synthetic import SyntheticDataset, make_vocab
from dlsg_tpu_torch.serve import Captioner
from dlsg_tpu_torch.train.trainer import RunGAN
from test_torch_parallel import tmp_path  # noqa: F401  (removed when a test ends)
from test_torch_train_steps import one_torch_thread  # noqa: F401  (autouse)

TINY = dict(train_batch_size=4, test_batch_size=4, beam_size=2)
TIMING = re.compile(r"time|spans \(")  # log lines that carry a wall time


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


class _Fakes:
    """A GAN step and a decode function that record what the trainer gives
    them and answer from their call count and the batch alone."""

    def __init__(self, ds, vocab_size, max_words, num_proposals):
        self.first = ds.frames[:, 0, 0]
        self.V, self.T, self.P = vocab_size, max_words, num_proposals
        self.steps, self.evals = [], []

    def vids(self, frames):
        return [int(np.flatnonzero(self.first == f)[0]) for f in _np(frames)[:, 0, 0]]

    def step(self, g_lr, d_lr, batch, epsilon):
        n = len(self.steps)
        caps = _np(batch["captions"])
        self.steps.append((np.float32(g_lr), np.float32(d_lr), np.float32(epsilon),
                           self.vids(batch["frames"]), caps.tolist()))
        f = np.float32
        return {"cap_loss": f(3.0 + 0.125 * n), "loss_G": f(0.5 - 0.0625 * n),
                "loss_D": f(-1.0 + 0.25 * n), "wasserstein": f(0.75 * n),
                "grad_penalty": f(0.0), "gan_lambda": f(0.01), "sample_tokens": caps[-1]}

    def decode(self, frames):
        k = len(self.evals)
        vids = self.vids(frames)
        self.evals.append(vids)
        ids = np.zeros((len(vids), self.T), np.int64)
        for row, vid in enumerate(vids):
            rng = np.random.default_rng([vid, k])
            n = int(rng.integers(1, self.T))
            ids[row, :n] = rng.integers(4, self.V, size=n)
            ids[row, n:] = 2  # <end>
        alpha = np.full((len(vids), self.T, 2 * self.P), 1.0 / (2 * self.P), np.float32)
        return ids, alpha


def _run_with_fakes(runner, trainer_mod, ds, monkeypatch, capsys, jax_side):
    fakes = _Fakes(ds, len(runner.vocab), runner.cfg.max_words, runner.cfg.num_proposals)
    saves = []
    monkeypatch.setattr(trainer_mod.ckpt, "save_model",
                        lambda d, name, params: saves.append(("model", name)))
    monkeypatch.setattr(trainer_mod.ckpt, "save_train",
                        lambda d, epoch, g, dstate=None, lambda_state=None:
                        saves.append(("train", epoch, dstate is not None, lambda_state is not None)))
    if jax_side:
        def lr(state):
            return state.opt_state.hyperparams["learning_rate"]

        def gan_step(gs, ds_, ls, batch, rng, eps):
            return gs, ds_, ls, fakes.step(lr(gs), lr(ds_), batch, eps)

        runner.gan_step = gan_step
        runner.decode_fn = lambda variables, frames, regions: fakes.decode(frames)
    else:
        def lr(state):
            return state.optimizer.param_groups[0]["lr"]

        def gan_step(gs, ds_, ls, batch, key, eps):
            assert key == runner.cfg.seed
            return gs, ds_, ls, fakes.step(lr(gs), lr(ds_), batch, eps)

        runner.gan_step = gan_step
        runner.decode_fn = lambda frames, regions: fakes.decode(frames)
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
                    csvs[os.path.relpath(os.path.join(dirpath, name), root)] = list(csv.reader(f))
    return fakes, saves, log, scalars, csvs


@pytest.mark.parametrize("dataset", ["msvd", "msr-vtt"])
def test_schedule_matches_jax_trainer(dataset, tmp_path, monkeypatch, capsys):
    kw = dict(TINY, dataset=dataset, epoch_num=2, log_every=1)
    jcfg = jax_tiny(result_dir=str(tmp_path / "jax"), **kw)
    jds = JaxSyntheticDataset(jcfg, jax_make_vocab(), num_videos=8, captions_per_video=2)
    jr = jtrainer.RunGAN(jcfg, jax_make_vocab(), jds, jds.eval_view(), jds.references, is_debug=False)
    want = _run_with_fakes(jr, jtrainer, jds, monkeypatch, capsys, jax_side=True)

    cfg = tiny_test_config(result_dir=str(tmp_path / "port"), **kw)
    ds = SyntheticDataset(cfg, make_vocab(), num_videos=8, captions_per_video=2)
    pr = RunGAN(cfg, make_vocab(), ds, ds.eval_view(), ds.references, is_debug=False, device="cpu")
    got = _run_with_fakes(pr, ttrainer, ds, monkeypatch, capsys, jax_side=False)

    (gf, gsaves, glog, gscalars, gcsv), (wf, wsaves, wlog, wscalars, wcsv) = got, want
    # 4 steps an epoch; 2 evals an epoch, each 2 decode batches of 4 clips
    assert len(wf.steps) == 8 and len(wf.evals) == 8
    for n, (g, w) in enumerate(zip(gf.steps, wf.steps)):
        assert g[:4] == w[:4], n  # G lr, D lr, epsilon, video ids
        assert g[4] == w[4], n  # captions
    assert len(gf.steps) == len(wf.steps)
    if dataset == "msr-vtt":  # the per-step epsilon moves within an epoch
        assert wf.steps[0][2] != wf.steps[3][2]
    assert gf.evals == wf.evals
    assert gsaves == wsaves and ("train", 1, True, True) in wsaves
    assert any(s[0] == "model" for s in wsaves)
    assert glog == wlog and any(ln.startswith("WE: ") for ln in wlog)
    assert [(s["tag"], s["step"]) for s in gscalars] == [(s["tag"], s["step"]) for s in wscalars]
    for g, w in zip(gscalars, wscalars):  # scores: the JAX package's C++ METEOR
        assert g["value"] == pytest.approx(w["value"], abs=1e-9), w
    assert gcsv == wcsv and "metrics.csv" in wcsv and "captioning/CIDEr_2.csv" in wcsv


def _gan_runner(root, epoch_num, resume=None, **cfg_kw):
    cfg = tiny_test_config(epoch_num=epoch_num, result_dir=str(root), **TINY, **cfg_kw)
    vocab = make_vocab()
    ds = SyntheticDataset(cfg, vocab, num_videos=8, captions_per_video=2)
    return RunGAN(cfg, vocab, ds, ds.eval_view(), ds.references, is_debug=False,
                  resume_epoch=resume, device="cpu")


def test_resume_continues_the_uninterrupted_run(tmp_path):
    """2 epochs straight == 1 epoch, resume 'latest', 1 more (as
    tests/test_trainer.py holds the JAX trainer)."""
    assert _gan_runner(tmp_path / "fresh", 1, resume="latest").last_epoch == -1
    a = _gan_runner(tmp_path / "a", 2)
    a.train()
    _gan_runner(tmp_path / "b", 1).train()
    b = _gan_runner(tmp_path / "b", 2, resume="latest")
    assert b.last_epoch == 0
    assert (b.gen_state.step, b.disc_state.step) == (4, 4 * b.cfg.num_D_visual)
    b.train()
    assert (a.gen_state.step, a.disc_state.step) == (b.gen_state.step, b.disc_state.step) == (8, 40)
    for model_a, model_b in ((a.gen_model, b.gen_model), (a.disc_model, b.disc_model)):
        for (n, x), y in zip(model_a.state_dict().items(), model_b.state_dict().values()):
            torch.testing.assert_close(y, x, rtol=0, atol=1e-5, msg=n)
    for k, x in a.lambda_state.items():
        torch.testing.assert_close(b.lambda_state[k], x, rtol=0, atol=1e-6, msg=k)
    # an explicit epoch number resumes the same way
    assert _gan_runner(tmp_path / "b", 3, resume="1").last_epoch == 1


def test_one_gan_epoch_writes_everything_and_serves_its_best_model(tmp_path):
    r = _gan_runner(tmp_path, 1)
    handler = r.train()
    root = tmp_path / r.base_name
    tags = {json.loads(ln)["tag"] for ln in open(root / "logs" / "scalars.jsonl")}
    assert {"Loss/cap_loss", "Loss/G_v_loss", "Loss/D_loss_visual", "Loss/wasserstein_visual",
            "parameter/gan_lambda", "results/CIDEr", "results/METEOR"} <= tags
    assert any(p.suffix == ".png" for p in (root / "images").iterdir())
    assert (tmp_path / "checkpoints" / "epoch_0" / "train.pt").exists()
    assert handler.best("CIDEr") > 0
    # best_CIDEr holds the model of the eval that wrote CIDEr_2.csv
    with open(root / "captioning" / "CIDEr_2.csv") as f:
        rows = list(csv.reader(f))[1:]
    captioner = Captioner.from_checkpoint(r.cfg, r.vocab, name="best_CIDEr", device="cpu")
    view = r.eval_dataset
    frames = np.stack([view[i]["frames"] for i in range(len(view))])
    regions = np.stack([view[i]["regions"] for i in range(len(view))])
    assert captioner.caption(frames, regions) == [pred for _, pred in rows]
    assert [int(v) for v, _ in rows] == list(range(len(view)))


def test_unported_options_raise(tmp_path):
    for kw, match in (
        (dict(mesh_data_axis=2), "= 2 ranks, but the world size is 1"),
        # the model axis needs a process group: no quiet replicated run
        (dict(mesh_model_axis=2), r"mesh_model_axis=2 does not divide the world size 1 \(no process group"),
        (dict(use_pallas_lstm=True), "no backward"),
    ):
        with pytest.raises((NotImplementedError, ValueError), match=match):
            _gan_runner(tmp_path, 1, **kw)
    # the mesh is the world: one process, 1 x 1 or -1 x 1
    assert _gan_runner(tmp_path, 1, mesh_data_axis=1).cfg.mesh_data_axis == 1
    # ported since: the worker pool (item 4; the synthetic set is read
    # in-process, as in JAX) and the two-pass decode (item 5)
    r = _gan_runner(tmp_path, 1, loader_workers=2, decode_two_pass_t1=4)
    assert r.cfg.loader_workers == 2 and r.decode_fn.__name__ == "decode_two_pass"


def test_profile_dir_traces_steps_and_stopwatch_reports(tmp_path, monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "1")
    cfg = tiny_test_config(epoch_num=1, result_dir=str(tmp_path / "results"),
                           profile_dir=str(tmp_path / "trace"), use_visual_gan=False, **TINY)
    vocab = make_vocab()
    ds = SyntheticDataset(cfg, vocab, num_videos=16, captions_per_video=2)
    r = RunGAN(cfg, vocab, ds, ds.eval_view(), ds.references, device="cpu")
    r.train()
    traces = list((tmp_path / "trace").glob("trace_*.json"))
    assert len(traces) == 1 and json.loads(traces[0].read_text())["traceEvents"]
    assert r._trace is None
    assert r.stopwatch.counts["train_step"] == 8 and r.stopwatch.counts["eval"] == 2
    assert "train_step" in r.stopwatch.report()
    assert not (tmp_path / "results" / "checkpoints").exists()  # is_debug: no saves
    monkeypatch.setenv("WORLD_SIZE", "2")  # torchrun's env without --distributed
    with pytest.raises(RuntimeError, match="--distributed"):
        RunGAN(cfg, vocab, ds, ds.eval_view(), ds.references, device="cpu")
