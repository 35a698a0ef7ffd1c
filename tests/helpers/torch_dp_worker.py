"""One rank of a dlsg_tpu_torch data-parallel job on the CPU (gloo), for
tests/test_torch_parallel.py and tests/test_torch_multiprocess.py.

    RANK=r WORLD_SIZE=n LOCAL_RANK=r MASTER_ADDR=127.0.0.1 MASTER_PORT=p \\
        python tests/helpers/torch_dp_worker.py JOB IN_DIR OUT_FILE

(without RANK in the environment: one process and no process group)

Imports dlsg_tpu_torch only (no jax, no dlsg_tpu). Jobs:

- steps: from the weights and global batches in IN_DIR, one GAN step on
  this rank's rows of each case (dropout off, epsilon 1, the penalty's
  mixing weights given); the same with each global computation made per
  rank in turn (the CE's token count, PSLScore2's batch mean, the
  gradient of PSLScore2's sum, the cap loss fed to lambda); one CE step;
  and a dropout draw;
- gan: the first of those GAN steps alone (run at world size 1);
- gan_f64: the GAN step of each case on the whole batch in float64, with
  no process group (`float64_torch` below);
- glove: Run built with `use_glove` from IN_DIR/glove.txt (no step): its
  word embedding (tests/test_torch_glove.py);
- baseline_ce: one CE step of CapBaselineModel from IN_DIR/weights.pt on
  this rank's rows of IN_DIR/batch.npz, dropout off, every word gold
  (tests/test_torch_baselines_trainer.py);
- run: the CE baseline trainer Run for one synthetic epoch of 16 captions,
  2 rows a rank, at RUN_CFG (tests/test_torch_baselines_trainer.py);
- trainer: RunGAN for one synthetic epoch (a train set not divisible by
  world x batch), then resumed from rank 0's epoch_0 checkpoint for one
  more; and evaluate() with the gather over a 5-clip and a 1-clip eval set.

Each rank writes its results with torch.save to OUT_FILE.
"""

from __future__ import annotations

import contextlib
import datetime
import os
import sys

import numpy as np
import torch

V = 40
KEY = 2
LR = 1e-4
# the run job's config: dropout off (with the hard-coded rates, patched),
# every scheduled-sampling coin gold (epsilon 1 - 1e-9 = 1.0 in fp32), and
# lr 1e-7, so that the 4 Adam updates keep the parameters near their start
# and the first moments compare the gradients (as
# tests/test_torch_trainer_ce_epoch.py does): at the trainer's 1.6e-4 a
# first update is +-lr on elements whose gradient sits at rounding level,
# and the later steps carry that into the moments
RUN_CFG = dict(dropout=0.0, ss_factor=10**9, learning_rate=1e-7, epoch_num=1,
               test_batch_size=4, beam_size=2)


@contextlib.contextmanager
def patched(*patches):
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in patches]
    for obj, name, value in patches:
        setattr(obj, name, value)
    try:
        yield
    finally:
        for obj, name, value in saved:
            setattr(obj, name, value)


def _np(t):
    return t.detach().clone()


def float64_torch() -> None:
    """Make the port compute in float64: the default dtype, every
    `torch.float32` the package names (read when it is imported, so this
    runs first) and `Tensor.float()`. The package casts to fp32 at many
    sites (flax's fp32 statistics and outputs), and each of them becomes a
    float64 cast."""
    torch.set_default_dtype(torch.float64)
    torch.float32 = torch.float = torch.float64
    torch.Tensor.float = lambda self, *args, **kw: self.double()


def f64_job(in_dir: str) -> dict:
    """The steps job's GAN step of each case on the whole batch, with no
    process group, in float64 (the weights, features and penalty weights
    are the fp32 ones, widened)."""
    # read while torch.load still knows its fp32 storage type
    weights = torch.load(os.path.join(in_dir, "weights.pt"), weights_only=True)
    saved = torch.float32, torch.float, torch.Tensor.float
    float64_torch()  # before the package is imported
    try:
        return _f64_steps(in_dir, weights)
    finally:
        torch.float32, torch.float, torch.Tensor.float = saved  # torch.save needs them


def _f64_steps(in_dir: str, weights: dict) -> dict:
    from dlsg_tpu_torch.config import tiny_test_config
    from dlsg_tpu_torch.models.discriminator import DiscV2
    from dlsg_tpu_torch.models.generator import CapGnnModel
    from dlsg_tpu_torch.ops import linear
    from dlsg_tpu_torch.train.gan_lambda import init_lambda_state
    from dlsg_tpu_torch.train.optim import TrainState, make_optimizer
    from dlsg_tpu_torch.train.steps import make_gan_train_step

    cfg = tiny_test_config(dropout=0.0)
    assert cfg.cdtype == torch.float64
    data = np.load(os.path.join(in_dir, "batches.npz"))
    out = {}
    for case in ("even", "uneven"):
        batch = {k: data[f"{case}_{k}"] for k in ("frames", "regions", "captions", "lengths")}
        for k in ("frames", "regions"):
            batch[k] = batch[k].astype(np.float64)
        g, d = CapGnnModel(cfg, V, device="cpu"), DiscV2(cfg, V, device="cpu")
        g.load_state_dict(weights["gen"])
        d.load_state_dict(weights["disc"])
        gs = TrainState.create(g, make_optimizer(LR))
        ds = TrainState.create(d, make_optimizer(LR))
        with patched((linear, "dropout", lambda x, rate, rng: x)):
            gs, ds, _, _ = make_gan_train_step(g, d, cfg)(
                gs, ds, init_lambda_state(0.01, device="cpu"), batch, KEY, 1.0,
                eps_gp=torch.from_numpy(data[f"{case}_eps_gp"].astype(np.float64)),
            )
        out[f"gan_{case}"] = {"g_mu": gs.first_moments(), "d_mu": ds.first_moments()}
        assert all(t.dtype == torch.float64 for t in out[f"gan_{case}"]["d_mu"].values())
    return out


def steps_job(in_dir: str, only_gan: bool = False) -> dict:
    from dlsg_tpu_torch.config import tiny_test_config
    from dlsg_tpu_torch.models import discriminator
    from dlsg_tpu_torch.models.discriminator import DiscV2
    from dlsg_tpu_torch.models.generator import CapGnnModel
    from dlsg_tpu_torch.ops import linear, losses
    from dlsg_tpu_torch.parallel import dist
    from dlsg_tpu_torch.train.gan_lambda import init_lambda_state
    from dlsg_tpu_torch.train.optim import TrainState, make_optimizer
    from dlsg_tpu_torch.train import steps
    from dlsg_tpu_torch.train.steps import make_ce_train_step, make_gan_train_step

    r, w = dist.rank(), dist.world_size()
    cfg = tiny_test_config(dropout=0.0)
    weights = torch.load(os.path.join(in_dir, "weights.pt"), weights_only=True)
    data = np.load(os.path.join(in_dir, "batches.npz"))
    no_dropout = (linear, "dropout", lambda x, rate, rng: x)
    per_rank_ce = (losses, "global_sum", lambda count: count * dist.world_size())
    per_rank_psl = [(discriminator, "global_sum", lambda x: x), (discriminator, "global_rows", lambda n: n)]
    # the global sum forward, but a backward that stays on this rank (an
    # all-reduce autograd does not see)
    local_grad = (discriminator, "global_sum",
                  lambda x: x + (dist.global_sum(x.detach()) - x.detach()))
    # every global loss (lambda's input among them) as this rank's own mean
    per_rank_losses = (steps, "global_sum", lambda x: x * dist.world_size())

    def shard(case):
        keys = ("frames", "regions", "captions", "lengths")
        b = data[f"{case}_captions"].shape[0] // w
        batch = {k: data[f"{case}_{k}"][r * b:(r + 1) * b] for k in keys}
        return batch, torch.from_numpy(data[f"{case}_eps_gp"][:, r * b:(r + 1) * b])

    def models():
        g, d = CapGnnModel(cfg, V, device="cpu"), DiscV2(cfg, V, device="cpu")
        g.load_state_dict(weights["gen"])
        d.load_state_dict(weights["disc"])
        return g, d

    def gan(case, *patches):
        batch, eps_gp = shard(case)
        g, d = models()
        gs = TrainState.create(g, make_optimizer(LR))
        ds = TrainState.create(d, make_optimizer(LR))
        with patched(no_dropout, *patches):
            gs, ds, lstate, m = make_gan_train_step(g, d, cfg)(
                gs, ds, init_lambda_state(0.01, device="cpu"), batch, KEY, 1.0, eps_gp=eps_gp
            )
        return {
            "g_mu": gs.first_moments(), "g_params": g.state_dict(),
            "d_mu": ds.first_moments(), "d_params": d.state_dict(),
            "metrics": {k: _np(v) for k, v in m.items()},
            "lambda": {k: _np(v) for k, v in lstate.items()},
            "g_step": gs.step, "d_step": ds.step,
        }

    def ce(case):
        batch, _ = shard(case)
        g, _ = models()
        gs = TrainState.create(g, make_optimizer(LR))
        with patched(no_dropout):
            gs, m = make_ce_train_step(g, cfg)(gs, batch, KEY, 1.0)
        return {"g_mu": gs.first_moments(), "g_params": g.state_dict(),
                "metrics": {k: _np(v) for k, v in m.items()}, "g_step": gs.step}

    if only_gan:
        return {"gan_uneven": gan("uneven")}
    gen = torch.Generator().manual_seed(5)
    return {
        "gan_even": gan("even"),
        "gan_uneven": gan("uneven"),
        "gan_even_per_rank_ce": gan("even", per_rank_ce),
        "gan_uneven_per_rank_ce": gan("uneven", per_rank_ce),
        "gan_uneven_per_rank_psl": gan("uneven", *per_rank_psl),
        "gan_uneven_local_psl_grad": gan("uneven", local_grad),
        "gan_uneven_per_rank_lambda": gan("uneven", per_rank_losses),
        "ce_uneven": ce("uneven"),
        "dropout": linear.dropout(torch.ones(6, 10), 0.5, gen),
    }


def trainer_job(in_dir: str) -> dict:
    from dlsg_tpu_torch.config import tiny_test_config
    from dlsg_tpu_torch.data.loader import eval_batches
    from dlsg_tpu_torch.data.synthetic import SyntheticDataset, make_vocab
    from dlsg_tpu_torch.evaluation import evaluate, make_decode_fn
    from dlsg_tpu_torch.models import CapGnnModel
    from dlsg_tpu_torch.parallel import dist
    from dlsg_tpu_torch.train.trainer import RunGAN

    r = dist.rank()
    vocab = make_vocab()
    out = {}

    # ---- RunGAN: 19 captions, batch 2, 2 ranks: shards of 10 and 9, 4 steps each
    def runner(result_dir, epoch_num, resume=None):
        cfg = tiny_test_config(epoch_num=epoch_num, result_dir=result_dir,
                               train_batch_size=2, test_batch_size=4, beam_size=2)
        ds = SyntheticDataset(cfg, vocab, num_videos=19, captions_per_video=1)
        run = RunGAN(cfg, vocab, ds, ds.eval_view(), ds.references, is_debug=False,
                     resume_epoch=resume, device="cpu")
        trained = []
        slice_batch = run._slice_batch

        def record(batch):
            trained.extend(int(v) for v in batch["video_ids"])
            return slice_batch(batch)

        run._slice_batch = record
        return run, trained

    own_dir = os.path.join(in_dir, f"results_rank{r}")
    run, trained = runner(own_dir, 1)
    run.train()
    out["epoch0"] = {
        "trained": trained, "steps": [run.gen_state.step, run.disc_state.step],
        "gen": run.gen_model.state_dict(), "disc": run.disc_model.state_dict(),
        "lambda": {k: _np(v) for k, v in run.lambda_state.items()},
        "best": run.result_handler.best("CIDEr"),
    }
    # both ranks resume from rank 0's checkpoint (rank 1 wrote none)
    dist.barrier()
    run, trained = runner(os.path.join(in_dir, "results_rank0"), 2, resume="latest")
    out["resumed_from"] = run.last_epoch
    run.train()
    out["epoch1"] = {
        "trained": trained, "steps": [run.gen_state.step, run.disc_state.step],
        "gen": run.gen_model.state_dict(), "disc": run.disc_model.state_dict(),
        "lambda": {k: _np(v) for k, v in run.lambda_state.items()},
    }

    # ---- evaluate() with the gather: 5 clips (shards of 3 and 2), then 1 (rank 1 empty)
    cfg = tiny_test_config(test_batch_size=2, beam_size=2)
    model = CapGnnModel(cfg, len(vocab), device="cpu")  # seeded: the same on every rank
    decode = make_decode_fn(model, cfg, return_alpha=True, device="cpu")
    for n in (5, 1):
        ds = SyntheticDataset(cfg, vocab, num_videos=n, captions_per_video=2, seed=n)
        view = ds.eval_view()
        scores, results, alpha, _ = evaluate(
            decode, eval_batches(view, cfg.test_batch_size, shard_index=r,
                                 num_shards=dist.world_size()),
            vocab, ds.references,
        )
        out[f"eval_{n}"] = {"scores": scores, "results": dict(results), "alpha": alpha,
                            "shard": len(range(r, len(view), dist.world_size()))}
    return out


def run_job(in_dir: str) -> dict:
    from dlsg_tpu_torch.config import tiny_test_config
    from dlsg_tpu_torch.data.synthetic import SyntheticDataset, make_vocab
    from dlsg_tpu_torch.ops import linear
    from dlsg_tpu_torch.parallel import dist
    from dlsg_tpu_torch.train.trainer import Run

    cfg = tiny_test_config(train_batch_size=2, result_dir=os.path.join(in_dir, f"run_rank{dist.rank()}"),
                           **RUN_CFG)
    vocab = make_vocab()
    ds = SyntheticDataset(cfg, vocab, num_videos=8, captions_per_video=2)
    with patched((linear, "dropout", lambda x, rate, rng: x)):
        run = Run(cfg, vocab, ds, ds.eval_view(), ds.references, device="cpu")
        trained, scores = [], []
        slice_batch, run_eval = run._slice_batch, run._run_eval

        def record(batch):
            trained.extend(int(v) for v in batch["video_ids"])
            return slice_batch(batch)

        def record_eval(*args):
            out = run_eval(*args)
            scores.append(out[0])
            return out

        run._slice_batch, run._run_eval = record, record_eval
        run.train()
    return {"g_mu": run.gen_state.first_moments(), "g_params": run.gen_model.state_dict(),
            "step": run.gen_state.step, "scores": scores[-1], "trained": trained}


def glove_job(in_dir: str) -> dict:
    from dlsg_tpu_torch.config import tiny_test_config
    from dlsg_tpu_torch.data.synthetic import SyntheticDataset, make_vocab
    from dlsg_tpu_torch.models.glove import WORD_EMBED_KEY
    from dlsg_tpu_torch.train.trainer import Run

    cfg = tiny_test_config(use_glove=True, glove_txt_path=os.path.join(in_dir, "glove.txt"),
                           data_dir=in_dir, result_dir=os.path.join(in_dir, "results"))
    vocab = make_vocab()
    ds = SyntheticDataset(cfg, vocab, num_videos=2, captions_per_video=1)
    run = Run(cfg, vocab, ds, ds.eval_view(), ds.references, device="cpu")
    return {"embedding": run.gen_model.state_dict()[WORD_EMBED_KEY].clone()}


def baseline_ce_job(in_dir: str) -> dict:
    from dlsg_tpu_torch.config import tiny_test_config
    from dlsg_tpu_torch.models import CapBaselineModel
    from dlsg_tpu_torch.ops import linear
    from dlsg_tpu_torch.parallel import dist
    from dlsg_tpu_torch.train.optim import TrainState, make_optimizer
    from dlsg_tpu_torch.train.steps import make_ce_train_step

    cfg = tiny_test_config(dropout=0.0)
    data = np.load(os.path.join(in_dir, "batch.npz"))
    b = data["captions"].shape[0] // dist.world_size()
    rows = slice(dist.rank() * b, (dist.rank() + 1) * b)
    model = CapBaselineModel(cfg, V, device="cpu")
    model.load_state_dict(torch.load(os.path.join(in_dir, "weights.pt"), weights_only=True))
    state = TrainState.create(model, make_optimizer(LR))
    with patched((linear, "dropout", lambda x, rate, rng: x)):
        state, m = make_ce_train_step(model, cfg)(state, {k: data[k][rows] for k in data.files}, KEY, 1.0)
    return {"g_mu": state.first_moments(), "g_params": model.state_dict(),
            "metrics": {k: _np(v) for k, v in m.items()}}


def distributed_job(job: str, in_dir: str) -> dict:
    from dlsg_tpu_torch.parallel import dist

    if "RANK" in os.environ:
        dist.init_distributed("cpu", timeout=datetime.timedelta(seconds=60))
    try:
        if job == "trainer":
            return trainer_job(in_dir)
        if job == "run":
            return run_job(in_dir)
        if job == "glove":
            return glove_job(in_dir)
        if job == "baseline_ce":
            return baseline_ce_job(in_dir)
        return steps_job(in_dir, only_gan=job == "gan")
    finally:
        if dist.is_distributed():
            torch.distributed.destroy_process_group()


def main() -> None:
    job, in_dir, out_file = sys.argv[1:4]
    torch.set_num_threads(1)
    result = f64_job(in_dir) if job == "gan_f64" else distributed_job(job, in_dir)
    result["foreign_modules"] = sorted(
        n for n in sys.modules if n.split(".")[0] in ("jax", "flax", "dlsg_tpu"))
    torch.save(result, out_file)
    print("WORKER OK", flush=True)


if __name__ == "__main__":
    main()
