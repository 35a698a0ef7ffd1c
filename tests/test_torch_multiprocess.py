"""dlsg_tpu_torch's RunGAN, evaluate() and CLI over two processes on gloo,
the counterpart of tests/test_multihost.py:55-147.

The 2-rank job runs once for the module (tests/helpers/torch_dp_worker.py,
which imports dlsg_tpu_torch alone): RunGAN for one synthetic epoch of 19
captions at batch 2 (shards of 10 and 9: one rank holds a batch more than
the 4 steps every rank must take), each rank writing under a result
directory of its own; then both ranks resume from rank 0's epoch_0
checkpoint for one more epoch; then evaluate() with the gather over an eval
set of 5 clips (shards of 3 and 2) and of 1 clip (rank 1's shard empty),
held against one process's evaluate() of the same weights here. Then
`torchrun --nproc_per_node=2 -m dlsg_tpu_torch.cli train --distributed` and
`evaluate --distributed` at tiny dims; the CLI's training starts with the
module, beside the trainer job.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from dlsg_tpu_torch.config import tiny_test_config
from dlsg_tpu_torch.data.loader import epoch_batch_indices, eval_batches
from dlsg_tpu_torch.data.synthetic import SyntheticDataset, make_vocab
from dlsg_tpu_torch.evaluation import evaluate, make_decode_fn
from dlsg_tpu_torch.models import CapGnnModel
from test_torch_cli import PORT_FLAGS, SCORES
from test_torch_parallel import REPO, WORLD, collect_ranks, launch_ranks
from test_torch_train_steps import one_torch_thread  # noqa: F401  (autouse)

CAPTIONS, BATCH, STEPS = 19, 2, 4  # 19 // 2 // 2 = 4 steps a rank


def _torchrun(args, log_dir, tag: str) -> subprocess.Popen:
    """Start `torchrun -m dlsg_tpu_torch.cli <args>` over 2 ranks; its output
    goes to log_dir/<tag>.out and .err (files: a pipe nobody reads yet
    could fill and stall it)."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    with open(log_dir / f"{tag}.out", "w") as out, open(log_dir / f"{tag}.err", "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
             str(WORLD), "-m", "dlsg_tpu_torch.cli"] + args,
            env=env, stdout=out, stderr=err, text=True,
        )
    proc.logs = (log_dir / f"{tag}.out", log_dir / f"{tag}.err")
    return proc


def _finish(proc: subprocess.Popen, timeout: float = 300):
    """(returncode, stdout, stderr); a run that hangs is killed at `timeout`."""
    try:
        proc.wait(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return (proc.returncode,) + tuple(f.read_text() for f in proc.logs)


def _cli_flags(result_dir) -> list:
    return ["--synthetic", "--synthetic_videos", "6", "--device", "cpu", "--distributed",
            "--result_dir", str(result_dir)] + PORT_FLAGS


@pytest.fixture(scope="module")
def cli_train(tmp_path_factory):
    """`torchrun -m dlsg_tpu_torch.cli train --distributed`, started before
    the trainer job so that the two run side by side."""
    work = tmp_path_factory.mktemp("dp_cli")
    proc = _torchrun(["train", "--no_debug", "--epoch_num", "1"] + _cli_flags(work), work, "train")
    try:
        yield work, proc
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


@pytest.fixture(scope="module")
def job(tmp_path_factory, cli_train):
    work = tmp_path_factory.mktemp("dp_trainer")
    return work, collect_ranks(launch_ranks("trainer", work), "trainer", work, timeout=600)


def test_shards_are_disjoint_complete_and_equal_in_steps(job):
    _, ranks = job
    for epoch in (0, 1):
        key = f"epoch{epoch}"
        trained = [r[key]["trained"] for r in ranks]
        assert [len(t) for t in trained] == [STEPS * BATCH] * WORLD
        order = np.random.default_rng(12 + 1000 * epoch).permutation(CAPTIONS)
        want = [order[r::WORLD][: STEPS * BATCH].tolist() for r in range(WORLD)]
        assert trained == want
        assert not set(trained[0]) & set(trained[1])
        # the shards partition the epoch; rank 0's holds one batch more than
        # the steps every rank takes
        assert sorted(order[0::WORLD].tolist() + order[1::WORLD].tolist()) == list(range(CAPTIONS))
        shards = [epoch_batch_indices(CAPTIONS, BATCH, seed=12, epoch=epoch, shard_index=r,
                                      num_shards=WORLD) for r in range(WORLD)]
        assert [len(s) for s in shards] == [STEPS + 1, STEPS]


@pytest.mark.parametrize("epoch", [0, 1])
def test_the_ranks_end_each_epoch_bitwise_equal(job, epoch):
    _, (r0, r1) = job
    a, b = r0[f"epoch{epoch}"], r1[f"epoch{epoch}"]
    assert a["steps"] == b["steps"] == [STEPS * (epoch + 1), STEPS * (epoch + 1) * 5]
    for part in ("gen", "disc", "lambda"):
        for name, t in a[part].items():
            assert torch.equal(t, b[part][name]), (part, name)


def test_only_rank_0_writes_logs_results_and_checkpoints(job):
    work, (r0, _) = job
    root0 = work / "results_rank0"
    assert (root0 / "checkpoints" / "epoch_0" / "train.pt").exists()
    assert (root0 / "checkpoints" / "epoch_1" / "train.pt").exists()
    logs = list(root0.glob("*/logs/scalars.jsonl"))
    assert len(logs) == 1 and logs[0].read_text()
    assert r0["epoch0"]["best"] > 0 and list(root0.glob("*/captioning/CIDEr_2.csv"))
    written = [p for p in (work / "results_rank1").rglob("*") if p.is_file()]
    assert written == []


def test_the_epoch_0_checkpoint_resumes_on_both_ranks(job):
    _, ranks = job
    assert [r["resumed_from"] for r in ranks] == [0, 0]
    assert [r["epoch1"]["steps"][0] for r in ranks] == [2 * STEPS, 2 * STEPS]


@pytest.mark.parametrize("clips", [5, 1])
def test_the_eval_gather_equals_one_process(job, clips):
    """Both ranks score the merged set alike, and as one process's
    evaluate() of the same weights scores the whole set (with 1 clip, rank
    1's shard is empty and still joins the gather)."""
    _, ranks = job
    cfg = tiny_test_config(test_batch_size=2, beam_size=2)
    vocab = make_vocab()
    ds = SyntheticDataset(cfg, vocab, num_videos=clips, captions_per_video=2, seed=clips)
    decode = make_decode_fn(CapGnnModel(cfg, len(vocab), device="cpu"), cfg, return_alpha=True,
                            device="cpu")
    scores, results, alpha, _ = evaluate(decode, eval_batches(ds.eval_view(), cfg.test_batch_size),
                                         vocab, ds.references)
    assert [r[f"eval_{clips}"]["shard"] for r in ranks] == [(clips + 1) // 2, clips // 2]
    # the merged set comes in rank order (rank 0's clips 0, 2, 4, then 1, 3),
    # as the JAX package's gather gives it
    order = [v for r in range(WORLD) for v in range(r, clips, WORLD)]
    for r in ranks:
        got = r[f"eval_{clips}"]
        assert got["scores"] == scores
        assert got["results"] == dict(results)
        assert list(got["results"]) == [str(v) for v in order]
        np.testing.assert_array_equal(got["alpha"], alpha[order])


def test_cli_train_and_evaluate_distributed(cli_train):
    """`torchrun -m dlsg_tpu_torch.cli train --distributed --device cpu
    --synthetic` trains and saves; `evaluate --distributed` of the saved
    model prints one score block (rank 0's)."""
    work, proc = cli_train
    rc, out, err = _finish(proc)
    assert rc == 0, out[-3000:] + err[-3000:]
    assert out.count("Epoch-0 lr: ") == 1
    assert (work / "checkpoints" / "epoch_0" / "train.pt").exists()
    rc, out, err = _finish(_torchrun(["evaluate", "--allow_random_params"] + _cli_flags(work),
                                    work, "evaluate"))
    assert rc == 0, out[-3000:] + err[-3000:]
    printed = [ln.split(": ")[0] for ln in out.splitlines() if ln.split(":")[0] in SCORES]
    assert printed == list(SCORES)
    assert out.count("inference time: ") == 1
