"""dlsg_tpu_torch's worker pool (`data/parallel_loader.py`) on HDF5 files in
the reference's layout (fabricated as tests/test_cli_realdata.py does).

Batches from 2 spawned workers must equal `train_batches` and dlsg_tpu's
`train_batches` bitwise, in order, over 2 epochs; an epoch left mid-way must
not stall the next one or `close()` (each within a time limit), and no
worker or shared-memory file may outlive `close()`; `RunGAN` with 2 workers
must train an epoch to the same parameters, bitwise, as in-process."""

import os
import threading
from dataclasses import replace

import pytest
import torch

from dlsg_tpu.config import parse_opt as jax_parse_opt
from dlsg_tpu.data import datasets as jdatasets
from dlsg_tpu.data import loader as jloader
from dlsg_tpu_torch.config import parse_opt
from dlsg_tpu_torch.data import datasets, loader
from dlsg_tpu_torch.data.parallel_loader import WorkerPool
from dlsg_tpu_torch.metrics.scorer import load_references_txt
from dlsg_tpu_torch.train import trainer as trainer_mod
from dlsg_tpu_torch.train.trainer import RunGAN
from dlsg_tpu_torch.vocab import Vocabulary
from test_cli_realdata import TINY_FLAGS, _fabricate_data_dir
from test_torch_data import _equal_batches
from test_torch_train_steps import one_torch_thread  # noqa: F401  (autouse)

TIME_LIMIT_S = 120


def _argv(root):
    # TINY_FLAGS without the mesh flags: one process, one device
    return ["--dataset", "msvd", "--data_dir", str(root)] + TINY_FLAGS[4:]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    _fabricate_data_dir(root)
    return root


def _within(fn, what):
    """Run fn in a thread; fail if it takes longer than TIME_LIMIT_S."""
    out, err = [], []

    def run():
        try:
            out.append(fn())
        except BaseException as e:  # re-raised in the test's thread
            err.append(e)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(TIME_LIMIT_S)
    assert not t.is_alive(), f"{what} did not finish within {TIME_LIMIT_S} s"
    if err:
        raise err[0]
    return out[0]


def _torch_shm():
    shm = "/dev/shm"
    return {n for n in os.listdir(shm) if n.startswith("torch_")} if os.path.isdir(shm) else set()


def test_pool_batches_equal_train_batches_and_jax(data):
    cfg, jcfg = parse_opt(_argv(data)), jax_parse_opt(_argv(data))
    ds, jds = datasets.CaptionDataset(cfg), jdatasets.CaptionDataset(jcfg)
    with WorkerPool(ds, 4, num_workers=2) as pool:
        for epoch in (0, 1):
            got = _within(lambda: list(pool.epoch_batches(seed=1, epoch=epoch)), f"epoch {epoch}")
            want = list(loader.train_batches(ds, 4, seed=1, epoch=epoch))
            jwant = list(jloader.train_batches(jds, 4, seed=1, epoch=epoch))
            assert len(got) == len(want) == len(jwant) == 3
            for g, w, j in zip(got, want, jwant):
                _equal_batches(g, w)
                _equal_batches(g, j)
                assert all(g[k].dtype == w[k].dtype for k in w)
        # a sharded epoch with its remainder kept
        kw = dict(seed=2, epoch=3, shard_index=1, num_shards=2, drop_remainder=False)
        got = _within(lambda: list(pool.epoch_batches(**kw)), "sharded epoch")
        want = list(loader.train_batches(ds, 4, **kw))
        assert [len(b["captions"]) for b in got] == [4, 2]
        for g, w in zip(got, want):
            _equal_batches(g, w)


def test_eval_set_through_the_pool_and_its_range_check(data):
    cfg = parse_opt(_argv(data))
    ev = datasets.EvalVideoDataset(cfg)
    with WorkerPool(ev, 2, num_workers=1) as pool:
        got = _within(lambda: list(pool.epoch_batches(seed=0)), "eval epoch")
    for g, w in zip(got, loader.train_batches(ev, 2, seed=0)):
        _equal_batches(g, w)
    ev.eval_list = (4, 4)  # not one contiguous range: a worker would rebuild (4, 5)
    with pytest.raises(ValueError, match="contiguous"):
        ev.spawn_spec()


def test_abandoned_epoch_then_the_next_then_close(data):
    """One batch of epoch 0 is read, the rest left queued in the workers;
    epoch 1 must still come out whole and right, and close() must return
    with the workers gone and no shared-memory file left."""
    cfg = parse_opt(_argv(data))
    ds = datasets.CaptionDataset(cfg)
    shm_before = _torch_shm()
    pool = WorkerPool(ds, 2, num_workers=2)
    try:
        first = _within(lambda: next(pool.epoch_batches(seed=5, epoch=0)), "first batch")
        _equal_batches(first, next(loader.train_batches(ds, 2, seed=5, epoch=0)))
        got = _within(lambda: list(pool.epoch_batches(seed=5, epoch=1)), "the epoch after")
        want = list(loader.train_batches(ds, 2, seed=5, epoch=1))
        assert len(got) == len(want) == 6
        for g, w in zip(got, want):
            _equal_batches(g, w)
        next(pool.epoch_batches(seed=5, epoch=2))  # abandoned again, just before close()
        workers = list(pool._loader._iterator._workers)
    finally:
        _within(pool.close, "close()")
    assert workers and not any(w.is_alive() for w in workers)
    del first, got
    assert _torch_shm() <= shm_before
    with pytest.raises(RuntimeError, match="closed"):
        pool.epoch_batches()


def test_rungan_with_two_workers_trains_like_in_process(data, tmp_path, monkeypatch):
    """One tiny GAN epoch on the HDF5 files with loader_workers=2 and 0:
    the same parameters, bitwise (the same batches in the same order)."""
    pools = []

    class CountedPool(WorkerPool):
        def epoch_batches(self, **kw):
            pools.append(self)
            return super().epoch_batches(**kw)

    monkeypatch.setattr(trainer_mod, "WorkerPool", CountedPool)
    states = []
    for workers in (0, 2):
        cfg = replace(parse_opt(_argv(data) + ["--epoch_num", "1"]), loader_workers=workers,
                      result_dir=str(tmp_path / f"w{workers}"))
        vocab = Vocabulary.load_reference_pkl(cfg.vocab_pkl_path)
        runner = RunGAN(cfg, vocab, datasets.CaptionDataset(cfg), datasets.EvalVideoDataset(cfg),
                        load_references_txt(cfg.test_reference_txt_path), device="cpu")
        _within(runner.train, f"RunGAN with {workers} workers")
        assert runner._worker_pool is None  # train() closed it
        assert runner.gen_state.step == 3
        states.append({**{f"G.{k}": v for k, v in runner.gen_model.state_dict().items()},
                       **{f"D.{k}": v for k, v in runner.disc_model.state_dict().items()}})
    assert len(pools) == 1  # the 2-worker run read its epoch from the pool
    assert states[0].keys() == states[1].keys()
    for k, v in states[0].items():
        torch.testing.assert_close(states[1][k], v, rtol=0, atol=0, msg=k)
