"""dlsg_tpu_torch's data pipeline against dlsg_tpu's: the synthetic dataset,
the epoch order, the train and eval batchers (synthetic data and the
reference's h5/pkl layout), and the host -> device prefetcher on the CPU.
Everything here is compared bitwise."""

import os
import threading

import h5py
import numpy as np
import pytest
import torch

from dlsg_tpu.config import parse_opt as jax_parse_opt
from dlsg_tpu.config import tiny_test_config as jax_tiny
from dlsg_tpu.data import datasets as jdatasets
from dlsg_tpu.data import loader as jloader
from dlsg_tpu.data import synthetic as jsynthetic
from dlsg_tpu_torch.config import parse_opt, tiny_test_config
from dlsg_tpu_torch.data import datasets, loader, synthetic
from dlsg_tpu_torch.data.prefetch import prefetch_to_device, stage_cast
from test_cli_realdata import TINY_FLAGS, _fabricate_data_dir


def _equal_batches(got, want):
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)


@pytest.mark.parametrize("seed", [0, 3])
def test_synthetic_dataset_matches_jax(seed):
    cfg, jcfg = tiny_test_config(), jax_tiny()
    vocab, jvocab = synthetic.make_vocab(extra_words=5), jsynthetic.make_vocab(extra_words=5)
    assert vocab.idx2word == jvocab.idx2word
    ds = synthetic.SyntheticDataset(cfg, vocab, num_videos=5, captions_per_video=3, seed=seed)
    jds = jsynthetic.SyntheticDataset(jcfg, jvocab, num_videos=5, captions_per_video=3, seed=seed)
    for name in ("frames", "regions", "spatials"):
        np.testing.assert_array_equal(getattr(ds, name), getattr(jds, name), err_msg=name)
    assert ds.references == jds.references
    assert len(ds.samples) == len(jds.samples) == 15
    for (v, cap, n), (jv, jcap, jn) in zip(ds.samples, jds.samples):
        assert (v, n) == (jv, jn)
        np.testing.assert_array_equal(cap, jcap)
    _equal_batches(ds[7], jds[7])
    _equal_batches(ds.eval_view()[4], jds.eval_view()[4])
    assert len(ds.eval_view()) == len(jds.eval_view()) == 5


@pytest.mark.parametrize("n,batch", [(16, 4), (23, 5), (7, 8)])
def test_epoch_batch_indices_match_jax(n, batch):
    for seed in (0, 12):
        for epoch in (0, 1, 5):
            for shards, index in ((1, 0), (2, 1), (3, 2)):
                for drop in (True, False):
                    kw = dict(seed=seed, epoch=epoch, shard_index=index, num_shards=shards,
                              drop_remainder=drop)
                    got = loader.epoch_batch_indices(n, batch, **kw)
                    want = jloader.epoch_batch_indices(n, batch, **kw)
                    assert len(got) == len(want)
                    for g, w in zip(got, want):
                        np.testing.assert_array_equal(g, w)


def test_train_and_eval_batches_match_jax_on_synthetic_data():
    cfg, jcfg = tiny_test_config(), jax_tiny()
    ds = synthetic.SyntheticDataset(cfg, synthetic.make_vocab(), num_videos=6, captions_per_video=2)
    jds = jsynthetic.SyntheticDataset(jcfg, jsynthetic.make_vocab(), num_videos=6, captions_per_video=2)
    for epoch in (0, 1):
        for shards, index in ((1, 0), (2, 1)):
            kw = dict(seed=12, epoch=epoch, shard_index=index, num_shards=shards)
            got = list(loader.train_batches(ds, 4, **kw))
            want = list(jloader.train_batches(jds, 4, **kw))
            assert len(got) == len(want) > 0
            for g, w in zip(got, want):
                _equal_batches(g, w)
    # 6 videos in batches of 4: the second is padded with the last video and
    # its padding rows are marked invalid
    got = list(loader.eval_batches(ds.eval_view(), 4))
    want = list(jloader.eval_batches(jds.eval_view(), 4))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        _equal_batches(g, w)
    np.testing.assert_array_equal(got[1]["valid"], [True, True, False, False])
    np.testing.assert_array_equal(got[1]["video_ids"], [4, 5, 5, 5])
    unpadded = list(loader.eval_batches(ds.eval_view(), 4, shard_index=1, num_shards=2,
                                        pad_to_full=False))
    for g, w in zip(unpadded, jloader.eval_batches(jds.eval_view(), 4, shard_index=1,
                                                   num_shards=2, pad_to_full=False)):
        _equal_batches(g, w)


def test_h5_datasets_and_batches_match_jax(tmp_path):
    """The reference's on-disk layout (fabricated as tests/test_cli_realdata.py
    does): both packages read the same samples and batches."""
    _fabricate_data_dir(tmp_path)
    argv = ["--dataset", "msvd", "--data_dir", str(tmp_path)] + TINY_FLAGS
    cfg, jcfg = parse_opt(argv), jax_parse_opt(argv)
    ds, jds = datasets.CaptionDataset(cfg), jdatasets.CaptionDataset(jcfg)
    assert len(ds) == len(jds) == 12
    _equal_batches(ds[5], jds[5])
    _equal_batches(ds.get_batch([7, 2, 11]), jds.get_batch([7, 2, 11]))
    for epoch in (0, 3):
        for g, w in zip(loader.train_batches(ds, 4, seed=1, epoch=epoch),
                        jloader.train_batches(jds, 4, seed=1, epoch=epoch)):
            _equal_batches(g, w)
    ev, jev = datasets.EvalVideoDataset(cfg), jdatasets.EvalVideoDataset(jcfg)
    assert ev.eval_list == jev.eval_list == (4, 5)
    _equal_batches(ev[1], jev[1])
    got, want = list(loader.eval_batches(ev, 4)), list(jloader.eval_batches(jev, 4))
    assert len(got) == len(want) == 1
    _equal_batches(got[0], want[0])
    np.testing.assert_array_equal(got[0]["valid"], [True, True, False, False])


def test_region_shards_concatenate_like_jax(tmp_path):
    """MSR-VTT's sharded region files are joined into one on first use."""
    cfg = tiny_test_config(dataset="msr-vtt", data_dir=str(tmp_path / "port"))
    jcfg = jax_tiny(dataset="msr-vtt", data_dir=str(tmp_path / "jax"))
    rng = np.random.default_rng(0)
    shards = [(rng.normal(size=(n, 2, 3, 4)), rng.normal(size=(n, 2, 3, 5))) for n in (2, 3)]
    for c in (cfg, jcfg):
        for i, (v, s) in enumerate(shards):
            path = c.region_feature_h5_path.replace(".h5", f"{i}.h5")
            os.makedirs(os.path.dirname(path), exist_ok=True)
            with h5py.File(path, "w") as h5:
                h5.create_dataset(c.region_visual_feats, data=v)
                h5.create_dataset(c.region_spatial_feats, data=s)
    datasets.maybe_concat_region_shards(cfg.region_feature_h5_path, cfg)
    jdatasets.maybe_concat_region_shards(jcfg.region_feature_h5_path, jcfg)
    with h5py.File(cfg.region_feature_h5_path) as a, h5py.File(jcfg.region_feature_h5_path) as b:
        for key in (cfg.region_visual_feats, cfg.region_spatial_feats):
            np.testing.assert_array_equal(a[key][()], b[key][()])
            assert a[key].shape[0] == 5


def _host_batches(n, seed=0):
    rng = np.random.default_rng(seed)
    for i in range(n):
        yield {
            "frames": rng.normal(size=(2, 3, 4)).astype(np.float32),
            "regions": rng.normal(size=(2, 3, 2, 5)).astype(np.float32),
            "captions": rng.integers(0, 9, size=(2, 6)).astype(np.int32),
            "lengths": np.array([3, 6], np.int32),
            "video_ids": np.array([2 * i, 2 * i + 1], np.int32),
        }


def test_prefetch_on_cpu_yields_the_same_batches():
    got = list(prefetch_to_device(_host_batches(5), "cpu"))
    want = list(_host_batches(5))
    assert len(got) == 5
    for g, w in zip(got, want):
        for k in ("frames", "regions", "captions", "lengths"):
            assert torch.is_tensor(g[k]) and g[k].device.type == "cpu"
            np.testing.assert_array_equal(g[k].numpy(), w[k])
        assert isinstance(g["video_ids"], np.ndarray)  # host-only fields stay
        np.testing.assert_array_equal(g["video_ids"], w["video_ids"])
    staged = next(prefetch_to_device(_host_batches(1), "cpu", stage_dtype=torch.bfloat16))
    assert staged["frames"].dtype == torch.bfloat16 and staged["captions"].dtype == torch.int32
    torch.testing.assert_close(staged["regions"], stage_cast(want[0]["regions"], torch.bfloat16))


def test_prefetch_closes_cleanly_when_abandoned():
    closed = threading.Event()

    def endless():
        try:
            yield from _host_batches(10**6)
        finally:
            closed.set()

    before = {t.ident for t in threading.enumerate()}
    it = prefetch_to_device(endless(), "cpu")
    first = next(it)
    assert first["frames"].shape == (2, 3, 4)
    it.close()  # stops and joins the producer thread, which closes the host iterator
    assert closed.wait(timeout=10)
    assert not [t for t in threading.enumerate()
                if t.ident not in before and t.name == "prefetch_to_device"]


def test_prefetch_raises_the_host_iterators_error():
    def failing():
        yield from _host_batches(2)
        raise OSError("disk gone")

    it = prefetch_to_device(failing(), "cpu")
    assert len([next(it), next(it)]) == 2
    with pytest.raises(OSError, match="disk gone"):
        next(it)
