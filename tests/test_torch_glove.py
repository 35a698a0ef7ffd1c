"""dlsg_tpu_torch's GloVe import (models/glove.py) against dlsg_tpu's, and its
use in the trainers: RunGAN and Run graft the matrix into the generator's
word embedding when they are built (RunLegacy does not, as in JAX), and
`freeze_word_embed` keeps it out of the optimizer
(tests/test_trainer.py:218,251 hold the JAX trainer to the same).

Every comparison is exact: the matrix is float64 and its fallback rows are
N(0, 0.6) draws of `np.random.default_rng(seed)` in both packages, and the
grafted embedding is that matrix rounded to fp32.
"""

import numpy as np
import pytest
import torch

from dlsg_tpu.models.glove import graft_word_embedding as jax_graft
from dlsg_tpu.models.glove import load_glove_matrix as jax_load
from dlsg_tpu.vocab import Vocabulary as JaxVocabulary
import dlsg_tpu_torch.train.trainer as ttrainer
from dlsg_tpu_torch.config import tiny_test_config
from dlsg_tpu_torch.data.synthetic import SyntheticDataset, make_vocab
from dlsg_tpu_torch.models import CapBaseline1
from dlsg_tpu_torch.models.glove import WORD_EMBED_KEY, graft_word_embedding, load_glove_matrix
from dlsg_tpu_torch.vocab import Vocabulary
from dlsg_tpu_torch.weights import params_to_jax
from test_torch_parallel import collect_ranks, launch_ranks
from test_torch_trainer import TINY
from test_torch_train_steps import one_torch_thread  # noqa: F401  (autouse)

WORDS = ["man", "dog,", "plays", "cat", "guitar"]


def _vector(word, word_size):
    """The text of `word`'s vector in the file: 0.1 * (i + 1) + 0.01 * len(word)."""
    return [f"{0.1 * (i + 1) + 0.01 * len(word):.3f}" for i in range(word_size)]


def _write_glove(path, words, word_size):
    """A GloVe text file: `_vector` of each of `words`, a line of the wrong
    width, a word out of the vocabulary."""
    lines = [" ".join([w] + _vector(w, word_size)) for w in words]
    lines += ["short 1.0", "zebra " + " ".join(["0.5"] * word_size)]
    path.write_text("\n".join(lines) + "\n")


@pytest.mark.parametrize("seed", [0, 3])
def test_load_glove_matrix_is_bitwise_jax(tmp_path, seed):
    """The file's rows (the vocabulary's `dog,` read as `dog`), the fallback
    rows of the missing words, and the .npy cache: its hit returns the same
    bits, and each package reads the other's cache."""
    _write_glove(tmp_path / "glove.txt", ["man", "dog", "guitar"], 4)
    words = WORDS + ["hat"]
    want = jax_load(JaxVocabulary.from_words(words), 4, str(tmp_path / "glove.txt"),
                    cache_npy_path=str(tmp_path / "jax" / "c.npy"), seed=seed)
    vocab = Vocabulary.from_words(words)
    got = load_glove_matrix(vocab, 4, str(tmp_path / "glove.txt"),
                            cache_npy_path=str(tmp_path / "port" / "c.npy"), seed=seed)
    assert got.dtype == want.dtype == np.float64 and got.shape == (len(vocab), 4)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[vocab("dog,")], np.float64(_vector("dog", 4)))
    np.testing.assert_array_equal(
        load_glove_matrix(vocab, 4, "missing.txt", cache_npy_path=str(tmp_path / "port" / "c.npy")),
        want)  # a cache hit reads no text file
    np.testing.assert_array_equal(
        load_glove_matrix(vocab, 4, "missing.txt", cache_npy_path=str(tmp_path / "jax" / "c.npy")),
        want)


def test_graft_matches_jax(tmp_path):
    cfg = tiny_test_config()
    model = CapBaseline1(cfg, 30, device="cpu")
    matrix = np.random.default_rng(1).normal(size=(30, cfg.word_size))
    params = model.state_dict()
    grafted = graft_word_embedding(params, matrix)
    want = jax_graft(params_to_jax(params), matrix)
    np.testing.assert_array_equal(params_to_jax(grafted)["decoder"]["step"]["word_embed"]["embedding"],
                                  np.asarray(want["decoder"]["step"]["word_embed"]["embedding"]))
    assert grafted[WORD_EMBED_KEY].dtype == torch.float32
    assert all(grafted[k] is v for k, v in params.items() if k != WORD_EMBED_KEY)
    with pytest.raises(ValueError, match="does not fit"):
        graft_word_embedding(model.state_dict(), matrix[:5])


def _runner(trainer, tmp_path, **kw):
    vocab = make_vocab()
    known = [w for w in vocab.idx2word if not w.startswith("<")][:4]
    cfg = tiny_test_config(epoch_num=1, result_dir=str(tmp_path / "results"), use_glove=True,
                           glove_txt_path=str(tmp_path / "glove.txt"), data_dir=str(tmp_path),
                           **TINY, **kw)
    _write_glove(tmp_path / "glove.txt", known, cfg.word_size)
    ds = SyntheticDataset(cfg, vocab, num_videos=8, captions_per_video=2)
    runner = getattr(ttrainer, trainer)(cfg, vocab, ds, ds.eval_view(), ds.references, device="cpu")
    want = jax_load(JaxVocabulary.from_idx2word(vocab.idx2word), cfg.word_size, str(tmp_path / "glove.txt"))
    return runner, known, want


@pytest.mark.parametrize("trainer", ["RunGAN", "Run", "RunLegacy"])
def test_trainers_graft_the_file_rows(trainer, tmp_path):
    """RunGAN and Run: every embedding row is JAX's matrix in fp32 (the
    file's vectors, the fallback draws elsewhere) and the matrix was
    cached; RunLegacy keeps its seeded embedding, as JAX's does."""
    runner, known, want = _runner(trainer, tmp_path)
    emb = runner.gen_model.state_dict()[WORD_EMBED_KEY]
    vocab = runner.vocab
    if trainer == "RunLegacy":
        assert not np.array_equal(emb.numpy(), want.astype(np.float32))
        return
    np.testing.assert_array_equal(emb.numpy(), want.astype(np.float32))
    for w in known:
        np.testing.assert_array_equal(emb[vocab(w)].numpy(),
                                      np.float64(_vector(w, runner.cfg.word_size)).astype(np.float32))
    assert (tmp_path / f"{runner.cfg.dataset}_glove.npy").exists()


@pytest.mark.parametrize("trainer", ["RunGAN", "Run"])
def test_frozen_glove_embedding_survives_training(trainer, tmp_path):
    """freeze_word_embed: the grafted embedding is bitwise unchanged after an
    epoch, and has no Adam state, while the other parameters move."""
    runner, _, want = _runner(trainer, tmp_path, freeze_word_embed=True)
    before = {k: v.clone() for k, v in runner.gen_model.state_dict().items()}
    runner.train()
    after = runner.gen_model.state_dict()
    assert runner.gen_state.step == 4
    assert torch.equal(after[WORD_EMBED_KEY], before[WORD_EMBED_KEY])
    np.testing.assert_array_equal(after[WORD_EMBED_KEY].numpy(), want.astype(np.float32))
    assert WORD_EMBED_KEY not in runner.gen_state.first_moments()
    moved = [k for k in before if k != WORD_EMBED_KEY and not torch.equal(after[k], before[k])]
    assert len(moved) > len(before) // 2


def test_two_ranks_graft_the_leaders_rows(tmp_path):
    """Over two gloo ranks only the leader reads the file and writes the
    cache; the other rank holds the same rows after the broadcast."""
    vocab = make_vocab()
    known = [w for w in vocab.idx2word if not w.startswith("<")][:4]
    word_size = tiny_test_config().word_size
    _write_glove(tmp_path / "glove.txt", known, word_size)
    got = collect_ranks(launch_ranks("glove", tmp_path), "glove", tmp_path, timeout=300)
    want = jax_load(JaxVocabulary.from_idx2word(vocab.idx2word), word_size, str(tmp_path / "glove.txt"))
    for r in got:
        np.testing.assert_array_equal(r["embedding"].numpy(), want.astype(np.float32))
    assert [p.name for p in tmp_path.glob("*_glove.npy")] == ["msvd_glove.npy"]
