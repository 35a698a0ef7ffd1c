"""dlsg_tpu_torch's caption metrics against dlsg_tpu's.

Both packages take their C++ tokenizer and METEOR aligner for ASCII text
(tests/test_native.py and tests/test_torch_native.py hold each to its
Python code). Scores are compared within 1e-9 on every key, corpus and per
video."""

import numpy as np
import pytest

from dlsg_tpu.config import tiny_test_config as jax_tiny
from dlsg_tpu.data.synthetic import SyntheticDataset as JaxSyntheticDataset
from dlsg_tpu.data.synthetic import make_vocab as jax_make_vocab
from dlsg_tpu.metrics import meteor as jmeteor
from dlsg_tpu.metrics import scorer as jscorer
from dlsg_tpu.metrics import tokenizer as jtokenizer
from dlsg_tpu_torch.metrics import meteor, scorer, tokenizer

KEYS = ("Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4", "METEOR", "ROUGE_L", "CIDEr")


def _references_and_hypotheses(seed):
    """Synthetic references (3 per video) and random hypotheses over the same
    words: empty, one-word, short and 26-token captions."""
    cfg = jax_tiny(max_words=26)
    vocab = jax_make_vocab(extra_words=10)
    ds = JaxSyntheticDataset(cfg, vocab, num_videos=12, captions_per_video=3, seed=seed)
    refs = {vid: [{"caption": c} for c in caps] for vid, caps in ds.references.items()}
    rng = np.random.default_rng(seed)
    words = vocab.idx2word[4:]
    lengths = [0, 1, 26, 26] + list(rng.integers(2, 12, size=8))
    hyps = {
        vid: " ".join(rng.choice(words, size=n)) for vid, n in zip(refs, lengths)
    }
    hyps["3"] = ds.references["3"][0]  # one exact match
    return refs, hyps


@pytest.mark.parametrize("seed", [0, 1])
def test_coco_scorer_matches_jax(seed):
    refs, hyps = _references_and_hypotheses(seed)
    pred = {k: [{"video_id": k, "caption": v}] for k, v in hyps.items()}
    ids = list(pred)
    got, want = scorer.COCOScorer(), jscorer.COCOScorer()
    g, _ = got.score(refs, pred, ids)
    w, _ = want.score(refs, pred, ids)
    assert set(g) == set(w) == set(KEYS)
    for k in KEYS:
        assert g[k] == pytest.approx(w[k], abs=1e-9), k
    assert set(got.imgToEval) == set(want.imgToEval)
    for vid, row in want.imgToEval.items():
        for k in KEYS:
            assert got.imgToEval[vid][k] == pytest.approx(row[k], abs=1e-9), (vid, k)
    assert w["CIDEr"] > 0 and w["METEOR"] > 0  # the cases are not all misses


def test_score_captions_matches_jax():
    refs, hyps = _references_and_hypotheses(2)
    got, want = scorer.score_captions(refs, hyps), jscorer.score_captions(refs, hyps)
    for k in KEYS:
        assert got[k] == pytest.approx(want[k], abs=1e-9), k


def test_load_references_txt_matches_jax(tmp_path):
    path = tmp_path / "refs.txt"
    path.write_text(
        "7010\ta man is playing a guitar\n7010\tsomeone plays guitar.\n"
        "no tab on this line\n7011\tla café est ouverte \n7012\ta dog\truns\n"
    )
    got = scorer.load_references_txt(str(path))
    assert got == jscorer.load_references_txt(str(path))
    assert got["7011"][0]["caption"] == "la caf est ouverte"
    assert [c["cap_id"] for c in got["7010"]] == [0, 1]


def test_tokenizer_matches_jax_on_the_fixture_corpus():
    """The tokenizer fixture (PTB cases: clitics, brackets, quotes,
    abbreviations, unicode) tokenizes alike in both packages."""
    import os

    path = os.path.join(os.path.dirname(__file__), "fixtures", "tokenizer_corpus.tsv")
    sents = [ln.split("\t")[0] for ln in open(path, encoding="utf-8") if ln.strip()]
    assert len(sents) > 50
    for s in sents:
        assert tokenizer.ptb_tokenize_line(s) == jtokenizer.ptb_tokenize_line(s), s
    caps = {"1": [{"caption": s} for s in sents[:20]], "2": sents[20:25]}
    assert tokenizer.tokenize_captions(caps) == jtokenizer.tokenize_captions(caps)


def test_meteor_custom_tables_are_the_jax_parser(tmp_path):
    """The official-resource parser reads each line as JAX's does; a loaded
    file becomes the port's stage-3 tables and changes its scores; None
    restores the shipped tables."""
    lines = [
        "0.9 ||| big dog ||| hound", "[NN] ||| blorp ||| zint ||| PPDB2.0Score=3.1 ||| 0-0",
        "guitar\tlute\t0.2", "no separators here", "a ||| b ||| c ||| d", "x ||| x",
    ]
    for ln in lines:
        assert meteor._parse_official_line(ln) == jmeteor._parse_official_line(ln), ln
    path = tmp_path / "para.txt"
    path.write_text("\n".join(lines) + "\n")
    before = meteor.score_pair("a blorp plays the lute", ["a zint plays the guitar"])
    try:
        counts = meteor.load_paraphrase_file(str(path), min_score=0.5)
        assert counts == {"word_pairs": 1, "phrase_pairs": 1, "lines_skipped": 3,
                          "native_synced": 1}
        assert meteor.get_paraphrase_table() == {"blorp": {"zint"}, "zint": {"blorp"}}
        assert meteor.get_phrase_table() == {"big dog": {"hound"}, "hound": {"big dog"}}
        assert meteor.score_pair("a blorp plays the lute", ["a zint plays the guitar"]) > before
    finally:
        meteor.set_paraphrase_table(None)
        meteor.set_phrase_table(None)
    assert meteor.score_pair("a blorp plays the lute", ["a zint plays the guitar"]) == before
    assert meteor.get_phrase_table() == jmeteor._load_phrases_file(jmeteor._PHRASES_PATH)
