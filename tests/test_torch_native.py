"""dlsg_tpu_torch's C++ tokenizer, stemmer and METEOR aligner
(`dlsg_tpu_torch/native`) against the port's Python implementations and
against dlsg_tpu's build of the same source (tests/test_native.py's cases).

The Python path is chosen by replacing the library's `ptb_tokenize` and
`meteor_stats` with functions that return None (`python_path`), never by a
failed build: a compiler that fails raises. Tokens and stems must be equal;
METEOR statistics equal within 1e-12 and the seven COCO scores equal exactly
(both engines sum the same terms in the same order)."""

import contextlib
import os
import random
import string

import pytest

from dlsg_tpu import native as jnative
from dlsg_tpu.metrics import meteor as jmeteor
from dlsg_tpu.metrics import scorer as jscorer
from dlsg_tpu.metrics import tokenizer as jtokenizer
from dlsg_tpu_torch import native
from dlsg_tpu_torch.metrics import meteor, scorer, stemmer, tokenizer
from test_native import SENTENCES, WORDS
from test_torch_metrics import KEYS, _references_and_hypotheses

STATS = ("wp_num", "wp_den", "wr_num", "wr_den", "chunks", "raw_matches")
PAIRS = [
    ("a man plays guitar", "the man playing a guitar"),
    ("a dog runs fast", "the dog is running quickly"),
    ("identical sentence here", "identical sentence here"),
    ("totally different words", "nothing matches at all"),
    ("", "a reference"),
    ("a lot of people are dancing", "many people are dancing"),
    ("the man sits down on a chair", "a man sits near a chair"),
    ("lots of cars on the road", "a lot of cars on a road"),
    ("a group of kids picks up the ball", "several kids grabs a ball"),
]
# rich in duplicates, stems, table words and phrase-table constituents
FUZZ_VOCAB = (
    "a the man guy woman dog cat runs running run walks walking quickly "
    "slow slices cutting cuts chop guitar piano plays playing ball park "
    "kid child children is are and on in big large small "
    "lot of lots many sits down stands up next to beside gets out into "
    "exits people group several couple two pair front top"
).split()


@contextlib.contextmanager
def python_path():
    """Tokenize and align through the Python implementations in the block."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(native, "ptb_tokenize", lambda line, lowercase=True: None)
        mp.setattr(native, "meteor_stats", lambda hyp, ref: None)
        yield


def _fuzz_strings(n, seed):
    alphabet = string.ascii_lowercase + string.digits + " .,;:!?'\"()-&%$#@{}[]/*"
    words = ["don't", "it's", "u.s.", "2,500", "10:30", "a&b", "...", "--", "cat", "dog's",
             "dogs'", "(hi)", '"q"', "'x'", "e.g.", "3.5", "and/or", "colour", "theatre",
             "honours.", "tsp.", "calif.", "((((((((((((((((((((((((((((((((((("]
    rng = random.Random(seed)
    for _ in range(n):
        if rng.random() < 0.5:
            yield "".join(rng.choices(alphabet, k=rng.randint(0, 60)))
        else:
            yield " ".join(rng.choices(words, k=rng.randint(1, 12)))


def _stats(hyp, ref):
    st = meteor._segment_stats(hyp.split(), ref.split())
    return tuple(getattr(st, a) for a in STATS)


def _assert_stats_equal(got, want, what):
    for a, g, w in zip(STATS, got, want):
        assert g == pytest.approx(w, abs=1e-12), (what, a, g, w)


def _corpus():
    path = os.path.join(os.path.dirname(__file__), "fixtures", "tokenizer_corpus.tsv")
    return [ln.rstrip("\n").split("\t") for ln in open(path, encoding="utf-8")]


def test_tokenizer_cpp_python_and_jax_agree():
    lines = SENTENCES + [s for s, _ in _corpus()] + list(_fuzz_strings(300, seed=3))
    for abbr in sorted(tokenizer.ABBREVIATIONS):
        lines += [f"a {abbr} b", f"see the {abbr}"]
    for s in lines:
        cpp = tokenizer.ptb_tokenize_line(s)
        with python_path():
            py = tokenizer.ptb_tokenize_line(s)
        assert cpp == py == jtokenizer.ptb_tokenize_line(s), (s, cpp, py)
    for s, expect in _corpus():  # the locked tokenizations, on both paths
        want = expect.split(" ") if expect else []
        assert tokenizer.ptb_tokenize_line(s) == want, s
        with python_path():
            assert tokenizer.ptb_tokenize_line(s) == want, s


def test_stemmer_cpp_python_and_jax_agree():
    for w in WORDS + FUZZ_VOCAB:
        want = stemmer.porter2_stem(w)
        assert native.porter2_stem(w) == want, w
        if jnative.available():
            assert jnative.porter2_stem(w) == want, w
    assert native.porter2_stem("café") is None  # non-ASCII: the Python stemmer


def test_meteor_stats_cpp_python_and_jax_agree():
    rng = random.Random(7)
    pairs = PAIRS + [
        (" ".join(rng.choices(FUZZ_VOCAB, k=rng.randint(1, 14))),
         " ".join(rng.choices(FUZZ_VOCAB, k=rng.randint(1, 14))))
        for _ in range(400)
    ]
    for hyp, ref in pairs:
        assert native.meteor_stats(hyp, ref) is not None
        cpp = _stats(hyp, ref)
        with python_path():
            py = _stats(hyp, ref)
        st = jmeteor._segment_stats(hyp.split(), ref.split())
        _assert_stats_equal(cpp, py, (hyp, ref, "python"))
        _assert_stats_equal(cpp, tuple(getattr(st, a) for a in STATS), (hyp, ref, "jax"))


def test_coco_scores_cpp_python_and_jax_agree():
    """The seven scores of the port's C++ path equal its Python path's and
    the JAX package's, exactly, corpus and per video."""
    for seed in (0, 1):
        refs, hyps = _references_and_hypotheses(seed)
        hyps["4"] = "a man — plays the guitar"  # non-ASCII: the Python route
        pred = {k: [{"video_id": k, "caption": v}] for k, v in hyps.items()}
        ids = list(pred)
        cpp = scorer.COCOScorer()
        got, _ = cpp.score(refs, pred, ids)
        py = scorer.COCOScorer()
        with python_path():
            want, _ = py.score(refs, pred, ids)
        jax_scores, _ = jscorer.COCOScorer().score(refs, pred, ids)
        assert set(got) == set(KEYS)
        for k in KEYS:
            assert got[k] == want[k] == jax_scores[k], (seed, k)
        assert cpp.imgToEval == py.imgToEval


def test_custom_tables_are_mirrored_into_the_library(tmp_path):
    """A loaded paraphrase file reaches the C++ aligner (the fast path stays
    on and agrees with Python on the new pairs); restoring the shipped tables
    restores the library's."""
    path = tmp_path / "para.txt"
    path.write_text("blorp ||| zint ||| 0.9\nbig dog ||| hound\n")
    hyp, ref = "a blorp sees a big dog", "the zint sees a hound"
    before = _stats(hyp, ref)
    try:
        info = meteor.load_paraphrase_file(str(path))
        assert info["native_synced"] == 1
        after = _stats(hyp, ref)
        with python_path():
            _assert_stats_equal(after, _stats(hyp, ref), "custom tables")
        assert after[0] > before[0]  # the new pairs match
    finally:
        meteor.set_paraphrase_table(None)
        meteor.set_phrase_table(None)
    _assert_stats_equal(_stats(hyp, ref), before, "restored tables")


def test_a_broken_compiler_raises_and_does_not_score_in_python(monkeypatch):
    monkeypatch.setenv("CXX", "false")
    monkeypatch.setattr(native, "_lib", None)
    assert not native.library_path().exists()
    with pytest.raises(RuntimeError, match="could not be built"):
        native.load()
    with pytest.raises(RuntimeError, match="could not be built"):
        meteor.score_pair("a man plays", ["a man plays a guitar"])
    with pytest.raises(RuntimeError, match="could not be built"):
        tokenizer.ptb_tokenize_line("a man plays.")
    with python_path():  # the explicit Python path still scores
        assert meteor.score_pair("a man plays", ["a man plays"]) > 0.95
