"""dlsg_tpu_torch's `Vocabulary.build_from_references` against
dlsg_tpu's: the same `word2idx` (every word at the same id) from the input
of tests/test_utils_aux.py:31-40 and from tests/fixtures/tokenizer_corpus.tsv
(whose lines are `text<TAB>tokenized text`: `build_from_references` reads
what follows the first tab), at min_count 1 and 2. Exact."""

import os

import pytest

from dlsg_tpu.vocab import Vocabulary as JaxVocabulary
from dlsg_tpu_torch.vocab import UNK_ID, Vocabulary

CORPUS = os.path.join(os.path.dirname(__file__), "fixtures", "tokenizer_corpus.tsv")
UTILS_AUX_REFS = "1\tA man plays guitar.\n1\tthe man is playing\n2\ta dog runs\n"


@pytest.fixture
def references(tmp_path):
    path = tmp_path / "refs.txt"
    path.write_text(UTILS_AUX_REFS + "3\ta man sits\nno tab: this line is skipped\n"
                    "4\tA man, a dog... and a guitar!\n")
    return {"utils_aux": str(path), "corpus": CORPUS}


@pytest.mark.parametrize("min_count", [1, 2])
@pytest.mark.parametrize("source", ["utils_aux", "corpus"])
def test_word2idx_equals_jax(references, source, min_count):
    got = Vocabulary.build_from_references(references[source], min_count=min_count)
    want = JaxVocabulary.build_from_references(references[source], min_count=min_count)
    assert got.word2idx == want.word2idx
    assert got.idx2word == want.idx2word and len(got) == len(want)


def test_build_from_references_as_tests_test_utils_aux(references):
    """tests/test_utils_aux.py:31-40's assertions hold for the port, and a
    word seen once leaves at min_count 2."""
    v = Vocabulary.build_from_references(references["utils_aux"])
    assert v("man") != UNK_ID and v("guitar") != UNK_ID
    assert v("zebra") == UNK_ID
    assert "." not in v.word2idx and "," not in v.word2idx
    v2 = Vocabulary.build_from_references(references["utils_aux"], min_count=2)
    assert v2("man") != UNK_ID and v2("zebra") == UNK_ID and v2("plays") == UNK_ID
