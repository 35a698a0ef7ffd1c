"""METEOR metric — native re-implementation.

The reference wraps `meteor-1.5.jar` through a persistent Java subprocess and a
stdio SCORE/EVAL protocol (`caption-eval/pycocoevalcap/meteor/meteor.py:15-84`).
The jar and its ~1GB paraphrase data are NOT shipped in the reference repo
(`.MISSING_LARGE_BLOBS`), so exact jar-output parity is unverifiable even there;
this module implements the published METEOR 1.5 English scoring algorithm
(Denkowski & Lavie 2014) natively:

- match stages — all FOUR of METEOR 1.5's, with its English stage weights
  (1.0, 0.6, 0.8, 0.6): exact > stem (Porter2/Snowball English) > synonym >
  paraphrase. The synonym stage uses a curated caption-domain synonym table
  (`metrics/data/synonyms.txt`, standing in for WordNet 3.0 synsets); the
  paraphrase stage uses a looser word-level equivalence table
  (`metrics/data/paraphrases.txt`) PLUS a multi-word PHRASE table
  (`metrics/data/phrase_paraphrases.txt`, '|||'-separated groups): like
  meteor-1.5's paraphrase stage, a span of hypothesis words can align to a
  span of reference words ("a lot of" ~ "many"), one-to-one at the word
  level, under the same lexicographic alignment objective. Both stand in for
  the unshippable ~1GB paraphrase-en.gz. `set_synonym_table` /
  `set_paraphrase_table` / `set_phrase_table` / `set_function_words` swap in
  custom tables, and `load_paraphrase_file` / `load_synonym_file` /
  `load_function_words_file` (or the $DLSG_METEOR_*_FILE env vars) install
  the OFFICIAL resources when a user has them — custom tables are mirrored
  into the C++ aligner so the native fast path stays active. The remaining
  default-config deviation from the jar is table CONTENT (curated
  caption-domain groups vs PPDB) — see BENCHMARKS.md "METEOR fidelity".
- alignment: the official Aligner's beam search over partial alignments,
  selecting by METEOR's documented objective — MAXIMIZE matched words, then
  MINIMIZE chunks, then MINIMIZE total match distance (Denkowski & Lavie 2011
  §2; meteor-1.5 Aligner.java uses the same beam strategy).
- scoring: weighted P/R with function-word discounting (delta), parameterized
  fmean (alpha), fragmentation penalty (gamma, beta) with the METEOR 1.5
  English defaults alpha=.85, beta=.2, gamma=.6, delta=.75,
  stage weights (1.0, .6, .8, .6).
- a perfect alignment (one chunk covering all of both sentences) carries zero
  fragmentation penalty, so identical sentences score 1.0 — the jar's observed
  behavior (feeding ground truth through coco-caption yields METEOR=1.0).
- corpus score: aggregate statistics over segments (METEOR's 'final score' is
  computed from summed statistics, not a mean of segment scores) — matching the
  jar's EVAL protocol semantics.

The scoring engine is validated against an independent implementation:
`tests/test_metrics.py::test_meteor_matches_nltk_reference` runs NLTK's METEOR
(exact+stem, original 2005 parameters) on a fixture set and asserts equality
when this engine is configured with the same parameters.

A copy of `dlsg_tpu/metrics/meteor.py`. The C++ aligner
(`dlsg_tpu_torch/native`, a copy of the JAX package's) scores ASCII pairs at
the default parameters; this Python version is the reference, with identical
results (tests/test_torch_native.py).
"""

from __future__ import annotations

import gzip
import io
import os
import re
import tempfile
from typing import Dict, List, Optional, Sequence, Tuple

from dlsg_tpu_torch import native
from dlsg_tpu_torch.metrics.stemmer import porter2_stem

# METEOR 1.5 English parameters (Denkowski & Lavie 2014, table 2)
ALPHA, BETA, GAMMA, DELTA = 0.85, 0.2, 0.6, 0.75
STAGE_WEIGHTS = (1.0, 0.6, 0.8, 0.6)  # exact, stem, synonym, paraphrase
BEAM_WIDTH = 40  # meteor-1.5 Aligner.java beam size

# A compact English function-word list (METEOR uses a corpus-derived list).
FUNCTION_WORDS = frozenset(
    """a an the this that these those some any each every no all both half
    i you he she it we they me him her us them my your his its our their
    is am are was were be been being do does did have has had will would
    shall should may might can could must of in on at by for with about
    against between into through during before after above below to from
    up down out off over under again further then once here there when
    where why how and or but if because as until while not so than too
    very s t just don now""".split()
)

_SYNONYMS_PATH = os.path.join(os.path.dirname(__file__), "data", "synonyms.txt")
_PARAPHRASES_PATH = os.path.join(os.path.dirname(__file__), "data", "paraphrases.txt")
_PHRASES_PATH = os.path.join(
    os.path.dirname(__file__), "data", "phrase_paraphrases.txt"
)

_SYNONYM: Optional[Dict[str, frozenset]] = None  # None -> load default file
_PARAPHRASE: Optional[Dict[str, frozenset]] = None
_PHRASE: Optional[Dict[str, frozenset]] = None
_FUNCTION: Optional[frozenset] = None  # None -> the built-in FUNCTION_WORDS
_SYN_CUSTOM = False  # a user-installed table replaces the shipped one
_PARA_CUSTOM = False
_PHRASE_CUSTOM = False
_FW_CUSTOM = False
_IS_DEFAULT_TABLE = True  # native fast path only valid with the shipped tables
# _sync_native() mirrors custom tables into the C++ aligner, which re-validates
# the native fast path even though the tables are non-default
_TABLES_NATIVE_SYNCED = False


def get_function_words() -> frozenset:
    """Current function-word set (delta discounting); default FUNCTION_WORDS."""
    return FUNCTION_WORDS if _FUNCTION is None else _FUNCTION


def _load_groups_file(path: str) -> Dict[str, frozenset]:
    """Parse a groups file (one space-separated equivalence group per line)."""
    table: Dict[str, set] = {}
    if os.path.exists(path):
        with open(path) as f:
            for line in f:
                words = line.split("#")[0].split()
                if len(words) < 2:
                    continue
                for w in words:
                    table.setdefault(w, set()).update(x for x in words if x != w)
    return {k: frozenset(v) for k, v in table.items()}


def get_synonym_table() -> Dict[str, frozenset]:
    """Stage-2 table (weight 0.8) — WordNet-synonymy stand-in."""
    global _SYNONYM
    if _SYNONYM is None:
        _SYNONYM = _load_groups_file(_SYNONYMS_PATH)
    return _SYNONYM


def get_paraphrase_table() -> Dict[str, frozenset]:
    """Stage-3 table (weight 0.6) — word-level paraphrase-en.gz stand-in."""
    global _PARAPHRASE
    if _PARAPHRASE is None:
        _PARAPHRASE = _load_groups_file(_PARAPHRASES_PATH)
    return _PARAPHRASE


def _load_phrases_file(path: str) -> Dict[str, frozenset]:
    """Parse a phrase-groups file: one group of '|||'-separated multi-word
    phrases per line ('a lot of ||| many ||| lots of'); '#' comments."""
    table: Dict[str, set] = {}
    if os.path.exists(path):
        with open(path) as f:
            for line in f:
                phrases = [
                    " ".join(p.split()) for p in line.split("#")[0].split("|||")
                ]
                phrases = [p for p in phrases if p]
                if len(phrases) < 2:
                    continue
                for p in phrases:
                    table.setdefault(p, set()).update(x for x in phrases if x != p)
    return {k: frozenset(v) for k, v in table.items()}


def get_phrase_table() -> Dict[str, frozenset]:
    """Stage-3 PHRASE table (weight 0.6): multi-word span equivalences, the
    span-match side of meteor-1.5's paraphrase stage
    (caption-eval/pycocoevalcap/meteor/meteor.py:12-23, data paraphrase-en.gz)."""
    global _PHRASE
    if _PHRASE is None:
        _PHRASE = _load_phrases_file(_PHRASES_PATH)
    return _PHRASE


_PHRASE_MAX_LEN: Optional[int] = None  # cached longest phrase (in words)


def _phrase_max_len() -> int:
    """Longest phrase in the CURRENT module phrase table — cached so the
    per-alignment span enumeration doesn't rescan GB-scale official tables
    (the C++ side keeps the same cache in phrase_max_len())."""
    global _PHRASE_MAX_LEN
    if _PHRASE_MAX_LEN is None:
        _PHRASE_MAX_LEN = max(
            (len(p.split()) for p in get_phrase_table()), default=0
        )
    return _PHRASE_MAX_LEN


def set_synonym_table(table: Optional[Dict[str, Sequence[str]]]) -> None:
    """Install a custom stage-2 synonym table (word -> equivalents).

    Pass None to restore the shipped default; pass {} to disable stage 2.
    """
    global _SYNONYM, _SYN_CUSTOM
    _SYN_CUSTOM = table is not None
    _SYNONYM = None if table is None else {
        k: frozenset(v) for k, v in table.items()
    }
    _sync_native()


def set_paraphrase_table(table: Optional[Dict[str, Sequence[str]]]) -> None:
    """Install a custom stage-3 paraphrase table (word -> equivalents).

    Pass None to restore the shipped default; pass {} to disable stage 3.
    """
    global _PARAPHRASE, _PARA_CUSTOM
    _PARA_CUSTOM = table is not None
    _PARAPHRASE = None if table is None else {
        k: frozenset(v) for k, v in table.items()
    }
    _sync_native()


def set_phrase_table(table: Optional[Dict[str, Sequence[str]]]) -> None:
    """Install a custom stage-3 PHRASE table (phrase -> equivalent phrases,
    all space-joined word strings). None restores the shipped default; {}
    disables span matching."""
    global _PHRASE, _PHRASE_CUSTOM, _PHRASE_MAX_LEN
    _PHRASE_CUSTOM = table is not None
    _PHRASE = None if table is None else {
        " ".join(k.split()): frozenset(" ".join(x.split()) for x in v)
        for k, v in table.items()
    }
    _PHRASE_MAX_LEN = None
    _sync_native()


def set_function_words(words: Optional[Sequence[str]]) -> None:
    """Install a custom function-word list for delta discounting (METEOR's
    own list is corpus-derived; the built-in is a compact stand-in). None
    restores the built-in; an empty list disables discounting."""
    global _FUNCTION, _FW_CUSTOM
    _FW_CUSTOM = words is not None
    _FUNCTION = None if words is None else frozenset(words)
    _sync_native()


_SYNC_SUSPENDED = False  # batch multiple table installs into one native push
_SYNC_DIR: Optional[str] = None  # one reused temp dir per process (no leak)


def _sync_dir() -> str:
    global _SYNC_DIR
    if _SYNC_DIR is None:
        import atexit
        import shutil

        _SYNC_DIR = tempfile.mkdtemp(prefix="dlsg_meteor_tables_")
        atexit.register(shutil.rmtree, _SYNC_DIR, ignore_errors=True)
    return _SYNC_DIR


def _sync_native() -> None:
    """Make the C++ aligner agree with the CURRENT Python-side tables.

    Default tables: reinstall the shipped files into an already-loaded
    library (a lazily-loaded one installs them itself). Custom tables: push
    the exact Python contents through the native loaders; only on success is
    the native fast path re-validated (_TABLES_NATIVE_SYNCED)."""
    global _IS_DEFAULT_TABLE, _TABLES_NATIVE_SYNCED
    _IS_DEFAULT_TABLE = not (
        _SYN_CUSTOM or _PARA_CUSTOM or _PHRASE_CUSTOM or _FW_CUSTOM
    )
    _TABLES_NATIVE_SYNCED = False
    if _SYNC_SUSPENDED:
        return  # maybe_load_env_tables() syncs once after all its loads
    if _IS_DEFAULT_TABLE:
        native.reload_default_tables()
        return
    lib = native.load()  # raises if the library cannot be built
    tmp = _sync_dir()
    representable = True

    def _write_pairs(name, table, sep=" ", allow_space=False):
        # 2-element groups through the native group loaders are exactly
        # symmetric pairs (no transitive closure); both engines look pairs up
        # in both directions, so one unordered pair per line suffices —
        # asymmetric custom entries become symmetric in BOTH engines already
        nonlocal representable
        pairs = set()
        for a, eq in table.items():
            for b in eq:
                if a != b:
                    pairs.add((a, b) if a <= b else (b, a))
        path = os.path.join(tmp, name)
        with open(path, "w") as f:
            for a, b in sorted(pairs):
                # the C++ group loaders re-tokenize on ANY whitespace, so a
                # tab/newline inside a key would silently change the pair —
                # normalized single-space phrases are the only spaces allowed
                clean = all(
                    "#" not in x and "|" not in x
                    and (" ".join(x.split()) == x if allow_space
                         else x.split() == [x])
                    for x in (a, b)
                )
                if not clean:
                    representable = False  # file format can't express it
                    continue
                f.write(f"{a}{sep}{b}\n")
        return path

    syn = _write_pairs("synonyms.txt", get_synonym_table())
    para = _write_pairs("paraphrases.txt", get_paraphrase_table())
    phr = _write_pairs("phrases.txt", get_phrase_table(), sep=" ||| ",
                       allow_space=True)
    fw_path = os.path.join(tmp, "function_words.txt")
    with open(fw_path, "w") as f:
        for w in sorted(get_function_words()):
            if "#" in w or w.split() != [w]:  # any whitespace re-tokenizes
                representable = False
                continue
            f.write(w + "\n")
    ok = representable and (
        lib.dlsg_meteor_load_synonyms(syn.encode()) >= 0
        and lib.dlsg_meteor_load_paraphrases(para.encode()) >= 0
        and lib.dlsg_meteor_load_phrases(phr.encode()) >= 0
        and lib.dlsg_meteor_load_function_words(fw_path.encode()) >= 0
    )
    if ok:
        _TABLES_NATIVE_SYNCED = True
    else:  # half-loaded native tables must never be consulted: reset them
        native.reload_default_tables()


def _open_maybe_gz(path: str):
    """Open text, transparently gunzipping (sniffs the magic, not the name)."""
    f = open(path, "rb")
    magic = f.read(2)
    f.seek(0)
    if magic == b"\x1f\x8b":
        return io.TextIOWrapper(gzip.GzipFile(fileobj=f), encoding="utf-8",
                                errors="replace")
    return io.TextIOWrapper(f, encoding="utf-8", errors="replace")


_PPDB_SCORE_RE = re.compile(r"PPDB(?:1\.0|2\.0)?Score=([-+0-9.eE]+)")


def _parse_official_line(line: str) -> Optional[Tuple[str, str, Optional[float]]]:
    """One line of an official paraphrase resource -> (phrase1, phrase2, score).

    Accepted shapes (meteor-1.5's paraphrase-en.gz is built from PPDB and
    distributed in the '|||' pair format; the jar itself ships no format spec,
    so the parser is deliberately tolerant):

    - ``p ||| phrase1 ||| phrase2`` / ``phrase1 ||| phrase2 ||| p`` /
      ``phrase1 ||| phrase2`` — any '|||' line with exactly two non-numeric
      fields; numeric fields are read as the pair score (min if several).
    - raw PPDB: ``[LHS] ||| phrase1 ||| phrase2 ||| features ||| alignment``
      (>=4 fields, bracketed first field) — score from the features'
      ``PPDB2.0Score=``/``PPDB1.0Score=`` when present.
    - ``phrase1 <TAB> phrase2 [<TAB> p]`` — tab-separated fallback.
    """
    if "|||" in line:
        fields = [f.strip() for f in line.split("|||")]
        if len(fields) >= 4 and fields[0][:1] == "[" and fields[0][-1:] == "]":
            m = _PPDB_SCORE_RE.search(fields[3])
            return fields[1], fields[2], (float(m.group(1)) if m else None)
    elif "\t" in line:
        fields = [f.strip() for f in line.split("\t")]
    else:
        return None
    phrases, score = [], None
    for f in fields:
        if not f:
            continue
        try:
            v = float(f)
        except ValueError:
            phrases.append(f)
        else:
            score = v if score is None else min(score, v)
    if len(phrases) != 2:
        return None
    return phrases[0], phrases[1], score


def load_paraphrase_file(path: str, min_score: Optional[float] = None) -> Dict[str, int]:
    """Install an OFFICIAL paraphrase resource as the stage-3 tables.

    The reference scores METEOR with meteor-1.5.jar + its ~1GB
    ``paraphrase-en.gz`` (caption-eval/pycocoevalcap/meteor/meteor.py:12-23;
    the data is not shipped — .MISSING_LARGE_BLOBS). When a user has the real
    file (or a raw PPDB dump), this loads it in place of the curated
    caption-domain tables, closing the remaining table-CONTENT delta to the
    jar: single-word pairs go to the word-level paraphrase table, pairs with a
    multi-word side to the phrase span table. The stage-2 synonym table is
    untouched (a distinct WordNet-derived resource in METEOR).

    ``min_score`` drops pairs whose score field (probability or PPDB score —
    whatever the file carries) is below the threshold; pairs without a score
    always load. The parsed tables are also mirrored into the native C++
    aligner so the fast path stays active; pairs its table files cannot hold
    leave the scoring to the Python aligner.

    Returns ``{"word_pairs": n, "phrase_pairs": n, "lines_skipped": n,
    "native_synced": 0|1}``. Memory note: the full paraphrase-en.gz expands to
    a few GB of Python dicts — the jar needed -Xmx2G for the same data.
    """
    global _PARAPHRASE, _PARA_CUSTOM, _PHRASE, _PHRASE_CUSTOM
    word: Dict[str, set] = {}
    phrase: Dict[str, set] = {}
    skipped = 0
    with _open_maybe_gz(path) as f:
        for line in f:
            parsed = _parse_official_line(line.rstrip("\n"))
            if parsed is None:
                skipped += 1
                continue
            p1, p2, score = parsed
            if min_score is not None and score is not None and score < min_score:
                continue
            # scoring tokenizes to lowercase; '#'/'|' would corrupt the table
            # files mirrored to the C++ loader (comment / field separators)
            p1 = " ".join(p1.lower().split())
            p2 = " ".join(p2.lower().split())
            if p1 == p2 or not p1 or not p2 or "#" in p1 + p2 or "|" in p1 + p2:
                skipped += 1
                continue
            tgt = word if (" " not in p1 and " " not in p2) else phrase
            tgt.setdefault(p1, set()).add(p2)
            tgt.setdefault(p2, set()).add(p1)
    # direct install (set_* would push to native once per table)
    global _PHRASE_MAX_LEN
    _PARA_CUSTOM = _PHRASE_CUSTOM = True
    _PARAPHRASE = {k: frozenset(v) for k, v in word.items()}
    _PHRASE = {k: frozenset(v) for k, v in phrase.items()}
    _PHRASE_MAX_LEN = None
    _sync_native()
    return {
        "word_pairs": sum(len(v) for v in word.values()) // 2,
        "phrase_pairs": sum(len(v) for v in phrase.values()) // 2,
        "lines_skipped": skipped,
        "native_synced": int(_TABLES_NATIVE_SYNCED),
    }


def load_synonym_file(path: str, min_score: Optional[float] = None) -> Dict[str, int]:
    """Install an external stage-2 SYNONYM resource (weight 0.8).

    Companion to :func:`load_paraphrase_file` for users with a real
    WordNet-derived synonym list (METEOR 1.5's synonymy module). Accepts the
    shipped groups format (space-separated equivalence groups per line, '#'
    comments) or the same '|||'/tab pair lines as the paraphrase loader
    (multi-word sides are rejected — stage 2 is word-level). Mirrored into
    the C++ aligner like every custom table. Returns
    ``{"word_pairs": n, "lines_skipped": n, "native_synced": 0|1}``."""
    global _SYNONYM, _SYN_CUSTOM
    table: Dict[str, set] = {}
    skipped = 0
    with _open_maybe_gz(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if "|||" in line or "\t" in line:
                parsed = _parse_official_line(line)
                if parsed is None:
                    skipped += 1
                    continue
                p1, p2, score = parsed
                if min_score is not None and score is not None and score < min_score:
                    continue
                words = [p1.lower(), p2.lower()]
            else:
                words = line.split("#")[0].lower().split()
                if len(words) < 2:
                    continue
            if any(" " in w or "#" in w or "|" in w for w in words):
                skipped += 1
                continue
            for w in words:
                table.setdefault(w, set()).update(x for x in words if x != w)
    _SYN_CUSTOM = True
    _SYNONYM = {k: frozenset(v) for k, v in table.items()}
    _sync_native()
    return {
        "word_pairs": sum(len(v) for v in table.values()) // 2,
        "lines_skipped": skipped,
        "native_synced": int(_TABLES_NATIVE_SYNCED),
    }


def load_function_words_file(path: str) -> Dict[str, int]:
    """Install METEOR's corpus-derived function-word list from a file (one or
    more whitespace-separated words per line, '#' comments) — the last
    documented content deviation from the jar's English configuration.
    Returns ``{"words": n, "native_synced": 0|1}``."""
    words = []
    with _open_maybe_gz(path) as f:
        for line in f:
            words.extend(line.split("#")[0].lower().split())
    set_function_words(words)
    return {"words": len(get_function_words()),
            "native_synced": int(_TABLES_NATIVE_SYNCED)}


_ENV_LOADERS = (
    ("DLSG_METEOR_PARAPHRASE_FILE", lambda p: load_paraphrase_file(p)),
    ("DLSG_METEOR_SYNONYM_FILE", lambda p: load_synonym_file(p)),
    ("DLSG_METEOR_FUNCTION_WORDS_FILE", lambda p: load_function_words_file(p)),
)
_env_table_loaded: Dict[str, str] = {}


def maybe_load_env_tables() -> None:
    """Honor $DLSG_METEOR_{PARAPHRASE,SYNONYM,FUNCTION_WORDS}_FILE (idempotent
    per path): every scoring entry point (Meteor()) calls this, so exporting a
    var routes ALL METEOR scoring — cli evaluate, in-training eval, serve —
    through the official resources without code changes."""
    global _SYNC_SUSPENDED
    pending = [
        (var, loader) for var, loader in _ENV_LOADERS
        if os.environ.get(var)
        and os.environ.get(var) != _env_table_loaded.get(var)
    ]
    if not pending:
        return
    # one native push for all loads (each would otherwise rewrite and re-sort
    # every table file — expensive with the real GB-scale resources)
    _SYNC_SUSPENDED = True
    try:
        for var, loader in pending:
            loader(os.environ[var])
            _env_table_loaded[var] = os.environ[var]
    finally:
        _SYNC_SUSPENDED = False
    _sync_native()


def _table_match(h, r, hs, rs, table) -> bool:
    """Both surface forms and stems are looked up (the tables list lemmas;
    METEOR's WordNet stage likewise lemmatizes before synset lookup)."""
    for a, b in ((h, r), (hs, rs)):
        if b in table.get(a, ()) or a in table.get(b, ()):
            return True
    return False


def _match_stage(h: str, r: str, syn, para) -> int:
    """Return the highest-precedence matching stage index, or -1.

    METEOR 1.5 stage order: 0 exact, 1 stem, 2 synonym, 3 paraphrase."""
    if h == r:
        return 0
    hs, rs = porter2_stem(h), porter2_stem(r)
    if hs == rs:
        return 1
    if _table_match(h, r, hs, rs, syn):
        return 2
    if _table_match(h, r, hs, rs, para):
        return 3
    return -1


def _phrase_candidates(hyp, ref, phrases):
    """Span-match candidates from the phrase table.

    Returns {hyp_start: [(ref_start, hyp_len, ref_len)]}. A candidate pairs a
    hyp span with a ref span whose surface phrases are table-equivalent; at
    least one side must be multi-word (1<->1 pairs belong to the word-level
    paraphrase table and would double-count stage precedence otherwise).
    """
    out: Dict[int, List[Tuple[int, int, int]]] = {}
    if not phrases:
        return out
    if phrases is _PHRASE:  # module table: cached (official tables are huge)
        max_len = _phrase_max_len()
    else:
        max_len = max(len(p.split()) for p in phrases)
    # index every ref span surface form up to the table's longest phrase
    ref_spans: Dict[str, List[Tuple[int, int]]] = {}
    for j in range(len(ref)):
        for rl in range(1, min(max_len, len(ref) - j) + 1):
            ref_spans.setdefault(" ".join(ref[j : j + rl]), []).append((j, rl))
    for i in range(len(hyp)):
        for hl in range(1, min(max_len, len(hyp) - i) + 1):
            equiv = phrases.get(" ".join(hyp[i : i + hl]))
            if not equiv:
                continue
            for ph in equiv:
                for j, rl in ref_spans.get(ph, ()):
                    if hl + rl >= 3:  # at least one side multi-word
                        out.setdefault(i, []).append((j, hl, rl))
    return out


def _align(
    hyp: List[str], ref: List[str], table=None, para_table=None, phrase_table=None
) -> List[Tuple[int, int, int, int, int]]:
    """METEOR alignment: beam search over one-to-one span matches.

    Matches are spans — single words for the exact/stem/synonym/word-paraphrase
    stages, multi-word spans for phrase paraphrases (meteor-1.5's paraphrase
    stage aligns phrases the same way). Every hyp/ref word is covered by at
    most one match.

    Objective (lexicographic, per the METEOR papers and Aligner.java):
    1. maximize the number of matched words (hyp coverage + ref coverage);
    2. minimize the number of chunks;
    3. minimize the sum of |i - j| over match start positions.
    Returns [(hyp_start, ref_start, hyp_len, ref_len, stage)] sorted by
    hyp_start.
    """
    if table is None:
        table = get_synonym_table()
    if para_table is None:
        para_table = get_paraphrase_table()
    if phrase_table is None:
        phrase_table = get_phrase_table()
    n, m = len(hyp), len(ref)
    cands: List[List[Tuple[int, int]]] = []
    for i in range(n):
        row = []
        for j in range(m):
            s = _match_stage(hyp[i], ref[j], table, para_table)
            if s >= 0:
                row.append((j, s))
        cands.append(row)
    span_cands = _phrase_candidates(hyp, ref, phrase_table)

    # partial alignment state: (used_ref_bitmask, last_end_i, last_end_j,
    #                           next_i, words, chunks, dist, matchlist)
    # last_end_* = final word index of the latest match (chunk adjacency);
    # next_i = first hyp index not yet covered by a span match;
    # words = total covered words, hyp side + ref side (2/word match).
    start = (0, -2, -2, 0, 0, 0, 0, ())
    beam = [start]
    for i in range(n):
        if not cands[i] and i not in span_cands:
            continue
        extended = {}

        def consider(state):
            key = (state[0], state[1], state[2], state[3])
            prev = extended.get(key)
            if prev is None or _state_rank(state) < _state_rank(prev):
                extended[key] = state

        for st in beam:
            used, li, lj, ni, wd, ch, ds, ml = st
            if ni > i:  # inside an earlier span match: pass through
                consider(st)
                continue
            consider((used, li, lj, i + 1, wd, ch, ds, ml))  # hyp[i] unmatched
            for j, s in cands[i]:
                bit = 1 << j
                if used & bit:
                    continue
                nch = ch + (0 if (li == i - 1 and lj == j - 1) else 1)
                consider((
                    used | bit, i, j, i + 1, wd + 2, nch,
                    ds + abs(i - j), ml + ((i, j, 1, 1, s),)
                ))
            for j, hl, rl in span_cands.get(i, ()):
                mask = ((1 << rl) - 1) << j
                if used & mask:
                    continue
                nch = ch + (0 if (li == i - 1 and lj == j - 1) else 1)
                consider((
                    used | mask, i + hl - 1, j + rl - 1, i + hl, wd + hl + rl,
                    nch, ds + abs(i - j), ml + ((i, j, hl, rl, 3),)
                ))
        beam = sorted(extended.values(), key=_state_rank)[:BEAM_WIDTH]

    best = min(beam, key=_state_rank)
    return list(best[7])


def _state_rank(state):
    """Total order on partial alignments: the METEOR objective, then a
    deterministic tie-break on the match list (keeps the C++ port exact)."""
    _, _, _, _, words, chunks, dist, matchlist = state
    return (-words, chunks, dist, matchlist)


def _count_chunks(matches: List[Tuple[int, int, int, int, int]]) -> int:
    """Number of contiguous, order-preserving match runs (a span match is
    contiguous with its successor when both spans abut on both sides)."""
    if not matches:
        return 0
    chunks = 1
    for (h0, r0, hl0, rl0, _), (h1, r1, _, _, _) in zip(matches, matches[1:]):
        if not (h1 == h0 + hl0 and r1 == r0 + rl0):
            chunks += 1
    return chunks


class MeteorParams:
    """Scoring parameters; defaults are METEOR 1.5 English."""

    __slots__ = ("alpha", "beta", "gamma", "delta", "weights")

    def __init__(
        self,
        alpha: float = ALPHA,
        beta: float = BETA,
        gamma: float = GAMMA,
        delta: float = DELTA,
        weights: Tuple[float, ...] = STAGE_WEIGHTS,
    ):
        self.alpha, self.beta, self.gamma, self.delta = alpha, beta, gamma, delta
        self.weights = weights

    def word_weight(self, word: str) -> float:
        """Function-word discounting: content words weigh delta, function
        words (1 - delta)."""
        return (1.0 - self.delta) if word in get_function_words() else self.delta


_DEFAULT_PARAMS = MeteorParams()


class SegmentStats:
    """Sufficient statistics of one hyp/ref pair (the jar's SCORE line reply)."""

    __slots__ = ("wp_num", "wp_den", "wr_num", "wr_den", "chunks", "raw_matches")

    def __init__(self, wp_num, wp_den, wr_num, wr_den, chunks, raw_matches):
        self.wp_num = wp_num
        self.wp_den = wp_den
        self.wr_num = wr_num
        self.wr_den = wr_den
        self.chunks = chunks
        self.raw_matches = raw_matches


def _segment_stats(
    hyp: List[str], ref: List[str], params: MeteorParams = _DEFAULT_PARAMS
) -> SegmentStats:
    # native fast path: the C++ aligner implements the same beam search and
    # synonym table (tests/test_torch_native.py asserts exact equivalence); only
    # valid at default parameters with the shipped tables — or with tables
    # that load_paraphrase_file() mirrored into the C++ side
    if params is _DEFAULT_PARAMS and (_IS_DEFAULT_TABLE or _TABLES_NATIVE_SYNCED):
        st = native.meteor_stats(" ".join(hyp), " ".join(ref))
        if st is not None:
            return SegmentStats(st[0], st[1], st[2], st[3], int(st[4]), st[5])
    matches = _align(hyp, ref)
    # every word covered by a match contributes its stage-weighted word weight
    # (a phrase match covers hl hyp words and rl ref words)
    wp_num = sum(
        params.weights[s] * params.word_weight(hyp[i + k])
        for i, _, hl, _, s in matches
        for k in range(hl)
    )
    wr_num = sum(
        params.weights[s] * params.word_weight(ref[j + k])
        for _, j, _, rl, s in matches
        for k in range(rl)
    )
    wp_den = sum(params.word_weight(w) for w in hyp)
    wr_den = sum(params.word_weight(w) for w in ref)
    chunks = _count_chunks(matches)
    cov_h = sum(hl for _, _, hl, _, _ in matches)
    cov_r = sum(rl for _, _, _, rl, _ in matches)
    # all-words-match, single chunk -> zero fragmentation (the jar scores
    # identical sentences 1.0; with beta=0.2 no other convention can)
    if matches and chunks == 1 and cov_h == len(hyp) and cov_r == len(ref):
        chunks = 0
    # fragmentation denominator: average covered words over the two sides
    # (equals the match count when all matches are single words)
    return SegmentStats(wp_num, wp_den, wr_num, wr_den, chunks, (cov_h + cov_r) / 2.0)


def _score_from_stats(st: SegmentStats, params: MeteorParams = _DEFAULT_PARAMS) -> float:
    if st.wp_den == 0 or st.wr_den == 0 or st.raw_matches == 0:
        return 0.0
    p = st.wp_num / st.wp_den
    r = st.wr_num / st.wr_den
    if p == 0 or r == 0:
        return 0.0
    fmean = (p * r) / (params.alpha * p + (1 - params.alpha) * r)
    frag = st.chunks / st.raw_matches if st.raw_matches else 0.0
    penalty = params.gamma * (frag**params.beta) if st.chunks > 0 else 0.0
    return (1.0 - penalty) * fmean


def score_pair(
    hypothesis: str,
    references: Sequence[str],
    params: MeteorParams = _DEFAULT_PARAMS,
) -> float:
    """Best score over references (METEOR scores against the best ref)."""
    hyp = hypothesis.split()
    best = 0.0
    for ref in references:
        best = max(best, _score_from_stats(_segment_stats(hyp, ref.split(), params), params))
    return best


class Meteor:
    """coco-caption Meteor API (`meteor/meteor.py:15-84`), Java-free."""

    def __init__(self, params: MeteorParams = _DEFAULT_PARAMS):
        maybe_load_env_tables()
        self.params = params

    def method(self) -> str:
        return "METEOR"

    def compute_score(self, gts, res):
        assert sorted(gts.keys()) == sorted(res.keys())
        ids = sorted(gts.keys())
        params = self.params
        scores: List[float] = []
        agg = SegmentStats(0.0, 0.0, 0.0, 0.0, 0, 0)
        for id_ in ids:
            assert len(res[id_]) == 1
            hyp = res[id_][0].split()
            best_score, best_stats = 0.0, None
            for ref in gts[id_]:
                st = _segment_stats(hyp, ref.split(), params)
                sc = _score_from_stats(st, params)
                if best_stats is None or sc > best_score:
                    best_score, best_stats = sc, st
            scores.append(best_score)
            agg.wp_num += best_stats.wp_num
            agg.wp_den += best_stats.wp_den
            agg.wr_num += best_stats.wr_num
            agg.wr_den += best_stats.wr_den
            agg.chunks += best_stats.chunks
            agg.raw_matches += best_stats.raw_matches
        return _score_from_stats(agg, params), scores
