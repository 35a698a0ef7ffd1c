"""PTB-style tokenizer.

Replaces the reference's Java subprocess
(`caption-eval/pycocoevalcap/tokenizer/ptbtokenizer.py:24-71`, which shells out
to stanford-corenlp-3.4.1.jar with `-preserveLines -lowerCase`) with a native
implementation of the PTB tokenization rules relevant to caption text, followed
by the same punctuation-token removal list (`ptbtokenizer.py:21-22`).

A copy of `dlsg_tpu/metrics/tokenizer.py`. ASCII lines go to the C++
tokenizer (`dlsg_tpu_torch/native`), which gives the same tokens; the
Python body below is the reference and takes the rest.
"""

from __future__ import annotations

import re
from typing import Dict, List

from dlsg_tpu_torch import native

# ptbtokenizer.py:21-22 — tokens removed after tokenization
PUNCTUATIONS = [
    "''", "'", "``", "`", "-LRB-", "-RRB-", "-LCB-", "-RCB-",
    ".", "?", "!", ",", ":", "-", "--", "...", ";",
]

_CONTRACTIONS = re.compile(
    r"\b(can)(not)\b|\b(d')(ye)\b|\b(gim)(me)\b|\b(gon)(na)\b|"
    r"\b(got)(ta)\b|\b(lem)(me)\b|\b(wan)(na)\b",
    re.IGNORECASE,
)

# Abbreviations whose trailing period stays attached (corenlp keeps lexicon
# abbreviations as single tokens). Mirrors the PTBLexer abbreviation classes
# (personal titles, months, streets, US states, company suffixes, Latin/
# scholarly, measures), lowercased, in TWO classes mirroring PTBLexer's
# lookahead design (corenlp jar invocation: caption-eval/pycocoevalcap/
# tokenizer/ptbtokenizer.py:28-53):
#
# - ABBREV_ALWAYS: entries that keep the period in any position (titles,
#   company suffixes, Latin/scholarly terms — PTBLexer's sentence-final-
#   capable classes). Their bare forms are not English words, so a trailing
#   period is unambiguous.
# - ABBREV_CONTEXTUAL: entries PTBLexer recognizes only with lookahead (the
#   JFlex rules match them when followed by further text): months, days,
#   US states, street/road suffixes, measures, and every entry whose bare
#   form collides with a common sentence-final caption word ("ten reps." /
#   "turn it to the max." / "the couple wed."). These keep the period only
#   when NOT line-final; at end of line the period is a sentence terminator
#   and splits off, exactly the ambiguity corenlp resolves with lookahead.
#
# Two-letter initials ("b.") need no entry: the single-initial rule keeps them.
ABBREV_ALWAYS = frozenset(
    """dr. mr. mrs. ms. jr. sr. prof. gen. gov. sgt. capt. rev. hon.
    u.s. u.k. e.g. i.e. etc. vs. co. inc. ltd.
    dept. approx. hr. a.m. p.m.
    lt. col. maj. adm. sen. pres. supt. det.
    misc. vol. ch. pp. univ. assn. bros. corp. mfg. ph.d.
    adj. adv. asst. bldg. cmdr. comdr. cpl. drs. ens. insp.
    messrs. mlle. mme. msgr. pfc. pvt. sens. sfc. surg. atty. attys.
    esq.
    cos. mfrs. mkt. pty. plc. dist. distrib.
    cf. al. seq. viz. ibid. orig. incl. nos.
    hrs. mins. secs. tsp. tbsp.
    exec. govt. natl. intl. admin. assoc. bldgs. mts. sts. rds.""".split()
)
ABBREV_CONTEXTUAL = frozenset(
    """st. ft. lb. lbs. oz. v. no. min. max. sec. in. gal. reps. rep.
    mt. ave. blvd. rd. hwy. fwy. pkwy. tpke. rte.
    jan. feb. mar. apr. jun. jul. aug. sept. oct. nov. dec. sep.
    mon. tues. wed. thurs. fri. sat. sun.
    ala. ariz. ark. calif. colo. conn. dak. del. fla. ind. kan. kans.
    mich. minn. mont. neb. nebr. nev. okla. ore. penn. penna. tenn. tex.
    wis. wisc. wyo.
    est. fig. ed. brig.
    kg. km. cm. mm. mi. qt. sq. cu.""".split()
)
# Union kept for introspection/tests; membership checks below use the classes.
ABBREVIATIONS = ABBREV_ALWAYS | ABBREV_CONTEXTUAL

# single-letter acronyms with internal periods ("u.s.a.", "t.v.", "o.k.") are
# single tokens at corenlp's PTBTokenizer — the trailing period stays attached
_ACRONYM = re.compile(r"([a-z]\.){2,}")

# --- Americanize filter ------------------------------------------------------
# corenlp's PTBLexer default is americanize=true, so the jar invocation at
# ptbtokenizer.py:28-39 rewrites British spellings to American ones before the
# captions reach the scorers. This is the caption-relevant subset of corenlp's
# edu.stanford.nlp.process.Americanize filter: the "-our -> -or" suffix rule
# (>= 3 letters before "our", with a curated keep-list for words like devour /
# contour where "-our" is not the British suffix), a word map for derived
# forms whose "our" is word-internal (favourite, neighbourhood, ...), the
# "-re -> -er" word list (centre, theatre, litre, ...), and programme(s).
_OUR_SUFFIXES = ("ouring", "oured", "ours", "our")  # longest first
_OUR_KEEP = frozenset(
    """devour devours devoured devouring contour contours contoured contouring
    detour detours detoured detouring glamour glamours velour velours
    downpour downpours troubadour troubadours paramour paramours pompadour
    pompadours tambour tambours""".split()
)
_AMERICANIZE = {
    # internal "our" (not reachable by the suffix rule)
    "favourite": "favorite", "favourites": "favorite" + "s",
    "colourful": "colorful", "colourfully": "colorfully",
    "neighbourhood": "neighborhood", "neighbourhoods": "neighborhoods",
    "honourable": "honorable", "favourable": "favorable",
    "behavioural": "behavioral", "labourer": "laborer", "labourers": "laborers",
    # "our" with a 2-letter prefix (below the suffix rule's >=3 threshold)
    "odour": "odor", "odours": "odors",
    # "-re" endings
    "centre": "center", "centres": "centers", "centred": "centered",
    "theatre": "theater", "theatres": "theaters",
    "litre": "liter", "litres": "liters",
    "metre": "meter", "metres": "meters",
    "fibre": "fiber", "fibres": "fibers",
    "calibre": "caliber", "sombre": "somber", "lustre": "luster",
    "spectre": "specter", "spectres": "specters",
    "sabre": "saber", "sabres": "sabers",
    "manoeuvre": "maneuver", "manoeuvres": "maneuvers",
    # misc
    "programme": "program", "programmes": "programs",
}


def americanize(tok: str) -> str:
    """British -> American spelling for one lowercased token (corenlp subset)."""
    mapped = _AMERICANIZE.get(tok)
    if mapped is not None:
        return mapped
    # ASCII-only gate (matching the C++ engine's byte-wise isalpha): the
    # suffix rule must never fire on accented tokens ("séjour") in one engine
    # and not the other
    if tok in _OUR_KEEP or not tok.isascii() or not tok.isalpha():
        return tok
    for suf in _OUR_SUFFIXES:
        if tok.endswith(suf) and len(tok) - len(suf) >= 3:
            return tok[: -len(suf)] + "or" + suf[3:]
    return tok


def ptb_tokenize_line(line: str, lowercase: bool = True) -> List[str]:
    """Tokenize one sentence with PTB rules (corenlp PTBTokenizer subset).

    Covers the phenomena that occur in caption text: punctuation splitting,
    n't / 's / 'll / 're / 've / 'd / 'm clitics, bracket normalization
    (-LRB- etc.), directional quote conversion, ellipses and dashes.

    ASCII text takes the C++ tokenizer (`native.ptb_tokenize`); this body is
    the reference behaviour.
    """
    s = line.strip()
    if lowercase:
        s = s.lower()

    # normalize unicode quotes/dashes
    s = (
        s.replace("‘", "'").replace("’", "'")
        .replace("“", '"').replace("”", '"')
        .replace("–", "--").replace("—", "--")
        .replace("…", "...")
    )

    toks = native.ptb_tokenize(s, lowercase=False)  # already lowercased
    if toks is not None:
        return toks

    # brackets -> PTB symbols
    for src, dst in [
        ("(", " -LRB- "), (")", " -RRB- "), ("{", " -LCB- "), ("}", " -RCB- "),
        # corenlp's PTB3 normalization gives square brackets their OWN tokens
        # (-LSB-/-RSB-), which coco's removal list (ptbtokenizer.py:21-22)
        # does NOT include — so [..] survives punctuation removal at the jar.
        ("[", " -LSB- "), ("]", " -RSB- "),
    ]:
        s = s.replace(src, dst)

    # directional double quotes: opening after start/space -> ``, else ''
    s = re.sub(r'(^|[ \t])"', r"\1 `` ", s)
    s = s.replace('"', " '' ")

    # separate ellipses and double dashes first
    s = s.replace("...", " ... ").replace("--", " -- ")

    # opening single quote -> ` (corenlp directional quotes); must run before
    # the clitic rules so "'s" etc. stay intact
    s = re.sub(r"(^|(?<=\s))'(?=\w)", "` ", s)

    # split off punctuation; , and : stay inside numbers (2,500 / 10:30) and
    # & stays inside compounds (a&b), like corenlp
    s = re.sub(r"([;@#$%?!])", r" \1 ", s)
    s = re.sub(r"(?<!\w)&|&(?!\w)", " & ", s)
    s = re.sub(r"(?<!\d),|,(?!\d)", " , ", s)
    s = re.sub(r"(?<!\d):|:(?!\d)", " : ", s)

    # clitics: don't -> do n't; it's -> it 's; we'll -> we 'll; etc.
    s = re.sub(r"\b(\w+)(n't)\b", r"\1 \2", s)
    s = re.sub(r"(\w)('s|'re|'ve|'ll|'d|'m)\b", r"\1 \2", s)
    # possessive plural: dogs' -> dogs '
    s = re.sub(r"(s)'(\s|$)", r"\1 ' \2", s)
    # closing single quote after a word: expert' -> expert '
    s = re.sub(r"(?<=\w)'(?=\s|$)", " '", s)

    s = _CONTRACTIONS.sub(lambda m: " ".join(g for g in m.groups() if g), s)

    # PTB3 escaping: corenlp 3.4.1's PTBLexer default escapeForwardSlashAsterisk
    # =true emits "\/" and "\*" inside tokens ("and/or" -> "and\/or")
    s = s.replace("/", "\\/").replace("*", "\\*")

    # final pass: a trailing period becomes its own token unless the token is
    # a known abbreviation (ALWAYS anywhere; CONTEXTUAL only with lookahead —
    # i.e. not line-final), a single initial (b.), or an ellipsis; word tokens
    # then pass through the Americanize filter (corenlp default americanize=true)
    toks: List[str] = []
    raw = s.split()
    last = len(raw) - 1
    for i, tok in enumerate(raw):
        # PTBLexer's lookahead is character-level: the abbreviation rule only
        # matches when followed by a letter/digit, so "gal. ," or "in. -RRB-"
        # splits like line-final, not like "gal. of"
        followed_by_word = i < last and raw[i + 1][:1].isalnum()
        keep_abbrev = tok in ABBREV_ALWAYS or (
            tok in ABBREV_CONTEXTUAL and followed_by_word
        )
        if (
            len(tok) > 1
            and tok.endswith(".")
            and not all(c == "." for c in tok)
            and not keep_abbrev
            and not (len(tok) == 2 and tok[0].isalpha())
            and not _ACRONYM.fullmatch(tok)
        ):
            toks.append(americanize(tok[:-1]))
            toks.append(".")
        else:
            toks.append(americanize(tok))
    return toks


def tokenize_captions(
    captions_for_image: Dict[str, List[dict]], remove_punct: bool = True
) -> Dict[str, List[str]]:
    """coco-caption API parity (ptbtokenizer.py:27-71).

    Input: {id: [{'caption': str}, ...]}; output: {id: [tokenized_str, ...]}
    with PUNCTUATIONS tokens removed.
    """
    out: Dict[str, List[str]] = {}
    punct = set(PUNCTUATIONS)
    for k, caps in captions_for_image.items():
        out[k] = []
        for c in caps:
            text = c["caption"] if isinstance(c, dict) else c
            toks = ptb_tokenize_line(text.replace("\n", " "))
            if remove_punct:
                toks = [t for t in toks if t not in punct]
            out[k].append(" ".join(toks))
    return out
