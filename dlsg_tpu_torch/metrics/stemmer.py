"""Porter2 (English Snowball) stemmer — dependency-free.

Backs the METEOR 'stem' match stage (meteor-1.5 uses the Snowball English
stemmer). Implemented from the published Porter2 algorithm description.
"""

from __future__ import annotations

_VOWELS = set("aeiouy")
_DOUBLES = ("bb", "dd", "ff", "gg", "mm", "nn", "pp", "rr", "tt")
_LI_ENDING = set("cdeghkmnrt")


def _is_vowel(word: str, i: int) -> bool:
    return word[i] in _VOWELS


def _regions(word: str):
    """R1/R2 start positions per the Porter2 definition."""
    # special prefixes
    for pre in ("gener", "commun", "arsen"):
        if word.startswith(pre):
            r1 = len(pre)
            break
    else:
        r1 = len(word)
        for i in range(1, len(word)):
            if not _is_vowel(word, i) and _is_vowel(word, i - 1):
                r1 = i + 1
                break
    r2 = len(word)
    for i in range(r1 + 1, len(word)):
        if not _is_vowel(word, i) and _is_vowel(word, i - 1):
            r2 = i + 1
            break
    return r1, r2


def _ends_short_syllable(word: str) -> bool:
    if len(word) == 2:
        return _is_vowel(word, 0) and not _is_vowel(word, 1)
    if len(word) >= 3:
        a, b, c = word[-3], word[-2], word[-1]
        return (
            b in _VOWELS
            and c not in _VOWELS
            and c not in "wxY"
            and a not in _VOWELS
        )
    return False


def _is_short(word: str, r1: int) -> bool:
    return r1 >= len(word) and _ends_short_syllable(word)


def porter2_stem(word: str) -> str:  # noqa: C901 — faithful algorithm port
    w = word.lower()
    if len(w) <= 2:
        return w

    exceptions = {
        "skis": "ski", "skies": "sky", "dying": "die", "lying": "lie",
        "tying": "tie", "idly": "idl", "gently": "gentl", "ugly": "ugli",
        "early": "earli", "only": "onli", "singly": "singl", "sky": "sky",
        "news": "news", "howe": "howe", "atlas": "atlas", "cosmos": "cosmos",
        "bias": "bias", "andes": "andes",
    }
    if w in exceptions:
        return exceptions[w]

    if w.startswith("'"):
        w = w[1:]
    # mark consonant y
    if w.startswith("y"):
        w = "Y" + w[1:]
    w = "".join(
        "Y" if c == "y" and i > 0 and w[i - 1] in _VOWELS else c
        for i, c in enumerate(w)
    )
    r1, r2 = _regions(w)

    # step 0
    for suf in ("'s'", "'s", "'"):
        if w.endswith(suf):
            w = w[: -len(suf)]
            break

    # step 1a
    if w.endswith("sses"):
        w = w[:-2]
    elif w.endswith(("ied", "ies")):
        w = w[:-2] if len(w) > 4 else w[:-1]
    elif w.endswith(("us", "ss")):
        pass
    elif w.endswith("s"):
        if any(c in _VOWELS for c in w[:-2]):
            w = w[:-1]

    if w in ("inning", "outing", "canning", "herring", "earring", "proceed", "exceed", "succeed"):
        return w.lower()

    # step 1b
    done_1b = False
    for suf in ("eedly", "eed"):
        if w.endswith(suf):
            if len(w) - len(suf) >= r1:
                w = w[: -len(suf)] + "ee"
            done_1b = True
            break
    if not done_1b:
        for suf in ("ingly", "edly", "ing", "ed"):
            if w.endswith(suf):
                stem = w[: -len(suf)]
                if any(c in _VOWELS for c in stem):
                    w = stem
                    if w.endswith(("at", "bl", "iz")):
                        w += "e"
                    elif w.endswith(_DOUBLES):
                        w = w[:-1]
                    elif _is_short(w, r1):
                        w += "e"
                break

    # step 1c
    if len(w) > 2 and w[-1] in "yY" and w[-2] not in _VOWELS:
        w = w[:-1] + "i"

    # step 2
    step2 = [
        ("ization", "ize"), ("ational", "ate"), ("fulness", "ful"),
        ("ousness", "ous"), ("iveness", "ive"), ("tional", "tion"),
        ("biliti", "ble"), ("lessli", "less"), ("entli", "ent"),
        ("ation", "ate"), ("alism", "al"), ("aliti", "al"), ("ousli", "ous"),
        ("iviti", "ive"), ("fulli", "ful"), ("enci", "ence"), ("anci", "ance"),
        ("abli", "able"), ("izer", "ize"), ("ator", "ate"), ("alli", "al"),
        ("bli", "ble"),
    ]
    for suf, rep in step2:
        if w.endswith(suf):
            if len(w) - len(suf) >= r1:
                w = w[: -len(suf)] + rep
            break
    else:
        if w.endswith("ogi") and len(w) >= 4 and w[-4] == "l" and len(w) - 3 >= r1:
            w = w[:-1]
        elif w.endswith("li") and len(w) - 2 >= r1 and w[-3] in _LI_ENDING:
            w = w[:-2]

    # step 3
    step3 = [
        ("ational", "ate"), ("tional", "tion"), ("alize", "al"),
        ("icate", "ic"), ("iciti", "ic"), ("ical", "ic"), ("ness", ""),
        ("ful", ""),
    ]
    for suf, rep in step3:
        if w.endswith(suf):
            if len(w) - len(suf) >= r1:
                w = w[: -len(suf)] + rep
            break
    else:
        if w.endswith("ative") and len(w) - 5 >= r2:
            w = w[:-5]

    # step 4
    step4 = (
        "ement", "ance", "ence", "able", "ible", "ment", "ant", "ent",
        "ism", "ate", "iti", "ous", "ive", "ize", "al", "er", "ic",
    )
    for suf in step4:
        if w.endswith(suf):
            if len(w) - len(suf) >= r2:
                w = w[: -len(suf)]
            break
    else:
        if w.endswith("ion") and len(w) - 3 >= r2 and w[-4] in "st":
            w = w[:-3]

    # step 5
    if w.endswith("e"):
        if len(w) - 1 >= r2 or (len(w) - 1 >= r1 and not _ends_short_syllable(w[:-1])):
            w = w[:-1]
    elif w.endswith("ll") and len(w) - 1 >= r2:
        w = w[:-1]

    return w.lower()
