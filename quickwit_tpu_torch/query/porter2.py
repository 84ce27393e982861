"""Porter2 (English Snowball) stemmer — the algorithm behind tantivy's
`en_stem` (rust-stemmers "english"), implemented faithfully so index
terms are byte-compatible with the reference's.

Spec: snowballstem.org/algorithms/english/stemmer.html. Every rule
below mirrors a clause of the published algorithm; tested against the
standard sample vocabulary pairs.
"""

from __future__ import annotations

_VOWELS = frozenset("aeiouy")
_DOUBLES = ("bb", "dd", "ff", "gg", "mm", "nn", "pp", "rr", "tt")
_LI_ENDINGS = frozenset("cdeghkmnrt")

_EXCEPTIONS = {
    "skis": "ski", "skies": "sky", "dying": "die", "lying": "lie",
    "tying": "tie", "idly": "idl", "gently": "gentl", "ugly": "ugli",
    "early": "earli", "only": "onli", "singly": "singl",
    "sky": "sky", "news": "news", "howe": "howe", "atlas": "atlas",
    "cosmos": "cosmos", "bias": "bias", "andes": "andes",
}
_EXCEPTIONS_1A = frozenset((
    "inning", "outing", "canning", "herring", "earring",
    "proceed", "exceed", "succeed",
))

_STEP2 = (
    ("ization", "ize"), ("ational", "ate"), ("ousness", "ous"),
    ("iveness", "ive"), ("fulness", "ful"), ("biliti", "ble"),
    ("lessli", "less"), ("tional", "tion"), ("ation", "ate"),
    ("alism", "al"), ("aliti", "al"), ("ousli", "ous"),
    ("entli", "ent"), ("fulli", "ful"), ("iviti", "ive"),
    ("enci", "ence"),
    ("anci", "ance"), ("abli", "able"), ("izer", "ize"),
    ("ator", "ate"), ("alli", "al"), ("bli", "ble"),
)
_STEP3 = (
    ("ational", "ate"), ("tional", "tion"), ("alize", "al"),
    ("icate", "ic"), ("iciti", "ic"), ("ical", "ic"),
    ("ful", ""), ("ness", ""),
)
_STEP4 = ("ement", "ance", "ence", "able", "ible", "ment",
          "ant", "ent", "ism", "ate", "iti", "ous", "ive", "ize",
          "al", "er", "ic")


def _is_vowel(word: str, i: int) -> bool:
    return word[i] in _VOWELS


def _regions(word: str) -> tuple[int, int]:
    """(r1, r2) start indexes per the spec (with the gener-/commun-/
    arsen- special cases for R1)."""
    n = len(word)
    r1 = n
    for prefix in ("gener", "commun", "arsen"):
        if word.startswith(prefix):
            r1 = len(prefix)
            break
    else:
        for i in range(1, n):
            if not _is_vowel(word, i) and _is_vowel(word, i - 1):
                r1 = i + 1
                break
    r2 = n
    for i in range(r1 + 1, n):
        if not _is_vowel(word, i) and _is_vowel(word, i - 1):
            r2 = i + 1
            break
    return r1, r2


def _ends_short_syllable(word: str) -> bool:
    """A short syllable at the END of the word: either (a) vowel +
    non-vowel other than w/x/Y preceded by a non-vowel, or (b) a vowel at
    the beginning followed by a non-vowel."""
    n = len(word)
    if n == 2:
        return _is_vowel(word, 0) and not _is_vowel(word, 1)
    if n >= 3:
        return (not _is_vowel(word, n - 3) and _is_vowel(word, n - 2)
                and word[n - 1] not in _VOWELS
                and word[n - 1] not in "wxY")
    return False


def _is_short(word: str, r1: int) -> bool:
    return r1 >= len(word) and _ends_short_syllable(word)


def _has_vowel(word: str, end: int) -> bool:
    return any(_is_vowel(word, i) for i in range(end))


def stem(word: str) -> str:
    if len(word) <= 2:
        return word
    word = word.lower()
    if word in _EXCEPTIONS:
        return _EXCEPTIONS[word]
    if word[0] == "'":
        word = word[1:]
    # mark consonant-y as Y
    if word.startswith("y"):
        word = "Y" + word[1:]
    chars = list(word)
    for i in range(1, len(chars)):
        if chars[i] == "y" and chars[i - 1] in _VOWELS:
            chars[i] = "Y"
    word = "".join(chars)

    r1, r2 = _regions(word)

    # step 0
    for suffix in ("'s'", "'s", "'"):
        if word.endswith(suffix):
            word = word[: -len(suffix)]
            break

    # step 1a
    if word.endswith("sses"):
        word = word[:-2]
    elif word.endswith(("ied", "ies")):
        word = word[:-3] + ("i" if len(word) > 4 else "ie")
    elif word.endswith(("us", "ss")):
        pass
    elif word.endswith("s"):
        if _has_vowel(word, len(word) - 2):
            word = word[:-1]

    if word in _EXCEPTIONS_1A:
        return word

    # step 1b
    if word.endswith(("eedly", "eed")):
        suffix_len = 5 if word.endswith("eedly") else 3
        if len(word) - suffix_len >= r1:  # suffix lies within R1
            word = word[: len(word) - suffix_len] + "ee"
    elif word.endswith(("ingly", "edly", "ing", "ed")):
        for suffix in ("ingly", "edly", "ing", "ed"):
            if word.endswith(suffix):
                stem_part = word[: -len(suffix)]
                if _has_vowel(stem_part, len(stem_part)):
                    word = stem_part
                    if word.endswith(("at", "bl", "iz")):
                        word += "e"
                    elif word.endswith(_DOUBLES):
                        word = word[:-1]
                    elif _is_short(word, r1):
                        word += "e"
                break

    # step 1c
    if (len(word) > 2 and word[-1] in "yY"
            and word[-2] not in _VOWELS):
        word = word[:-1] + "i"

    # step 2 (suffix must be in R1)
    for suffix, repl in _STEP2:
        if word.endswith(suffix):
            if len(word) - len(suffix) >= r1:
                word = word[: -len(suffix)] + repl
            break
    else:
        if word.endswith("ogi"):
            if len(word) - 3 >= r1 and len(word) > 3 and word[-4] == "l":
                word = word[:-1]
        elif word.endswith("li"):
            if len(word) - 2 >= r1 and word[-3] in _LI_ENDINGS:
                word = word[:-2]

    # step 3
    for suffix, repl in _STEP3:
        if word.endswith(suffix):
            if len(word) - len(suffix) >= r1:
                word = word[: -len(suffix)] + repl
            break
    else:
        if word.endswith("ative") and len(word) - 5 >= r2:
            word = word[:-5]

    # step 4 (suffix must be in R2)
    for suffix in _STEP4:
        if word.endswith(suffix):
            if len(word) - len(suffix) >= r2:
                word = word[: -len(suffix)]
            break
    else:
        if word.endswith("ion") and len(word) - 3 >= r2 \
                and len(word) > 3 and word[-4] in "st":
            word = word[:-3]

    # step 5
    if word.endswith("e"):
        if len(word) - 1 >= r2:
            word = word[:-1]
        elif len(word) - 1 >= r1 and not _ends_short_syllable(word[:-1]):
            word = word[:-1]
    elif word.endswith("l") and len(word) - 1 >= r2 and len(word) > 1 \
            and word[-2] == "l":
        word = word[:-1]

    return word.replace("Y", "y")
