# Copied from whisper_tpu/normalizers/basic.py (jax-free); keep in step with it.
"""Language-agnostic text normalization for WER evaluation.

Behavioral parity target: reference ``whisper/normalizers/basic.py`` —
lowercase, strip bracketed/parenthesized asides, replace markers/symbols/
punctuation with spaces, optionally drop diacritics (NFKD + a manual table of
non-decomposing letters), optionally split into graphemes.
"""

import re
import unicodedata

import regex

# non-ASCII letters whose base form NFKD does not separate
_LETTER_FOLDS = {
    "œ": "oe", "Œ": "OE",
    "ø": "o", "Ø": "O",
    "æ": "ae", "Æ": "AE",
    "ß": "ss", "ẞ": "SS",
    "đ": "d", "Đ": "D",
    "ð": "d", "Ð": "D",
    "þ": "th", "Þ": "th",
    "ł": "l", "Ł": "L",
}


def _clean(s: str, *, fold_diacritics: bool, keep: str = "") -> str:
    """Space out markers/symbols/punctuation; optionally fold diacritics.

    With fold_diacritics the string is NFKD-decomposed so combining marks
    (category Mn) can be dropped and the _LETTER_FOLDS table applied;
    otherwise NFKC keeps letters composed.
    """
    form = "NFKD" if fold_diacritics else "NFKC"
    out = []
    for c in unicodedata.normalize(form, s):
        if c in keep:
            out.append(c)
            continue
        if fold_diacritics and c in _LETTER_FOLDS:
            out.append(_LETTER_FOLDS[c])
            continue
        category = unicodedata.category(c)
        if fold_diacritics and category == "Mn":
            continue  # combining mark: drop entirely
        out.append(" " if category[0] in "MSP" else c)
    return "".join(out)


def remove_symbols_and_diacritics(s: str, keep: str = "") -> str:
    """Replace markers/symbols/punctuation with a space and drop diacritics."""
    return _clean(s, fold_diacritics=True, keep=keep)


def remove_symbols(s: str) -> str:
    """Replace markers/symbols/punctuation with a space, keeping diacritics."""
    return _clean(s, fold_diacritics=False)


class BasicTextNormalizer:
    def __init__(self, remove_diacritics: bool = False, split_letters: bool = False):
        self.clean = (
            remove_symbols_and_diacritics if remove_diacritics else remove_symbols
        )
        self.split_letters = split_letters

    def __call__(self, s: str) -> str:
        s = s.lower()
        s = re.sub(r"[<\[][^>\]]*[>\]]", "", s)  # drop [bracketed] annotations
        s = re.sub(r"\(([^)]+?)\)", "", s)  # drop (parenthesized) asides
        s = self.clean(s).lower()

        if self.split_letters:
            s = " ".join(regex.findall(r"\X", s, regex.U))

        s = re.sub(r"\s+", " ", s)
        return s
