# Copied from whisper_tpu/normalizers/english.py (jax-free); keep in step with it.
"""English text normalization for WER evaluation.

PROVENANCE: ``EnglishNumberNormalizer.process_words`` is DERIVED FROM the
reference's number transducer (``whisper/normalizers/english.py:165-386``),
behavior-preserving — same branch order, same per-category decision chain,
cosmetically reorganized (``output()`` → ``emit()``, ``windowed`` → padded
index loop).  This is deliberate, not an independent redesign: the
transducer's exact quirks (suffix splitting, the ``value % 100`` carry
rules, ``double oh seven`` nominal runs, currency reordering) ARE the WER
evaluation spec — published WER numbers (reference
notebooks/LibriSpeech.ipynb, BASELINE.md 4.26%) are only comparable if the
normalizer is branch-for-branch identical, and the reference golden tests
in tests/test_normalizer.py pin every one of those branches.  This module
is evaluation-only: nothing on the transcription path imports it.

The surrounding pieces follow the same behavioral contract: the UK→US
spelling map (reference english.py:450-462, driven by the identical
``english.json`` asset) and the contraction/title expansion pipeline
(reference english.py:465-550).
"""

import json
import os
import re
from fractions import Fraction
from typing import Iterator, List, Optional, Union

from .basic import remove_symbols_and_diacritics

_ONES_NAMES = [
    "one", "two", "three", "four", "five", "six", "seven", "eight", "nine",
    "ten", "eleven", "twelve", "thirteen", "fourteen", "fifteen", "sixteen",
    "seventeen", "eighteen", "nineteen",
]
_TENS_NAMES = {
    "twenty": 20, "thirty": 30, "forty": 40, "fifty": 50,
    "sixty": 60, "seventy": 70, "eighty": 80, "ninety": 90,
}
_MULTIPLIER_NAMES = {
    "hundred": 10**2, "thousand": 10**3, "million": 10**6, "billion": 10**9,
    "trillion": 10**12, "quadrillion": 10**15, "quintillion": 10**18,
    "sextillion": 10**21, "septillion": 10**24, "octillion": 10**27,
    "nonillion": 10**30, "decillion": 10**33,
}

_ARABIC = re.compile(r"^\d+(\.\d+)?$")


def _fraction(s) -> Optional[Fraction]:
    try:
        return Fraction(s)
    except ValueError:
        return None


class EnglishNumberNormalizer:
    """Convert spelled-out numbers to arabic digits.

    Handles suffixes (``1960s``, ``274th``), currency words after numbers
    (``$20 million`` -> ``20000000 dollars``), nominal digit strings
    (``one oh one`` -> ``101``), ``double``/``triple``, ``point`` decimals,
    and keeps literal ``one``/``ones`` readable.
    """

    def __init__(self):
        self.zeros = {"o", "oh", "zero"}
        self.ones = {name: i + 1 for i, name in enumerate(_ONES_NAMES)}
        self.tens = dict(_TENS_NAMES)
        self.multipliers = dict(_MULTIPLIER_NAMES)

        # plural/ordinal variants map to (value, printed suffix)
        self.ones_suffixed = {}
        for name, value in self.ones.items():
            plural = "sixes" if name == "six" else name + "s"
            self.ones_suffixed[plural] = (value, "s")
            if value > 3 and value not in (5, 12):
                ordinal = name + ("h" if name.endswith("t") else "th")
                self.ones_suffixed[ordinal] = (value, "th")
        self.ones_suffixed.update(
            {
                "zeroth": (0, "th"), "first": (1, "st"), "second": (2, "nd"),
                "third": (3, "rd"), "fifth": (5, "th"), "twelfth": (12, "th"),
            }
        )

        self.tens_suffixed = {}
        for name, value in self.tens.items():
            self.tens_suffixed[name.replace("y", "ies")] = (value, "s")
            self.tens_suffixed[name.replace("y", "ieth")] = (value, "th")

        self.multipliers_suffixed = {}
        for name, value in self.multipliers.items():
            self.multipliers_suffixed[name + "s"] = (value, "s")
            self.multipliers_suffixed[name + "th"] = (value, "th")

        self.decimals = {*self.ones, *self.tens, *self.zeros}

        self.preceding_prefixers = {
            "minus": "-", "negative": "-", "plus": "+", "positive": "+",
        }
        self.following_prefixers = {
            "pound": "£", "pounds": "£", "euro": "€", "euros": "€",
            "dollar": "$", "dollars": "$", "cent": "¢", "cents": "¢",
        }
        self.prefixes = set(self.preceding_prefixers.values()) | set(
            self.following_prefixers.values()
        )
        self.suffixers = {"per": {"cent": "%"}, "percent": "%"}
        self.specials = {"and", "double", "triple", "point"}

        self.words = set().union(
            self.zeros, self.ones, self.ones_suffixed,
            self.tens, self.tens_suffixed,
            self.multipliers, self.multipliers_suffixed,
            self.preceding_prefixers, self.following_prefixers,
            self.suffixers, self.specials,
        )
        self.literal_words = {"one", "ones"}

    # -- the transducer ----------------------------------------------------
    #
    # State: `value` is the number being accumulated (int while it is still
    # arithmetically extendable, str once it became a digit string), `prefix`
    # a pending sign/currency symbol.  Each token category has a handler;
    # handlers yield finished chunks and mutate the state.

    def process_words(self, words: List[str]) -> Iterator[str]:
        prefix: Optional[str] = None
        value: Optional[Union[str, int]] = None
        skip = False

        def emit(result) -> str:
            nonlocal prefix, value
            out = str(result)
            if prefix is not None:
                out = prefix + out
            prefix = None
            value = None
            return out

        if not words:
            return

        padded = [None] + list(words) + [None]
        for idx in range(1, len(padded) - 1):
            prev, current, nxt = padded[idx - 1], padded[idx], padded[idx + 1]
            if skip:
                skip = False
                continue

            next_is_numeric = nxt is not None and _ARABIC.match(nxt)
            has_prefix = current[0] in self.prefixes
            bare = current[1:] if has_prefix else current

            if _ARABIC.match(bare):
                # an arabic literal, possibly signed/currency-prefixed
                f = _fraction(bare)
                assert f is not None
                if value is not None:
                    if isinstance(value, str) and value.endswith("."):
                        # extend a decimal / dotted sequence: "3.5" + "12"
                        value = str(value) + str(current)
                        continue
                    yield emit(value)
                if has_prefix:
                    prefix = current[0]
                value = f.numerator if f.denominator == 1 else bare

            elif current not in self.words:
                if value is not None:
                    yield emit(value)
                yield emit(current)

            elif current in self.zeros:
                value = str(value or "") + "0"

            elif current in self.ones:
                ones = self.ones[current]
                if value is None:
                    value = ones
                elif isinstance(value, str) or prev in self.ones:
                    if prev in self.tens and ones < 10:
                        # "twenty one": overwrite the trailing zero
                        assert value[-1] == "0"
                        value = value[:-1] + str(ones)
                    else:
                        value = str(value) + str(ones)
                elif ones < 10:
                    value = value + ones if value % 10 == 0 else str(value) + str(ones)
                else:  # eleven..nineteen
                    value = value + ones if value % 100 == 0 else str(value) + str(ones)

            elif current in self.ones_suffixed:
                ones, suffix = self.ones_suffixed[current]
                if value is None:
                    yield emit(str(ones) + suffix)
                elif isinstance(value, str) or prev in self.ones:
                    if prev in self.tens and ones < 10:
                        assert value[-1] == "0"
                        yield emit(value[:-1] + str(ones) + suffix)
                    else:
                        yield emit(str(value) + str(ones) + suffix)
                elif ones < 10:
                    if value % 10 == 0:
                        yield emit(str(value + ones) + suffix)
                    else:
                        yield emit(str(value) + str(ones) + suffix)
                else:
                    if value % 100 == 0:
                        yield emit(str(value + ones) + suffix)
                    else:
                        yield emit(str(value) + str(ones) + suffix)
                value = None

            elif current in self.tens:
                tens = self.tens[current]
                if value is None:
                    value = tens
                elif isinstance(value, str):
                    value = str(value) + str(tens)
                else:
                    value = value + tens if value % 100 == 0 else str(value) + str(tens)

            elif current in self.tens_suffixed:
                tens, suffix = self.tens_suffixed[current]
                if value is None:
                    yield emit(str(tens) + suffix)
                elif isinstance(value, str):
                    yield emit(str(value) + str(tens) + suffix)
                elif value % 100 == 0:
                    yield emit(str(value + tens) + suffix)
                else:
                    yield emit(str(value) + str(tens) + suffix)

            elif current in self.multipliers:
                multiplier = self.multipliers[current]
                if value is None:
                    value = multiplier
                elif isinstance(value, str) or value == 0:
                    f = _fraction(value)
                    p = f * multiplier if f is not None else None
                    if f is not None and p.denominator == 1:
                        value = p.numerator
                    else:
                        yield emit(value)
                        value = multiplier
                else:
                    # scale only the sub-thousand residual: "one thousand
                    # two hundred" -> 1000 + 200
                    before = value // 1000 * 1000
                    residual = value % 1000
                    value = before + residual * multiplier

            elif current in self.multipliers_suffixed:
                multiplier, suffix = self.multipliers_suffixed[current]
                if value is None:
                    yield emit(str(multiplier) + suffix)
                elif isinstance(value, str):
                    f = _fraction(value)
                    p = f * multiplier if f is not None else None
                    if f is not None and p.denominator == 1:
                        yield emit(str(p.numerator) + suffix)
                    else:
                        yield emit(value)
                        yield emit(str(multiplier) + suffix)
                else:
                    before = value // 1000 * 1000
                    residual = value % 1000
                    value = before + residual * multiplier
                    yield emit(str(value) + suffix)
                value = None

            elif current in self.preceding_prefixers:
                # sign applies only when a number follows
                if value is not None:
                    yield emit(value)
                if nxt in self.words or next_is_numeric:
                    prefix = self.preceding_prefixers[current]
                else:
                    yield emit(current)

            elif current in self.following_prefixers:
                # currency word applies only after a number
                if value is not None:
                    prefix = self.following_prefixers[current]
                    yield emit(value)
                else:
                    yield emit(current)

            elif current in self.suffixers:
                if value is not None:
                    suffix = self.suffixers[current]
                    if isinstance(suffix, dict):
                        if nxt in suffix:
                            yield emit(str(value) + suffix[nxt])
                            skip = True
                        else:
                            yield emit(value)
                            yield emit(current)
                    else:
                        yield emit(str(value) + suffix)
                else:
                    yield emit(current)

            elif current in self.specials:
                if nxt not in self.words and not next_is_numeric:
                    if value is not None:
                        yield emit(value)
                    yield emit(current)
                elif current == "and":
                    # "one hundred and two": drop the "and" after multipliers
                    if prev not in self.multipliers:
                        if value is not None:
                            yield emit(value)
                        yield emit(current)
                elif current in ("double", "triple"):
                    if nxt in self.ones or nxt in self.zeros:
                        repeats = 2 if current == "double" else 3
                        digit = self.ones.get(nxt, 0)
                        value = str(value or "") + str(digit) * repeats
                        skip = True
                    else:
                        if value is not None:
                            yield emit(value)
                        yield emit(current)
                elif current == "point":
                    if nxt in self.decimals or next_is_numeric:
                        value = str(value or "") + "."
                else:
                    raise ValueError(f"Unexpected token: {current}")

            else:
                raise ValueError(f"Unexpected token: {current}")

        if value is not None:
            yield emit(value)

    # -- pre/post passes ---------------------------------------------------

    def preprocess(self, s: str) -> str:
        # "<number> and a half" -> "<number> point five" when it follows a
        # number word; otherwise keep the idiom
        results = []
        segments = re.split(r"\band\s+a\s+half\b", s)
        for i, segment in enumerate(segments):
            if len(segment.strip()) == 0:
                continue
            if i == len(segments) - 1:
                results.append(segment)
            else:
                results.append(segment)
                last_word = segment.rsplit(maxsplit=2)[-1]
                if last_word in self.decimals or last_word in self.multipliers:
                    results.append("point five")
                else:
                    results.append("and a half")
        s = " ".join(results)

        # separate number/letter boundaries, but re-attach ordinal suffixes
        s = re.sub(r"([a-z])([0-9])", r"\1 \2", s)
        s = re.sub(r"([0-9])([a-z])", r"\1 \2", s)
        s = re.sub(r"([0-9])\s+(st|nd|rd|th|s)\b", r"\1\2", s)
        return s

    def postprocess(self, s: str) -> str:
        def combine_cents(m: re.Match) -> str:
            try:
                return f"{m.group(1)}{m.group(2)}.{int(m.group(3)):02d}"
            except ValueError:
                return m.string

        def extract_cents(m: re.Match) -> str:
            try:
                return f"¢{int(m.group(1))}"
            except ValueError:
                return m.string

        # "$2 and ¢7" -> "$2.07"; "$0.35" -> "¢35"
        s = re.sub(r"([€£$])([0-9]+) (?:and )?¢([0-9]{1,2})\b", combine_cents, s)
        s = re.sub(r"[€£$]0.([0-9]{1,2})\b", extract_cents, s)

        # keep "one(s)" spelled out for readability
        s = re.sub(r"\b1(s?)\b", r"one\1", s)
        return s

    def __call__(self, s: str) -> str:
        s = self.preprocess(s)
        s = " ".join(word for word in self.process_words(s.split()) if word is not None)
        return self.postprocess(s)


class EnglishSpellingNormalizer:
    """British→American spelling map (tysto.com list, shipped as english.json)."""

    def __init__(self):
        mapping_path = os.path.join(os.path.dirname(__file__), "english.json")
        with open(mapping_path) as f:
            self.mapping = json.load(f)

    def __call__(self, s: str) -> str:
        return " ".join(self.mapping.get(word, word) for word in s.split())


class EnglishTextNormalizer:
    def __init__(self):
        self.ignore_patterns = r"\b(hmm|mm|mhm|mmm|uh|um)\b"
        self.replacers = {
            # common contractions
            r"\bwon't\b": "will not",
            r"\bcan't\b": "can not",
            r"\blet's\b": "let us",
            r"\bain't\b": "aint",
            r"\by'all\b": "you all",
            r"\bwanna\b": "want to",
            r"\bgotta\b": "got to",
            r"\bgonna\b": "going to",
            r"\bi'ma\b": "i am going to",
            r"\bimma\b": "i am going to",
            r"\bwoulda\b": "would have",
            r"\bcoulda\b": "could have",
            r"\bshoulda\b": "should have",
            r"\bma'am\b": "madam",
            # titles and honorifics
            r"\bmr\b": "mister ",
            r"\bmrs\b": "missus ",
            r"\bst\b": "saint ",
            r"\bdr\b": "doctor ",
            r"\bprof\b": "professor ",
            r"\bcapt\b": "captain ",
            r"\bgov\b": "governor ",
            r"\bald\b": "alderman ",
            r"\bgen\b": "general ",
            r"\bsen\b": "senator ",
            r"\brep\b": "representative ",
            r"\bpres\b": "president ",
            r"\brev\b": "reverend ",
            r"\bhon\b": "honorable ",
            r"\basst\b": "assistant ",
            r"\bassoc\b": "associate ",
            r"\blt\b": "lieutenant ",
            r"\bcol\b": "colonel ",
            r"\bjr\b": "junior ",
            r"\bsr\b": "senior ",
            r"\besq\b": "esquire ",
            # perfect tenses with unambiguous participles
            r"'d been\b": " had been",
            r"'s been\b": " has been",
            r"'d gone\b": " had gone",
            r"'s gone\b": " has gone",
            r"'d done\b": " had done",  # "'s done" is ambiguous
            r"'s got\b": " has got",
            # general contractions
            r"n't\b": " not",
            r"'re\b": " are",
            r"'s\b": " is",
            r"'d\b": " would",
            r"'ll\b": " will",
            r"'t\b": " not",
            r"'ve\b": " have",
            r"'m\b": " am",
        }
        self.standardize_numbers = EnglishNumberNormalizer()
        self.standardize_spellings = EnglishSpellingNormalizer()

    def __call__(self, s: str) -> str:
        s = s.lower()

        s = re.sub(r"[<\[][^>\]]*[>\]]", "", s)  # drop [bracketed] annotations
        s = re.sub(r"\(([^)]+?)\)", "", s)  # drop (parenthesized) asides
        s = re.sub(self.ignore_patterns, "", s)
        s = re.sub(r"\s+'", "'", s)  # re-attach detached apostrophes

        for pattern, replacement in self.replacers.items():
            s = re.sub(pattern, replacement, s)

        s = re.sub(r"(\d),(\d)", r"\1\2", s)  # digit-group commas
        s = re.sub(r"\.([^0-9]|$)", r" \1", s)  # periods not in numbers
        s = remove_symbols_and_diacritics(s, keep=".%$¢€£")

        s = self.standardize_numbers(s)
        s = self.standardize_spellings(s)

        # strip numeric symbols left dangling without adjacent digits
        s = re.sub(r"[.$¢€£]([^0-9])", r" \1", s)
        s = re.sub(r"([^0-9])%", r"\1 ", s)

        s = re.sub(r"\s+", " ", s)
        return s
