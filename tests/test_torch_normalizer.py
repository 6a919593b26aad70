"""whisper_tpu_torch's text normalizers (copies of whisper_tpu's) against
whisper_tpu's.

The golden cases of tests/test_normalizer.py (the reference suite's)
hold the port's normalizers, and on the same inputs, those cases and
more, both packages' normalizers give equal strings.
"""

import pytest

import whisper_tpu.normalizers as jn
import whisper_tpu.normalizers.basic as jbasic
import whisper_tpu.normalizers.english as jenglish

from whisper_tpu_torch.normalizers import BasicTextNormalizer, EnglishTextNormalizer
from whisper_tpu_torch.normalizers.basic import remove_symbols, remove_symbols_and_diacritics
from whisper_tpu_torch.normalizers.english import (
    EnglishNumberNormalizer,
    EnglishSpellingNormalizer,
)

# tests/test_normalizer.py's test_number_normalizer, (input, expected)
NUMBER_CASES = [
    ("two", "2"),
    ("thirty one", "31"),
    ("five twenty four", "524"),
    ("nineteen ninety nine", "1999"),
    ("twenty nineteen", "2019"),
    ("two point five million", "2500000"),
    ("four point two billions", "4200000000s"),
    ("200 thousand", "200000"),
    ("200 thousand dollars", "$200000"),
    ("$20 million", "$20000000"),
    ("€52.4 million", "€52400000"),
    ("£77 thousands", "£77000s"),
    ("two double o eight", "2008"),
    ("three thousand twenty nine", "3029"),
    ("forty three thousand two hundred sixty", "43260"),
    ("forty three thousand two hundred and sixty", "43260"),
    ("nineteen fifties", "1950s"),
    ("thirty first", "31st"),
    ("thirty three thousand and three hundred and thirty third", "33333rd"),
    ("three billion", "3000000000"),
    ("millions", "1000000s"),
    ("july third twenty twenty", "july 3rd 2020"),
    ("august twenty sixth twenty twenty one", "august 26th 2021"),
    ("3 14", "3 14"),
    ("3.14", "3.14"),
    ("3 point 2", "3.2"),
    ("3 point 14", "3.14"),
    ("fourteen point 4", "14.4"),
    ("two point two five dollars", "$2.25"),
    ("two hundred million dollars", "$200000000"),
    ("$20.1 million", "$20100000"),
    ("ninety percent", "90%"),
    ("seventy six per cent", "76%"),
    ("double oh seven", "007"),
    ("double zero seven", "007"),
    ("nine one one", "911"),
    ("nine double one", "911"),
    ("one triple oh one", "10001"),
    ("two thousandth", "2000th"),
    ("thirty two thousandth", "32000th"),
    ("minus 500", "-500"),
    ("positive twenty thousand", "+20000"),
    ("two dollars and seventy cents", "$2.70"),
    ("3 cents", "¢3"),
    ("$0.36", "¢36"),
    ("three euros and sixty five cents", "€3.65"),
    ("three and a half million", "3500000"),
    ("forty eight and a half dollars", "$48.5"),
    ("b747", "b 747"),
    ("10 th", "10th"),
    ("10th", "10th"),
]


@pytest.mark.parametrize("text,expected", NUMBER_CASES)
def test_number_normalizer(text, expected):
    assert EnglishNumberNormalizer()(text) == expected
    assert EnglishTextNormalizer()(text) == expected


def test_spelling_normalizer():
    std = EnglishSpellingNormalizer()
    assert std("mobilisation") == "mobilization"
    assert std("cancelation") == "cancellation"


def test_text_normalizer():
    std = EnglishTextNormalizer()
    assert std("Let's") == "let us"
    assert std("he's like") == "he is like"
    assert std("she's been like") == "she has been like"
    assert std("10km") == "10 km"
    assert std("10mm") == "10 mm"
    assert std("RC232") == "rc 232"
    assert (
        std("Mr. Park visited Assoc. Prof. Kim Jr.")
        == "mister park visited associate professor kim junior"
    )


def test_basic_normalizer():
    std = BasicTextNormalizer()
    assert std("Hello, World!") == "hello world "
    assert std("[inaudible] spoken (noise) text") == " spoken text"
    std_d = BasicTextNormalizer(remove_diacritics=True)
    assert std_d("café naïve") == "cafe naive"
    assert remove_symbols_and_diacritics("œsophagus ß") == "oesophagus ss"
    assert remove_symbols("don't — stop!") == "don t   stop "


MORE = [
    "Mr. Park visited Assoc. Prof. Kim Jr.", "Let's go, he's been like 10km away!",
    "The colour of the organisation's programme", "[inaudible] spoken (noise) text",
    "I'd've won £1,500,000.50 in 1999 — honestly.", "uh um hmm, Dr. Who's 3rd episode (2005)",
    "Ça va? Naïve café, œsophagus, straße, Ørsted", "two thousand and twenty one point five percent",
    "RC232 at 10mm, 3.14, $0.36, €52.4 million", "won't can't shouldn't y'all ain't",
]


@pytest.mark.parametrize("text", [a for a, _ in NUMBER_CASES] + MORE)
def test_normalizers_equal_whisper_tpu(text):
    pairs = [
        (EnglishTextNormalizer(), jn.EnglishTextNormalizer()),
        (EnglishNumberNormalizer(), jenglish.EnglishNumberNormalizer()),
        (EnglishSpellingNormalizer(), jenglish.EnglishSpellingNormalizer()),
        (BasicTextNormalizer(), jn.BasicTextNormalizer()),
        (BasicTextNormalizer(remove_diacritics=True, split_letters=True),
         jbasic.BasicTextNormalizer(remove_diacritics=True, split_letters=True)),
        (remove_symbols, jbasic.remove_symbols),
        (remove_symbols_and_diacritics, jbasic.remove_symbols_and_diacritics),
    ]
    for port, ref in pairs:
        assert port(text) == ref(text)
