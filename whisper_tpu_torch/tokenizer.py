# Copied from whisper_tpu/tokenizer.py (jax-free); keep in step with it.
"""Whisper tokenizer: byte-level BPE with Whisper's special-token layout.

Interface parity target: reference ``whisper/tokenizer.py`` (Tokenizer
dataclass, get_encoding/get_tokenizer, LANGUAGES table, special-token layout at
``tokenizer.py:340-351``, word splitting at ``tokenizer.py:277-327``).

The BPE core is native C++ (whisper_tpu/native/bpe.cpp) replacing the Rust
``tiktoken`` dependency; Unicode pre-tokenization uses the ``regex`` module
with the exact pat_str from reference ``tokenizer.py:360``.  A pure-Python
merge loop backs the native core when the toolchain is unavailable.
"""

import base64
import ctypes
import os
import string
from dataclasses import dataclass, field
from functools import cached_property, lru_cache
from typing import Dict, List, Optional, Tuple

import numpy as np
import regex

from .native import ASSETS_DIR, load_native

# The 100 languages Whisper was trained on, in vocabulary order: the token id
# of language i is sot + 1 + i.  Data table identical to reference
# whisper/tokenizer.py:10-111 (ordering is part of the checkpoint contract).
LANGUAGES = {
    "en": "english", "zh": "chinese", "de": "german", "es": "spanish",
    "ru": "russian", "ko": "korean", "fr": "french", "ja": "japanese",
    "pt": "portuguese", "tr": "turkish", "pl": "polish", "ca": "catalan",
    "nl": "dutch", "ar": "arabic", "sv": "swedish", "it": "italian",
    "id": "indonesian", "hi": "hindi", "fi": "finnish", "vi": "vietnamese",
    "he": "hebrew", "uk": "ukrainian", "el": "greek", "ms": "malay",
    "cs": "czech", "ro": "romanian", "da": "danish", "hu": "hungarian",
    "ta": "tamil", "no": "norwegian", "th": "thai", "ur": "urdu",
    "hr": "croatian", "bg": "bulgarian", "lt": "lithuanian", "la": "latin",
    "mi": "maori", "ml": "malayalam", "cy": "welsh", "sk": "slovak",
    "te": "telugu", "fa": "persian", "lv": "latvian", "bn": "bengali",
    "sr": "serbian", "az": "azerbaijani", "sl": "slovenian", "kn": "kannada",
    "et": "estonian", "mk": "macedonian", "br": "breton", "eu": "basque",
    "is": "icelandic", "hy": "armenian", "ne": "nepali", "mn": "mongolian",
    "bs": "bosnian", "kk": "kazakh", "sq": "albanian", "sw": "swahili",
    "gl": "galician", "mr": "marathi", "pa": "punjabi", "si": "sinhala",
    "km": "khmer", "sn": "shona", "yo": "yoruba", "so": "somali",
    "af": "afrikaans", "oc": "occitan", "ka": "georgian", "be": "belarusian",
    "tg": "tajik", "sd": "sindhi", "gu": "gujarati", "am": "amharic",
    "yi": "yiddish", "lo": "lao", "uz": "uzbek", "fo": "faroese",
    "ht": "haitian creole", "ps": "pashto", "tk": "turkmen", "nn": "nynorsk",
    "mt": "maltese", "sa": "sanskrit", "lb": "luxembourgish", "my": "myanmar",
    "bo": "tibetan", "tl": "tagalog", "mg": "malagasy", "as": "assamese",
    "tt": "tatar", "haw": "hawaiian", "ln": "lingala", "ha": "hausa",
    "ba": "bashkir", "jw": "javanese", "su": "sundanese", "yue": "cantonese",
}

# language code lookup by name, with aliases (reference tokenizer.py:114-128)
TO_LANGUAGE_CODE = {
    **{language: code for code, language in LANGUAGES.items()},
    "burmese": "my",
    "valencian": "ca",
    "flemish": "nl",
    "haitian": "ht",
    "letzeburgesch": "lb",
    "pushto": "ps",
    "panjabi": "pa",
    "moldavian": "ro",
    "moldovan": "ro",
    "sinhalese": "si",
    "castilian": "es",
    "mandarin": "zh",
}

# GPT-2 pre-tokenization pattern (reference tokenizer.py:360)
_PAT_STR = r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"""


class WhisperEncoding:
    """Byte-level BPE encoding with Whisper's special tokens.

    Drop-in for the subset of ``tiktoken.Encoding`` the pipeline uses:
    encode / decode / encode_single_token / eot_token / special_tokens_set.
    """

    def __init__(
        self,
        name: str,
        mergeable_ranks: Dict[bytes, int],
        special_tokens: Dict[str, int],
        explicit_n_vocab: int,
    ):
        self.name = name
        self._ranks = mergeable_ranks
        self._special_tokens = special_tokens
        self.n_vocab = explicit_n_vocab
        self.eot_token = special_tokens["<|endoftext|>"]
        self.special_tokens_set = set(special_tokens.keys())

        # id -> bytes for ordinary tokens; id -> str for specials
        self._id_to_bytes: Dict[int, bytes] = {v: k for k, v in mergeable_ranks.items()}
        self._id_to_special: Dict[int, str] = {v: k for k, v in special_tokens.items()}

        self._pat = regex.compile(_PAT_STR)
        self._piece_cache: Dict[bytes, Tuple[int, ...]] = {}

        self._native = load_native()
        self._native_handle = None
        if self._native is not None:
            self._native_handle = self._load_native_ranks()

    def _load_native_ranks(self):
        tokens = sorted(self._ranks.items(), key=lambda kv: kv[1])
        blob = b"".join(t for t, _ in tokens)
        offsets = np.zeros(len(tokens) + 1, dtype=np.int32)
        np.cumsum([len(t) for t, _ in tokens], out=offsets[1:])
        ranks = np.array([r for _, r in tokens], dtype=np.int32)
        data = np.frombuffer(blob, dtype=np.uint8)
        handle = self._native.bpe_new()
        self._native.bpe_load(
            handle,
            data.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            ranks.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            len(tokens),
        )
        # keep the backing buffers alive until bpe_load copies complete (it
        # copies synchronously, but hold refs for safety)
        self._native_buffers = (data, offsets, ranks)
        return handle

    # -- encoding ----------------------------------------------------------

    def _encode_piece(self, piece: bytes) -> Tuple[int, ...]:
        cached = self._piece_cache.get(piece)
        if cached is not None:
            return cached
        if self._native_handle is not None:
            buf = (ctypes.c_int32 * (len(piece) + 1))()
            n = self._native.bpe_encode_piece(
                self._native_handle,
                (ctypes.c_uint8 * len(piece)).from_buffer_copy(piece),
                len(piece),
                buf,
                len(piece) + 1,
            )
            if n >= 0:
                result = tuple(buf[:n])
            else:
                result = self._encode_piece_py(piece)
        else:
            result = self._encode_piece_py(piece)
        if len(self._piece_cache) < 100_000:
            self._piece_cache[piece] = result
        return result

    def _encode_piece_py(self, piece: bytes) -> Tuple[int, ...]:
        """Pure-Python greedy lowest-rank merge (fallback path)."""
        if piece in self._ranks:
            return (self._ranks[piece],)
        parts = [piece[i : i + 1] for i in range(len(piece))]
        while len(parts) > 1:
            best_rank = None
            best_i = -1
            for i in range(len(parts) - 1):
                rank = self._ranks.get(parts[i] + parts[i + 1])
                if rank is not None and (best_rank is None or rank < best_rank):
                    best_rank = rank
                    best_i = i
            if best_i < 0:
                break
            parts[best_i : best_i + 2] = [parts[best_i] + parts[best_i + 1]]
        return tuple(self._ranks[p] for p in parts)

    def encode(self, text: str, **kwargs) -> List[int]:
        # plain text only: special-token strings in the input are an error,
        # matching tiktoken's default disallowed_special behavior
        if "<|" in text:
            for special in self.special_tokens_set:
                if special in text:
                    raise ValueError(
                        f"Encountered text corresponding to disallowed special "
                        f"token {special!r}."
                    )
        tokens: List[int] = []
        for match in self._pat.finditer(text):
            tokens.extend(self._encode_piece(match.group().encode("utf-8")))
        return tokens

    def encode_single_token(self, text: str) -> int:
        if text in self._special_tokens:
            return self._special_tokens[text]
        b = text.encode("utf-8") if isinstance(text, str) else text
        if b in self._ranks:
            return self._ranks[b]
        raise KeyError(text)

    # -- decoding ----------------------------------------------------------

    def decode_bytes(self, token_ids: List[int]) -> bytes:
        out = []
        for t in token_ids:
            b = self._id_to_bytes.get(int(t))
            if b is not None:
                out.append(b)
            else:
                special = self._id_to_special.get(int(t))
                if special is None:
                    raise KeyError(f"token id {t} out of range")
                out.append(special.encode("utf-8"))
        return b"".join(out)

    def decode(self, token_ids: List[int], errors: str = "replace") -> str:
        return self.decode_bytes(token_ids).decode("utf-8", errors=errors)


@dataclass
class Tokenizer:
    """Access to BPE encode/decode plus Whisper's special-token helpers.

    API parity with reference ``whisper/tokenizer.py:131-327``.
    """

    encoding: WhisperEncoding
    num_languages: int
    language: Optional[str] = None
    task: Optional[str] = None
    sot_sequence: Tuple[int, ...] = ()
    special_tokens: Dict[str, int] = field(default_factory=dict)

    def __post_init__(self):
        for special in self.encoding.special_tokens_set:
            self.special_tokens[special] = self.encoding.encode_single_token(special)

        sot = self.special_tokens["<|startoftranscript|>"]
        translate = self.special_tokens["<|translate|>"]
        transcribe = self.special_tokens["<|transcribe|>"]

        langs = tuple(LANGUAGES.keys())[: self.num_languages]
        sot_sequence = [sot]
        if self.language is not None:
            sot_sequence.append(sot + 1 + langs.index(self.language))
        if self.task is not None:
            sot_sequence.append(transcribe if self.task == "transcribe" else translate)
        self.sot_sequence = tuple(sot_sequence)

    def encode(self, text: str, **kwargs) -> List[int]:
        return self.encoding.encode(text, **kwargs)

    def decode(self, token_ids: List[int], **kwargs) -> str:
        token_ids = [t for t in token_ids if t < self.timestamp_begin]
        return self.encoding.decode(token_ids, **kwargs)

    def decode_with_timestamps(self, token_ids: List[int], **kwargs) -> str:
        """Like decode() but timestamp tokens render as e.g. ``<|1.08|>``."""
        return self.encoding.decode(token_ids, **kwargs)

    @cached_property
    def eot(self) -> int:
        return self.encoding.eot_token

    @cached_property
    def transcribe(self) -> int:
        return self.special_tokens["<|transcribe|>"]

    @cached_property
    def translate(self) -> int:
        return self.special_tokens["<|translate|>"]

    @cached_property
    def sot(self) -> int:
        return self.special_tokens["<|startoftranscript|>"]

    @cached_property
    def sot_lm(self) -> int:
        return self.special_tokens["<|startoflm|>"]

    @cached_property
    def sot_prev(self) -> int:
        return self.special_tokens["<|startofprev|>"]

    @cached_property
    def no_speech(self) -> int:
        return self.special_tokens["<|nospeech|>"]

    @cached_property
    def no_timestamps(self) -> int:
        return self.special_tokens["<|notimestamps|>"]

    @cached_property
    def timestamp_begin(self) -> int:
        return self.special_tokens["<|0.00|>"]

    @cached_property
    def language_token(self) -> int:
        if self.language is None:
            raise ValueError("This tokenizer does not have language token configured")
        return self.to_language_token(self.language)

    def to_language_token(self, language: str) -> int:
        if token := self.special_tokens.get(f"<|{language}|>", None):
            return token
        raise KeyError(f"Language {language} not found in tokenizer.")

    @cached_property
    def all_language_tokens(self) -> Tuple[int, ...]:
        result = []
        for token, token_id in self.special_tokens.items():
            if token.strip("<|>") in LANGUAGES:
                result.append(token_id)
        return tuple(result)[: self.num_languages]

    @cached_property
    def all_language_codes(self) -> Tuple[str, ...]:
        return tuple(self.decode([l]).strip("<|>") for l in self.all_language_tokens)

    @cached_property
    def sot_sequence_including_notimestamps(self) -> Tuple[int, ...]:
        return tuple(list(self.sot_sequence) + [self.no_timestamps])

    @cached_property
    def non_speech_tokens(self) -> Tuple[int, ...]:
        """Token ids of speaker tags / sound annotations to suppress.

        Same construction as reference ``tokenizer.py:241-275``: symbol list,
        multi-char brackets, U+2640-267F music symbols (safe to suppress by
        first token since the 3-byte UTF-8 forms share a prefix), plus
        leading-position ``-`` and ``'``.
        """
        symbols = list('"#()*+/:;<=>@[\\]^_`{|}~「」『』')
        symbols += (
            "<< >> <<< >>> -- --- -( -[ (' (\" (( )) ((( ))) [[ ]] {{ }} ♪♪ ♪♪♪".split()
        )
        miscellaneous = set("♩♪♫♬♭♮♯")
        assert all(0x2640 <= ord(c) <= 0x267F for c in miscellaneous)

        result = {self.encoding.encode(" -")[0], self.encoding.encode(" '")[0]}
        for symbol in symbols + list(miscellaneous):
            for tokens in [
                self.encoding.encode(symbol),
                self.encoding.encode(" " + symbol),
            ]:
                if len(tokens) == 1 or symbol in miscellaneous:
                    result.add(tokens[0])

        return tuple(sorted(result))

    def split_to_word_tokens(self, tokens: List[int]):
        if self.language in {"zh", "ja", "th", "lo", "my", "yue"}:
            # no-space scripts: split at valid unicode codepoint boundaries
            return self.split_tokens_on_unicode(tokens)
        return self.split_tokens_on_spaces(tokens)

    def split_tokens_on_unicode(self, tokens: List[int]):
        decoded_full = self.decode_with_timestamps(tokens)
        replacement_char = "�"

        words = []
        word_tokens = []
        current_tokens: List[int] = []
        unicode_offset = 0

        for token in tokens:
            current_tokens.append(token)
            decoded = self.decode_with_timestamps(current_tokens)

            # a group is complete when its decode has no replacement char, or
            # when the replacement char is genuinely present in the full text
            if (
                replacement_char not in decoded
                or decoded_full[unicode_offset + decoded.index(replacement_char)]
                == replacement_char
            ):
                words.append(decoded)
                word_tokens.append(current_tokens)
                current_tokens = []
                unicode_offset += len(decoded)

        return words, word_tokens

    def split_tokens_on_spaces(self, tokens: List[int]):
        subwords, subword_tokens_list = self.split_tokens_on_unicode(tokens)
        words = []
        word_tokens = []

        for subword, subword_tokens in zip(subwords, subword_tokens_list):
            special = subword_tokens[0] >= self.eot
            with_space = subword.startswith(" ")
            punctuation = subword.strip() in string.punctuation
            if special or with_space or punctuation or len(words) == 0:
                words.append(subword)
                word_tokens.append(subword_tokens)
            else:
                words[-1] = words[-1] + subword
                word_tokens[-1].extend(subword_tokens)

        return words, word_tokens


@lru_cache(maxsize=None)
def get_encoding(name: str = "gpt2", num_languages: int = 99) -> WhisperEncoding:
    vocab_path = os.path.join(ASSETS_DIR, f"{name}.tiktoken")
    with open(vocab_path) as f:
        ranks = {
            base64.b64decode(token): int(rank)
            for token, rank in (line.split() for line in f if line)
        }
    n_vocab = len(ranks)
    special_tokens = {}

    # special-token layout (reference tokenizer.py:340-351); the 1501
    # timestamp tokens cover 0.00-30.00s in 0.02s steps
    specials = [
        "<|endoftext|>",
        "<|startoftranscript|>",
        *[f"<|{lang}|>" for lang in list(LANGUAGES.keys())[:num_languages]],
        "<|translate|>",
        "<|transcribe|>",
        "<|startoflm|>",
        "<|startofprev|>",
        "<|nospeech|>",
        "<|notimestamps|>",
        *[f"<|{i * 0.02:.2f}|>" for i in range(1501)],
    ]
    for token in specials:
        special_tokens[token] = n_vocab
        n_vocab += 1

    return WhisperEncoding(
        name=f"{name}.tiktoken",
        mergeable_ranks=ranks,
        special_tokens=special_tokens,
        explicit_n_vocab=n_vocab,
    )


@lru_cache(maxsize=None)
def get_tokenizer(
    multilingual: bool,
    *,
    num_languages: int = 99,
    language: Optional[str] = None,
    task: Optional[str] = None,  # "transcribe", "translate", or None
) -> Tokenizer:
    if language is not None:
        language = language.lower()
        if language not in LANGUAGES:
            if language in TO_LANGUAGE_CODE:
                language = TO_LANGUAGE_CODE[language]
            else:
                raise ValueError(f"Unsupported language: {language}")

    if multilingual:
        encoding_name = "multilingual"
        language = language or "en"
        task = task or "transcribe"
    else:
        encoding_name = "gpt2"
        language = None
        task = None

    encoding = get_encoding(name=encoding_name, num_languages=num_languages)

    return Tokenizer(
        encoding=encoding, num_languages=num_languages, language=language, task=task
    )
