"""Segment decoding: options, orchestration, and result assembly.

Counterpart of ``whisper_tpu/decoding.py`` (API parity target: reference
``whisper/decoding.py``): ``DecodingOptions``, ``DecodingResult``,
``decode()``, ``detect_language()`` and the ``DecodingTask`` wiring.  The
per-token work is in :mod:`whisper_tpu_torch.engine`; this module builds
the initial tokens and suppression masks and turns the engine's buffers
into ``DecodingResult`` objects.  This slice decodes greedily (and samples
at T > 0) one audio at a time.
"""

from dataclasses import dataclass, field, replace
from typing import TYPE_CHECKING, Dict, Iterable, List, Optional, Union

import numpy as np
import torch

from .audio import CHUNK_LENGTH
from .engine import (
    EngineSpec,
    FilterArgs,
    ctx_bucket,
    decode_engine,
    detect_language_engine,
    prefill_bucket,
)
from .tokenizer import Tokenizer, get_tokenizer
from .utils import compression_ratio

if TYPE_CHECKING:
    from .models.whisper import Whisper


def _token_mask(n_vocab: int, indices: Iterable[int], device) -> torch.Tensor:
    mask = torch.zeros(n_vocab, dtype=torch.bool)
    mask[list(indices)] = True
    return mask.to(device)


def _as_mel(model: "Whisper", mel) -> torch.Tensor:
    mel = torch.as_tensor(mel)
    return mel.to(model.device)


def _features_given(model: "Whisper", mel: torch.Tensor) -> bool:
    return tuple(mel.shape[-2:]) == (model.dims.n_audio_ctx, model.dims.n_audio_state)


def _language_probs(tokenizer: Tokenizer, probs: torch.Tensor) -> List[Dict[str, float]]:
    probs = probs[:, list(tokenizer.all_language_tokens)].float().cpu().numpy()
    return [
        {c: float(row[j]) for j, c in enumerate(tokenizer.all_language_codes)}
        for row in probs
    ]


def detect_language(model: "Whisper", mel, tokenizer: Tokenizer = None):
    """Detect the spoken language from one decoder step at <|sot|>.

    Returns (language_tokens (n_audio,), language_probs list-of-dicts), with
    singleton squeezing — parity with reference decoding.py:18-77.
    """
    if tokenizer is None:
        tokenizer = get_tokenizer(model.is_multilingual, num_languages=model.num_languages)
    if tokenizer.language is None or tokenizer.language_token not in tokenizer.sot_sequence:
        raise ValueError("This model doesn't have language tokens so it can't perform lang id")

    mel = _as_mel(model, mel)
    single = mel.dim() == 2
    if single:
        mel = mel[None]
    lang_tokens, lang_probs, _ = detect_language_engine(
        model.params,
        model.dims,
        mel,
        _token_mask(model.dims.n_vocab, tokenizer.all_language_tokens, model.device),
        tokenizer.sot,
        features_given=_features_given(model, mel),
    )
    lang_tokens = lang_tokens.cpu().numpy()
    language_probs = _language_probs(tokenizer, lang_probs)
    if single:
        return lang_tokens[0], language_probs[0]
    return lang_tokens, language_probs


@dataclass(frozen=True)
class DecodingOptions:
    # field-for-field parity with reference decoding.py:80-114
    task: str = "transcribe"  # "transcribe" or "translate"
    language: Optional[str] = None

    temperature: float = 0.0
    sample_len: Optional[int] = None
    best_of: Optional[int] = None  # independent samples when t > 0
    beam_size: Optional[int] = None  # beams when t == 0
    patience: Optional[float] = None  # beam patience (arXiv:2204.05424)

    length_penalty: Optional[float] = None  # Google-NMT alpha, or length norm

    prompt: Optional[Union[str, List[int]]] = None  # previous-context prefix
    prefix: Optional[Union[str, List[int]]] = None  # current-context prefix

    suppress_tokens: Optional[Union[str, Iterable[int]]] = "-1"
    suppress_blank: bool = True

    without_timestamps: bool = False
    max_initial_timestamp: Optional[float] = 1.0

    # kept for API compatibility; the compute dtype is chosen at model load
    fp16: bool = True

    # explicit seed for temperature > 0 sampling (a torch.Generator on the
    # model's device); None draws one from numpy's global RNG
    seed: Optional[int] = None

    # "int8" cross-attention K/V: not in this slice (raises)
    kv_cache_dtype: Optional[str] = None


@dataclass(frozen=True)
class DecodingResult:
    audio_features: Optional[torch.Tensor]
    language: str
    language_probs: Optional[Dict[str, float]] = None
    tokens: List[int] = field(default_factory=list)
    text: str = ""
    avg_logprob: float = np.nan
    no_speech_prob: float = np.nan
    temperature: float = np.nan
    compression_ratio: float = np.nan


class DecodingTask:
    """Host orchestration of one segment-decoding configuration."""

    # benchmark hook (see _bench_forced); None in production
    _forced_tokens = None

    def __init__(self, model: "Whisper", options: DecodingOptions,
                 draft_model: Optional["Whisper"] = None):
        self.model = model
        if draft_model is not None:
            raise NotImplementedError(
                "speculative decoding (draft_model): ROADMAP.md, Queue 1, "
                "'Speculative decoding'"
            )

        language = options.language or "en"
        tokenizer = get_tokenizer(
            model.is_multilingual,
            num_languages=model.num_languages,
            language=language,
            task=options.task,
        )
        self.tokenizer: Tokenizer = tokenizer
        self.options = self._verify_options(options)

        self.n_ctx: int = model.dims.n_text_ctx
        self.sample_len: int = options.sample_len or model.dims.n_text_ctx // 2

        self.sot_sequence = tokenizer.sot_sequence
        if self.options.without_timestamps:
            self.sot_sequence = tokenizer.sot_sequence_including_notimestamps

        self.initial_tokens = self._get_initial_tokens()
        self.sample_begin: int = len(self.initial_tokens)
        self.sot_index: int = self.initial_tokens.index(tokenizer.sot)

        # suppression masks (reference decoding.py:555-558,615-642)
        n_vocab = model.dims.n_vocab
        suppress_indices = self._get_suppress_tokens() if self.options.suppress_tokens else ()
        blank_indices = (
            tuple(tokenizer.encode(" ") + [tokenizer.eot]) if self.options.suppress_blank else ()
        )
        self._suppress_mask = _token_mask(n_vocab, suppress_indices, model.device)
        self._blank_mask = _token_mask(n_vocab, blank_indices, model.device)

        max_initial_ts_index = -1
        if not options.without_timestamps and options.max_initial_timestamp:
            precision = CHUNK_LENGTH / model.dims.n_audio_ctx  # 0.02 s
            max_initial_ts_index = round(options.max_initial_timestamp / precision)
        self._max_initial_ts_index = max_initial_ts_index

        prefill = prefill_bucket(len(self.initial_tokens), self.n_ctx)
        self.spec = EngineSpec(
            prefill_len=prefill,
            ctx_len=ctx_bucket(prefill, self.sample_len, self.n_ctx),
            argmax=options.temperature == 0,
            use_ts_rules=not options.without_timestamps,
            eot=tokenizer.eot,
            no_speech=tokenizer.no_speech if tokenizer.no_speech is not None else -1,
            no_timestamps=tokenizer.no_timestamps,
            timestamp_begin=tokenizer.timestamp_begin,
        )

    # -- option/token assembly (parity with decoding.py:572-642) -----------

    def _verify_options(self, options: DecodingOptions) -> DecodingOptions:
        if options.beam_size is not None and options.best_of is not None:
            raise ValueError("beam_size and best_of can't be given together")
        if options.temperature == 0:
            if options.best_of is not None:
                raise ValueError("best_of with greedy sampling (T=0) is not compatible")
        if options.patience is not None and options.beam_size is None:
            raise ValueError("patience requires beam_size to be given")
        if options.length_penalty is not None and not (0 <= options.length_penalty <= 1):
            raise ValueError("length_penalty (alpha) should be a value between 0 and 1")
        if options.kv_cache_dtype not in (None, "int8"):
            raise ValueError("kv_cache_dtype must be None or 'int8'")
        if options.beam_size or options.best_of:
            raise NotImplementedError(
                "beam_size / best_of: ROADMAP.md, Queue 1, 'Beam search and best-of'"
            )
        if options.kv_cache_dtype == "int8":
            raise NotImplementedError(
                "kv_cache_dtype='int8': ROADMAP.md, Queue 1, 'Quantization'"
            )
        return options

    def _get_initial_tokens(self):
        tokens = list(self.sot_sequence)

        if prefix := self.options.prefix:
            prefix_tokens = (
                self.tokenizer.encode(" " + prefix.strip()) if isinstance(prefix, str) else prefix
            )
            if self.sample_len is not None:
                max_prefix_len = self.n_ctx // 2 - self.sample_len
                prefix_tokens = prefix_tokens[-max_prefix_len:]
            tokens = tokens + prefix_tokens

        if prompt := self.options.prompt:
            prompt_tokens = (
                self.tokenizer.encode(" " + prompt.strip()) if isinstance(prompt, str) else prompt
            )
            tokens = [self.tokenizer.sot_prev] + prompt_tokens[-(self.n_ctx // 2 - 1):] + tokens

        return tuple(tokens)

    def _get_suppress_tokens(self):
        suppress_tokens = self.options.suppress_tokens

        if isinstance(suppress_tokens, str):
            suppress_tokens = [int(t) for t in suppress_tokens.split(",")]

        if -1 in suppress_tokens:
            suppress_tokens = [t for t in suppress_tokens if t >= 0]
            suppress_tokens.extend(self.tokenizer.non_speech_tokens)
        elif suppress_tokens is None or len(suppress_tokens) == 0:
            suppress_tokens = []
        else:
            assert isinstance(suppress_tokens, list), "suppress_tokens must be a list"

        suppress_tokens.extend(
            [
                self.tokenizer.transcribe,
                self.tokenizer.translate,
                self.tokenizer.sot,
                self.tokenizer.sot_prev,
                self.tokenizer.sot_lm,
            ]
        )
        if self.tokenizer.no_speech is not None:
            suppress_tokens.append(self.tokenizer.no_speech)

        return tuple(sorted(set(suppress_tokens)))

    def _generator(self) -> Optional[torch.Generator]:
        """Sampling generator on the model's device: DecodingOptions.seed,
        else a seed from numpy's global RNG.  None at temperature 0."""
        if self.options.temperature == 0:
            return None
        seed = self.options.seed
        if seed is None:
            seed = int(np.random.randint(0, 2**31 - 1))
        return torch.Generator(device=self.model.device).manual_seed(seed)

    def _bench_forced(self) -> Optional[List[int]]:
        """Benchmark-only pinned token sequence (engine._greedy_update).

        Set ``DecodingTask._forced_tokens`` (class attribute — covers the
        tasks transcribe constructs) or an instance attribute to a sequence
        of ints; every greedy sampling step ``s < len`` then commits
        ``forced[s]`` while all per-step compute still runs.  Lets a
        benchmark drive random weights through production-shaped decodes.
        """
        forced = self._forced_tokens
        if forced is None:
            return None
        return [int(x) for x in np.asarray(forced).reshape(-1)]

    # -- run ---------------------------------------------------------------

    def run(self, mel) -> List[DecodingResult]:
        tokenizer = self.tokenizer
        mel = _as_mel(self.model, mel)
        n_audio = mel.shape[0]
        if n_audio != 1:
            raise NotImplementedError(
                "batched decoding: ROADMAP.md, Queue 1, 'Batch and chunked'"
            )
        features_given = _features_given(self.model, mel)

        initial = list(self.initial_tokens)
        languages = [self.options.language]
        language_probs = None
        audio_features = None

        if self.options.language is None or self.options.task == "lang_id":
            lang_tokens, lang_probs, audio_features = detect_language_engine(
                self.model.params,
                self.model.dims,
                mel,
                _token_mask(self.model.dims.n_vocab, tokenizer.all_language_tokens,
                            self.model.device),
                tokenizer.sot,
                features_given=features_given,
            )
            language_probs = _language_probs(tokenizer, lang_probs)
            languages = [max(p, key=p.get) for p in language_probs]
            if self.options.language is None:
                initial[self.sot_index + 1] = int(lang_tokens[0])

        if self.options.task == "lang_id":
            return [
                DecodingResult(
                    audio_features=audio_features[0], language=languages[0],
                    language_probs=language_probs[0],
                )
            ]

        if audio_features is not None:
            # reuse the features computed during language detection instead
            # of re-encoding the mel (reference decoding.py:716-722)
            mel = audio_features
            features_given = True

        initial_block = torch.zeros((1, self.spec.prefill_len), dtype=torch.int64)
        initial_block[0, : self.sample_begin] = torch.tensor(initial)
        fargs = FilterArgs(
            suppress_mask=self._suppress_mask,
            blank_mask=self._blank_mask,
            sample_begin=self.sample_begin,
            max_initial_ts_index=self._max_initial_ts_index,
        )
        result = decode_engine(
            self.model.params,
            self.model.dims,
            self.spec,
            mel,
            initial_block.to(self.model.device),
            self.sample_begin,
            self.sot_index,
            self.sample_len,
            self.options.temperature,
            fargs,
            generator=self._generator(),
            features_given=features_given,
            forced_tokens=self._bench_forced(),
        )
        return self._assemble(result, languages, language_probs)

    # -- host finalize (parity with decoding.py:712-789) ----------------------

    def _assemble(self, result, languages, language_probs) -> List[DecodingResult]:
        tokenizer = self.tokenizer
        eot = tokenizer.eot
        tokens_buf = result.tokens.cpu().numpy()  # (1, n_ctx+1)
        seq_len = min(int(result.seq_len[0]), tokens_buf.shape[1])
        sum_logprob = float(result.sum_logprobs[0])
        no_speech_prob = float(result.no_speech_probs[0])

        # slice [sample_begin : first EOT] (decoding.py:749-752)
        seq = [int(t) for t in tokens_buf[0, :seq_len]] + [eot]
        tokens = seq[self.sample_begin : seq.index(eot, self.sample_begin)]

        # rank by sum_logprob with length penalty (decoding.py:190-213): one
        # candidate, so only avg_logprob below depends on it
        text = tokenizer.decode(tokens).strip()
        return [
            DecodingResult(
                audio_features=result.audio_features[0],
                language=languages[0],
                language_probs=language_probs[0] if language_probs else None,
                tokens=tokens,
                text=text,
                avg_logprob=sum_logprob / (len(tokens) + 1),
                no_speech_prob=no_speech_prob,
                temperature=self.options.temperature,
                compression_ratio=compression_ratio(text),
            )
        ]


def decode(
    model: "Whisper",
    mel,
    options: DecodingOptions = DecodingOptions(),
    **kwargs,
) -> Union[DecodingResult, List[DecodingResult]]:
    """Decode 30-second mel segment(s); parity with reference decoding.py:792-826."""
    mel = _as_mel(model, mel)
    if single := mel.dim() == 2:
        mel = mel[None]

    draft_model = kwargs.pop("draft_model", None)
    if kwargs:
        options = replace(options, **kwargs)

    result = DecodingTask(model, options, draft_model=draft_model).run(mel)
    return result[0] if single else result
