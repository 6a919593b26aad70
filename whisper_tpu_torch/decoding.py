"""Segment decoding: options, orchestration, and result assembly.

Counterpart of ``whisper_tpu/decoding.py`` (API parity target: reference
``whisper/decoding.py``): ``DecodingOptions``, ``DecodingResult``,
``decode()``, ``detect_language()`` and the ``DecodingTask`` wiring.  The
per-token work is in :mod:`whisper_tpu_torch.engine`; this module builds
the initial tokens and suppression masks and turns the engine's buffers
into ``DecodingResult`` objects: greedy, best-of sampling and beam search,
for one audio or a batch, and for a batch whose windows carry prompts of
their own (``run_with_prompts``, under ``transcribe_batch``).

Under a mesh (``with mesh:``, :mod:`whisper_tpu_torch.parallel`) every
rank is given the whole batch, as whisper_tpu's single controller is; each
data group decodes its contiguous block of rows (``Mesh.rows``: a group
may get none, and still joins the gather) under its model group alone, and
every rank returns every row's result, gathered as objects on a CPU gloo
group.  The ranks of a model group take the same host decisions: their
logits are the same after each all-reduce, and a sampling seed drawn from
numpy is rank 0's of the group.
"""

from dataclasses import dataclass, field, replace
from typing import TYPE_CHECKING, Dict, Iterable, List, Optional, Union

import numpy as np
import torch

from .audio import CHUNK_LENGTH
from .engine import (
    EngineResult,
    EngineSpec,
    FilterArgs,
    ctx_bucket,
    decode_engine,
    decode_engine_speculative,
    detect_language_engine,
    prefill_bucket,
)
from .parallel.mesh import current_mesh
from .profiling import span
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


def _host(result: "DecodingResult") -> "DecodingResult":
    if isinstance(result.audio_features, torch.Tensor):
        return replace(result, audio_features=result.audio_features.cpu())
    return result


def _over_data(model: "Whisper", run, mel: torch.Tensor, *per_row) -> List["DecodingResult"]:
    """``run(mel, *per_row)`` on the batch; under a mesh with a data axis
    above 1, on this data group's rows only, under its model group
    (``Mesh.model_only``), with every group's results gathered in row
    order.  The features come back on the model's device."""
    mesh = current_mesh()
    if mesh is None or mesh.shape["data"] == 1:
        return run(mel, *per_row)
    rows = mesh.rows(mel.shape[0])
    local = []
    if len(rows):
        with mesh.model_only():
            local = run(mel[rows.start:rows.stop], *(a[rows.start:rows.stop] for a in per_row))
    parts = mesh.gather_objects([_host(r) for r in local], "data")
    return [replace(r, audio_features=r.audio_features.to(model.device))
            if isinstance(r.audio_features, torch.Tensor) else r for part in parts for r in part]


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

    # "int8": the token loop's cross-attention K/V in int8, per (audio,
    # head, channel), quantized after a full-precision prefill
    kv_cache_dtype: Optional[str] = None

    # tokens the draft model proposes per speculative round (used only when
    # a draft model is given; see DecodingTask)
    draft_len: int = 4


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
    """Host orchestration of one segment-decoding configuration.

    ``draft_model``: a smaller Whisper for speculative greedy decoding
    (:func:`~whisper_tpu_torch.engine.decode_engine_speculative`); the
    tokens stay the target's own greedy choices, the draft only sets the
    speed.  It is kept at temperature 0 without beam or best-of, and must
    share the target's vocabulary; other configurations ignore it
    (whisper_tpu/decoding.py:205-241).
    """

    # benchmark hook (see _bench_forced); None in production
    _forced_tokens = None

    def __init__(self, model: "Whisper", options: DecodingOptions,
                 draft_model: Optional["Whisper"] = None):
        self.model = model
        self.draft_model = None
        if draft_model is not None and options.temperature == 0 and not (
            options.beam_size or options.best_of
        ):
            if draft_model.dims.n_vocab != model.dims.n_vocab:
                raise ValueError(
                    "draft model must share the target's vocabulary "
                    f"(draft {draft_model.dims.n_vocab} vs "
                    f"target {model.dims.n_vocab}); e.g. large-v3-turbo "
                    "drafts for large-v3, tiny for large-v2"
                )
            self.draft_model = draft_model
        # the draft reads the target's encoder output when the feature shapes
        # match (large-v3-turbo kept large-v3's encoder); a mismatched
        # encoder would only lower the acceptance rate
        self._share_encoder = self.draft_model is not None and (
            self.draft_model.dims.n_audio_ctx, self.draft_model.dims.n_audio_state
        ) == (model.dims.n_audio_ctx, model.dims.n_audio_state)

        language = options.language or "en"
        tokenizer = get_tokenizer(
            model.is_multilingual,
            num_languages=model.num_languages,
            language=language,
            task=options.task,
        )
        self.tokenizer: Tokenizer = tokenizer
        self.options = self._verify_options(options)

        self.n_group: int = options.beam_size or options.best_of or 1
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

        beam = options.beam_size or 0
        patience = options.patience or 1.0
        max_candidates = round(beam * patience) if beam else 0
        if beam:
            assert max_candidates > 0, f"Invalid beam size ({beam}) or patience ({patience})"

        prefill = prefill_bucket(len(self.initial_tokens), self.n_ctx)
        self.spec = EngineSpec(
            beam_size=beam,
            n_group=self.n_group,
            max_candidates=max_candidates,
            prefill_len=prefill,
            ctx_len=ctx_bucket(prefill, self.sample_len, self.n_ctx),
            argmax=options.temperature == 0,
            use_ts_rules=not options.without_timestamps,
            eot=tokenizer.eot,
            no_speech=tokenizer.no_speech if tokenizer.no_speech is not None else -1,
            no_timestamps=tokenizer.no_timestamps,
            timestamp_begin=tokenizer.timestamp_begin,
            kv_int8=options.kv_cache_dtype == "int8",
            # greedy/sampling rows of a decoder at least 1024 wide may defer
            # their self-K/V writes in 8-step blocks; write_block() decides
            # per decode (whisper_tpu/decoding.py:310-319)
            write_block=0 if beam or model.dims.n_text_state < 1024 else 8,
        )

    def write_block(self, n_audio: int) -> int:
        """The write block of a decode of n_audio audios: as whisper_tpu
        resolves it on its kernel path (whisper_tpu/decoding.py:676-684),
        since every decode here runs kernel K2.  0 (a K/V column per step)
        for beam search, for a decoder narrower than 1024, and for one audio
        with its weights and cross K/V unquantized or with a group of rows;
        else the spec's 8, for several audios (best-of groups among them)
        and for one row of an int8 configuration."""
        from .quantize import Int8Weight

        wb = self.spec.write_block
        if n_audio > 1:
            return wb
        all_dense = (not isinstance(self.model.params["decoder"]["blocks"]["q_w"], Int8Weight)
                     and self.options.kv_cache_dtype != "int8")
        return 0 if all_dense or self.n_group > 1 else wb

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
            mesh = current_mesh()
            if mesh is not None:  # a model group samples alike
                seed = mesh.broadcast_object(seed, "model")
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
        if self.options.beam_size:
            raise ValueError("_forced_tokens is greedy-only (benchmark hook)")
        return [int(x) for x in np.asarray(forced).reshape(-1)]

    # -- run ---------------------------------------------------------------

    def _engine(self, spec: EngineSpec, mel, initial_rows: List[List[int]], sample_begin,
                sot_index, features_given: bool) -> EngineResult:
        """decode_engine on per-audio initial token rows, right-padded to
        the spec's prefill block; with a draft model,
        decode_engine_speculative."""
        initial_block = torch.zeros((len(initial_rows), spec.prefill_len), dtype=torch.int64)
        for i, row in enumerate(initial_rows):
            initial_block[i, : len(row)] = torch.tensor(row)
        initial_block = initial_block.to(self.model.device)
        filter_args = FilterArgs(
            suppress_mask=self._suppress_mask,
            blank_mask=self._blank_mask,
            sample_begin=sample_begin,
            max_initial_ts_index=self._max_initial_ts_index,
        )
        if self.draft_model is not None:
            return decode_engine_speculative(
                self.model.params,
                self.draft_model.params,
                self.model.dims,
                self.draft_model.dims,
                spec,
                mel,
                initial_block,
                sample_begin,
                sot_index,
                self.sample_len,
                filter_args,
                draft_len=self.options.draft_len,
                features_given=features_given,
                share_encoder=self._share_encoder,
                # whisper_tpu's benchmark-only all-accept mode, not an option
                force_accept=getattr(self, "_force_accept", False),
            )
        return decode_engine(
            self.model.params,
            self.model.dims,
            replace(spec, write_block=self.write_block(len(initial_rows))),
            mel,
            initial_block,
            sample_begin,
            sot_index,
            self.sample_len,
            self.options.temperature,
            filter_args,
            generator=self._generator(),
            features_given=features_given,
            forced_tokens=self._bench_forced(),
        )

    def run(self, mel) -> List[DecodingResult]:
        """Decode a batch of mels (n_audio, n_mels, 3000), or of encoder
        features (n_audio, Ta, C): one result per audio, each with its own
        detected language when ``options.language`` is None.  Under a mesh
        each data group decodes its rows (see the module's docstring)."""
        return _over_data(self.model, self._run, _as_mel(self.model, mel))

    def _run(self, mel: torch.Tensor) -> List[DecodingResult]:
        tokenizer = self.tokenizer
        n_audio = mel.shape[0]
        features_given = _features_given(self.model, mel)

        # per-audio initial tokens (language id may rewrite the lang slot)
        initial = [list(self.initial_tokens) for _ in range(n_audio)]
        languages = [self.options.language] * n_audio
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
                for row, token in zip(initial, lang_tokens.cpu().tolist()):
                    row[self.sot_index + 1] = int(token)

        if self.options.task == "lang_id":
            return [
                DecodingResult(
                    audio_features=audio_features[i], language=languages[i],
                    language_probs=language_probs[i],
                )
                for i in range(n_audio)
            ]

        if audio_features is not None and (self.draft_model is None or self._share_encoder):
            # reuse the features computed during language detection instead
            # of re-encoding the mel (reference decoding.py:716-722); a draft
            # with an encoder of its own needs the raw mel
            mel = audio_features
            features_given = True

        result = self._engine(self.spec, mel, initial, self.sample_begin, self.sot_index,
                              features_given)
        with span("assemble"):  # the results read back to the host
            return self._assemble(result, languages, language_probs)

    def run_with_prompts(self, mel, prompts: List[List[int]]) -> List[DecodingResult]:
        """Decode a batch where each row carries its own prompt tokens.

        Per-row semantics are those of running decode() once per row with
        ``DecodingOptions(prompt=prompts[i])``: the engine runs each row at
        its own position, so rows with prompts of different lengths share
        one decode (whisper_tpu/decoding.py:687-782).  This is what lets
        transcribe_batch keep per-file condition_on_previous_text
        conditioning.  Under a mesh each data group decodes its rows.
        """
        mel = _as_mel(self.model, mel)
        assert len(prompts) == mel.shape[0]
        return _over_data(self.model, self._run_with_prompts, mel, list(prompts))

    def _run_with_prompts(self, mel: torch.Tensor, prompts: List[List[int]]) -> List[DecodingResult]:
        if self.options.language is None:
            raise ValueError("run_with_prompts requires a pinned language")
        if self.options.prompt or self.options.prefix:
            raise ValueError("options-level prompt/prefix conflict with per-row prompts")

        tokenizer = self.tokenizer
        n_audio = mel.shape[0]

        max_prompt = self.n_ctx // 2 - 1
        rows: List[List[int]] = []
        for prompt in prompts:
            tokens = list(self.sot_sequence)
            if prompt:
                tokens = [tokenizer.sot_prev] + list(prompt)[-max_prompt:] + tokens
            rows.append(tokens)
        sample_begins = [len(r) for r in rows]
        sot_indices = [r.index(tokenizer.sot) for r in rows]

        P = prefill_bucket(max(sample_begins), self.n_ctx)
        spec = replace(self.spec, prefill_len=P, ctx_len=ctx_bucket(P, self.sample_len, self.n_ctx))
        result = self._engine(spec, mel, rows, sample_begins, sot_indices,
                              _features_given(self.model, mel))
        languages = [self.options.language] * n_audio
        with span("assemble"):
            return self._assemble(result, languages, None, sample_begins=sample_begins)

    # -- host finalize (parity with decoding.py:384-404,712-789) ------------

    def _assemble(self, result, languages, language_probs,
                  sample_begins=None) -> List[DecodingResult]:
        """One result per audio (one language each) from the engine's
        buffers of its G rows."""
        tokenizer = self.tokenizer
        eot = tokenizer.eot
        G = self.n_group
        n_audio = len(languages)
        if sample_begins is None:
            sample_begins = [self.sample_begin] * n_audio
        tokens_buf = result.tokens.cpu().numpy()  # (n_audio * G, n_ctx+1)
        seq_lens = np.minimum(result.seq_len.cpu().numpy(), tokens_buf.shape[1])
        sum_logprobs = result.sum_logprobs.cpu().numpy()
        no_speech_probs = result.no_speech_probs.float().cpu().numpy()

        def trim(seq: List[int], sb: int) -> List[int]:
            """slice [sample_begin : first EOT] (decoding.py:749-752)"""
            seq = [int(t) for t in seq] + [eot]
            return seq[sb : seq.index(eot, sb)]

        grouped_tokens: List[List[List[int]]] = []
        grouped_scores: List[List[float]] = []
        if self.spec.beam_size:
            beam = self.spec.beam_size
            fin_tokens = result.fin_tokens.cpu().numpy()
            fin_scores = result.fin_scores.cpu().numpy()
            fin_count = result.fin_count.cpu().numpy()
            for i in range(n_audio):
                # finished rows carry their own EOT; trim() stops there
                seqs = [list(row) for row in fin_tokens[i, : fin_count[i]]]
                scores = [float(x) for x in fin_scores[i, : fin_count[i]]]
                if len(seqs) < beam:
                    # top up with unfinished beams by score (decoding.py:384-395)
                    group_lp = sum_logprobs[i * G : (i + 1) * G]
                    for j in list(np.argsort(group_lp))[::-1]:
                        row = i * G + j
                        seqs.append(list(tokens_buf[row, : seq_lens[row]]) + [eot])
                        scores.append(float(group_lp[j]))
                        if len(seqs) >= beam:
                            break
                grouped_tokens.append([trim(s, sample_begins[i]) for s in seqs])
                grouped_scores.append(scores)
        else:
            for i in range(n_audio):
                rows = range(i * G, (i + 1) * G)
                grouped_tokens.append([trim(tokens_buf[r, : seq_lens[r]], sample_begins[i])
                                       for r in rows])
                grouped_scores.append([float(sum_logprobs[r]) for r in rows])

        # rank by sum_logprob with length penalty (decoding.py:190-213)
        alpha = self.options.length_penalty

        def score(lp: float, length: int) -> float:
            penalty = length if alpha is None else ((5 + length) / 6) ** alpha
            return lp / penalty

        results = []
        for i, (seqs, scores) in enumerate(zip(grouped_tokens, grouped_scores)):
            ranked = int(np.argmax([score(lp, len(s)) for lp, s in zip(scores, seqs)]))
            tokens, sum_logprob = seqs[ranked], scores[ranked]
            text = tokenizer.decode(tokens).strip()
            results.append(
                DecodingResult(
                    audio_features=result.audio_features[i],
                    language=languages[i],
                    language_probs=language_probs[i] if language_probs else None,
                    tokens=tokens,
                    text=text,
                    avg_logprob=sum_logprob / (len(tokens) + 1),
                    no_speech_prob=float(no_speech_probs[i]),
                    temperature=self.options.temperature,
                    compression_ratio=compression_ratio(text),
                )
            )
        return results


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
