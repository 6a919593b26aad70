"""Batched multi-file transcription for serving throughput.

Counterpart of ``whisper_tpu/batch.py``.  Windows from many files decode
together, one row (or one beam or best-of group) per file, through
``DecodingTask.run_with_prompts``: the decode step reads every weight once
for all rows, so extra files cost little per step.

Semantics: identical per file to ``transcribe``, including the default
``condition_on_previous_text=True`` prompt conditioning, because the decode
engine runs each row at its own position (each file's window carries its
own prompt length).  Language is either pinned or detected once per file on
its first window (batched), with files grouped by detected language.  The
per-file seek and segmentation logic is ``transcribe``'s
(``transcribe.segment_window``).  Word timestamps align all of a round's
files in one batched pass (``timing.find_alignment_batch``).

The mel store of a group of files stays on the model's device, and each
round's windows are sliced out of it there (:func:`_slice_windows`).
PyTorch compiles nothing per shape, so the JAX package's waveform-width
buckets and padded batch rows, which bound its XLA compiles, are not
carried over: a round decodes exactly its files' rows.

A language model over an audio prefix (``models.uni_moe.UniMoe``) takes
its own path through the same groups, rounds and mel store
(:func:`_transcribe_lm`): fixed 30 s windows, one greedy segment each.

Under a mesh (``with mesh:``) the files split over the data groups, each a
contiguous block (``Mesh.rows``); a group runs its own groups of files and
seek loops under its model group alone, and every rank returns every
file's result, gathered in input order on a CPU gloo group.
"""

import inspect
from queue import Queue
from threading import Thread
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from . import engine
from .audio import (
    FRAMES_PER_SECOND,
    HOP_LENGTH,
    N_FRAMES,
    N_SAMPLES,
    SAMPLE_RATE,
    load_audio,
    log_mel_spectrogram,
)
from .decoding import DecodingOptions, DecodingTask, detect_language
from .models.uni_moe import UniMoe
from .parallel.mesh import current_mesh
from .profiling import recording, span
from .timing import add_word_timestamps, find_alignment_batch
from .tokenizer import get_tokenizer
from .transcribe import _refine_seek_with_word_timings, needs_fallback, segment_window
from .utils import exact_div, get_end


def _slice_windows(
    mels: torch.Tensor,  # (n_files, n_mels, F) mel store on the device
    rows: torch.Tensor,  # (B,) file indices
    seeks: torch.Tensor,  # (B,) per-row window start frames
    sizes: torch.Tensor,  # (B,) per-row valid frame counts
    n_frames: int = N_FRAMES,
) -> torch.Tensor:
    """Per-file decode windows (B, n_mels, n_frames) out of the mel store,
    on its device: a gather and a mask.

    As whisper_tpu's ``_slice_windows_dev``: the host-side
    ``pad_or_trim(mel[:, seek:seek+3000])`` of the reference
    (transcribe.py:284-286), with frames past a row's ``size`` zeroed like
    pad_or_trim's zero padding, and a start that would run past the store
    moved back to fit, as ``dynamic_slice`` moves it.
    """
    n_mels, width = mels.shape[1], mels.shape[2]
    frames = torch.arange(n_frames, device=mels.device)
    start = seeks.to(mels.device).clamp(0, width - n_frames)
    index = (start[:, None] + frames[None, :])[:, None, :].expand(-1, n_mels, -1)
    windows = mels[rows.to(mels.device)].gather(2, index)
    mask = frames[None, None, :] < sizes.to(mels.device)[:, None, None]
    return torch.where(mask, windows, 0.0)


class _FileState:
    def __init__(self, content_frames: int, clip_timestamps: Union[str, List[float]] = "0"):
        self.content_frames = content_frames
        self.segments: List[dict] = []
        self.tokens: List[int] = []
        self.language: Optional[str] = None
        self.last_speech_timestamp = 0.0
        self.prompt_reset_since = 0
        self.initial_prompt_len = 0

        # clip windows, as in transcribe (reference transcribe.py:168-177)
        if isinstance(clip_timestamps, str):
            clip_timestamps = [
                float(ts) for ts in (clip_timestamps.split(",") if clip_timestamps else [])
            ]
        seek_points = [round(ts * FRAMES_PER_SECOND) for ts in clip_timestamps]
        if len(seek_points) == 0:
            seek_points.append(0)
        if len(seek_points) % 2 == 1:
            seek_points.append(self.content_frames)
        self.seek_clips = list(zip(seek_points[::2], seek_points[1::2]))
        self.clip_idx = 0
        self.seek = self.seek_clips[0][0]

    @property
    def done(self) -> bool:
        """Advance across clip boundaries; True when no window remains."""
        while self.clip_idx < len(self.seek_clips):
            clip_start, clip_end = self.seek_clips[self.clip_idx]
            if self.seek < clip_start:
                self.seek = clip_start
            if self.seek >= min(clip_end, self.content_frames):
                self.clip_idx += 1
                if self.clip_idx < len(self.seek_clips):
                    self.seek = self.seek_clips[self.clip_idx][0]
                continue
            return False
        return True

    def window_size(self) -> int:
        clip_end = self.seek_clips[self.clip_idx][1]
        return min(N_FRAMES, self.content_frames - self.seek, clip_end - self.seek)


def _file_windows(mels: torch.Tensor, states: List[_FileState], row_indices: List[int]) -> torch.Tensor:
    """Windows of the given files of a group at their current seeks, out of
    the group's mel store; a finished (or empty) file gets a zero window."""
    seeks = [0 if states[i].done else states[i].seek for i in row_indices]
    sizes = [0 if states[i].done else states[i].window_size() for i in row_indices]
    rows, seeks, sizes = torch.tensor([row_indices, seeks, sizes], dtype=torch.int64).to(mels.device)
    return _slice_windows(mels, rows, seeks, sizes)


def _waveform(audio) -> np.ndarray:
    """A path decoded on the host, or a waveform as float32 (int16 is
    16-bit PCM and scales by 1/32768, as log_mel_spectrogram reads it)."""
    if isinstance(audio, str):
        return load_audio(audio)
    audio = np.asarray(audio).reshape(-1)
    if audio.dtype == np.int16:
        return audio.astype(np.float32) / 32768.0
    return audio.astype(np.float32)


def _prepare_mels(model, audios, _sync) -> Tuple[torch.Tensor, List[int]]:
    """Host-decode ``audios``, upload them as one buffer and compute every
    log-mel in one batched pass on the model's device; returns the mel store
    (n_files, n_mels, F) there and the files' lengths in samples.

    Numerically the per-file ``log_mel_spectrogram(padding=N_SAMPLES)``: a
    row is padded with zeros to the longest file, and that longer zero tail
    changes none of the row's frames that a window reads.  The
    dynamic-range floor is per row (max - 8 over the row's own frames), and
    the tail is silence, which never raises the row's max; the frames a
    window reads lie inside the row's own length plus its 30 s of zero
    padding, where the two waveforms agree sample for sample, reflected
    edges included.
    """
    with span("audio_host"):
        waves = [_waveform(a) for a in audios]
        lens = [w.shape[0] for w in waves]
        buf = np.zeros((len(waves), max(lens) if lens else 0), np.float32)
        for i, w in enumerate(waves):
            buf[i, : w.shape[0]] = w
    with span("mel"):
        mels = _sync(log_mel_spectrogram(buf, model.dims.n_mels, padding=N_SAMPLES,
                                         device=model.device))
    return mels, lens


def transcribe_batch(
    model,
    audios: Sequence[Union[str, np.ndarray]],
    *,
    batch_size: int = 16,
    temperature: Union[float, Tuple[float, ...]] = (0.0, 0.2, 0.4, 0.6, 0.8, 1.0),
    compression_ratio_threshold: Optional[float] = 2.4,
    logprob_threshold: Optional[float] = -1.0,
    no_speech_threshold: Optional[float] = 0.6,
    condition_on_previous_text: bool = True,
    initial_prompt: Optional[str] = None,
    carry_initial_prompt: bool = False,
    word_timestamps: bool = False,
    prepend_punctuations: str = "\"'“¿([{-",
    append_punctuations: str = "\"'.。,，!！?？:：”)]}、",
    clip_timestamps: Union[str, List[float]] = "0",
    hallucination_silence_threshold: Optional[float] = None,
    word_seek_refinement: bool = True,
    stage_timer=None,
    **decode_options,
) -> List[dict]:
    """Transcribe many files concurrently; returns one result dict per file,
    as ``transcribe`` returns for it.

    Files go in groups of ``batch_size``; while a group decodes, a thread
    prepares the next group's mel store (host audio decode, upload, mel).
    Inside a group each round decodes the next window of up to
    ``batch_size`` unfinished files.

    ``stage_timer``: any object whose ``.stage(name)`` is a context manager,
    such as a :class:`~whisper_tpu_torch.profiling.StageTimer`; it is
    installed with ``profiling.recording`` for the call and the calling
    thread (the groups run on it, one after another), so that wall time
    is attributed to the audio_host / mel / window_slice / engine / segment
    / alignment stages (and the spans inside them: the engine's encoder,
    prefill and token steps, the results' assembly), with the device
    synchronised at each of those six stages' boundaries and the groups
    prepared serially.  Under ``profiling.recording`` without a
    ``stage_timer`` the same spans record with neither.

    ``word_seek_refinement`` (default True = the reference's semantics):
    with ``word_timestamps=True`` the reference rewinds each window's seek
    to the last aligned word's end and re-decodes the tail (reference
    transcribe.py:413-416).  ``False`` keeps the decode's own window
    advance, for windows that are fixed by construction
    (``transcribe_chunked``).  It excludes
    ``hallucination_silence_threshold``, whose heuristics steer that seek.

    Under a mesh with a data axis above 1, each data group transcribes its
    block of the files and the results are gathered (module docstring).
    """
    if isinstance(model, UniMoe):
        options = {k: v for k, v in locals().items() if k not in ("model", "audios", "decode_options")}
        return _transcribe_lm(model, audios, options, decode_options)
    mesh = current_mesh()
    if mesh is not None and mesh.shape["data"] > 1:
        call = {k: v for k, v in locals().items()
                if k not in ("model", "audios", "decode_options", "mesh")}
        rows = mesh.rows(len(audios))
        local = []
        if len(rows):
            with mesh.model_only():
                local = transcribe_batch(model, list(audios)[rows.start:rows.stop], **call,
                                         **decode_options)
        return [r for part in mesh.gather_objects(local, "data") for r in part]
    if not word_seek_refinement and hallucination_silence_threshold is not None and word_timestamps:
        raise ValueError(
            "word_seek_refinement=False is incompatible with "
            "hallucination_silence_threshold (its silence-skip heuristics "
            "steer the seek that refinement controls)"
        )
    if decode_options.pop("prompt", None):
        raise NotImplementedError(
            "transcribe_batch manages prompts per file; use transcribe() for a "
            "fixed decode-level prompt"
        )

    _sync = _syncer(stage_timer)
    temperatures = [temperature] if isinstance(temperature, (int, float)) else list(temperature)
    group_kw = dict(
        batch_size=batch_size,
        temperatures=temperatures,
        compression_ratio_threshold=compression_ratio_threshold,
        logprob_threshold=logprob_threshold,
        no_speech_threshold=no_speech_threshold,
        condition_on_previous_text=condition_on_previous_text,
        initial_prompt=initial_prompt,
        carry_initial_prompt=carry_initial_prompt,
        word_timestamps=word_timestamps,
        prepend_punctuations=prepend_punctuations,
        append_punctuations=append_punctuations,
        clip_timestamps=clip_timestamps,
        hallucination_silence_threshold=hallucination_silence_threshold,
        word_seek_refinement=word_seek_refinement,
        decode_options=decode_options,
        _sync=_sync,
    )
    # every file's windows, prompts and fallback ladder live inside its group
    return _run_groups(model, audios, batch_size, stage_timer, _sync, _transcribe_group, group_kw)


def _syncer(stage_timer):
    """The stage boundaries' device sync: under a ``stage_timer``, wait for
    a CUDA tensor's queued work; else nothing."""

    def _sync(x):
        if stage_timer is not None and x.is_cuda:
            torch.cuda.synchronize(x.device)
        return x

    return _sync


def _run_groups(model, audios, batch_size, stage_timer, _sync, group, group_kw) -> List[dict]:
    """``group(model, mels, lens, **group_kw)`` over the files in groups of
    ``batch_size``, each group's mel store prepared by
    :func:`_prepare_mels`; the results in input order."""
    groups = [list(audios[i : i + batch_size]) for i in range(0, len(audios), batch_size)]
    if not groups:
        return []
    if stage_timer is not None:
        with recording(stage_timer, this_thread=True):
            return [r for g in groups for r in group(model, *_prepare_mels(model, g, _sync), **group_kw)]
    if len(groups) == 1:
        return group(model, *_prepare_mels(model, groups[0], _sync), **group_kw)

    # a thread prepares group k+1's mel store while group k decodes; the
    # queue holds at most two prepared groups, and an error in the thread
    # surfaces here
    q: Queue = Queue(maxsize=2)

    def _producer():
        for g in groups:
            try:
                q.put(_prepare_mels(model, g, _sync))
            except BaseException as e:
                q.put(e)
                return

    th = Thread(target=_producer, daemon=True)
    th.start()
    results = []
    for _ in groups:
        item = q.get()
        if isinstance(item, BaseException):
            th.join()
            raise item
        results.extend(group(model, *item, **group_kw))
    th.join()
    return results


def _transcribe_group(
    model,
    mels,
    lens,
    *,
    batch_size,
    temperatures,
    compression_ratio_threshold,
    logprob_threshold,
    no_speech_threshold,
    condition_on_previous_text,
    initial_prompt,
    carry_initial_prompt,
    word_timestamps,
    prepend_punctuations,
    append_punctuations,
    clip_timestamps,
    hallucination_silence_threshold,
    word_seek_refinement,
    decode_options,
    _sync,
):
    """Decode one group of files out of its mel store on the device; the
    per-file logic of :func:`transcribe_batch`
    (whisper_tpu/batch.py:346-679)."""
    states = [
        _FileState(
            content_frames=(n + N_SAMPLES) // HOP_LENGTH - N_FRAMES,
            clip_timestamps=clip_timestamps,
        )
        for n in lens
    ]

    # language: pinned, or batched detection on each file's first window
    language = decode_options.get("language")
    if language is None and not model.is_multilingual:
        language = "en"
    if language is not None:
        for st in states:
            st.language = language
    else:
        _, probs = detect_language(model, _file_windows(mels, states, list(range(len(states)))))
        for st, p in zip(states, probs):
            st.language = max(p, key=p.get)

    input_stride = exact_div(N_FRAMES, model.dims.n_audio_ctx)
    time_precision = input_stride * HOP_LENGTH / SAMPLE_RATE

    # group by language so each batch shares one task and tokenizer
    by_language = {}
    for idx, st in enumerate(states):
        by_language.setdefault(st.language, []).append(idx)

    for lang, indices in by_language.items():
        tokenizer = get_tokenizer(
            model.is_multilingual,
            num_languages=model.num_languages,
            language=lang,
            task=decode_options.get("task", "transcribe"),
        )
        remaining_prompt_length = model.dims.n_text_ctx // 2 - 1
        if initial_prompt is not None:
            prompt_tokens = tokenizer.encode(" " + initial_prompt.strip())
            remaining_prompt_length -= len(prompt_tokens)
            for idx in indices:
                states[idx].tokens = list(prompt_tokens)
                states[idx].initial_prompt_len = len(prompt_tokens)

        def prompt_for(st: _FileState) -> List[int]:
            """Per-window prompt; parity with transcribe's assembly."""
            if carry_initial_prompt:
                nignored = max(st.initial_prompt_len, st.prompt_reset_since)
                remaining = st.tokens[nignored:][-remaining_prompt_length:]
                return st.tokens[: st.initial_prompt_len] + remaining
            return st.tokens[st.prompt_reset_since :]

        tasks = {}  # temperature -> DecodingTask

        def get_task(t: float) -> DecodingTask:
            if t not in tasks:
                kwargs = {k: v for k, v in decode_options.items() if k not in ("language", "draft_model")}
                if t > 0:
                    kwargs.pop("beam_size", None)
                    kwargs.pop("patience", None)
                else:
                    kwargs.pop("best_of", None)
                tasks[t] = DecodingTask(
                    model,
                    DecodingOptions(**kwargs, language=lang, temperature=t),
                    draft_model=decode_options.get("draft_model"),
                )
            return tasks[t]

        active = [i for i in indices if not states[i].done]
        while active:
            # refill: the next window of up to batch_size unfinished files,
            # so rows that carry a prompt decode beside files that start
            rows = active[:batch_size]
            sizes = [states[i].window_size() for i in rows]
            with span("window_slice"):
                windows = _sync(_file_windows(mels, states, rows))
            prompts = [prompt_for(states[i]) for i in rows]

            # temperature-fallback ladder over the whole batch; rows that have
            # already passed the gates keep their earlier result
            results = [None] * len(rows)
            for t in temperatures:
                with span("engine"):
                    batch_results = get_task(t).run_with_prompts(windows, prompts)
                any_pending = False
                for j in range(len(rows)):
                    if results[j] is not None:
                        continue
                    r = batch_results[j]
                    if not needs_fallback(
                        r, compression_ratio_threshold, logprob_threshold, no_speech_threshold
                    ) or t == temperatures[-1]:
                        results[j] = r
                    else:
                        any_pending = True
                if not any_pending:
                    break

            # phase 1: per-file segmentation and seek advance
            pending = []  # rows that produced segments this round
            with span("segment"):
                for j, i in enumerate(rows):
                    st = states[i]
                    result = results[j]
                    segment_size = sizes[j]
                    time_offset = float(st.seek * HOP_LENGTH / SAMPLE_RATE)
                    segment_duration = segment_size * HOP_LENGTH / SAMPLE_RATE

                    if no_speech_threshold is not None:
                        should_skip = result.no_speech_prob > no_speech_threshold
                        if logprob_threshold is not None and result.avg_logprob > logprob_threshold:
                            should_skip = False
                        if should_skip:
                            st.seek += segment_size
                            continue

                    previous_seek = st.seek
                    current_segments, st.seek, single_ts_ending = segment_window(
                        result=result,
                        tokenizer=tokenizer,
                        seek=previous_seek,
                        segment_size=segment_size,
                        time_offset=time_offset,
                        segment_duration=segment_duration,
                        input_stride=input_stride,
                        time_precision=time_precision,
                    )
                    pending.append(
                        dict(
                            state=st, row=j, segments=current_segments, result=result,
                            previous_seek=previous_seek, segment_size=segment_size,
                            time_offset=time_offset, segment_duration=segment_duration,
                            single_ts_ending=single_ts_ending,
                        )
                    )

            # phase 2 (word timestamps): one batched alignment pass for all
            # files that produced text this round, from the encoder features
            # the decode already computed
            if word_timestamps and pending:
                with span("alignment"):
                    _align_round(
                        model, tokenizer, pending, prepend_punctuations, append_punctuations,
                        word_seek_refinement, hallucination_silence_threshold,
                    )

            # phase 3: commit segments and tokens per file
            for p in pending:
                if p.get("restart"):
                    continue
                st = p["state"]
                for segment in p["segments"]:
                    if segment["start"] == segment["end"] or not segment["text"].strip():
                        segment["text"] = ""
                        segment["tokens"] = []
                        segment["words"] = []
                st.segments.extend(
                    {"id": k, **segment}
                    for k, segment in enumerate(p["segments"], start=len(st.segments))
                )
                st.tokens.extend(tok for segment in p["segments"] for tok in segment["tokens"])
                if not condition_on_previous_text or p["result"].temperature > 0.5:
                    # don't condition on text produced at high temperature
                    st.prompt_reset_since = len(st.tokens)

            active = [i for i in indices if not states[i].done]

    return [
        dict(
            text=get_tokenizer(
                model.is_multilingual,
                num_languages=model.num_languages,
                language=st.language,
                task=decode_options.get("task", "transcribe"),
            ).decode(st.tokens[st.initial_prompt_len :]),
            segments=st.segments,
            language=st.language,
        )
        for st in states
    ]


def _transcribe_lm(model: UniMoe, audios, options: dict, decode_options: dict) -> List[dict]:
    """:func:`transcribe_batch` of a language model over an audio prefix
    (:class:`~.models.uni_moe.UniMoe`): each file cut into consecutive 30 s
    windows, each window decoded greedily after the chat template's prompt
    around its audio tokens (:func:`.engine.decode_lm`), one segment a
    window, in the groups and rounds of the Whisper path.

    The options: ``batch_size``, ``stage_timer``, and ``temperature`` 0
    alone.  An option left at transcribe_batch's default is a choice of
    Whisper's decoding (its temperature ladder, quality gates, previous-text
    prompts, timestamps) that this path does not make; one set to anything
    else that it does not implement, any decode option that is not None,
    and a device mesh raise NotImplementedError."""
    defaults = {k: p.default for k, p in inspect.signature(transcribe_batch).parameters.items()
                if p.default is not inspect.Parameter.empty}
    temperature = options.pop("temperature")
    refused = [k for k, v in options.items() if k not in ("batch_size", "stage_timer") and v != defaults[k]]
    refused += [k for k, v in decode_options.items() if v is not None]
    temperatures = [temperature] if isinstance(temperature, (int, float)) else list(temperature)
    if temperature != defaults["temperature"] and temperatures != [0.0]:
        refused.append("temperature")
    if refused:
        raise NotImplementedError(
            f"transcribe_batch of {type(model).__name__} decodes greedily at temperature 0, one "
            f"segment a 30 s window; it does not implement {sorted(refused)}")
    if current_mesh() is not None:
        raise NotImplementedError(f"transcribe_batch of {type(model).__name__} runs on one device")
    _sync = _syncer(options["stage_timer"])
    return _run_groups(model, audios, options["batch_size"], options["stage_timer"], _sync,
                       _transcribe_group_lm, dict(batch_size=options["batch_size"], _sync=_sync,
                                                  numbers=iter(range(len(audios)))))


def _transcribe_group_lm(model: UniMoe, mels, lens, *, batch_size, _sync, numbers) -> List[dict]:
    """One group of files on the LM path: each round decodes the next 30 s
    window of up to ``batch_size`` unfinished files (the group's files
    take the next of ``numbers``, their places in the call, which
    ``engine.LmPins.forced`` reads).  A segment holds its window's place
    (``seek`` in frames, ``start`` and ``end`` in seconds), the decoded ids
    before the stop token (``tokens``; ``text`` is empty: the tokenizer's
    files are not in the repository), the log-probability of each id
    decoded, stop token included (``token_logprobs``), their mean
    (``avg_logprob``), and the window's work (``prompt_tokens``, the
    prefill's positions, and ``routed_picks``, the routed experts' picks
    over its tokens and layers)."""
    states = [_FileState(content_frames=(n + N_SAMPLES) // HOP_LENGTH - N_FRAMES) for n in lens]
    files = [next(numbers) for _ in lens]
    pins = engine.LmPins.forced
    prompt = engine.LmPins.prompt or model.prompt
    if prompt is None:
        raise ValueError("the chat template's ids around the audio come with the model's tokenizer: "
                         "give the model its prompt, (ids before, ids after)")
    eos = model.dims.eos
    active = [i for i, st in enumerate(states) if not st.done]
    while active:
        rows = active[:batch_size]
        sizes = [states[i].window_size() for i in rows]
        with span("window_slice"):
            windows = _sync(_file_windows(mels, states, rows))
        with span("engine"):
            forced = None if pins is None else [pins(files[i], states[i].seek) for i in rows]
            decoded = engine.decode_lm(model, windows, prompt, forced)
        with span("segment"):
            for i, size, w in zip(rows, sizes, decoded):
                st = states[i]
                text = w.tokens[:-1] if w.tokens and w.tokens[-1] == eos else w.tokens
                st.segments.append(dict(
                    id=len(st.segments), seek=st.seek, start=st.seek * HOP_LENGTH / SAMPLE_RATE,
                    end=(st.seek + size) * HOP_LENGTH / SAMPLE_RATE, text="", tokens=text,
                    token_logprobs=w.logprobs, avg_logprob=sum(w.logprobs) / max(len(w.logprobs), 1),
                    prompt_tokens=w.prompt_tokens, routed_picks=w.routed_picks))
                st.seek += size
        active = [i for i in active if not states[i].done]
    return [dict(text="", segments=st.segments, language=None) for st in states]


def _align_round(model, tokenizer, pending, prepend_punctuations, append_punctuations,
                 word_seek_refinement, hallucination_silence_threshold) -> None:
    """Word timestamps for one round's segmented files, then each file's
    word-timing seek refinement (transcribe's word-timestamps branch)."""
    text_tokens = [
        [tok for segment in p["segments"] for tok in segment["tokens"] if tok < tokenizer.eot]
        for p in pending
    ]
    aligned = [k for k, toks in enumerate(text_tokens) if toks]
    alignments = find_alignment_batch(
        model, tokenizer, [text_tokens[k] for k in aligned], None,
        [pending[k]["segment_size"] for k in aligned],
        features=torch.stack([pending[k]["result"].audio_features for k in aligned]),
    ) if aligned else []
    per_row = dict(zip(aligned, alignments))

    # rows with no text tokens still run add_word_timestamps (with an empty
    # alignment) and the seek refinement, exactly as transcribe() does
    for k, p in enumerate(pending):
        st = p["state"]
        add_word_timestamps(
            segments=p["segments"],
            model=model,
            tokenizer=tokenizer,
            mel=None,
            num_frames=p["segment_size"],
            prepend_punctuations=prepend_punctuations,
            append_punctuations=append_punctuations,
            last_speech_timestamp=st.last_speech_timestamp,
            alignment=per_row.get(k, []),
        )
        if word_seek_refinement:
            st.seek, restart = _refine_seek_with_word_timings(
                p["segments"],
                seek=st.seek,
                previous_seek=p["previous_seek"],
                segment_size=p["segment_size"],
                single_timestamp_ending=p["single_ts_ending"],
                time_offset=p["time_offset"],
                window_end_time=float((p["previous_seek"] + N_FRAMES) * HOP_LENGTH / SAMPLE_RATE),
                segment_duration=p["segment_duration"],
                content_frames=st.content_frames,
                content_duration=float(st.content_frames * HOP_LENGTH / SAMPLE_RATE),
                last_speech_timestamp=st.last_speech_timestamp,
                threshold=hallucination_silence_threshold,
            )
            if restart:
                # transcribe()'s `continue`: nothing from this window commits
                # and the window re-decodes from the refined seek next round
                p["segments"].clear()
                p["restart"] = True
                continue
        last_word_end = get_end(p["segments"])
        if last_word_end is not None:
            st.last_speech_timestamp = last_word_end
