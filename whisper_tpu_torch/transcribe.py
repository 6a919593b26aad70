"""Long-form transcription: 30-second sliding windows with temperature fallback.

Counterpart of ``whisper_tpu/transcribe.py:49-550`` (behavioural parity
target: reference ``whisper/transcribe.py:38-514``): the seek loop,
clip_timestamps, prompt conditioning (condition_on_previous_text,
carry_initial_prompt, prompt reset above T = 0.5), the temperature ladder
gated on compression ratio / avg logprob / no-speech probability, and
timestamp-token segmentation, word timestamps with the word-timing seek
refinement and the hallucination-silence heuristics, and the command line
(``cli``, ``python -m whisper_tpu_torch``, whose ``--chunked`` runs
:func:`whisper_tpu_torch.chunked.transcribe_chunked`).  The loop is host-side (seek
advances are data-dependent); the whole file's mel stays on the model's
device and each window is sliced there.
"""

import argparse
import os
import traceback
import warnings
from typing import TYPE_CHECKING, List, Optional, Tuple, Union

import numpy as np
import torch
import tqdm

from .audio import (
    FRAMES_PER_SECOND,
    HOP_LENGTH,
    N_FRAMES,
    N_SAMPLES,
    SAMPLE_RATE,
    log_mel_spectrogram,
)
from .decoding import DecodingOptions, DecodingResult
from .tokenizer import LANGUAGES, TO_LANGUAGE_CODE, get_tokenizer
from .utils import (
    exact_div,
    format_timestamp,
    get_end,
    make_safe,
    optional_float,
    optional_int,
    str2bool,
)
from .utils.writers import get_writer

if TYPE_CHECKING:
    from .models.whisper import Whisper


def _new_segment(
    *,
    seek: int,
    start: float,
    end: float,
    tokens,
    result: DecodingResult,
    tokenizer,
) -> dict:
    tokens = [int(t) for t in tokens]
    text_tokens = [token for token in tokens if token < tokenizer.eot]
    return {
        "seek": seek,
        "start": start,
        "end": end,
        "text": tokenizer.decode(text_tokens),
        "tokens": tokens,
        "temperature": result.temperature,
        "avg_logprob": result.avg_logprob,
        "compression_ratio": result.compression_ratio,
        "no_speech_prob": result.no_speech_prob,
    }


def segment_window(
    *,
    result: DecodingResult,
    tokenizer,
    seek: int,
    segment_size: int,
    time_offset: float,
    segment_duration: float,
    input_stride: int,
    time_precision: float,
):
    """Split one window's tokens into segments and compute the seek advance.

    The timestamp-token segmentation rules of reference
    transcribe.py:339-399, including the single-timestamp-ending case.
    Returns (current_segments, new_seek, single_timestamp_ending).
    """
    tokens = np.array(result.tokens)
    current_segments: List[dict] = []

    timestamp_tokens = tokens >= tokenizer.timestamp_begin
    single_timestamp_ending = (
        len(timestamp_tokens) >= 2 and timestamp_tokens[-2:].tolist() == [False, True]
    )

    consecutive = np.where(timestamp_tokens[:-1] & timestamp_tokens[1:])[0] + 1
    if len(consecutive) > 0:
        # split at consecutive timestamp-token pairs
        slices = consecutive.tolist()
        if single_timestamp_ending:
            slices.append(len(tokens))

        last_slice = 0
        for current_slice in slices:
            sliced_tokens = tokens[last_slice:current_slice]
            start_pos = int(sliced_tokens[0]) - tokenizer.timestamp_begin
            end_pos = int(sliced_tokens[-1]) - tokenizer.timestamp_begin
            current_segments.append(
                _new_segment(
                    seek=seek,
                    start=time_offset + start_pos * time_precision,
                    end=time_offset + end_pos * time_precision,
                    tokens=sliced_tokens,
                    result=result,
                    tokenizer=tokenizer,
                )
            )
            last_slice = current_slice

        if single_timestamp_ending:
            # no speech after the final timestamp: advance a full window
            new_seek = seek + segment_size
        else:
            # continue from the last complete segment's end timestamp
            last_timestamp_pos = int(tokens[last_slice - 1]) - tokenizer.timestamp_begin
            new_seek = seek + last_timestamp_pos * input_stride
    else:
        duration = segment_duration
        timestamps = tokens[np.nonzero(timestamp_tokens)[0]]
        if len(timestamps) > 0 and int(timestamps[-1]) != tokenizer.timestamp_begin:
            last_timestamp_pos = int(timestamps[-1]) - tokenizer.timestamp_begin
            duration = last_timestamp_pos * time_precision

        current_segments.append(
            _new_segment(
                seek=seek,
                start=time_offset,
                end=time_offset + duration,
                tokens=tokens,
                result=result,
                tokenizer=tokenizer,
            )
        )
        new_seek = seek + segment_size

    return current_segments, new_seek, single_timestamp_ending


def needs_fallback(
    result: DecodingResult,
    compression_ratio_threshold: Optional[float],
    logprob_threshold: Optional[float],
    no_speech_threshold: Optional[float],
) -> bool:
    """Quality gates of the temperature ladder (reference transcribe.py:203-222)."""
    fallback = False
    if (
        compression_ratio_threshold is not None
        and result.compression_ratio > compression_ratio_threshold
    ):
        fallback = True  # too repetitive
    if logprob_threshold is not None and result.avg_logprob < logprob_threshold:
        fallback = True  # low confidence
    if (
        no_speech_threshold is not None
        and result.no_speech_prob > no_speech_threshold
        and logprob_threshold is not None
        and result.avg_logprob < logprob_threshold
    ):
        fallback = False  # silence: accept as-is
    return fallback


# punctuation set used by the hallucination heuristics (prepend+append defaults)
_PUNCTUATION = "\"'“¿([{-\"'.。,，!！?？:：”)]}、"


def _word_anomaly_score(word: dict) -> float:
    """Score how implausible a word timing is (long/short/improbable)."""
    probability = word.get("probability", 0.0)
    duration = word["end"] - word["start"]
    score = 0.0
    if probability < 0.15:
        score += 1.0
    if duration < 0.133:
        score += (0.133 - duration) * 15
    if duration > 2.0:
        score += duration - 2.0
    return score


def _is_segment_anomaly(segment: Optional[dict]) -> bool:
    if segment is None or not segment["words"]:
        return False
    words = [w for w in segment["words"] if w["word"] not in _PUNCTUATION][:8]
    score = sum(_word_anomaly_score(w) for w in words)
    return score >= 3 or score + 0.01 >= len(words)


def _first_segment_with_words(segments: List[dict]) -> Optional[dict]:
    return next((s for s in segments if s["words"]), None)


def _refine_seek_with_word_timings(
    current_segments: List[dict],
    *,
    seek: int,
    previous_seek: int,
    segment_size: int,
    single_timestamp_ending: bool,
    time_offset: float,
    window_end_time: float,
    segment_duration: float,
    content_frames: int,
    content_duration: float,
    last_speech_timestamp: float,
    threshold: Optional[float],
):
    """Word-timing seek refinement + hallucination-silence skipping.

    Semantics of reference transcribe.py:413-472.  Returns
    (seek, restart_window) where restart_window means "re-decode from the new
    seek, discarding this window's segments".
    """
    if not single_timestamp_ending:
        last_word_end = get_end(current_segments)
        if last_word_end is not None and last_word_end > time_offset:
            seek = round(last_word_end * FRAMES_PER_SECOND)

    if threshold is None:
        return seek, False

    # skip trailing silence when the window ends well past the last word
    if not single_timestamp_ending:
        last_word_end = get_end(current_segments)
        if last_word_end is not None and last_word_end > time_offset:
            remaining_duration = window_end_time - last_word_end
            if remaining_duration > threshold:
                seek = round(last_word_end * FRAMES_PER_SECOND)
            else:
                seek = previous_seek + segment_size

    # a suspicious first segment after a gap: skip the leading silence
    first_segment = _first_segment_with_words(current_segments)
    if first_segment is not None and _is_segment_anomaly(first_segment):
        gap = first_segment["start"] - time_offset
        if gap > threshold:
            return previous_seek + round(gap * FRAMES_PER_SECOND), True

    # drop hallucination-like segments that are surrounded by silence (or by
    # more hallucinations) and resume from the first one
    hal_last_end = last_speech_timestamp
    for si, segment in enumerate(current_segments):
        if not segment["words"]:
            continue
        if _is_segment_anomaly(segment):
            next_segment = _first_segment_with_words(current_segments[si + 1 :])
            if next_segment is not None:
                hal_next_start = next_segment["words"][0]["start"]
            else:
                hal_next_start = time_offset + segment_duration
            silence_before = (
                segment["start"] - hal_last_end > threshold
                or segment["start"] < threshold
                or segment["start"] - time_offset < 2.0
            )
            silence_after = (
                hal_next_start - segment["end"] > threshold
                or _is_segment_anomaly(next_segment)
                or window_end_time - segment["end"] < 2.0
            )
            if silence_before and silence_after:
                seek = round(
                    max(time_offset + 1, segment["start"]) * FRAMES_PER_SECOND
                )
                if content_duration - segment["end"] < threshold:
                    seek = content_frames
                current_segments[si:] = []
                break
        hal_last_end = segment["end"]

    return seek, False


def transcribe(
    model: "Whisper",
    audio: Union[str, np.ndarray, torch.Tensor],
    *,
    verbose: Optional[bool] = None,
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
    **decode_options,
):
    """Transcribe audio, returning {"text", "segments", "language"}.

    Parameter semantics match reference transcribe.py:38-126; see that
    docstring for the meaning of each threshold.
    """
    # whole-file mel with 30 s of trailing silence for the final window
    mel = log_mel_spectrogram(audio, model.dims.n_mels, padding=N_SAMPLES, device=model.device)
    content_frames = mel.shape[-1] - N_FRAMES
    content_duration = float(content_frames * HOP_LENGTH / SAMPLE_RATE)

    def slice_window(seek: int, size: int) -> torch.Tensor:
        """Window [seek : seek+size], zero-padded to 3000 frames, as
        pad_or_trim(mel[:, seek:seek+size])."""
        window = mel.new_zeros((mel.shape[0], N_FRAMES))
        window[:, :size] = mel[:, seek : seek + size]
        return window

    if decode_options.get("language", None) is None:
        if not model.is_multilingual:
            decode_options["language"] = "en"
        else:
            if verbose:
                print(
                    "Detecting language using up to the first 30 seconds. "
                    "Use `--language` to specify the language"
                )
            _, probs = model.detect_language(slice_window(0, N_FRAMES))
            decode_options["language"] = max(probs, key=probs.get)
            if verbose is not None:
                print(f"Detected language: {LANGUAGES[decode_options['language']].title()}")

    language: str = decode_options["language"]
    task: str = decode_options.get("task", "transcribe")
    tokenizer = get_tokenizer(
        model.is_multilingual,
        num_languages=model.num_languages,
        language=language,
        task=task,
    )

    if isinstance(clip_timestamps, str):
        clip_timestamps = [
            float(ts) for ts in (clip_timestamps.split(",") if clip_timestamps else [])
        ]
    seek_points: List[int] = [round(ts * FRAMES_PER_SECOND) for ts in clip_timestamps]
    if len(seek_points) == 0:
        seek_points.append(0)
    if len(seek_points) % 2 == 1:
        seek_points.append(content_frames)
    seek_clips: List[Tuple[int, int]] = list(zip(seek_points[::2], seek_points[1::2]))

    if word_timestamps and task == "translate":
        warnings.warn("Word-level timestamps on translations may not be reliable.")

    # speculative draft model (a Whisper object, not a DecodingOptions field)
    draft_model = decode_options.pop("draft_model", None)

    def decode_with_fallback(segment: torch.Tensor) -> DecodingResult:
        """Temperature ladder with quality gates (reference transcribe.py:184-224)."""
        temperatures = [temperature] if isinstance(temperature, (int, float)) else temperature
        decode_result = None

        for t in temperatures:
            kwargs = {**decode_options}
            if t > 0:
                # beam search only applies at t == 0
                kwargs.pop("beam_size", None)
                kwargs.pop("patience", None)
            else:
                kwargs.pop("best_of", None)

            options = DecodingOptions(**kwargs, temperature=t)
            decode_result = model.decode(segment, options, draft_model=draft_model)

            if not needs_fallback(
                decode_result,
                compression_ratio_threshold,
                logprob_threshold,
                no_speech_threshold,
            ):
                break

        return decode_result

    clip_idx = 0
    seek = seek_clips[clip_idx][0]
    input_stride = exact_div(N_FRAMES, model.dims.n_audio_ctx)  # 2 mel frames/token
    time_precision = input_stride * HOP_LENGTH / SAMPLE_RATE  # 0.02 s/token
    all_tokens: List[int] = []
    all_segments: List[dict] = []
    prompt_reset_since = 0

    remaining_prompt_length = model.dims.n_text_ctx // 2 - 1
    if initial_prompt is not None:
        initial_prompt_tokens = tokenizer.encode(" " + initial_prompt.strip())
        all_tokens.extend(initial_prompt_tokens)
        remaining_prompt_length -= len(initial_prompt_tokens)
    else:
        initial_prompt_tokens = []

    # progress bar shown when not printing per-segment lines
    with tqdm.tqdm(total=content_frames, unit="frames", disable=verbose is not False) as pbar:
        last_speech_timestamp = 0.0
        while clip_idx < len(seek_clips):
            seek_clip_start, seek_clip_end = seek_clips[clip_idx]
            if seek < seek_clip_start:
                seek = seek_clip_start
            if seek >= seek_clip_end:
                clip_idx += 1
                if clip_idx < len(seek_clips):
                    seek = seek_clips[clip_idx][0]
                continue
            time_offset = float(seek * HOP_LENGTH / SAMPLE_RATE)
            window_end_time = float((seek + N_FRAMES) * HOP_LENGTH / SAMPLE_RATE)
            segment_size = min(N_FRAMES, content_frames - seek, seek_clip_end - seek)
            segment_duration = segment_size * HOP_LENGTH / SAMPLE_RATE
            mel_segment = slice_window(seek, segment_size)

            if carry_initial_prompt:
                nignored = max(len(initial_prompt_tokens), prompt_reset_since)
                remaining_prompt = all_tokens[nignored:][-remaining_prompt_length:]
                decode_options["prompt"] = initial_prompt_tokens + remaining_prompt
            else:
                decode_options["prompt"] = all_tokens[prompt_reset_since:]

            result: DecodingResult = decode_with_fallback(mel_segment)

            if no_speech_threshold is not None:
                # voice-activity gate (reference transcribe.py:298-310)
                should_skip = result.no_speech_prob > no_speech_threshold
                if logprob_threshold is not None and result.avg_logprob > logprob_threshold:
                    should_skip = False
                if should_skip:
                    seek += segment_size
                    continue

            previous_seek = seek
            current_segments, seek, single_timestamp_ending = segment_window(
                result=result,
                tokenizer=tokenizer,
                seek=seek,
                segment_size=segment_size,
                time_offset=time_offset,
                segment_duration=segment_duration,
                input_stride=input_stride,
                time_precision=time_precision,
            )

            if word_timestamps:
                from .timing import add_word_timestamps

                add_word_timestamps(
                    segments=current_segments,
                    model=model,
                    tokenizer=tokenizer,
                    mel=mel_segment,
                    num_frames=segment_size,
                    prepend_punctuations=prepend_punctuations,
                    append_punctuations=append_punctuations,
                    last_speech_timestamp=last_speech_timestamp,
                    # the decode already encoded this window: skip the
                    # alignment pass's encoder
                    features=result.audio_features,
                )

                seek, restart = _refine_seek_with_word_timings(
                    current_segments,
                    seek=seek,
                    previous_seek=previous_seek,
                    segment_size=segment_size,
                    single_timestamp_ending=single_timestamp_ending,
                    time_offset=time_offset,
                    window_end_time=window_end_time,
                    segment_duration=segment_duration,
                    content_frames=content_frames,
                    content_duration=content_duration,
                    last_speech_timestamp=last_speech_timestamp,
                    threshold=hallucination_silence_threshold,
                )
                if restart:
                    continue

                last_word_end = get_end(current_segments)
                if last_word_end is not None:
                    last_speech_timestamp = last_word_end

            if verbose:
                for segment in current_segments:
                    start, end, text = segment["start"], segment["end"], segment["text"]
                    line = f"[{format_timestamp(start)} --> {format_timestamp(end)}] {text}"
                    print(make_safe(line))

            # drop instantaneous or empty segments
            for segment in current_segments:
                if segment["start"] == segment["end"] or segment["text"].strip() == "":
                    segment["text"] = ""
                    segment["tokens"] = []
                    segment["words"] = []

            all_segments.extend(
                [
                    {"id": i, **segment}
                    for i, segment in enumerate(current_segments, start=len(all_segments))
                ]
            )
            all_tokens.extend(
                [token for segment in current_segments for token in segment["tokens"]]
            )

            if not condition_on_previous_text or result.temperature > 0.5:
                # don't condition on text produced at high temperature
                prompt_reset_since = len(all_tokens)

            pbar.update(min(content_frames, seek) - previous_seek)

    return dict(
        text=tokenizer.decode(all_tokens[len(initial_prompt_tokens):]),
        segments=all_segments,
        language=language,
    )


def cli():
    """``python -m whisper_tpu_torch``: whisper_tpu's command line (the same
    flags and defaults) on a torch device, CUDA by default."""
    from . import available_models, load_model

    def valid_model_name(name):
        if name in available_models() or os.path.exists(name):
            return name
        raise ValueError(
            f"model should be one of {available_models()} or path to a model checkpoint"
        )

    # flag-set parity with whisper_tpu's CLI (reference transcribe.py:527-567),
    # declared as a table: (name, kwargs)
    flags = [
        ("audio", dict(nargs="+", type=str, help="audio file(s) to process")),
        ("--model", dict(default="turbo", type=valid_model_name,
                         help="model name or checkpoint path (.pt, or whisper_tpu's .npz)")),
        ("--model_dir", dict(type=str, default=None,
                             help="checkpoint cache directory (default ~/.cache/whisper)")),
        ("--device", dict(default="cuda",
                          help="torch device to run on, e.g. 'cuda' or 'cpu'")),
        (("--output_dir", "-o"), dict(type=str, default=".",
                                      help="where to write transcripts")),
        (("--output_format", "-f"), dict(type=str, default="all",
                                         choices=["txt", "vtt", "srt", "tsv", "json", "all"],
                                         help="transcript format ('all' writes every format)")),
        ("--verbose", dict(type=str2bool, default=True,
                           help="print segments as they are decoded")),
        ("--task", dict(type=str, default="transcribe",
                        choices=["transcribe", "translate"],
                        help="same-language transcription, or translation to English")),
        ("--language", dict(type=str, default=None,
                            choices=sorted(LANGUAGES.keys())
                            + sorted(k.title() for k in TO_LANGUAGE_CODE.keys()),
                            help="spoken language (omit to auto-detect)")),
        ("--temperature", dict(type=float, default=0, help="sampling temperature")),
        ("--best_of", dict(type=optional_int, default=5,
                           help="independent samples to draw when temperature > 0")),
        ("--beam_size", dict(type=optional_int, default=5,
                             help="beam width at temperature 0")),
        ("--patience", dict(type=float, default=None,
                            help="beam-search patience factor (arXiv:2204.05424; 1.0 = plain beam search)")),
        ("--length_penalty", dict(type=float, default=None,
                                  help="Google-NMT length-penalty alpha (arXiv:1609.08144); default is simple length normalization")),
        ("--suppress_tokens", dict(type=str, default="-1",
                                   help="token ids to forbid, comma-separated; '-1' blocks the standard non-speech set")),
        ("--initial_prompt", dict(type=str, default=None,
                                  help="text to condition the first window on")),
        ("--carry_initial_prompt", dict(type=str2bool, default=False,
                                        help="keep prepending initial_prompt to every window's prompt")),
        ("--condition_on_previous_text", dict(type=str2bool, default=True,
                                              help="feed each window's output as the next window's prompt")),
        ("--fp16", dict(type=str2bool, default=True,
                        help="accepted for reference-CLI compatibility; the dtype is set at model load (bfloat16 on CUDA)")),
        ("--temperature_increment_on_fallback", dict(type=optional_float, default=0.2,
                                                     help="temperature step for the quality-gated retry ladder")),
        ("--compression_ratio_threshold", dict(type=optional_float, default=2.4,
                                               help="retry when gzip compression ratio exceeds this (repetition)")),
        ("--logprob_threshold", dict(type=optional_float, default=-1.0,
                                     help="retry when mean token log-probability falls below this")),
        ("--no_speech_threshold", dict(type=optional_float, default=0.6,
                                       help="with a failed logprob gate, treat the window as silence above this <|nospeech|> probability")),
        ("--word_timestamps", dict(type=str2bool, default=False,
                                   help="attach per-word timings via cross-attention DTW")),
        ("--prepend_punctuations", dict(type=str, default="\"'“¿([{-",
                                        help="with word_timestamps, glue these onto the following word")),
        ("--append_punctuations", dict(type=str, default="\"'.。,，!！?？:：”)]}、",
                                       help="with word_timestamps, glue these onto the preceding word")),
        ("--highlight_words", dict(type=str2bool, default=False,
                                   help="karaoke-style <u>word</u> highlighting in srt/vtt (needs word_timestamps)")),
        ("--max_line_width", dict(type=optional_int, default=None,
                                  help="subtitle line length cap (needs word_timestamps)")),
        ("--max_line_count", dict(type=optional_int, default=None,
                                  help="subtitle line count cap (needs word_timestamps)")),
        ("--max_words_per_line", dict(type=optional_int, default=None,
                                      help="subtitle word cap per line (needs word_timestamps; ignored with max_line_width)")),
        ("--threads", dict(type=optional_int, default=0,
                           help="torch CPU threads (0 keeps torch's default)")),
        ("--clip_timestamps", dict(type=str, default="0",
                                   help="process only these start,end,... second ranges (last end defaults to EOF)")),
        ("--hallucination_silence_threshold", dict(type=optional_float,
                                                   help="with word_timestamps, skip silences longer than this around suspected hallucinations")),
        # whisper_tpu's extensions; the port does not have them yet
        ("--draft_model", dict(type=str, default=None,
                               help="speculative decoding (not in this port yet: "
                               "ROADMAP.md, Queue 1, 'Speculative decoding')")),
        ("--chunked", dict(type=str2bool, default=False,
                           help="decode fixed overlapping 30s chunks of each file as one "
                           "batch instead of walking windows sequentially (faster on long "
                           "files; disables cross-window prompt conditioning)")),
        ("--chunk_overlap", dict(type=float, default=5.0,
                                 help="seconds of audio shared between consecutive chunks "
                                 "in --chunked mode")),
    ]
    parser = argparse.ArgumentParser(formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    for names, kwargs in flags:
        names = (names,) if isinstance(names, str) else names
        parser.add_argument(*names, **kwargs)

    args = parser.parse_args().__dict__
    model_name: str = args.pop("model")
    model_dir: str = args.pop("model_dir")
    output_dir: str = args.pop("output_dir")
    output_format: str = args.pop("output_format")
    device: str = args.pop("device")
    if (threads := args.pop("threads")) and threads > 0:
        torch.set_num_threads(threads)
    if args.pop("draft_model") is not None:
        raise NotImplementedError("--draft_model: ROADMAP.md, Queue 1, 'Speculative decoding'")
    os.makedirs(output_dir, exist_ok=True)

    if model_name.endswith(".en") and args["language"] not in {"en", "English"}:
        if args["language"] is not None:
            warnings.warn(
                f"{model_name} is an English-only model but received "
                f"'{args['language']}'; using English instead."
            )
        args["language"] = "en"

    temperature = args.pop("temperature")
    if (increment := args.pop("temperature_increment_on_fallback")) is not None:
        temperature = tuple(np.arange(temperature, 1.0 + 1e-6, increment))
    else:
        temperature = [temperature]

    model = load_model(model_name, device=device, download_root=model_dir)

    writer = get_writer(output_format, output_dir)
    word_options = [
        "highlight_words",
        "max_line_count",
        "max_line_width",
        "max_words_per_line",
    ]
    if not args["word_timestamps"]:
        for option in word_options:
            if args[option]:
                parser.error(f"--{option} requires --word_timestamps True")
    if args["max_line_count"] and not args["max_line_width"]:
        warnings.warn("--max_line_count has no effect without --max_line_width")
    if args["max_words_per_line"] and args["max_line_width"]:
        warnings.warn("--max_words_per_line has no effect with --max_line_width")
    writer_args = {arg: args.pop(arg) for arg in word_options}
    chunked = args.pop("chunked")
    chunk_overlap = args.pop("chunk_overlap")
    if chunked:
        from .chunked import transcribe_chunked

        # chunked mode decodes chunks independently; drop the options it
        # rejects (the default True would otherwise always raise)
        args.pop("condition_on_previous_text", None)
        args.pop("clip_timestamps", None)
    for audio_path in args.pop("audio"):
        try:
            if chunked:
                result = transcribe_chunked(model, audio_path, chunk_overlap=chunk_overlap,
                                            temperature=temperature, **args)
            else:
                result = transcribe(model, audio_path, temperature=temperature, **args)
            writer(result, audio_path, **writer_args)
        except Exception as e:
            traceback.print_exc()
            print(f"Skipping {audio_path} due to {type(e).__name__}: {str(e)}")


if __name__ == "__main__":
    cli()
