"""Long-form transcription: 30-second sliding windows with temperature fallback.

Counterpart of ``whisper_tpu/transcribe.py:49-550`` (behavioural parity
target: reference ``whisper/transcribe.py:38-514``): the seek loop,
clip_timestamps, prompt conditioning (condition_on_previous_text,
carry_initial_prompt, prompt reset above T = 0.5), the temperature ladder
gated on compression ratio / avg logprob / no-speech probability, and
timestamp-token segmentation.  The loop is host-side (seek advances are
data-dependent); the whole file's mel stays on the model's device and each
window is sliced there.  Word timestamps wait for kernels K3 and K4.
"""

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
from .tokenizer import LANGUAGES, get_tokenizer
from .utils import exact_div, format_timestamp, make_safe

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
    clip_timestamps: Union[str, List[float]] = "0",
    **decode_options,
):
    """Transcribe audio, returning {"text", "segments", "language"}.

    Parameter semantics match reference transcribe.py:38-126; see that
    docstring for the meaning of each threshold.
    """
    if word_timestamps:
        raise NotImplementedError(
            "word_timestamps: ROADMAP.md, Queue 1, 'Word timing and alignment' "
            "(kernels K3 and K4)"
        )

    # whole-file mel with 30 s of trailing silence for the final window
    mel = log_mel_spectrogram(audio, model.dims.n_mels, padding=N_SAMPLES, device=model.device)
    content_frames = mel.shape[-1] - N_FRAMES

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
            decode_result = model.decode(segment, options)

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
            current_segments, seek, _ = segment_window(
                result=result,
                tokenizer=tokenizer,
                seek=seek,
                segment_size=segment_size,
                time_offset=time_offset,
                segment_duration=segment_duration,
                input_stride=input_stride,
                time_precision=time_precision,
            )

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
