"""Streaming (incremental) transcription.

Counterpart of ``whisper_tpu/streaming.py``: feed 16 kHz mono PCM in chunks
of any size, get finalized segments back as soon as each 30-second window
can be decoded.  The per-window pipeline (prompt conditioning, the
temperature-fallback ladder, timestamp segmentation, word timestamps with
the seek refinement and hallucination heuristics) is
:func:`whisper_tpu_torch.transcribe.transcribe`'s, through the same
helpers, so a stream fed to its end matches a one-shot ``transcribe`` of the
same audio, with one exception, as there:

**Normalization.** ``transcribe`` takes the log-Mel dynamic-range floor
(max - 8) over the whole file; a stream cannot see the future, so each
window's floor is over its own frames (:func:`~whisper_tpu_torch.audio.
log_mel_frames`).  The outputs are the same whenever each window's mel peak
is within 8 of the file's, as in any window that holds speech.

Each window's mel is computed on the model's device and decoded there.

Usage::

    st = StreamingTranscriber(model, language="en")
    for chunk in pcm_chunks:          # float32 @ 16 kHz, any chunk size
        for segment in st.push(chunk):
            print(segment["text"])    # finalized, never revised
    final = st.flush()                # drains the tail (< 30 s remainder)
    st.result                         # {"text", "segments", "language"}
"""

from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from .audio import HOP_LENGTH, N_FFT, N_FRAMES, SAMPLE_RATE, log_mel_frames, pad_or_trim
from .decoding import DecodingOptions, DecodingResult
from .tokenizer import get_tokenizer
from .transcribe import _refine_seek_with_word_timings, needs_fallback, segment_window
from .utils import exact_div, get_end

_MARGIN = N_FFT // 2  # samples a frame reads beyond its hop-aligned start


class StreamingTranscriber:
    """Stateful incremental transcriber; one instance per audio stream."""

    def __init__(
        self,
        model,
        *,
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
        hallucination_silence_threshold: Optional[float] = None,
        **decode_options,
    ):
        self.model = model
        self.temperatures = (
            [temperature] if isinstance(temperature, (int, float)) else list(temperature)
        )
        self.compression_ratio_threshold = compression_ratio_threshold
        self.logprob_threshold = logprob_threshold
        self.no_speech_threshold = no_speech_threshold
        self.condition_on_previous_text = condition_on_previous_text
        self.carry_initial_prompt = carry_initial_prompt
        self.word_timestamps = word_timestamps
        self.prepend_punctuations = prepend_punctuations
        self.append_punctuations = append_punctuations
        self.hallucination_silence_threshold = hallucination_silence_threshold
        self.decode_options = dict(decode_options)

        if self.decode_options.get("language") is None and not model.is_multilingual:
            self.decode_options["language"] = "en"
        self._tokenizer = None
        self._initial_prompt = initial_prompt
        self._initial_prompt_tokens: List[int] = []

        # PCM ring: `_pcm` holds samples [_pcm_start, _pcm_start + len) of the
        # stream; consumed audio is dropped as seek advances
        self._pcm = np.zeros(0, np.float32)
        self._pcm_start = 0  # stream index of _pcm[0]
        self._total_samples = 0
        self._finished = False

        self.seek = 0  # stream mel-frame index, as in transcribe()
        self.all_tokens: List[int] = []
        self.all_segments: List[dict] = []
        self.prompt_reset_since = 0
        self.last_speech_timestamp = 0.0
        self.language: Optional[str] = self.decode_options.get("language")

        self._input_stride = exact_div(N_FRAMES, model.dims.n_audio_ctx)
        self._time_precision = self._input_stride * HOP_LENGTH / SAMPLE_RATE

    # -- public API ----------------------------------------------------------

    def push(self, pcm: np.ndarray) -> List[dict]:
        """Feed PCM (float32 mono @ 16 kHz); returns newly finalized segments."""
        if self._finished:
            raise RuntimeError("stream already flushed")
        pcm = np.asarray(pcm, np.float32).reshape(-1)
        self._pcm = np.concatenate([self._pcm, pcm])
        self._total_samples += len(pcm)
        out: List[dict] = []
        # decode every full window available; leave the tail for flush
        while self._frames_available() - self.seek >= N_FRAMES:
            out.extend(self._process_window(final=False))
        return out

    def flush(self) -> List[dict]:
        """Signal end-of-stream; decode the remaining tail (< 30 s windows)."""
        if self._finished:
            return []
        self._finished = True
        out: List[dict] = []
        content_frames = self._content_frames()
        while self.seek < content_frames:
            out.extend(self._process_window(final=True))
        return out

    @property
    def result(self) -> dict:
        """Accumulated {"text", "segments", "language"} (transcribe format)."""
        tokenizer = self._get_tokenizer() if self.language else None
        text = (
            tokenizer.decode(self.all_tokens[len(self._initial_prompt_tokens):])
            if tokenizer
            else ""
        )
        return dict(text=text, segments=self.all_segments, language=self.language)

    # -- internals -----------------------------------------------------------

    def _frames_available(self) -> int:
        """Mel frames fully determined by the samples received so far."""
        return max(0, (self._total_samples - _MARGIN) // HOP_LENGTH + 1)

    def _content_frames(self) -> int:
        # transcribe() computes mel over audio + N_SAMPLES zeros and sets
        # content_frames = frames - N_FRAMES, which reduces to total // HOP
        return self._total_samples // HOP_LENGTH

    def _window_mel(self, seek: int, segment_size: int) -> torch.Tensor:
        """Mel frames [seek, seek+segment_size), zero-padded to N_FRAMES, on
        the model's device.

        Samples beyond the stream are zeros (the analog of transcribe's 30 s
        of zero padding); the first window's left edge is reflected exactly
        as torch.stft's centred frames are.
        """
        first = seek * HOP_LENGTH - _MARGIN
        last = (seek + segment_size - 1) * HOP_LENGTH + _MARGIN  # exclusive
        slice_ = np.zeros(last - first, np.float32)
        # copy the available real samples into place
        lo = max(first, self._pcm_start)
        hi = min(last, self._pcm_start + len(self._pcm))
        if hi > lo:
            slice_[lo - first : hi - first] = self._pcm[lo - self._pcm_start : hi - self._pcm_start]
        if first < 0:
            # reflect the left edge (only while seek * HOP < MARGIN, at the
            # very start of the stream): sample -k mirrors sample k
            n = -first
            slice_[:n] = slice_[n + 1 : 2 * n + 1][::-1]
        mel = log_mel_frames(slice_, self.model.dims.n_mels, device=self.model.device)
        return pad_or_trim(mel, N_FRAMES)

    def _get_tokenizer(self):
        if self._tokenizer is None:
            self._tokenizer = get_tokenizer(
                self.model.is_multilingual,
                num_languages=self.model.num_languages,
                language=self.language,
                task=self.decode_options.get("task", "transcribe"),
            )
            if self._initial_prompt is not None:
                self._initial_prompt_tokens = self._tokenizer.encode(
                    " " + self._initial_prompt.strip()
                )
                self.all_tokens = list(self._initial_prompt_tokens) + self.all_tokens
        return self._tokenizer

    def _detect_language(self, mel_segment: torch.Tensor):
        _, probs = self.model.detect_language(mel_segment)
        self.language = max(probs, key=probs.get)
        self.decode_options["language"] = self.language

    def _decode_with_fallback(self, segment: torch.Tensor) -> DecodingResult:
        decode_result = None
        for t in self.temperatures:
            kwargs = {**self.decode_options}
            if t > 0:
                kwargs.pop("beam_size", None)
                kwargs.pop("patience", None)
            else:
                kwargs.pop("best_of", None)
            options = DecodingOptions(**kwargs, temperature=t)
            decode_result = self.model.decode(segment, options)
            if not needs_fallback(
                decode_result,
                self.compression_ratio_threshold,
                self.logprob_threshold,
                self.no_speech_threshold,
            ):
                break
        return decode_result

    def _drop_consumed_pcm(self):
        """Release PCM the seek pointer has passed (keep the frame margin)."""
        keep_from = max(0, self.seek * HOP_LENGTH - _MARGIN)
        if keep_from > self._pcm_start:
            self._pcm = self._pcm[keep_from - self._pcm_start :]
            self._pcm_start = keep_from

    def _process_window(self, final: bool) -> List[dict]:
        content_frames = self._content_frames() if final else self._frames_available()
        content_duration = float(content_frames * HOP_LENGTH / SAMPLE_RATE)
        segment_size = min(N_FRAMES, content_frames - self.seek)
        mel_segment = self._window_mel(self.seek, segment_size)

        if self.language is None:
            self._detect_language(mel_segment)
        tokenizer = self._get_tokenizer()

        remaining_prompt_length = self.model.dims.n_text_ctx // 2 - 1 - len(
            self._initial_prompt_tokens
        )
        if self.carry_initial_prompt:
            nignored = max(len(self._initial_prompt_tokens), self.prompt_reset_since)
            remaining = self.all_tokens[nignored:][-remaining_prompt_length:]
            self.decode_options["prompt"] = self._initial_prompt_tokens + remaining
        else:
            self.decode_options["prompt"] = self.all_tokens[self.prompt_reset_since:]

        time_offset = float(self.seek * HOP_LENGTH / SAMPLE_RATE)
        window_end_time = float((self.seek + N_FRAMES) * HOP_LENGTH / SAMPLE_RATE)
        segment_duration = segment_size * HOP_LENGTH / SAMPLE_RATE

        result = self._decode_with_fallback(mel_segment)

        if self.no_speech_threshold is not None:
            should_skip = result.no_speech_prob > self.no_speech_threshold
            if self.logprob_threshold is not None and result.avg_logprob > self.logprob_threshold:
                should_skip = False
            if should_skip:
                self.seek += segment_size
                self._drop_consumed_pcm()
                return []

        previous_seek = self.seek
        current_segments, self.seek, single_timestamp_ending = segment_window(
            result=result,
            tokenizer=tokenizer,
            seek=previous_seek,
            segment_size=segment_size,
            time_offset=time_offset,
            segment_duration=segment_duration,
            input_stride=self._input_stride,
            time_precision=self._time_precision,
        )

        if self.word_timestamps:
            from .timing import add_word_timestamps

            add_word_timestamps(
                segments=current_segments,
                model=self.model,
                tokenizer=tokenizer,
                mel=mel_segment,
                num_frames=segment_size,
                prepend_punctuations=self.prepend_punctuations,
                append_punctuations=self.append_punctuations,
                last_speech_timestamp=self.last_speech_timestamp,
                # the decode already encoded this window
                features=result.audio_features,
            )
            self.seek, restart = _refine_seek_with_word_timings(
                current_segments,
                seek=self.seek,
                previous_seek=previous_seek,
                segment_size=segment_size,
                single_timestamp_ending=single_timestamp_ending,
                time_offset=time_offset,
                window_end_time=window_end_time,
                segment_duration=segment_duration,
                content_frames=content_frames,
                content_duration=content_duration,
                last_speech_timestamp=self.last_speech_timestamp,
                threshold=self.hallucination_silence_threshold,
            )
            if restart:
                self._drop_consumed_pcm()
                return []
            last_word_end = get_end(current_segments)
            if last_word_end is not None:
                self.last_speech_timestamp = last_word_end

        for segment in current_segments:
            if segment["start"] == segment["end"] or not segment["text"].strip():
                segment["text"] = ""
                segment["tokens"] = []
                segment["words"] = []

        new_segments = [
            {"id": i, **segment}
            for i, segment in enumerate(current_segments, start=len(self.all_segments))
        ]
        self.all_segments.extend(new_segments)
        self.all_tokens.extend(tok for segment in current_segments for tok in segment["tokens"])
        if not self.condition_on_previous_text or result.temperature > 0.5:
            self.prompt_reset_since = len(self.all_tokens)

        self._drop_consumed_pcm()
        return new_segments
