"""Forced alignment: word timestamps for a KNOWN transcript.

Counterpart of ``whisper_tpu/align.py``.  The decoder is teacher-forced
over the given tokens and the alignment heads' cross-attention scores go
through the word-timing pipeline of :mod:`whisper_tpu_torch.timing` (the
median filter K3 and the DTW trace K4 on a CUDA tensor), so any provided
text aligns to the audio: the "re-align an edited transcript" or
subtitle-retiming workflow.

Two entry points on one function:

- ``align(model, audio, text=...)``: one clip of at most 30 s;
- ``align(model, audio, segments=[{"start", "end", "text"}, ...])``: a long
  file whose coarse segment times are known (for example ``transcribe``'s
  output, its text then edited); each segment's window is sliced out of
  the file's mel on the device, and all segments align in one batched pass
  (``timing.find_alignment_batch``).
"""

from typing import List, Optional, Union

import numpy as np
import torch

from .audio import FRAMES_PER_SECOND, N_FRAMES, N_SAMPLES, SAMPLE_RATE, load_audio, log_mel_spectrogram
from .timing import find_alignment_batch, merge_punctuations
from .tokenizer import get_tokenizer

__all__ = ["align"]


def align(
    model,
    audio: Union[str, np.ndarray],
    text: Optional[str] = None,
    *,
    segments: Optional[List[dict]] = None,
    language: str = "en",
    prepend_punctuations: str = "\"'“¿([{-",
    append_punctuations: str = "\"'.。,，!！?？:：”)]}、",
    medfilt_width: int = 7,
) -> dict:
    """Word-align known text to audio; returns {"segments", "language"}.

    Each returned segment carries the input text and
    ``words=[{"word", "start", "end", "probability"}, ...]`` with absolute
    times.  Exactly one of ``text`` (a clip of at most 30 s) or ``segments``
    (``{"start", "end", "text"}`` dicts, each spanning at most 30 s) must be
    given.
    """
    if (text is None) == (segments is None):
        raise ValueError("pass exactly one of text= or segments=")

    from .batch import _slice_windows

    wave = load_audio(audio) if isinstance(audio, str) else np.asarray(audio)
    if wave.ndim != 1:
        wave = wave.reshape(-1)
    duration = wave.shape[0] / SAMPLE_RATE

    if text is not None:
        if duration > N_SAMPLES / SAMPLE_RATE + 1e-6:
            raise ValueError(
                f"audio is {duration:.1f} s; align(text=...) handles one "
                "<=30 s clip — pass segments=[{'start','end','text'}, ...] "
                "with the coarse segment times instead"
            )
        segments = [dict(start=0.0, end=min(duration, 30.0), text=text)]

    starts = [float(s["start"]) for s in segments]
    ends = [float(s["end"]) for s in segments]
    for st, en in zip(starts, ends):
        if not 0.0 <= st <= en <= duration + 1e-6:
            raise ValueError(f"segment [{st}, {en}] outside the {duration:.1f} s audio")
        if en - st > 30.0 + 1e-6:
            raise ValueError(f"segment [{st}, {en}] exceeds the 30 s window")

    tokenizer = get_tokenizer(
        model.is_multilingual,
        num_languages=model.num_languages,
        language=language,
        task="transcribe",
    )
    tokens_batch = [
        [t for t in tokenizer.encode(str(s["text"])) if t < tokenizer.eot] for s in segments
    ]

    # the whole file's mel on the model's device; one window per segment
    mel_store = log_mel_spectrogram(wave, model.dims.n_mels, padding=N_SAMPLES,
                                    device=model.device)[None]
    seeks = [int(round(st * FRAMES_PER_SECOND)) for st in starts]
    sizes = [min(int(round((en - st) * FRAMES_PER_SECOND)), N_FRAMES) for st, en in zip(starts, ends)]
    rows, seek_t, size_t = torch.tensor(
        [[0] * len(segments), seeks, sizes], dtype=torch.int64
    ).to(model.device)
    mels = _slice_windows(mel_store, rows, seek_t, size_t)

    alignments = find_alignment_batch(model, tokenizer, tokens_batch, mels, sizes,
                                      medfilt_width=medfilt_width)

    out_segments = []
    for seg, alignment in zip(segments, alignments):
        merge_punctuations(alignment, prepend_punctuations, append_punctuations)
        off = float(seg["start"])
        words = [
            dict(
                word=w.word,
                start=round(float(off + w.start), 2),
                end=round(float(off + w.end), 2),
                probability=float(w.probability),
            )
            for w in alignment
            if w.word
        ]
        out_segments.append(
            dict(start=float(seg["start"]), end=float(seg["end"]), text=str(seg["text"]), words=words)
        )
    return dict(segments=out_segments, language=language)
