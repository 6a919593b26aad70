"""Chunked parallel transcription of ONE long file.

Counterpart of ``whisper_tpu/chunked.py``.  The reference's ``transcribe``
walks a file window by window, because each window's seek depends on the
previous decode's timestamps (reference transcribe.py:229-238,339-399).
``transcribe_chunked`` trades that for FIXED overlapping 30 s chunks that
all decode together through ``transcribe_batch`` (whose per-file semantics
are transcribe's), then stitches the chunks' segments at the overlap
midpoints: the fixed-chunk strategy of Hugging Face's chunked long-form
pipeline.

The trade: output can differ from sequential ``transcribe`` near chunk
boundaries (a sentence straddling a cut goes to whichever side owns the
overlap midpoint, and cross-window prompt conditioning is off by
construction).  Exact sequential semantics remain the default
``transcribe``; this is the throughput mode for long files.
"""

from typing import List, Optional, Sequence, Union

import numpy as np

from .audio import CHUNK_LENGTH, FRAMES_PER_SECOND, N_SAMPLES, SAMPLE_RATE, load_audio
from .utils import format_timestamp, make_safe

__all__ = [
    "transcribe_chunked",
    "chunk_offsets",
    "detect_file_language",
    "merge_chunk_segments",
    "owned_segments",
]


def detect_file_language(model, wave: np.ndarray, verbose=None) -> str:
    """One language for a whole file, from its first 30 s (the reference's
    policy, transcribe.py:334-345): per-chunk detection could disagree
    across the chunks of one recording."""
    if not model.is_multilingual:
        return "en"
    from .audio import log_mel_spectrogram, pad_or_trim
    from .tokenizer import LANGUAGES

    head = wave[:N_SAMPLES]
    head = head.astype(np.float32) / 32768.0 if head.dtype == np.int16 else head.astype(np.float32)
    mel = log_mel_spectrogram(pad_or_trim(head), model.dims.n_mels, device=model.device)
    _, probs = model.detect_language(mel)
    language = max(probs, key=probs.get)
    if verbose is not None:
        print(f"Detected language: {LANGUAGES[language].title()}")
    return language


def chunk_offsets(n_samples: int, overlap: float = 5.0, sample_rate: int = SAMPLE_RATE) -> List[int]:
    """Start offsets (in samples) of fixed 30 s chunks covering a waveform.

    Chunks advance by ``CHUNK_LENGTH - overlap`` seconds; the final chunk is
    the first one whose 30 s span reaches the end of the audio (it may hold
    less than 30 s of content but never starts past the end).
    """
    if not 0.0 <= overlap < CHUNK_LENGTH:
        raise ValueError(f"overlap must be in [0, {CHUNK_LENGTH}), got {overlap}")
    chunk_samples = CHUNK_LENGTH * sample_rate
    stride = int(round((CHUNK_LENGTH - overlap) * sample_rate))
    offsets = [0]
    while offsets[-1] + chunk_samples < n_samples:
        offsets.append(offsets[-1] + stride)
    return offsets


def owned_segments(
    segments: Sequence[dict],
    index: int,
    offsets_sec: Sequence[float],
    chunk_length: float = float(CHUNK_LENGTH),
) -> List[dict]:
    """Chunk ``index``'s OWNED segments, rebased to absolute time.

    A chunk owns the region between the midpoints of its overlaps with its
    neighbours (fixed by the offsets alone, so ownership needs no
    neighbour's result); a segment belongs to the chunk that owns the
    segment's own midpoint.  Times, seeks and words are rebased by the
    chunk's offset; ``id`` is left as it is (the caller renumbers).  The
    inputs are not mutated.
    """
    off = offsets_sec[index]
    lo = (offsets_sec[index] + offsets_sec[index - 1] + chunk_length) / 2.0 if index > 0 else -np.inf
    hi = (
        (offsets_sec[index + 1] + offsets_sec[index] + chunk_length) / 2.0
        if index < len(offsets_sec) - 1
        else np.inf
    )
    kept: List[dict] = []
    for seg in segments:
        mid = off + (seg["start"] + seg["end"]) / 2.0
        if not (lo <= mid < hi):
            continue
        out = dict(
            seg,
            seek=seg["seek"] + int(round(off * FRAMES_PER_SECOND)),
            start=seg["start"] + off,
            end=seg["end"] + off,
        )
        if seg.get("words"):
            out["words"] = [dict(w, start=w["start"] + off, end=w["end"] + off) for w in seg["words"]]
        kept.append(out)
    return kept


def merge_chunk_segments(
    chunk_segments: Sequence[Sequence[dict]],
    offsets_sec: Sequence[float],
    chunk_length: float = float(CHUNK_LENGTH),
) -> List[dict]:
    """Stitch per-chunk segment lists into one absolute-time list: the
    concatenation of :func:`owned_segments` over the chunks, with ids
    renumbered across the file."""
    if len(chunk_segments) != len(offsets_sec):
        raise ValueError("one offset per chunk required")
    merged: List[dict] = []
    for i, segments in enumerate(chunk_segments):
        for seg in owned_segments(segments, i, offsets_sec, chunk_length):
            merged.append(dict(seg, id=len(merged)))
    return merged


def transcribe_chunked(
    model,
    audio: Union[str, np.ndarray],
    *,
    chunk_overlap: float = 5.0,
    batch_size: int = 16,
    verbose: Optional[bool] = None,
    **options,
) -> dict:
    """Transcribe one (long) file by decoding fixed overlapping 30 s chunks
    in parallel; returns the same {"text", "segments", "language"} dict as
    ``transcribe``.

    ``chunk_overlap`` seconds of audio are shared between consecutive chunks
    so that speech cut by a chunk edge is seen whole by one of the two;
    segments are stitched at the overlap midpoints
    (``merge_chunk_segments``).  Every ``transcribe_batch`` option is
    accepted except those that contradict fixed chunks:
    ``condition_on_previous_text`` (chunks are independent) and
    ``clip_timestamps`` (use sequential ``transcribe`` for clips).

    ``word_timestamps=True`` keeps the chunked throughput: the sequential
    path's word-based seek refinement (reference transcribe.py:413-416,
    which rewinds to the last aligned word and re-decodes the tail) is off,
    because a neighbouring chunk already decodes every boundary region
    whole.  Word times are rebased to the file's time while stitching.
    ``hallucination_silence_threshold`` needs that refinement and therefore
    sequential ``transcribe``.
    """
    from .batch import transcribe_batch

    if options.pop("condition_on_previous_text", False):
        raise ValueError(
            "transcribe_chunked decodes chunks independently; "
            "condition_on_previous_text=True requires sequential transcribe()"
        )
    if str(options.pop("clip_timestamps", "0")) != "0":
        raise ValueError("clip_timestamps is not supported in chunked mode; use transcribe()")
    if options.get("hallucination_silence_threshold") is not None:
        raise ValueError(
            "hallucination_silence_threshold steers the sequential seek "
            "(via word-based refinement); chunked windows are fixed — use "
            "sequential transcribe() for it"
        )

    wave = load_audio(audio) if isinstance(audio, str) else np.asarray(audio)
    if wave.ndim != 1:
        wave = wave.reshape(-1)
    offsets = chunk_offsets(wave.shape[0], chunk_overlap)

    if options.pop("word_seek_refinement", False):
        raise ValueError(
            "transcribe_chunked always decodes with word_seek_refinement="
            "False: its fixed overlapping chunks make the reference's "
            "rewind-to-last-word re-decode redundant"
        )

    if options.get("language") is None:
        options["language"] = detect_file_language(model, wave, verbose=verbose)

    chunk_samples = CHUNK_LENGTH * SAMPLE_RATE
    results = transcribe_batch(
        model,
        [wave[o : o + chunk_samples] for o in offsets],
        batch_size=batch_size,
        condition_on_previous_text=False,
        word_seek_refinement=False,
        **options,
    )

    language = results[0]["language"]
    if len(results) == 1:
        merged = results[0]["segments"]
    else:
        merged = merge_chunk_segments([r["segments"] for r in results],
                                      [o / SAMPLE_RATE for o in offsets])
    if verbose:
        for seg in merged:
            line = f"[{format_timestamp(seg['start'])} --> {format_timestamp(seg['end'])}] {seg['text']}"
            print(make_safe(line))
    return dict(text="".join(s["text"] for s in merged), segments=merged, language=language)
