"""Word-level timestamps via cross-attention DTW alignment.

Counterpart of ``whisper_tpu/timing.py`` (behavioural parity target:
reference ``whisper/timing.py`` — find_alignment, merge_punctuations,
add_word_timestamps with its duration-median boundary heuristics).

The teacher-forced forward returns the alignment heads' cross-attention
scores directly (no hooks), and the softmax -> z-norm -> median filter
(kernel K3) -> mean over heads -> DTW wavefront (kernel K4) pipeline runs on
the model's device with fixed shapes: the token length is bucketed, and the
frame count is handled by masking plus a reflect remap at the window's last
real frame, so results match the reference's sliced computation.  Only the
O(N+M) backtrace runs on the host (C++, the JAX package's native dtw.cpp).
"""

from dataclasses import dataclass
from typing import TYPE_CHECKING, List, Optional

import numpy as np
import torch

from .audio import HOP_LENGTH, SAMPLE_RATE, TOKENS_PER_SECOND
from .models.whisper import decoder_forward, encoder_apply
from .ops.dtw import _unskew_trace, backtrace, dtw, dtw_trace
from .ops.median import median_filter
from .tokenizer import Tokenizer

if TYPE_CHECKING:
    from .models.whisper import Whisper

__all__ = ["WordTiming", "find_alignment", "merge_punctuations", "add_word_timestamps",
           "median_filter", "dtw"]

_TOKEN_BUCKETS = (32, 64, 128, 256, 448)


def _token_bucket(n: int) -> int:
    for b in _TOKEN_BUCKETS:
        if n <= b:
            return b
    return _TOKEN_BUCKETS[-1]


@dataclass
class WordTiming:
    word: str
    tokens: List[int]
    start: float
    end: float
    probability: float


@torch.inference_mode()
def _alignment_device(
    params,
    dims,
    heads: np.ndarray,  # (K, 2) (layer, head) pairs
    sot_len: int,
    eot: int,
    medfilt_width: int,
    n_rows: int,  # token bucket minus sot_len (DTW row count)
    mel: torch.Tensor,  # (B, n_mels, 3000) or, features_given, (B, Ta, C)
    tokens: torch.Tensor,  # (B, Tb) — sot_seq + no_timestamps + text + eot, padded
    t_real: torch.Tensor,  # (B,): true token counts
    nf2: torch.Tensor,  # (B,): num_frames // 2 (true audio columns)
    qk_scale: float,
    features_given: bool = False,
):
    """Teacher-forced pass, attention pipeline and DTW trace on the device.

    Batched over segments: each row has its own true token length and frame
    count, handled by masking and a per-row reflect remap.  Returns
    (token_probs (B, Tb - sot_len), trace diagonals (B, n_rows+Ta+1,
    n_rows+1) int32).
    """
    dtype = params["decoder"]["tok_emb"].dtype
    feats = mel.to(dtype) if features_given else encoder_apply(params, dims, mel)
    logits, qk = decoder_forward(params, dims, tokens, feats, alignment_heads=heads)

    # per-token probabilities of the sampled text (reference timing.py:198-201)
    probs = torch.softmax(logits[:, sot_len:, :eot].float(), dim=-1)
    next_tokens = torch.roll(tokens, -1, dims=1)[:, sot_len:]  # predicted at row i
    token_probs = probs.gather(2, next_tokens.clamp(0, eot - 1)[:, :, None])[:, :, 0]

    # attention weights (K, B, Tb, Ta): mask frames beyond each row's audio,
    # softmax, z-normalise across that row's real token rows (timing.py:207-211)
    w = qk * qk_scale
    K, B, Tb, ta = w.shape
    frame_idx = torch.arange(ta, device=w.device)
    frame_ok = frame_idx[None, None, None, :] < nf2[None, :, None, None]
    w = torch.softmax(w.masked_fill(~frame_ok, float("-inf")), dim=-1)

    row_valid = torch.arange(Tb, device=w.device)[None, None, :, None] < t_real[None, :, None, None]
    denom = t_real.float()[None, :, None, None]
    mean = torch.where(row_valid, w, 0.0).sum(dim=2, keepdim=True) / denom
    var = torch.where(row_valid, (w - mean) ** 2, 0.0).sum(dim=2, keepdim=True) / denom
    w = (w - mean) / torch.sqrt(var)

    # the reference's reflect padding at each row's frame boundary, so the
    # median filter sees the same neighbourhood (timing.py:35)
    src = torch.where(
        frame_idx[None, :] < nf2[:, None],
        frame_idx[None, :],
        (2 * (nf2[:, None] - 1) - frame_idx[None, :]).clamp(0, ta - 1),
    )  # (B, Ta)
    w = w.gather(3, src[None, :, None, :].expand(K, B, Tb, ta)).contiguous()
    w = median_filter(w, medfilt_width)

    matrix = w.mean(dim=0)  # (B, Tb, Ta)
    text_rows = matrix[:, sot_len : sot_len + n_rows]
    return token_probs, dtw_trace(-text_rows, n_rows, ta)


def find_alignment_batch(
    model: "Whisper",
    tokenizer: Tokenizer,
    text_tokens_batch: List[List[int]],
    mels,  # (B, n_mels, 3000); ignored when ``features`` is given
    num_frames_batch: List[int],
    *,
    features=None,  # (B, Ta, C) encoder features from the decode
    medfilt_width: int = 7,
    qk_scale: float = 1.0,
) -> List[List[WordTiming]]:
    """Align a batch of segments in one device pass.

    Per-segment results are identical to :func:`find_alignment`; all
    segments share one (bucketed) token length, with per-row masking for the
    true lengths and frame counts.  Pass ``features`` (the encoder output the
    decode already computed for these windows) to skip re-encoding.
    """
    if not text_tokens_batch:
        return []
    sot_len = len(tokenizer.sot_sequence)
    device = model.device

    fulls = [
        [*tokenizer.sot_sequence, tokenizer.no_timestamps, *text, tokenizer.eot]
        for text in text_tokens_batch
    ]
    t_reals = [len(f) for f in fulls]
    tb = _token_bucket(max(t_reals))
    padded = np.full((len(fulls), tb), tokenizer.eot, np.int64)
    for i, f in enumerate(fulls):
        padded[i, : min(len(f), tb)] = f[:tb]

    source = torch.as_tensor(features if features is not None else mels).to(device)
    if source.dim() == 2:
        source = source[None]

    token_probs, trace_diags = _alignment_device(
        model.params,
        model.dims,
        np.asarray(model.alignment_heads),
        sot_len,
        tokenizer.eot,
        medfilt_width,
        tb - sot_len,
        source,
        torch.from_numpy(padded).to(device),
        torch.tensor(t_reals, device=device),
        torch.tensor([nf // 2 for nf in num_frames_batch], device=device),
        qk_scale,
        features_given=features is not None,
    )
    token_probs = token_probs.cpu().numpy()
    trace_diags = trace_diags.cpu().numpy()

    out: List[List[WordTiming]] = []
    for i, text_tokens in enumerate(text_tokens_batch):
        if len(text_tokens) == 0:
            out.append([])
            continue
        out.append(
            _timings_from_alignment(
                tokenizer,
                text_tokens,
                token_probs[i],
                trace_diags[i],
                sot_len=sot_len,
                t_real=t_reals[i],
                tb=tb,
                m_real=num_frames_batch[i] // 2,
            )
        )
    return out


def _timings_from_alignment(
    tokenizer, text_tokens, token_probs, trace_diags, *, sot_len, t_real, tb, m_real
) -> List[WordTiming]:
    """Host post-processing: backtrace, word splitting, jump-time extraction."""
    text_token_probs = token_probs[: len(text_tokens)].tolist()

    # rows: no_timestamps + text tokens (the reference's [len(sot):-1] slice)
    n_real = t_real - sot_len - 1
    trace = _unskew_trace(trace_diags, tb - sot_len, trace_diags.shape[0] - (tb - sot_len) - 1)
    trace = trace[: n_real + 1, : m_real + 1]
    text_indices, time_indices = backtrace(trace)

    words, word_tokens = tokenizer.split_to_word_tokens(text_tokens + [tokenizer.eot])
    if len(word_tokens) <= 1:
        # a lone EOT has no word boundaries to time
        return []
    word_boundaries = np.pad(np.cumsum([len(t) for t in word_tokens[:-1]]), (1, 0))

    jumps = np.pad(np.diff(text_indices), (1, 0), constant_values=1).astype(bool)
    jump_times = time_indices[jumps] / TOKENS_PER_SECOND
    start_times = jump_times[word_boundaries[:-1]]
    end_times = jump_times[word_boundaries[1:]]
    word_probabilities = [
        np.mean(text_token_probs[i:j])
        for i, j in zip(word_boundaries[:-1], word_boundaries[1:])
    ]

    return [
        WordTiming(word, tokens, start, end, probability)
        for word, tokens, start, end, probability in zip(
            words, word_tokens, start_times, end_times, word_probabilities
        )
    ]


def find_alignment(
    model: "Whisper",
    tokenizer: Tokenizer,
    text_tokens: List[int],
    mel,
    num_frames: int,
    *,
    features=None,  # (Ta, C) encoder features; skips the encoder pass
    medfilt_width: int = 7,
    qk_scale: float = 1.0,
) -> List[WordTiming]:
    """Align text tokens to audio frames; parity with timing.py:163-242."""
    if len(text_tokens) == 0:
        return []
    return find_alignment_batch(
        model, tokenizer, [text_tokens], mel if features is None else None, [num_frames],
        features=features, medfilt_width=medfilt_width, qk_scale=qk_scale,
    )[0]


def merge_punctuations(alignment: List[WordTiming], prepended: str, appended: str):
    """Fold punctuation-only timings into neighbours (timing.py:245-276)."""
    # prepended punctuation attaches to the following word
    i = len(alignment) - 2
    j = len(alignment) - 1
    while i >= 0:
        previous = alignment[i]
        following = alignment[j]
        if previous.word.startswith(" ") and previous.word.strip() in prepended:
            following.word = previous.word + following.word
            following.tokens = previous.tokens + following.tokens
            previous.word = ""
            previous.tokens = []
        else:
            j = i
        i -= 1

    # appended punctuation attaches to the preceding word
    i = 0
    j = 1
    while j < len(alignment):
        previous = alignment[i]
        following = alignment[j]
        if not previous.word.endswith(" ") and following.word in appended:
            previous.word = previous.word + following.word
            previous.tokens = previous.tokens + following.tokens
            following.word = ""
            following.tokens = []
        else:
            i = j
        j += 1


def add_word_timestamps(
    *,
    segments: List[dict],
    model: "Whisper",
    tokenizer: Tokenizer,
    mel,
    num_frames: int,
    prepend_punctuations: str = "\"'“¿([{-",
    append_punctuations: str = "\"'.。,，!！?？:：”)]}、",
    last_speech_timestamp: float,
    alignment: Optional[List[WordTiming]] = None,
    features=None,
    **kwargs,
):
    """Attach per-word timings to segments; parity with timing.py:279-388.

    ``alignment`` may be precomputed; otherwise it is computed here — from
    ``features`` (the window's encoder output, skipping the encoder pass)
    when given.
    """
    if len(segments) == 0:
        return

    text_tokens_per_segment = [
        [token for token in segment["tokens"] if token < tokenizer.eot]
        for segment in segments
    ]

    text_tokens = [t for seg in text_tokens_per_segment for t in seg]
    if alignment is None:
        alignment = find_alignment(
            model, tokenizer, text_tokens, mel, num_frames, features=features, **kwargs
        )
    word_durations = np.array([t.end - t.start for t in alignment])
    word_durations = word_durations[word_durations.nonzero()]
    median_duration = np.median(word_durations) if len(word_durations) > 0 else 0.0
    median_duration = min(0.7, float(median_duration))
    max_duration = median_duration * 2

    # truncate overlong words at sentence boundaries (timing.py:307-317)
    if len(word_durations) > 0:
        sentence_end_marks = ".。!！?？"
        for i in range(1, len(alignment)):
            if alignment[i].end - alignment[i].start > max_duration:
                if alignment[i].word in sentence_end_marks:
                    alignment[i].end = alignment[i].start + max_duration
                elif alignment[i - 1].word in sentence_end_marks:
                    alignment[i].start = alignment[i].end - max_duration

    merge_punctuations(alignment, prepend_punctuations, append_punctuations)

    time_offset = segments[0]["seek"] * HOP_LENGTH / SAMPLE_RATE
    word_index = 0

    for segment, seg_text_tokens in zip(segments, text_tokens_per_segment):
        saved_tokens = 0
        words = []

        while word_index < len(alignment) and saved_tokens < len(seg_text_tokens):
            timing = alignment[word_index]

            if timing.word:
                words.append(
                    dict(
                        word=timing.word,
                        start=round(time_offset + timing.start, 2),
                        end=round(time_offset + timing.end, 2),
                        probability=timing.probability,
                    )
                )

            saved_tokens += len(timing.tokens)
            word_index += 1

        # boundary fixes at pauses and segment edges (timing.py:344-386)
        if len(words) > 0:
            if words[0]["end"] - last_speech_timestamp > median_duration * 4 and (
                words[0]["end"] - words[0]["start"] > max_duration
                or (len(words) > 1 and words[1]["end"] - words[0]["start"] > max_duration * 2)
            ):
                if len(words) > 1 and words[1]["end"] - words[1]["start"] > max_duration:
                    boundary = max(words[1]["end"] / 2, words[1]["end"] - max_duration)
                    words[0]["end"] = words[1]["start"] = boundary
                words[0]["start"] = max(0, words[0]["end"] - max_duration)

            if segment["start"] < words[0]["end"] and segment["start"] - 0.5 > words[0]["start"]:
                words[0]["start"] = max(0, min(words[0]["end"] - median_duration, segment["start"]))
            else:
                segment["start"] = words[0]["start"]

            if segment["end"] > words[-1]["start"] and segment["end"] + 0.5 < words[-1]["end"]:
                words[-1]["end"] = max(words[-1]["start"] + median_duration, segment["end"])
            else:
                segment["end"] = words[-1]["end"]

            last_speech_timestamp = segment["end"]

        segment["words"] = words
