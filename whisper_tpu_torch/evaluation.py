"""WER/CER evaluation and int8 against full precision.

Counterpart of ``whisper_tpu/evaluation.py``: edit-distance WER and CER
with the English text normalizer (the port's copy,
:mod:`whisper_tpu_torch.normalizers`); ``evaluate_batched``, a corpus of
utterances of at most 30 s decoded through ``transcribe_batch``;
``int8_wer_gate``, the WER delta an int8 model may cost; and
``int8_divergence_proxy``, greedy token agreement and teacher-forced logit
divergence along the full-precision model's own greedy trajectory (both
models score the same prefixes, so divergence does not compound), which
runs on random weights.  The WER functions need a corpus with reference
texts to say anything about a model.
"""

import time
from dataclasses import dataclass, replace
from typing import Callable, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .decoding import DecodingOptions, DecodingTask
from .normalizers import EnglishTextNormalizer


def edit_distance(ref: Sequence, hyp: Sequence) -> int:
    """Levenshtein distance over token sequences (two-row DP)."""
    if len(ref) < len(hyp):
        ref, hyp = hyp, ref
    previous = list(range(len(hyp) + 1))
    for i, r in enumerate(ref, start=1):
        current = [i] + [0] * len(hyp)
        for j, h in enumerate(hyp, start=1):
            current[j] = min(
                previous[j] + 1,  # deletion
                current[j - 1] + 1,  # insertion
                previous[j - 1] + (r != h),  # substitution
            )
        previous = current
    return previous[-1]


@dataclass
class ErrorRate:
    errors: int = 0
    total: int = 0

    def update(self, ref: Sequence, hyp: Sequence):
        self.errors += edit_distance(ref, hyp)
        self.total += len(ref)

    @property
    def rate(self) -> float:
        return self.errors / max(self.total, 1)


def word_error_rate(
    references: Iterable[str],
    hypotheses: Iterable[str],
    normalizer: Optional[Callable[[str], str]] = None,
) -> float:
    """Corpus-level WER with (by default) the English text normalizer, the
    reference's LibriSpeech evaluation protocol."""
    normalizer = normalizer or EnglishTextNormalizer()
    wer = ErrorRate()
    for ref, hyp in zip(references, hypotheses):
        wer.update(normalizer(ref).split(), normalizer(hyp).split())
    return wer.rate


def char_error_rate(
    references: Iterable[str],
    hypotheses: Iterable[str],
    normalizer: Optional[Callable[[str], str]] = None,
) -> float:
    normalizer = normalizer or EnglishTextNormalizer()
    cer = ErrorRate()
    for ref, hyp in zip(references, hypotheses):
        cer.update(list(normalizer(ref)), list(normalizer(hyp)))
    return cer.rate


def evaluate_batched(
    model,
    items: List[Tuple[np.ndarray, str]],  # (16 kHz mono waveform, reference text)
    batch_size: int = 16,
    language: str = "en",
    without_timestamps: bool = True,
    **decode_options,
) -> dict:
    """Greedy-decode utterances of at most 30 s, ``batch_size`` at a time,
    and score them: corpus WER and CER, the decode's wall and real-time
    factor, and the hypotheses.

    The utterances go through ``transcribe_batch`` (one window each, at
    T = 0 with no fallback and no silence skip, no previous-text prompt),
    the port's many-file path, where whisper_tpu's drives
    ``DecodingTask.run`` on zero-padded mels.  ``decode_options`` go to
    ``transcribe_batch`` (``sample_len``, ``beam_size``, ...)."""
    from .batch import transcribe_batch

    options = dict(temperature=0.0, condition_on_previous_text=False,
                   compression_ratio_threshold=None, logprob_threshold=None,
                   no_speech_threshold=None)
    options.update(decode_options)
    audios = [np.asarray(audio, np.float32) for audio, _ in items]
    refs = [text for _, text in items]
    t0 = time.perf_counter()
    results = transcribe_batch(model, audios, batch_size=batch_size, language=language,
                               without_timestamps=without_timestamps, **options)
    decode_seconds = time.perf_counter() - t0
    hyps = [r["text"].strip() for r in results]
    audio_seconds = sum(len(a) / 16000.0 for a in audios)
    return {
        "wer": word_error_rate(refs, hyps),
        "cer": char_error_rate(refs, hyps),
        "n_utterances": len(refs),
        "audio_seconds": audio_seconds,
        "decode_seconds": decode_seconds,
        "rtf": audio_seconds / max(decode_seconds, 1e-9),
        "hypotheses": hyps,
    }


# The largest absolute corpus-WER increase int8 may cost (whisper_tpu's
# gate): 0.3 percentage points on base.en's 4.26% LibriSpeech test-clean
# (BASELINE.md), well below the ~0.9 pp between adjacent model sizes.
INT8_WER_GATE_MAX_DELTA = 0.003


def int8_wer_gate(
    bf16_model,
    int8_model,
    items: List[Tuple[np.ndarray, str]],
    batch_size: int = 16,
    max_delta: float = INT8_WER_GATE_MAX_DELTA,
    bf16_report: Optional[dict] = None,
    **decode_options,
) -> dict:
    """WER-delta acceptance gate: int8 against full precision on the same
    utterances (``evaluate_batched`` for each; ``bf16_report``, a report
    of ``evaluate_batched`` on the same items, saves the full-precision
    decode).  ``passed``: the int8 WER exceeds the other by at most
    ``max_delta``."""
    bf16 = bf16_report or evaluate_batched(bf16_model, items, batch_size=batch_size, **decode_options)
    int8 = evaluate_batched(int8_model, items, batch_size=batch_size, **decode_options)
    delta = int8["wer"] - bf16["wer"]
    return {
        "bf16_wer": bf16["wer"],
        "int8_wer": int8["wer"],
        "delta": delta,
        "max_delta": max_delta,
        "passed": delta <= max_delta,
        "n_utterances": bf16["n_utterances"],
    }


def int8_divergence_proxy(
    bf16_model,
    int8_model,
    mels: np.ndarray,  # (N, n_mels, 3000): batched 30 s windows
    sample_len: int = 32,
    language: str = "en",
    batch_size: int = 8,
    int8_decode_options: Optional[dict] = None,
    **decode_options,
) -> dict:
    """Token agreement and teacher-forced logit divergence of ``int8_model``
    against ``bf16_model`` (the full-precision model, whatever its dtype).

    ``int8_decode_options`` apply to the int8 model's decodes only, e.g.
    ``{"kv_cache_dtype": "int8"}`` for the whole int8 configuration against
    a clean full-precision baseline.
    """
    options = DecodingOptions(
        language=language, without_timestamps=True, sample_len=sample_len, **decode_options
    )
    int8_options = replace(options, **int8_decode_options) if int8_decode_options else options
    mels = np.asarray(mels)
    agree_rates: List[float] = []
    logit_maxdiff: List[float] = []
    logit_meandiff: List[float] = []
    top1_match: List[float] = []
    sot_seq = DecodingTask(bf16_model, options).initial_tokens

    for start in range(0, len(mels), batch_size):
        chunk = torch.from_numpy(mels[start : start + batch_size])
        full = DecodingTask(bf16_model, options).run(chunk)
        quant = DecodingTask(int8_model, int8_options).run(chunk)
        for f, q in zip(full, quant):
            n = max(len(f.tokens), len(q.tokens), 1)
            agree_rates.append(sum(a == b for a, b in zip(f.tokens, q.tokens)) / n)

        # teacher-forced logits on the full-precision greedy trajectory
        for i, f in enumerate(full):
            tokens = torch.tensor([list(sot_seq) + list(f.tokens)], dtype=torch.int64)
            mel = chunk[i : i + 1]
            lb = bf16_model.logits(tokens, bf16_model.embed_audio(mel))[0].float().cpu().numpy()
            lq = int8_model.logits(tokens, int8_model.embed_audio(mel))[0].float().cpu().numpy()
            diff = np.abs(lb - lq)
            logit_maxdiff.append(float(diff.max()))
            logit_meandiff.append(float(diff.mean()))
            top1_match.append(float(np.mean(lb.argmax(-1) == lq.argmax(-1))))

    return {
        "token_agreement": float(np.mean(agree_rates)),
        "token_agreement_min": float(np.min(agree_rates)),
        "logit_absdiff_max": float(np.max(logit_maxdiff)),
        "logit_absdiff_mean": float(np.mean(logit_meandiff)),
        "top1_match": float(np.mean(top1_match)),
        "n_windows": len(agree_rates),
    }
