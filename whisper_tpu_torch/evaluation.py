"""int8 against full precision, offline.

Counterpart of ``whisper_tpu/evaluation.py:int8_divergence_proxy``: greedy
token agreement between a model and its int8 copy, and the teacher-forced
logit divergence along the full-precision model's own greedy trajectory
(both models score the same prefixes, so divergence does not compound).
It runs on random weights; WER, CER and the int8 WER gate need real
checkpoints and a corpus (ROADMAP.md Queue 1, item 17).
"""

from dataclasses import replace
from typing import List, Optional

import numpy as np
import torch

from .decoding import DecodingOptions, DecodingTask


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
