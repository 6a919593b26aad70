"""The comparison that decides ``correct``.

Once the window has closed and the port's state is freed, a sample of the
requests it finished, drawn from the seed with the longest among them, is
served again by the plain float32 reference (``benchmark/reference``) from
the same waveforms, the same seeded state_dict (made again on the card)
and the same forced sequence.  Compared, each against its limit in
``limits/<cell>.json``:

- ``segments_wrong``: windows whose segment differs from the reference's
  (seek, start, end, tokens) or is missing; exact, limit 0;
- ``failed``: requests that raised or never came; limit 0;
- ``logprob_gap``: the mean size, over the sampled windows, of the gap
  between the port's average log-probability of the forced tokens (under
  the greedy timestamp filters) and the reference's, in nats a token.  A window in
  which the reference's timestamp-probability rule comes within
  ``MARGIN`` nats of suppressing a forced token is left out of this gap
  alone (rounding could then decide the rule either way, and a suppressed
  token's log-probability is minus infinity); the weights make that rare,
  and the run says how many were left out;
- ``no_speech_gap``: the mean size of the gap between the port's
  log P(no speech) at a window's SOT and the reference's, in nats.

The widest gaps (``*_max``) go to the log beside them.
"""

import gc
import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..reference import whisper_ref
from . import traffic, weights

TIME_TOLERANCE = 1e-6  # s; the segment times are exact multiples of 0.02 s
MARGIN = 1.0  # nats


def sample(lengths: Sequence[float], n: int, seed: int) -> List[int]:
    """n indices drawn from the seed, the longest request always among them."""
    longest = int(np.argmax(lengths))
    rest = [i for i in range(len(lengths)) if i != longest]
    picked = traffic.rng(seed, 6).choice(len(rest), size=min(n - 1, len(rest)), replace=False)
    return [longest] + [rest[i] for i in sorted(picked)]


def _worst(a: float, b: float) -> float:
    """The larger of two gaps; a NaN (a reading that is no number) is infinite."""
    return math.inf if math.isnan(b) else max(a, b)


def compare(expected: List[Dict], result) -> Dict:
    """One request's readings: its port result (a dict, or an exception, or
    None if it never came) against the reference's windows; the gaps of
    each window, signed (port less reference)."""
    out = {"segments_wrong": 0, "logprob": [], "no_speech": [], "left_out": 0}
    if not isinstance(result, dict):
        out["segments_wrong"] = len(expected)
        return out
    segments = result["segments"]
    for k, e in enumerate(expected):
        if k >= len(segments):
            out["segments_wrong"] += 1
            continue
        s = segments[k]
        if (s["seek"] != e["seek"] or abs(s["start"] - e["start"]) > TIME_TOLERANCE
                or abs(s["end"] - e["end"]) > TIME_TOLERANCE or list(s["tokens"]) != list(e["tokens"])):
            out["segments_wrong"] += 1
        if e["min_margin"] >= MARGIN:
            out["logprob"].append(s["avg_logprob"] - e["avg_logprob"])
        else:
            out["left_out"] += 1
        p = s["no_speech_prob"]
        out["no_speech"].append(math.log(p) - e["no_speech_logprob"] if p > 0 else -math.inf)
    out["segments_wrong"] += max(0, len(segments) - len(expected))
    return out


def _mean_abs(gaps: List[float]) -> float:
    """The mean size of the gaps; a NaN (a reading that is no number) or an
    infinity makes it infinite."""
    if not gaps:
        return 0.0
    if any(not math.isfinite(g) for g in gaps):
        return math.inf
    return sum(abs(g) for g in gaps) / len(gaps)


def _max_abs(gaps: List[float]) -> float:
    return math.inf if any(not math.isfinite(g) for g in gaps) else max((abs(g) for g in gaps), default=0.0)


def as_result(windows: List[Dict]) -> Dict:
    """The reference's windows in the shape of a transcription result."""
    return {"segments": [dict(seek=w["seek"], start=w["start"], end=w["end"], tokens=w["tokens"],
                              avg_logprob=w["avg_logprob"],
                              no_speech_prob=math.exp(w["no_speech_logprob"])) for w in windows]}


def judge(cell, seed: int, forced: Sequence[int], waves: List[np.ndarray], results: list,
          device, failed: int, products: Optional[str] = None):
    """The readings of the sampled requests: (the numbers compared, each
    with its limit; every reading; a line for the log).  ``products="fp8"``
    judges the reference computed with float8 products in the port's place
    (the comparison's control) instead of ``results``."""
    whisper_ref.use_float32()
    state = weights.make_state_dict(cell.dims, cell.config["assumed"]["weights"], seed,
                                    getattr(torch, cell.config["dtype"]), device)
    model = whisper_ref.Model(state, cell.dims, device)
    low = whisper_ref.Model(state, cell.dims, device, products=products) if products else None
    del state
    wrong, logprob, no_speech = 0, [], []
    margin, left_out, windows = math.inf, 0, 0
    with torch.inference_mode():
        for wave, result in zip(waves, results):
            expected = whisper_ref.judge_file(model, wave, forced, cell.vocab)
            if low is not None:
                result = as_result(whisper_ref.judge_file(low, wave, forced, cell.vocab))
            margin = min([margin] + [e["min_margin"] for e in expected])
            one = compare(expected, result)
            wrong += one["segments_wrong"]
            logprob += one["logprob"]
            no_speech += one["no_speech"]
            left_out, windows = left_out + one["left_out"], windows + len(expected)
    del model, low
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    readings = {"segments_wrong": wrong, "failed": failed,
                "logprob_gap": _mean_abs(logprob), "logprob_gap_max": _max_abs(logprob),
                "no_speech_gap": _mean_abs(no_speech), "no_speech_gap_max": _max_abs(no_speech)}
    log = (f"reference: {windows} windows of {len(waves)} requests; the timestamp rule's least "
           f"margin {margin:.3f} nats, {left_out} windows within {MARGIN} of it; "
           + ", ".join(f"{k} {v!r}" for k, v in readings.items() if k not in cell.limits))
    checks = {k: {"value": readings[k], "limit": v} for k, v in cell.limits.items()}
    return checks, readings, log


def passed(checks: Dict[str, Dict[str, float]]) -> bool:
    """Every reading at or under its limit."""
    return all(c["value"] <= c["limit"] for c in checks.values())
