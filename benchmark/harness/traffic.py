"""The one generator of every traffic mix: it reads a mix's parameters
(``benchmark/traffic/<name>.json``) and a seed, and returns the audio, the
lengths and the schedule.  What a mix asks of a model family (Whisper's
forced token sequence) the family draws from the seed itself.

Every seed gets the same lengths and gaps between arrivals, so that the
seed changes the inputs and not the amount of work: lengths are the
quantiles (k + 1/2) / n of their distribution, and so are the gaps of an
open loop, shuffled in a fixed order; a closed loop's calls take their
files in an order of the seed's.
"""

import math
from typing import Dict, List

import numpy as np

SAMPLE_RATE = 16000


def rng(seed: int, *stream: int) -> np.random.Generator:
    """A generator of its own for each use of a seed (any whole number)."""
    return np.random.default_rng([seed % 2**64, *stream])


def quantiles(dist: Dict, n: int) -> np.ndarray:
    """n quantiles (k + 1/2) / n of a length distribution, ascending."""
    q = (np.arange(n) + 0.5) / n
    if dist["dist"] == "log_uniform":
        lo, hi = math.log(dist["low"]), math.log(dist["high"])
        return np.exp(lo + q * (hi - lo))
    if dist["dist"] == "exponential":
        return -np.log1p(-q) * dist["mean"]
    raise ValueError(f"unknown distribution {dist['dist']!r}")


def waveform(seed: int, seconds: float) -> np.ndarray:
    """A seeded synthetic 16 kHz waveform: noise shaped by a syllable-rate
    envelope and a few drifting tones, float32 in [-1, 1]."""
    r = rng(seed, 1)
    n = int(seconds * SAMPLE_RATE)
    t = np.arange(n, dtype=np.float64) / SAMPLE_RATE
    envelope = 0.55 + 0.45 * np.sin(2 * np.pi * 4.0 * t + r.uniform(0, 2 * np.pi)) * np.sin(
        2 * np.pi * 0.31 * t + r.uniform(0, 2 * np.pi))
    tones = sum(np.sin(2 * np.pi * (f + 20 * np.sin(2 * np.pi * 0.2 * t)) * t)
                for f in r.uniform(120, 2400, size=4))
    wave = envelope * (0.25 * tones + r.standard_normal(n))
    return (wave / np.abs(wave).max()).astype(np.float32)


def clips(seed: int, lengths: np.ndarray, wave: np.ndarray, stream: int) -> List[np.ndarray]:
    """Slices of the waveform of the given lengths (s), at seeded offsets."""
    r = rng(seed, 3, stream)
    out = []
    for s in lengths:
        n = int(round(s * SAMPLE_RATE))
        at = int(r.integers(0, wave.shape[0] - n + 1))
        out.append(wave[at : at + n])
    return out


def batch_calls(seed: int, mix: Dict, wave: np.ndarray, n_calls: int, first: int = 0) -> List[List[np.ndarray]]:
    """Closed loop: each call transcribes the same set of file lengths, in
    an order of the seed's, cut from the waveform at offsets of the seed's."""
    lengths = quantiles(mix["length_s"], mix["files_per_call"])
    calls = []
    for c in range(first, first + n_calls):
        order = rng(seed, 4, c).permutation(len(lengths))
        calls.append(clips(seed, lengths[order], wave, stream=c))
    return calls


def open_schedule(seed: int, mix: Dict, seconds: float, stream: int) -> Dict[str, np.ndarray]:
    """Open loop: the due times (s from the start) of rate x seconds
    requests, and their lengths, each a fixed set of quantiles in a fixed
    shuffled order (the quantiles of the gaps add up to a little less than
    ``seconds``).  The order is not the seed's: in an order of the seed's,
    runs of one seed spread by 1% and runs of six seeds by 4% (the
    batches the arrivals form); the seed still chooses the audio, the
    weights and the forced text."""
    n = max(1, int(round(mix["rate_per_s"] * seconds)))
    r = rng(0, 5, stream)
    gaps = quantiles({"dist": "exponential", "mean": 1.0 / mix["rate_per_s"]}, n)[r.permutation(n)]
    due = np.cumsum(gaps) - gaps[0]
    return {"due": due, "lengths": quantiles(mix["length_s"], n)[r.permutation(n)]}
