"""The comparison that decides ``correct``.

Once the window has closed and the port's state is freed, a sample of the
requests it finished, drawn from the seed with the longest among them, is
judged by the cell's model family (``judge`` of ``families/<family>.py``)
against its plain reference (``benchmark/reference``).  Each number the
family reads that ``limits/<cell>.json`` names is compared with its limit;
a run is correct where every one lies at or under it.
"""

import math
from typing import Dict, List, Sequence

import numpy as np

from . import traffic


def sample(lengths: Sequence[float], n: int, seed: int) -> List[int]:
    """n indices drawn from the seed, the longest request always among them."""
    longest = int(np.argmax(lengths))
    rest = [i for i in range(len(lengths)) if i != longest]
    picked = traffic.rng(seed, 6).choice(len(rest), size=min(n - 1, len(rest)), replace=False)
    return [longest] + [rest[i] for i in sorted(picked)]


def mean_abs(gaps: List[float]) -> float:
    """The mean size of the gaps; a NaN (a reading that is no number) or an
    infinity makes it infinite."""
    if not gaps:
        return 0.0
    if any(not math.isfinite(g) for g in gaps):
        return math.inf
    return sum(abs(g) for g in gaps) / len(gaps)


def max_abs(gaps: List[float]) -> float:
    return math.inf if any(not math.isfinite(g) for g in gaps) else max((abs(g) for g in gaps), default=0.0)


def passed(checks: Dict[str, Dict[str, float]]) -> bool:
    """Every reading at or under its limit."""
    return all(c["value"] <= c["limit"] for c in checks.values())
