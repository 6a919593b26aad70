"""idle_pct.serve: the share of the server's batch rounds (``bench.round``
spans around its calls into transcribe_batch) in which no kernel or copy
ran on the card; the gaps between arrivals are left out."""

from benchmark.harness.trace import ROUND, union


def read(run):
    if run.trace is None:
        return None
    rounds = union(run.trace.spans.get(ROUND, []))
    wall = sum(b - a for a, b in rounds)
    if wall <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s(rounds) / wall)
