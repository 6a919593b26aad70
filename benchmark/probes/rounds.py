"""A server's batch rounds, as ``run.rounds``: the audios of each, and a
``bench.round`` span around each (the batcher's call into
``transcribe_batch``, its ``_transcribe_batch`` attribute), which
``idle_pct.serve`` and ``mfu_pct.serve`` read.  Only where the run has a
server."""

import contextlib
from typing import List

from benchmark.harness.trace import ROUND, span


class Rounds:
    def __init__(self):
        self.audios: List[int] = []


@contextlib.contextmanager
def install(run):
    batcher = getattr(run, "batcher", None)
    if batcher is None:
        yield
        return
    run.rounds = rounds = Rounds()
    inner = batcher._transcribe_batch

    def round_probe(model, audios, **kw):
        with span(ROUND, True):
            out = inner(model, audios, **kw)
        rounds.audios.append(len(audios))
        return out

    batcher._transcribe_batch = round_probe
    try:
        yield
    finally:
        batcher._transcribe_batch = inner
