"""mfu_pct.serve: the model operations of the requests served in the traced
window (the family's ``window_ops``) over the wall of the server's batch
rounds (``bench.round`` spans) at 989 TFLOP/s."""

from benchmark.harness import arith
from benchmark.harness.trace import ROUND, union


def read(run):
    if run.trace is None or not run.windows:
        return None
    wall = sum(b - a for a, b in union(run.trace.spans.get(ROUND, [])))
    if wall <= 0:
        return None
    ops = sum(run.family.window_ops(run.dims, *work) for work in run.windows)
    return 100.0 * ops / arith.PEAK_OPS_PER_S / wall
