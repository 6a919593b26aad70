"""mfu_pct.batch: the model operations of the windows the traced window
decoded (the family's ``window_ops``; Whisper's: encoder, cross K/V, prompt
prefill, each token's decoder step and logits) over the window's wall at
989 TFLOP/s."""

from benchmark.harness import arith


def read(run):
    if run.trace is None or not run.windows:
        return None
    ops = sum(run.family.window_ops(run.dims, *work) for work in run.windows)
    return 100.0 * ops / arith.PEAK_OPS_PER_S / run.trace.window_s
