"""k1.roofline_pct: K1's share of its roofline over the traced window.

The device time of K1's kernels by name, against the least time of the
work of the encoder passes the window made (the audios of a server's
rounds, ``probes/rounds.py``, or else the windows decoded): 4 H T^2 D
operations a layer and window at 989 TFLOP/s (bf16), or its bytes at
3.35 TB/s if larger."""

from benchmark.harness import arith

KERNELS = ("encoder_attention_wgmma_kernel", "encoder_attention_kernel")


def read(run):
    if run.trace is None:
        return None
    rounds = getattr(run, "rounds", None)
    windows = sum(rounds.audios) if rounds is not None else len(run.windows)
    seconds = run.trace.kernel_s(KERNELS)
    if not windows or seconds <= 0:
        return None
    ops, nbytes = arith.k1_ops(run.dims, windows)
    return 100.0 * arith.bound_s(nbytes, ops) / seconds
