"""k2.roofline_pct: K2's share of its roofline over the traced window.

The device time of K2's kernels by name (its GEMVs, the MLP stage K5 and
decode-attention), against the bytes its launches need once at 3.35 TB/s:
each launch reads the L layers' weights, its audios' cross K/V and each
row's self K/V up to its position (``arith.k2_launch_bytes``); the rows and
positions of each launch are recorded around the engine's K2 step
(``probes/k2_steps.py``)."""

from benchmark.harness import arith

KERNELS = ("gemv_kernel", "gemv_tc_kernel", "mlp_stream_kernel", "decode_attention_kernel")


def read(run):
    if run.trace is None:
        return None
    launches = run.k2.launches() if hasattr(run, "k2") else []
    seconds = run.trace.kernel_s(KERNELS)
    if not launches or seconds <= 0:
        return None
    nbytes = sum(arith.k2_launch_bytes(run.dims, rows, audios, T, positions, w)
                 for rows, audios, T, positions, w in launches)
    return 100.0 * arith.bound_s(nbytes, 0.0) / seconds
