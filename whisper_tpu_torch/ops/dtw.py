"""Dynamic time warping for word-level alignment.

Counterpart of ``whisper_tpu/ops/dtw.py``: the cost and trace run as an
anti-diagonal wavefront on the model's device (kernel K4,
:mod:`.kernels.dtw`, on a CUDA tensor; its plain version on a CPU tensor),
and the sequential backtrace runs on the host in C++ (the JAX package's
``native/dtw.cpp``, built by path), with a NumPy walk where that library
is missing.
"""

import numpy as np
import torch

from ..native import load_native
from .kernels.dtw import dtw_trace as _dtw_trace_kernel


def dtw_trace(x: torch.Tensor, n: int, m: int) -> torch.Tensor:
    """Trace diagonals of cost matrix x, (n, m) -> (n+m+1, n+1) int32 or
    batched (B, n, m) -> (B, n+m+1, n+1)."""
    if x.dim() == 2:
        return _dtw_trace_kernel(x[None].contiguous(), n, m)[0]
    return _dtw_trace_kernel(x.contiguous(), n, m)


def _unskew_trace(diags: np.ndarray, n: int, m: int) -> np.ndarray:
    """(n+m+1, n+1) diagonal layout -> (n+1, m+1) trace matrix."""
    i = np.arange(n + 1)[:, None]
    j = np.arange(m + 1)[None, :]
    return diags[(i + j).clip(0, n + m), np.broadcast_to(i, (n + 1, m + 1))]


def backtrace(trace: np.ndarray) -> np.ndarray:
    """Walk the trace matrix back from (N, M); parity with reference
    timing.py:57-79."""
    trace = np.ascontiguousarray(trace, dtype=np.int32)
    n1, m1 = trace.shape
    lib = load_native()
    if lib is not None:
        import ctypes

        out_i = np.empty(n1 + m1, dtype=np.int32)
        out_j = np.empty(n1 + m1, dtype=np.int32)
        count = lib.dtw_backtrace(
            trace.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            n1,
            m1,
            out_i.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            out_j.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )
        if count >= 0:
            return np.stack([out_i[:count], out_j[:count]])

    # NumPy walk (the same one)
    i, j = n1 - 1, m1 - 1
    trace[0, :] = 2
    trace[:, 0] = 1
    result = []
    while i > 0 or j > 0:
        result.append((i - 1, j - 1))
        t = trace[i, j]
        if t == 0:
            i -= 1
            j -= 1
        elif t == 1:
            i -= 1
        elif t == 2:
            j -= 1
        else:
            raise ValueError("Unexpected trace[i, j]")
    return np.array(result)[::-1, :].T


def dtw(x) -> np.ndarray:
    """Minimum-cost monotone alignment path through cost matrix x (N, M):
    (2, path_len) int arrays of (text_indices, time_indices), as reference
    timing.py:141-151.  The trace runs where x lies (a CUDA tensor runs
    K4)."""
    x = torch.as_tensor(x, dtype=torch.float32)
    n, m = x.shape
    diags = dtw_trace(x, n, m).cpu().numpy()
    return backtrace(_unskew_trace(diags, n, m))


def dtw_numpy(x: np.ndarray) -> np.ndarray:
    """Pure NumPy row-scan DTW (test oracle; mirrors dtw_cpu timing.py:82-105)."""
    N, M = x.shape
    cost = np.full((N + 1, M + 1), np.inf, dtype=np.float64)
    trace = -np.ones((N + 1, M + 1), dtype=np.int32)
    cost[0, 0] = 0
    x = x.astype(np.float64)
    for i in range(1, N + 1):
        c0 = cost[i - 1, :-1]  # cost[i-1, j-1]
        c1 = cost[i - 1, 1:]  # cost[i-1, j]
        row = cost[i]
        trow = trace[i]
        for j in range(1, M + 1):
            a, b, c = c0[j - 1], c1[j - 1], row[j - 1]
            if a < b and a < c:
                v, t = a, 0
            elif b < a and b < c:
                v, t = b, 1
            else:
                v, t = c, 2
            row[j] = x[i - 1, j - 1] + v
            trow[j] = t
    return backtrace(trace)
