"""K4: the DTW trace of word timing as a hand-written Hopper kernel.

Replaces ``whisper_tpu/ops/kernels/dtw_pallas.py:dtw_trace_pallas``.  The
kernel is ``whisper_tpu_torch/csrc/dtw.cu`` (its header says what bounds
it and how warps of one slot a lane walk the diagonals);
:func:`dtw_trace_plain` is the same wavefront in PyTorch, one anti-diagonal
per step, as ``whisper_tpu.ops.dtw._dtw_trace_device``.  Codes: 0 diagonal,
1 up, 2 left, ties to 2; each cell adds its cost to the cost of the branch
it chose, in f32.  The traces are bit-equal.  :func:`dtw_chain` runs the
kernel's cell update as one dependent chain in one thread: its time per
update, times the n + m - 1 diagonals, is the kernel's latency bound.
"""

from typing import Tuple

import torch

from . import _lib

MAX_ROWS = 1023  # n + 1 slots, one a lane, of one block


def dtw_trace_plain(x: torch.Tensor, n: int, m: int) -> torch.Tensor:
    """(B, n, m) f32 costs -> (B, n + m + 1, n + 1) int32 trace diagonals:
    slot i of diagonal d is cell (i, d - i)."""
    B = x.shape[0]
    dev = x.device
    inf = torch.tensor(float("inf"), device=dev)
    i_idx = torch.arange(n + 1, device=dev)
    x_flat = x.float().reshape(B, n * m)
    prev2 = torch.full((B, n + 1), float("inf"), device=dev)
    prev2[:, 0] = 0.0  # d = 0: cost[0, 0] = 0
    prev = torch.full((B, n + 1), float("inf"), device=dev)  # d = 1
    trace = torch.zeros((B, n + m + 1, n + 1), dtype=torch.int32, device=dev)
    pad = torch.full((B, 1), float("inf"), device=dev)
    for d in range(2, n + m + 1):
        j = d - i_idx
        valid = (i_idx >= 1) & (j >= 1) & (j <= m)
        c0 = torch.cat([pad, prev2[:, :-1]], dim=1)  # cost[i-1, j-1]
        c1 = torch.cat([pad, prev[:, :-1]], dim=1)  # cost[i-1, j]
        c2 = prev  # cost[i, j-1]
        t = torch.where(
            (c0 < c1) & (c0 < c2), 0, torch.where((c1 < c0) & (c1 < c2), 1, 2)
        ).to(torch.int32)
        c = torch.where(t == 0, c0, torch.where(t == 1, c1, c2))
        flat = ((i_idx - 1) * m + (j - 1)).clamp(0, n * m - 1)
        new = torch.where(valid, x_flat[:, flat] + c, inf)
        trace[:, d] = t
        prev2, prev = prev, new
    return trace


def dtw_trace(x: torch.Tensor, n: int, m: int) -> torch.Tensor:
    """Trace diagonals of (B, n, m) f32 costs, (B, n + m + 1, n + 1) int32.
    A CPU tensor takes :func:`dtw_trace_plain`; a CUDA tensor launches the
    kernel (n <= 1023) or raises."""
    if x.dim() != 3 or tuple(x.shape[1:]) != (n, m):
        raise ValueError(f"dtw trace: costs of shape (B, {n}, {m}), got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return dtw_trace_plain(x, n, m)
    if x.device.type != "cuda":
        raise ValueError(f"dtw trace: unsupported device {x.device}")
    _lib.refuse_grad("dtw_trace (K4)", x)
    if x.dtype != torch.float32 or not x.is_contiguous() or not 1 <= n <= MAX_ROWS:
        raise ValueError(
            f"dtw trace kernel: contiguous float32 and n <= {MAX_ROWS}, got {x.dtype}, n={n}"
        )
    trace = torch.empty((x.shape[0], n + m + 1, n + 1), dtype=torch.int32, device=x.device)
    err = _lib.lib().dtw_trace(x.data_ptr(), trace.data_ptr(), x.shape[0], n, m,
                               _lib.stream_ptr(x.device))
    _lib.check(err, "dtw_trace")
    _lib.count_launch(dtw_trace)
    return trace


dtw_trace.launches = 0


def dtw_chain(seed: torch.Tensor, iters: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run ``iters`` dependent DTW cell updates in one CUDA thread (each
    update's cost is the next one's upper neighbour, the wavefront's
    critical path) from ``seed`` (4 f32 on the card: c0, c1, c2, the cell's
    cost); returns the last cost and the sum of the codes (f32 and int32
    tensors of one element), so that nothing is optimised away."""
    if seed.device.type != "cuda" or seed.dtype != torch.float32 or seed.numel() != 4 or iters < 1:
        raise ValueError("dtw chain: 4 f32 on a CUDA device and iters >= 1")
    _lib.refuse_grad("dtw_chain", seed)
    out = torch.empty(1, dtype=torch.float32, device=seed.device)
    codes = torch.empty(1, dtype=torch.int32, device=seed.device)
    err = _lib.lib().dtw_chain(seed.contiguous().data_ptr(), out.data_ptr(), codes.data_ptr(), iters,
                               _lib.stream_ptr(seed.device))
    _lib.check(err, "dtw_chain")
    return out, codes
