"""K3: the median filter of word timing as a hand-written Hopper kernel.

Replaces ``whisper_tpu/ops/kernels/median_pallas.py:median_filter_pallas``.
The kernel is ``whisper_tpu_torch/csrc/median.cu`` (its header says what
bounds it); :func:`median_filter_plain` is the same function in PyTorch.
Both order each window as the JAX package's stable ``jnp.sort`` does (-0
equal to +0, NaN last, equal values in window order), so the kernel, the
plain version and ``whisper_tpu.ops.median._median_filter_xla`` agree bit
for bit.
"""

import torch

from . import _lib

MAX_WIDTH = 13


def _sort_keys(x: torch.Tensor) -> torch.Tensor:
    """f32 -> int64 keys in jnp.sort's order: the IEEE order as an integer
    after -0 -> +0 and NaN -> the canonical NaN, times 16 (room for the
    window position that makes equal values keep their order)."""
    x = torch.where(x == 0, 0.0, x)
    x = torch.where(torch.isnan(x), float("nan"), x).contiguous()
    bits = x.view(torch.int32)
    return (bits ^ ((bits >> 31) & 0x7FFFFFFF)).to(torch.int64) * 16


def median_filter_plain(x: torch.Tensor, width: int) -> torch.Tensor:
    """Median of each width-wide window along the last axis of f32 x, with
    numpy's reflect padding (T > width // 2)."""
    T = x.shape[-1]
    pad = width // 2
    positions = torch.arange(width, device=x.device)
    idx = torch.arange(T, device=x.device)[:, None] + positions - pad
    idx = torch.where(idx < 0, -idx, torch.where(idx >= T, 2 * (T - 1) - idx, idx))
    windows = x[..., idx]  # (..., T, width)
    keys = _sort_keys(x)[..., idx] + positions  # distinct within a window
    middle = keys.sort(dim=-1).values[..., pad : pad + 1] & 15  # window position
    return windows.gather(-1, middle)[..., 0]


def median_filter(x: torch.Tensor, width: int) -> torch.Tensor:
    """Median filter along the last axis of f32 x (odd width <= 13, T >
    width // 2).  A CPU tensor takes :func:`median_filter_plain`; a CUDA
    tensor launches the kernel or raises."""
    if width % 2 != 1 or width > MAX_WIDTH:
        raise ValueError(f"median filter: odd width <= {MAX_WIDTH}, got {width}")
    T = x.shape[-1]
    if T <= width // 2:
        raise ValueError(f"median filter: length {T} <= width // 2")
    if x.device.type == "cpu":
        return median_filter_plain(x, width)
    if x.device.type != "cuda":
        raise ValueError(f"median filter: unsupported device {x.device}")
    _lib.refuse_grad("median_filter (K3)", x)
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"median filter kernel: contiguous float32 only, got {x.dtype}")
    out = torch.empty_like(x)
    err = _lib.lib().median_filter(
        x.data_ptr(), out.data_ptr(), x.numel() // T, T, width, _lib.stream_ptr(x.device)
    )
    _lib.check(err, "median_filter")
    _lib.count_launch(median_filter)
    return out


median_filter.launches = 0
