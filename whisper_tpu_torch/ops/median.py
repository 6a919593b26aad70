"""Median filtering along the trailing axis.

Counterpart of ``whisper_tpu/ops/median.py``: reflect padding, odd widths.
Widths up to 13 (word timing uses 7) run kernel K3
(:mod:`.kernels.median`) on a CUDA tensor, its plain version on a CPU
tensor; wider ones take the plain version, as the JAX package takes its
XLA form there.
"""

import torch

from .kernels.median import MAX_WIDTH, median_filter_plain
from .kernels.median import median_filter as _median_kernel


def median_filter(x: torch.Tensor, filter_width: int) -> torch.Tensor:
    """Apply a median filter of odd width along the last dimension of x."""
    if x.shape[-1] <= filter_width // 2:
        return x
    assert filter_width > 0 and filter_width % 2 == 1, "`filter_width` should be an odd number"
    if filter_width <= MAX_WIDTH:
        return _median_kernel(x, filter_width)
    return median_filter_plain(x, filter_width)
