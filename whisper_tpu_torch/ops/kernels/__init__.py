"""Hand-written Hopper kernels (CUDA C++ in ``whisper_tpu_torch/csrc``),
each beside its plain PyTorch version.  :func:`build` compiles them."""

from ._lib import build

__all__ = ["build"]
