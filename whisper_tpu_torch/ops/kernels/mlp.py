"""K5: the decoder MLP of one decode step as hand-written Hopper kernels.

Replaces ``whisper_tpu/ops/kernels/mlp_pallas.py:mlp_fused_pallas``:
``x + fc2(gelu(fc1(layer_norm(x))))`` for 1-128 rows, each weight read
once per row tile of 16, int8 weights converted inside the kernel.  The
kernels are K2's MLP stage in ``whisper_tpu_torch/csrc/fused_step.cu``
(``mlp_stage``): in bf16 two launches of ``mlp_stream_kernel``, fc1 with
its LayerNorm prologue and GELU, then fc2 with the residual, each a
persistent grid streaming its weights by TMA into the tensor cores, fc2's
inputs split over a thread-block cluster; in f32 the CUDA-core GEMV.  So
the decode step runs this code in every layer of every step and there is
one implementation; :func:`mlp_fused_plain` is the same function in
PyTorch.
No model path calls it on its own: the decode step runs its code inside
K2, whose launches hold at most 128 rows (K2's ``row_slices``).

Weights in the port's layout: w1 (4C, C), w2 (C, 4C), tensors of x's
dtype or :class:`~whisper_tpu_torch.quantize.Int8Weight`.  Numerics as
``mlp_pallas.py``'s: LayerNorm statistics in f32, the normalised row rounded
to the compute dtype, each product accumulated in f32 and rounded once
(times the int8 scales first), the bias, GELU (exact erf; the TPU kernel's
A&S erf differs by at most 1.5e-7 before rounding) and the residual each
rounded.
"""

from typing import Optional

import torch

from ...models.whisper import _gelu, _linear, _linear_rows, layer_norm
from ...quantize import Int8Weight
from . import _lib

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_ROWS = 128  # csrc/fused_step.cu MAX_ROWS
MAX_BF16_WIDTH = 2048  # csrc/fused_step.cu: 256 * LN_VECS, a LayerNorm row in a warp's registers


def mlp_fused_plain(x, ln_g, ln_b, w1, b1, w2, b2, partial: bool = False):
    """x (..., C) + fc2(gelu(fc1(layer_norm(x)))) in PyTorch.  ``partial``:
    the weights are a model shard (F / model hidden units), whose fc2
    product is summed over the mesh's model group before its bias and the
    residual."""
    h = _gelu(_linear(layer_norm(x, ln_g, ln_b), w1, b1))
    return x + _linear_rows(h, w2, b2, partial)


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _check(x, ln_g, ln_b, w1, b1, w2, b2, out) -> bool:
    """Raise on what the kernel does not take; True for int8 weights."""
    B, C = x.shape
    int8 = isinstance(w1, Int8Weight)
    if int8 != isinstance(w2, Int8Weight):
        raise ValueError("fused MLP kernel: both weights int8, or neither")
    q1, q2 = (w1.q, w2.q) if int8 else (w1, w2)
    F = q1.shape[0]
    if not 1 <= B <= MAX_ROWS or C % 16 or F % 16 or x.dtype not in _DTYPES:
        raise ValueError(f"fused MLP kernel: B={B} (1-{MAX_ROWS}), C={C} and F={F} (multiples "
                         f"of 16), dtype {x.dtype} (bf16 or f32)")
    if x.dtype == torch.bfloat16 and C > MAX_BF16_WIDTH:
        raise ValueError(f"fused MLP kernel: C={C}, at most {MAX_BF16_WIDTH} in bf16")
    if out is not None and (out.shape != x.shape or out.dtype != x.dtype or out.device != x.device
                            or not out.is_contiguous()):
        raise ValueError("fused MLP kernel: out must be contiguous, of x's shape, dtype and device")
    if any(t.data_ptr() % 16 for t in (x, ln_g, ln_b, q1, q2)):
        raise ValueError("fused MLP kernel: x, the LayerNorm weights and the weights must start on "
                         "a 16-byte boundary (16-byte loads; the weights are read by TMA)")
    if tuple(q1.shape) != (F, C) or tuple(q2.shape) != (C, F):
        raise ValueError(f"fused MLP kernel: weights {(F, C)} and {(C, F)} expected")
    dense = [x, ln_g, ln_b] + [b for b in (b1, b2) if b is not None] + ([] if int8 else [w1, w2])
    if any(t.dtype != x.dtype or t.device != x.device or not t.is_contiguous() for t in dense):
        raise ValueError(f"fused MLP kernel: every tensor contiguous, of x's dtype {x.dtype}, "
                         f"on {x.device}")
    if int8 and any(
        w.q.dtype != torch.int8 or w.s.dtype != torch.float32 or tuple(w.s.shape) != (w.q.shape[0], 1)
        or w.q.device != x.device or w.s.device != x.device
        or not (w.q.is_contiguous() and w.s.is_contiguous())
        for w in (w1, w2)
    ):
        raise ValueError("fused MLP kernel: int8 weights (out, in) with f32 scales (out, 1)")
    return int8


def _ff_scratch(B: int, F: int, x: torch.Tensor) -> torch.Tensor:
    """fc1's output, fc2's input: B * F elements of x's dtype on its device."""
    return torch.empty(B * F, dtype=x.dtype, device=x.device)


def mlp_fused(
    x: torch.Tensor,  # (B, C)
    ln_g: torch.Tensor,  # (C,)
    ln_b: torch.Tensor,
    w1,  # (4C, C) tensor or Int8Weight
    b1: Optional[torch.Tensor],  # (4C,)
    w2,  # (C, 4C)
    b2: Optional[torch.Tensor],  # (C,)
    out: Optional[torch.Tensor] = None,  # (B, C); x itself: in place
) -> torch.Tensor:
    """``x + fc2(gelu(fc1(layer_norm(x))))`` for B rows, into ``out`` when
    given (which may be x: the residual is then updated in place, as K2's
    MLP stage does).  A CPU tensor takes :func:`mlp_fused_plain`; a CUDA
    tensor launches the kernels (1 <= B <= 128, widths multiples of 16 and
    in bf16 C <= 2048, bf16 or f32, weights of x's dtype or both int8; x,
    ln_g, ln_b and the weights 16-byte aligned) or raises."""
    if x.device.type == "cpu":
        y = mlp_fused_plain(x, ln_g, ln_b, w1, b1, w2, b2)
        return y if out is None else out.copy_(y)
    if x.device.type != "cuda":
        raise ValueError(f"fused MLP kernel: unsupported device {x.device}")
    _lib.refuse_grad("mlp_fused (K5)", x, ln_g, ln_b, w1, b1, w2, b2, out)
    int8 = _check(x, ln_g, ln_b, w1, b1, w2, b2, out)
    q1, q2 = (w1.q, w2.q) if int8 else (w1, w2)
    (B, C), F = x.shape, q1.shape[0]
    if out is None:
        out = torch.empty_like(x)
    scratch = _ff_scratch(B, F, x)
    err = _lib.lib().mlp_fused(
        _DTYPES[x.dtype], int(int8), B, C, F, x.data_ptr(), out.data_ptr(), ln_g.data_ptr(),
        ln_b.data_ptr(), q1.data_ptr(), _ptr(w1.s) if int8 else None, _ptr(b1), q2.data_ptr(),
        _ptr(w2.s) if int8 else None, _ptr(b2), scratch.data_ptr(), _lib.stream_ptr(x.device),
    )
    _lib.check(err, "mlp_fused")
    _lib.count_launch(mlp_fused)
    return out


# runs of the MLP stage: one per call of mlp_fused, and L per K2 step
# (fused_step.fused_decoder_layers adds them, its MLP stage being this code)
mlp_fused.launches = 0
