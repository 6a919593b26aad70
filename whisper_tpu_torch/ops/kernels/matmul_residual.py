"""E1: matmul with a bias and residual epilogue as a hand-written Hopper kernel.

Replaces ``scripts/_matmul_pallas_experiment.py:matmul_residual_pallas``,
the experiment of a fused fc2 epilogue for the encoder's MLP: ``res +
(round(x @ w) + bias)``, f32 accumulation over all of K, one rounding to
res's dtype, then the bias and the residual in that dtype.  The kernel is
``whisper_tpu_torch/csrc/matmul_residual.cu`` (its header says what bounds
it and how it is laid out); :func:`matmul_residual_plain` is the same
function in PyTorch.  No model path calls it, and the experiment
(:mod:`whisper_tpu_torch.experiments.encoder_ops`) times it beside
``_linear`` plus the residual add.  The encoder's fc2 runs on its
successor, the encoder block's GEMM (:mod:`.encoder_block`: the weight
in its own (out, in) layout, the epilogue stored by TMA).
"""

import torch

from . import _lib

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
BK = 32  # csrc/matmul_residual.cu K_MULTIPLE: K is a multiple of it


def fits(k: int, n: int) -> bool:
    """Whether the kernel takes a (.., K) x (K, N) product: K a multiple of
    32, N of 8 (16-byte rows, as TMA's strides need).  The counterpart of
    the TPU kernel's ``fits``, whose VMEM working set has no meaning here."""
    return k >= BK and k % BK == 0 and n >= 8 and n % 8 == 0


def matmul_residual_plain(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                          res: torch.Tensor) -> torch.Tensor:
    """``res + (x @ w + bias)`` in PyTorch: the product in f32, rounded once
    to res's dtype, then the bias and the residual in that dtype."""
    y = torch.matmul(x.float(), w.float()).to(res.dtype)
    return (y + bias) + res


def _ulp_bound(v: torch.Tensor) -> torch.Tensor:
    """Per element, the spacing of bf16 values at |v| (8 significant bits:
    2^(e - 8) for |v| in [2^(e - 1), 2^e)), doubled where |v| is the
    binade's largest value, one ulp below the next power of two, so that a
    neighbour across that power is covered too."""
    mag = v.float().abs().clamp_min(torch.finfo(torch.float32).tiny)
    _, e = torch.frexp(mag)  # mag = m 2^e, m in [0.5, 1)
    ulp = torch.ldexp(torch.ones_like(mag), e - 8)
    return torch.where(torch.ldexp(torch.ones_like(mag), e) - mag <= ulp, 2 * ulp, ulp)


def bf16_rounding_bound(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                        res: torch.Tensor) -> torch.Tensor:
    """How far, per element, a correct bf16 kernel may lie from
    :func:`matmul_residual_plain`, which rounds three times: ``y = bf16(x @
    w)``, ``t = bf16(y + bias)``, ``out = bf16(t + res)``.  A kernel's f32
    product sums in another order, so where it lies near a rounding
    boundary its y lands one ulp of |y| apart; the bias add then rounds
    each side once more (one ulp of |t| between them), and the residual
    add again (one ulp of |out|).  The bound is ``ulp(y) + ulp(t) +
    ulp(out)`` (f32, the shape of out), each ulp taken at the plain value's
    binade, or at the next binade up where the value lies within one ulp
    of a power of two (the kernel's own intermediates cannot be read, and
    may sit across it)."""
    y = torch.matmul(x.float(), w.float()).to(torch.bfloat16)
    t = y + bias
    return _ulp_bound(y) + _ulp_bound(t) + _ulp_bound(t + res)


def matmul_residual(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                    res: torch.Tensor) -> torch.Tensor:
    """x (M, K), w (K, N), bias (N,), res (M, N) -> (M, N).  A CPU tensor
    takes :func:`matmul_residual_plain`; a CUDA tensor launches the kernel
    (bf16 on the tensor cores or f32 on the CUDA cores, every tensor of one
    dtype, contiguous and 16-byte aligned, any M, ``fits(K, N)``) or
    raises."""
    if x.device.type == "cpu":
        return matmul_residual_plain(x, w, bias, res)
    if x.device.type != "cuda":
        raise ValueError(f"matmul_residual kernel: unsupported device {x.device}")
    _lib.refuse_grad("matmul_residual (E1)", x, w, bias, res)
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"matmul_residual kernel: x (M, K) and w (K, N), got {tuple(x.shape)}, "
                         f"{tuple(w.shape)}")
    (M, K), N = x.shape, w.shape[1]
    if tuple(bias.shape) != (N,) or tuple(res.shape) != (M, N):
        raise ValueError(f"matmul_residual kernel: bias ({N},) and res ({M}, {N}), got "
                         f"{tuple(bias.shape)}, {tuple(res.shape)}")
    if not fits(K, N):
        raise ValueError(f"matmul_residual kernel: K={K} (a multiple of {BK}) and N={N} (of 8)")
    for t in (x, w, bias, res):
        if t.dtype != x.dtype or x.dtype not in _DTYPES or t.device != x.device or not t.is_contiguous():
            raise ValueError("matmul_residual kernel: every tensor contiguous, bf16 or f32 alike, "
                             f"on {x.device}")
        if t.data_ptr() % 16:
            raise ValueError("matmul_residual kernel: every tensor must start on a 16-byte boundary "
                             "(TMA, vector loads)")
    out = torch.empty_like(res)
    err = _lib.lib().matmul_residual(
        _DTYPES[x.dtype], x.data_ptr(), w.data_ptr(), bias.data_ptr(), res.data_ptr(),
        out.data_ptr(), M, K, N, _lib.stream_ptr(x.device),
    )
    _lib.check(err, "matmul_residual")
    _lib.count_launch(matmul_residual)
    return out


matmul_residual.launches = 0
