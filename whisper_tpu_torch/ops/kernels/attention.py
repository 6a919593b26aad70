"""K1: encoder self-attention as a hand-written Hopper kernel.

Replaces ``whisper_tpu/ops/kernels/attention_pallas.py:attention_pallas``.
The kernel is ``whisper_tpu_torch/csrc/attention.cu`` (its header says what
bounds it and how it is built); :func:`attention_plain` is the same function
in PyTorch, with the TPU kernel's exact softmax and deferred normalisation.
"""

import torch

from . import _lib

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIM = 64


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``_attn_kernel`` in PyTorch: (B, H, T, D) -> (B, H, T, D).

    q and k are scaled by D^-0.25 in f32; the exp weights round to v's
    dtype before PV, the f32 denominator is summed from those rounded
    weights, and the division comes after PV.
    """
    scale = q.shape[-1] ** -0.25
    s = torch.matmul(q.float() * scale, (k.float() * scale).transpose(-1, -2))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True)).to(v.dtype)
    denom = p.float().sum(dim=-1, keepdim=True)
    out = torch.matmul(p.float(), v.float())
    return (out / denom).to(q.dtype)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Non-causal attention (B, H, T, D) -> (B, H, T, D).

    A CPU tensor takes :func:`attention_plain`; a CUDA tensor launches the
    kernel (bf16 or f32, D = 64, contiguous) or raises.
    """
    if q.device.type == "cpu":
        return attention_plain(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"encoder attention: unsupported device {q.device}")
    if not (q.shape == k.shape == v.shape and q.dim() == 4):
        raise ValueError(f"encoder attention: shapes {q.shape}, {k.shape}, {v.shape}")
    b, h, t, d = q.shape
    if d != HEAD_DIM:
        raise ValueError(f"encoder attention kernel takes head_dim {HEAD_DIM}, got {d}")
    for x in (q, k, v):
        if x.dtype != q.dtype or x.dtype not in _DTYPES:
            raise ValueError(f"encoder attention: dtype {x.dtype} (bf16 or f32, all equal)")
        if x.device != q.device or not x.is_contiguous():
            raise ValueError("encoder attention: q, k, v must be contiguous on one device")
    out = torch.empty_like(q)
    err = _lib.lib().encoder_attention(
        _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b * h, t, d, _lib.stream_ptr(q.device),
    )
    _lib.check(err, "encoder_attention")
    attention.launches += 1
    return out


attention.launches = 0
