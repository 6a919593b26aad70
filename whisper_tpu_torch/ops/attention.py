"""Multi-head attention ops.

Counterpart of ``whisper_tpu/ops/attention.py``.  ``qkv_attention`` and
``qkv_attention_kt`` are the plain reference (f32 scores and softmax,
weights cast to v's dtype, f32 PV); ``encoder_attention`` is the encoder's
self-attention, which runs kernel K1 (:mod:`.kernels.attention`) on CUDA
tensors.
"""

from typing import Optional, Tuple

import torch

from .kernels.attention import attention as _attention_kernel


def qkv_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    *,
    return_qk: bool = False,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Scaled dot-product attention over (B, H, T, D).

    q and k are each scaled by D^-0.25 in their own dtype; scores are f32
    (exact products of the inputs, f32 accumulation); ``mask`` is additive
    and broadcastable to (B, H, Tq, Tk).  Returns (out, f32 scores or None).
    """
    scale = q.shape[-1] ** -0.25
    qk = torch.matmul((q * scale).float(), (k * scale).float().transpose(-1, -2))
    if mask is not None:
        qk = qk + mask
    w = torch.softmax(qk, dim=-1).to(v.dtype)
    out = torch.matmul(w.float(), v.float()).to(q.dtype)
    return out, (qk if return_qk else None)


def qkv_attention_kt(
    q: torch.Tensor,  # (B, H, Tq, D)
    k_t: torch.Tensor,  # (B, H, D, Tk) — keys stored time-last
    v_t: torch.Tensor,  # (B, H, D, Tk) — values stored time-last
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Attention over K/V stored in the caches' (B, H, D, T) layout; the
    same contractions and numerics as :func:`qkv_attention`."""
    scale = q.shape[-1] ** -0.25
    qk = torch.matmul((q * scale).float(), (k_t * scale).float())
    if mask is not None:
        qk = qk + mask
    w = torch.softmax(qk, dim=-1).to(v_t.dtype)
    return torch.matmul(w.float(), v_t.float().transpose(-1, -2)).to(q.dtype)


def encoder_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Self-attention over the encoder's 1500-frame context: kernel K1 on a
    CUDA tensor, its plain version on a CPU tensor."""
    return _attention_kernel(q, k, v)


def split_heads(x: torch.Tensor, n_head: int) -> torch.Tensor:
    """(B, T, C) -> (B, H, T, C//H)"""
    b, t, c = x.shape
    return x.reshape(b, t, n_head, c // n_head).transpose(1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """(B, H, T, D) -> (B, T, H*D)"""
    b, h, t, d = x.shape
    return x.transpose(1, 2).reshape(b, t, h * d)
