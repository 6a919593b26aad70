"""K2: all decoder layers of one greedy decode step as hand-written Hopper
kernels.

Replaces ``whisper_tpu/ops/kernels/fused_step_pallas.py:fused_decoder_layers``
in the variant the greedy single-file path runs: one audio, one row, no
pending write block, unquantized weights.  The kernels are
``whisper_tpu_torch/csrc/fused_step.cu`` (its header says what bounds them
and how they are laid out); :func:`fused_decoder_layers_plain` is the same
function in PyTorch, a loop over layers in ``decoder_step``'s op order.

Contract (as the TPU kernel's): x (B, C) is the token + position
embedding; returns (hidden (B, C) after the last layer, no final
LayerNorm; k_new, v_new (L, B, C)).  Self-attention reads cache positions
< t plus the new token; the caller writes the new K/V into column t.
"""

import ctypes
from typing import Dict, Tuple

import torch

from ...models.whisper import NEG_INF, _gelu, _layer, _linear, layer_norm
from ..attention import merge_heads, qkv_attention_kt, split_heads
from . import _lib

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIM = 64

# the kernel's weight table order (csrc/fused_step.cu enum W)
WEIGHTS = (
    "attn_ln_g", "attn_ln_b", "q_w", "q_b", "k_w", "v_w", "v_b", "o_w", "o_b",
    "xattn_ln_g", "xattn_ln_b", "xq_w", "xq_b", "xo_w", "xo_b",
    "mlp_ln_g", "mlp_ln_b", "fc1_w", "fc1_b", "fc2_w", "fc2_b",
)


def fused_decoder_layers_plain(
    blocks: Dict[str, torch.Tensor],
    n_head: int,
    x: torch.Tensor,  # (B, C)
    t: int,
    self_k: torch.Tensor,  # (L, B, H, D, T)
    self_v: torch.Tensor,
    cross_k: torch.Tensor,  # (L, 1, H, D, Ta)
    cross_v: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The layers of ``decoder_step`` in PyTorch: the softmax runs over
    [cache positions < t | the new token], in f32, and the weights round to
    the compute dtype before PV."""
    L = self_k.shape[0]
    n_ctx = self_k.shape[-1]
    pos_mask = torch.where(
        torch.arange(n_ctx, device=x.device) < t, 0.0, NEG_INF
    ).float()
    x = x[:, None, :]  # (B, 1, C)
    k_news, v_news = [], []
    for i in range(L):
        p = _layer(blocks, i)
        h = layer_norm(x, p["attn_ln_g"], p["attn_ln_b"])
        q = split_heads(_linear(h, p["q_w"], p["q_b"]), n_head)  # (B, H, 1, D)
        k_new = split_heads(_linear(h, p["k_w"]), n_head)
        v_new = split_heads(_linear(h, p["v_w"], p["v_b"]), n_head)

        scale = q.shape[-1] ** -0.25
        qs = (q * scale).float()
        s_old = torch.matmul(qs, (self_k[i] * scale).float()) + pos_mask
        s_new = torch.matmul(qs, (k_new * scale).float().transpose(-1, -2))
        w = torch.softmax(torch.cat([s_old, s_new], dim=-1), dim=-1).to(q.dtype)
        attn = torch.matmul(
            w[..., :n_ctx].float(), self_v[i].float().transpose(-1, -2)
        ) + w[..., n_ctx:].float() * v_new.float()
        x = x + _linear(merge_heads(attn.to(q.dtype)), p["o_w"], p["o_b"])

        hx = layer_norm(x, p["xattn_ln_g"], p["xattn_ln_b"])
        xq = split_heads(_linear(hx, p["xq_w"], p["xq_b"]), n_head)
        xattn = qkv_attention_kt(xq, cross_k[i], cross_v[i])
        x = x + _linear(merge_heads(xattn), p["xo_w"], p["xo_b"])
        hm = _gelu(_linear(layer_norm(x, p["mlp_ln_g"], p["mlp_ln_b"]), p["fc1_w"], p["fc1_b"]))
        x = x + _linear(hm, p["fc2_w"], p["fc2_b"])
        k_news.append(merge_heads(k_new)[:, 0])
        v_news.append(merge_heads(v_new)[:, 0])
    return x[:, 0], torch.stack(k_news), torch.stack(v_news)


def _check_args(blocks, n_head, x, t, self_k, self_v, cross_k, cross_v) -> None:
    B, C = x.shape
    L, _, H, D, T = self_k.shape
    if B != 1:
        raise ValueError(f"fused decode-step kernel: batch 1 only, got {B}")
    if D != HEAD_DIM or H != n_head or C != H * D or (16 * C) > 48 * 1024:
        raise ValueError(f"fused decode-step kernel: C={C}, H={H}, D={D} unsupported")
    if self_v.shape != self_k.shape or self_k.shape[1] != 1:
        raise ValueError(f"fused decode-step kernel: self cache {tuple(self_k.shape)}")
    if cross_k.shape != cross_v.shape or cross_k.shape[:4] != (L, 1, H, D):
        raise ValueError(f"fused decode-step kernel: cross cache {tuple(cross_k.shape)}")
    if not 0 <= t <= T:
        raise ValueError(f"fused decode-step kernel: t={t} outside [0, {T}]")
    if x.dtype not in _DTYPES:
        raise ValueError(f"fused decode-step kernel: dtype {x.dtype} (bf16 or f32)")
    stacked = [self_k, self_v, cross_k, cross_v] + [blocks[n] for n in WEIGHTS]
    for a in [x] + stacked:
        if a.dtype != x.dtype or a.device != x.device or not a.is_contiguous():
            raise ValueError(
                "fused decode-step kernel: every input must be contiguous, of "
                f"x's dtype {x.dtype}, on {x.device}"
            )
    if any(a.shape[0] != L for a in stacked):
        raise ValueError(f"fused decode-step kernel: {L} layers expected")


def fused_decoder_layers(
    blocks: Dict[str, torch.Tensor],
    n_head: int,
    x: torch.Tensor,
    t: int,
    self_k: torch.Tensor,
    self_v: torch.Tensor,
    cross_k: torch.Tensor,
    cross_v: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """All decoder layers of one step.  A CPU tensor takes
    :func:`fused_decoder_layers_plain`; a CUDA tensor launches the kernels
    (batch 1, head_dim 64, bf16 or f32) or raises."""
    if x.device.type == "cpu":
        return fused_decoder_layers_plain(
            blocks, n_head, x, t, self_k, self_v, cross_k, cross_v
        )
    if x.device.type != "cuda":
        raise ValueError(f"fused decode-step kernel: unsupported device {x.device}")
    _check_args(blocks, n_head, x, t, self_k, self_v, cross_k, cross_v)
    L, _, H, _, T = self_k.shape
    C = x.shape[1]
    hidden = torch.empty_like(x)
    k_new = torch.empty((L, 1, C), dtype=x.dtype, device=x.device)
    v_new = torch.empty_like(k_new)
    scratch = torch.empty(6 * C, dtype=x.dtype, device=x.device)
    table = (ctypes.c_void_p * len(WEIGHTS))(*(blocks[n].data_ptr() for n in WEIGHTS))
    err = _lib.lib().fused_decoder_layers(
        _DTYPES[x.dtype], L, C, H, T, t, cross_k.shape[-1],
        x.data_ptr(), hidden.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
        self_k.data_ptr(), self_v.data_ptr(), cross_k.data_ptr(), cross_v.data_ptr(),
        ctypes.cast(table, ctypes.c_void_p), scratch.data_ptr(),
        _lib.stream_ptr(x.device),
    )
    _lib.check(err, "fused_decoder_layers")
    fused_decoder_layers.launches += 1
    return hidden, k_new, v_new


fused_decoder_layers.launches = 0
