"""K2: all decoder layers of one decode step as hand-written Hopper kernels.

Replaces ``whisper_tpu/ops/kernels/fused_step_pallas.py:fused_decoder_layers``
in the variants without a pending write block, unquantized: B rows of A
audios (A divides B, G = B / A rows per audio, group-major: row = audio * G
+ g), each row at its own position.  That covers one greedy row, a beam or
best-of group of one audio, one row per audio of a batch (the TPU kernel's
"multi" layout), and the beam or best-of groups of several audios, which
whisper_tpu leaves to XLA's ``decoder_step(..., n_group=G)``.  The kernels
are ``whisper_tpu_torch/csrc/fused_step.cu`` (its header says what bounds
them and how they are laid out); :func:`fused_decoder_layers_plain` is the
same function in PyTorch, a loop over layers in ``decoder_step``'s op order.

Contract (as the TPU kernel's): x (B, C) is the token + position
embedding; returns (hidden (B, C) after the last layer, no final
LayerNorm; k_new, v_new (L, B, C)).  Self-attention reads row b's cache
positions < t[b] (all of them for t[b] past the cache) plus its new token;
cross-attention reads audio b // G's K/V; the caller writes the new K/V
into column t[b].
"""

import collections
import ctypes
from typing import Dict, Tuple

import torch

from ...models.whisper import NEG_INF, Position, _gelu, _layer, _linear, layer_norm
from ..attention import merge_heads, qkv_attention_kt, split_heads
from . import _lib

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIM = 64
MAX_ROWS = 128  # csrc/fused_step.cu MAX_ROWS

# the kernel's weight table order (csrc/fused_step.cu enum W)
WEIGHTS = (
    "attn_ln_g", "attn_ln_b", "q_w", "q_b", "k_w", "v_w", "v_b", "o_w", "o_b",
    "xattn_ln_g", "xattn_ln_b", "xq_w", "xq_b", "xo_w", "xo_b",
    "mlp_ln_g", "mlp_ln_b", "fc1_w", "fc1_b", "fc2_w", "fc2_b",
)

def _cross_attention(xq: torch.Tensor, cross_k: torch.Tensor, cross_v: torch.Tensor) -> torch.Tensor:
    """xq (B, H, 1, D) against A audios' K/V (A, H, D, Ta): the G = B / A
    rows of each audio fold into its query axis, as whisper_tpu's
    ``_cross_step_attention`` does, so each audio's K/V serves its rows."""
    B, H, _, D = xq.shape
    A = cross_k.shape[0]
    G = B // A
    if G == 1:
        return qkv_attention_kt(xq, cross_k, cross_v)
    q = xq[:, :, 0].reshape(A, G, H, D).transpose(1, 2)  # (A, H, G, D)
    out = qkv_attention_kt(q, cross_k, cross_v)
    return out.transpose(1, 2).reshape(B, H, 1, D)


def fused_decoder_layers_plain(
    blocks: Dict[str, torch.Tensor],
    n_head: int,
    x: torch.Tensor,  # (B, C)
    t: Position,  # shared by the rows, or (B,) per row
    self_k: torch.Tensor,  # (L, B, H, D, T)
    self_v: torch.Tensor,
    cross_k: torch.Tensor,  # (L, A, H, D, Ta), A divides B
    cross_v: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The layers of ``decoder_step`` in PyTorch: the softmax runs over
    [row b's cache positions < t[b] | its new token], in f32, and the
    weights round to the compute dtype before PV.  Cross-attention folds
    each audio's rows into its query axis (``_cross_attention``)."""
    L = self_k.shape[0]
    n_ctx = self_k.shape[-1]
    if cross_k.shape[1] < 1 or x.shape[0] % cross_k.shape[1]:
        raise ValueError(f"{cross_k.shape[1]} audios do not divide {x.shape[0]} rows")
    positions = torch.arange(n_ctx, device=x.device)
    if isinstance(t, int):
        pos_mask = torch.where(positions < t, 0.0, NEG_INF).float()
    else:  # (B, 1, 1, T): each row its own length
        pos_mask = torch.where(positions < t[:, None], 0.0, NEG_INF).float()[:, None, None, :]
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
        xattn = _cross_attention(xq, cross_k[i], cross_v[i])
        x = x + _linear(merge_heads(xattn), p["xo_w"], p["xo_b"])
        hm = _gelu(_linear(layer_norm(x, p["mlp_ln_g"], p["mlp_ln_b"]), p["fc1_w"], p["fc1_b"]))
        x = x + _linear(hm, p["fc2_w"], p["fc2_b"])
        k_news.append(merge_heads(k_new)[:, 0])
        v_news.append(merge_heads(v_new)[:, 0])
    return x[:, 0], torch.stack(k_news), torch.stack(v_news)


def _check_args(blocks, n_head, x, positions, self_k, self_v, cross_k, cross_v) -> None:
    B, C = x.shape
    L, _, H, D, T = self_k.shape
    if not 1 <= B <= MAX_ROWS:
        raise ValueError(f"fused decode-step kernel: at most {MAX_ROWS} rows, got {B}")
    if D != HEAD_DIM or H != n_head or C != H * D or C % 8:
        raise ValueError(f"fused decode-step kernel: C={C}, H={H}, D={D} unsupported")
    if self_v.shape != self_k.shape or self_k.shape[1] != B:
        raise ValueError(f"fused decode-step kernel: self cache {tuple(self_k.shape)}")
    A = cross_k.shape[1]
    if cross_k.shape != cross_v.shape or A < 1 or B % A or cross_k.shape[:4] != (L, A, H, D):
        raise ValueError(
            f"fused decode-step kernel: cross cache {tuple(cross_k.shape)} "
            f"(audios must divide the {B} rows)"
        )
    if positions is not None and (positions.shape != (B,) or positions.device != x.device):
        raise ValueError(f"fused decode-step kernel: positions {tuple(positions.shape)} for {B} rows")
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
    t: Position,
    self_k: torch.Tensor,
    self_v: torch.Tensor,
    cross_k: torch.Tensor,
    cross_v: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """All decoder layers of one step for B rows.  A CPU tensor takes
    :func:`fused_decoder_layers_plain`; a CUDA tensor launches the kernels
    (1 <= B <= 128 rows of A audios, A dividing B; head_dim 64; bf16 or
    f32) or raises.

    ``t``: one position for every row (a host int, a kernel argument), or
    a (B,) integer tensor on x's device, one per row, which the kernel
    reads there.  A position past the cache reads the whole cache.
    """
    if x.device.type == "cpu":
        return fused_decoder_layers_plain(
            blocks, n_head, x, t, self_k, self_v, cross_k, cross_v
        )
    if x.device.type != "cuda":
        raise ValueError(f"fused decode-step kernel: unsupported device {x.device}")
    L, B, H, _, T = self_k.shape
    if isinstance(t, int):
        shared, positions, positions_ptr = min(max(t, 0), T), None, None
    else:
        shared, positions = 0, t.to(torch.int32).contiguous()
        positions_ptr = positions.data_ptr()
    _check_args(blocks, n_head, x, positions, self_k, self_v, cross_k, cross_v)
    A, C = cross_k.shape[1], x.shape[1]
    hidden = torch.empty_like(x)
    k_new = torch.empty((L, B, C), dtype=x.dtype, device=x.device)
    v_new = torch.empty_like(k_new)
    scratch = torch.empty(6 * B * C, dtype=x.dtype, device=x.device)
    table = (ctypes.c_void_p * len(WEIGHTS))(*(blocks[n].data_ptr() for n in WEIGHTS))
    err = _lib.lib().fused_decoder_layers(
        _DTYPES[x.dtype], L, B, A, C, H, T, shared, cross_k.shape[-1],
        positions_ptr, x.data_ptr(), hidden.data_ptr(), k_new.data_ptr(),
        v_new.data_ptr(), self_k.data_ptr(), self_v.data_ptr(), cross_k.data_ptr(),
        cross_v.data_ptr(), ctypes.cast(table, ctypes.c_void_p), scratch.data_ptr(),
        _lib.stream_ptr(x.device),
    )
    _lib.check(err, "fused_decoder_layers")
    fused_decoder_layers.launches += 1
    fused_decoder_layers.launches_by_layout[(A, B // A)] += 1
    return hidden, k_new, v_new


fused_decoder_layers.launches = 0
fused_decoder_layers.launches_by_layout = collections.Counter()  # (A, G) -> launches
