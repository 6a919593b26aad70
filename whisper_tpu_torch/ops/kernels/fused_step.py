"""K2: all decoder layers of one decode step as hand-written Hopper kernels.

Replaces ``whisper_tpu/ops/kernels/fused_step_pallas.py:fused_decoder_layers``
in all its variants, unquantized and int8, with and without a pending write
block: B rows of A audios (A divides B, G = B / A rows per audio,
group-major: row = audio * G + g), each row at its own position.  That
covers one greedy row, a beam or best-of group of one audio, one row per
audio of a batch (the TPU kernel's "multi" layout), and the beam or best-of
groups of several audios, which whisper_tpu leaves to XLA's
``decoder_step(..., n_group=G)`` and ``decoder_step_pending(...,
n_group=G)``.  The kernels
are ``whisper_tpu_torch/csrc/fused_step.cu`` (its header says what bounds
them and how they are laid out); :func:`fused_decoder_layers_plain` is the
same function in PyTorch, a loop over layers in ``decoder_step``'s op order.
Its MLP stage is kernel K5's code (:mod:`.mlp`).

int8 (``whisper_tpu_torch.quantize``): the eight projections (q, k, v, o,
xq, xo, fc1, fc2) may all be :class:`Int8Weight` (L, out, in) int8 with f32
scales (L, out, 1), and the cross K/V Int8Weight with scales (L, A, H, D, 1);
either, both or neither.  On the card the int8 bytes are what the kernels
read: nothing is dequantized to run the bf16 instances.  The int8 logits
projection (:func:`int8_logits`) is K2's GEMV with an f32 epilogue.

Contract (as the TPU kernel's): x (B, C) is the token + position
embedding; returns (hidden (B, C) after the last layer, no final
LayerNorm; k_new, v_new (L, B, C)).  Self-attention reads row b's cache
positions < t[b] (all of them for t[b] past the cache) plus its new token;
cross-attention reads audio b // G's K/V; the caller writes the new K/V
into column t[b].

The pending block (``pend_k, pend_v`` (L, B, H, D, W) and ``pend_w``, the
write-block engine's, ``whisper_tpu_torch.models.whisper.
decoder_step_fused_pending``): t[b] is then the block's start, and row b's
self-attention reads its cache positions < t[b], its first ``pend_w``
pending columns and its new token, one softmax over the three in f32.  The
caller puts the new K/V into pending column ``pend_w``.

Any number of rows: one launch takes at most 128 (``MAX_ROWS``), so a CUDA
step of more rows launches once per slice of :func:`row_slices`, each
slice whole audios or part of one audio's group; every launch reads and
writes the full tensors in place from its first row and first audio
(``csrc/fused_step.cu``'s header), so nothing is copied per step.
"""

import collections
import ctypes
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from ...models.whisper import (
    NEG_INF,
    Position,
    _cross_step_attention_k,
    _layer,
    _linear,
    layer_norm,
)
from ...quantize import Int8Weight, take_layer
from ..attention import merge_heads, split_heads
from . import _lib
from .mlp import MAX_BF16_WIDTH, mlp_fused, mlp_fused_plain

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIM = 64
MAX_ROWS = 128  # csrc/fused_step.cu MAX_ROWS: a launch's rows
MAX_PEND = 64  # csrc/fused_step.cu MAX_PEND: a pending block's columns

# the kernel's weight table order (csrc/fused_step.cu enum W)
WEIGHTS = (
    "attn_ln_g", "attn_ln_b", "q_w", "q_b", "k_w", "v_w", "v_b", "o_w", "o_b",
    "xattn_ln_g", "xattn_ln_b", "xq_w", "xq_b", "xo_w", "xo_b",
    "mlp_ln_g", "mlp_ln_b", "fc1_w", "fc1_b", "fc2_w", "fc2_b",
)
# the projections that may be int8, in the order of the kernel's scale
# table (csrc/fused_step.cu enum PROJ)
PROJECTIONS = ("q_w", "k_w", "v_w", "o_w", "xq_w", "xo_w", "fc1_w", "fc2_w")


def _values(leaf):
    """A leaf's tensor of values: an int8 leaf's q."""
    return leaf.q if isinstance(leaf, Int8Weight) else leaf


# xq (B, H, 1, D) against A audios' cross K/V, dense or int8, each audio's
# G = B / A rows folded into its query axis as whisper_tpu's
# ``_cross_step_attention`` does
_cross_attention = _cross_step_attention_k


def _self_attention(q, k_new, v_new, self_k, self_v, t: Position, pend_k=None, pend_v=None,
                    pend_w: int = 0) -> torch.Tensor:
    """One layer's self-attention, (B, H, 1, D): q, k_new, v_new (B, H, 1,
    D) against row b's cache positions < t[b] of self_k/self_v (B, H, D,
    T), then the first pend_w columns of pend_k/pend_v (B, H, D, W) when
    given, then the new token; q and k scaled by D^-0.25 and rounded, one
    f32 softmax over the three, the weights rounded to the compute dtype
    before an f32 PV."""
    n_ctx = self_k.shape[-1]
    positions = torch.arange(n_ctx, device=q.device)
    if isinstance(t, int):
        mask = torch.where(positions < t, 0.0, NEG_INF).float()
    else:  # (B, 1, 1, T): each row its own length
        mask = torch.where(positions < t[:, None], 0.0, NEG_INF).float()[:, None, None, :]
    if pend_k is not None:
        W = pend_k.shape[-1]
        pend_mask = torch.where(torch.arange(W, device=q.device) < pend_w, 0.0, NEG_INF).float()
        # the pending columns after the cache's
        mask = torch.cat([mask, pend_mask.expand(*mask.shape[:-1], W)], dim=-1)
        self_k = torch.cat([self_k, pend_k], dim=-1)
        self_v = torch.cat([self_v, pend_v], dim=-1)
        n_ctx += W
    scale = q.shape[-1] ** -0.25
    qs = (q * scale).float()
    s_old = torch.matmul(qs, (self_k * scale).float()) + mask
    s_new = torch.matmul(qs, (k_new * scale).float().transpose(-1, -2))
    w = torch.softmax(torch.cat([s_old, s_new], dim=-1), dim=-1).to(q.dtype)
    attn = torch.matmul(
        w[..., :n_ctx].float(), self_v.float().transpose(-1, -2)
    ) + w[..., n_ctx:].float() * v_new.float()
    return attn.to(q.dtype)


def fused_decoder_layers_plain(
    blocks: Dict[str, torch.Tensor],
    n_head: int,
    x: torch.Tensor,  # (B, C)
    t: Position,  # shared by the rows, or (B,) per row
    self_k: torch.Tensor,  # (L, B, H, D, T)
    self_v: torch.Tensor,
    cross_k,  # (L, A, H, D, Ta), A divides B; or Int8Weight
    cross_v,
    pend_k: Optional[torch.Tensor] = None,  # (L, B, H, D, W)
    pend_v: Optional[torch.Tensor] = None,
    pend_w: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The layers of ``decoder_step`` in PyTorch: the softmax runs over
    [row b's cache positions < t[b] | its new token], in f32, and the
    weights round to the compute dtype before PV.  With a pending block, as
    whisper_tpu's ``decoder_step_pending``, over [cache positions < t[b] |
    pending columns < pend_w | new token] (``_self_attention``).
    Cross-attention folds each audio's rows into its query axis
    (``_cross_attention``).  int8 weights go through ``_linear``'s int8
    branch."""
    L = self_k.shape[0]
    A = _values(cross_k).shape[1]
    if A < 1 or x.shape[0] % A:
        raise ValueError(f"{A} audios do not divide {x.shape[0]} rows")
    x = x[:, None, :]  # (B, 1, C)
    k_news, v_news = [], []
    for i in range(L):
        p = _layer(blocks, i)
        h = layer_norm(x, p["attn_ln_g"], p["attn_ln_b"])
        q = split_heads(_linear(h, p["q_w"], p["q_b"]), n_head)  # (B, H, 1, D)
        k_new = split_heads(_linear(h, p["k_w"]), n_head)
        v_new = split_heads(_linear(h, p["v_w"], p["v_b"]), n_head)

        pend = (pend_k[i], pend_v[i], pend_w) if pend_k is not None else ()
        attn = _self_attention(q, k_new, v_new, self_k[i], self_v[i], t, *pend)
        x = x + _linear(merge_heads(attn), p["o_w"], p["o_b"])

        hx = layer_norm(x, p["xattn_ln_g"], p["xattn_ln_b"])
        xq = split_heads(_linear(hx, p["xq_w"], p["xq_b"]), n_head)
        xattn = _cross_attention(xq, take_layer(cross_k, i), take_layer(cross_v, i))
        x = x + _linear(merge_heads(xattn), p["xo_w"], p["xo_b"])
        x = mlp_fused_plain(x, p["mlp_ln_g"], p["mlp_ln_b"], p["fc1_w"], p["fc1_b"], p["fc2_w"],
                            p["fc2_b"])
        k_news.append(merge_heads(k_new)[:, 0])
        v_news.append(merge_heads(v_new)[:, 0])
    return x[:, 0], torch.stack(k_news), torch.stack(v_news)


def takes(n_head: int, width: int, dtype: torch.dtype) -> bool:
    """Whether K2 takes a decoder of this shape: head_dim 64 (C = 64 H), C
    a multiple of 16, bf16 or f32, and in bf16 C <= MAX_BF16_WIDTH (its MLP
    stage).  The engine asks once per decode, before any launch, as
    whisper_tpu's ``_fused_ok`` does; :func:`fused_decoder_layers` itself
    still raises on a shape it refuses."""
    return (width == n_head * HEAD_DIM and width % 16 == 0 and dtype in _DTYPES
            and (dtype != torch.bfloat16 or width <= MAX_BF16_WIDTH))


def row_slices(rows: int, audios: int) -> List[Tuple[Tuple[int, int], Tuple[int, int]]]:
    """The launches of a step of ``rows`` rows of ``audios`` audios (G =
    rows / audios rows each, group-major): ((first row, end row), (first
    audio, end audio)) per launch, each of at most ``MAX_ROWS`` rows, in
    order.  Groups that fit take whole audios, as many to a launch as fit
    (32 x 5: 25 audios, then 7); a group wider than MAX_ROWS is cut into
    ceil(G / MAX_ROWS) launches of its one audio, as even as they go (G =
    200: 100 and 100 rows of audio a)."""
    if audios < 1 or rows < 1 or rows % audios:
        raise ValueError(f"{audios} audios do not divide {rows} rows")
    G = rows // audios
    if G > MAX_ROWS:
        parts = -(-G // MAX_ROWS)
        cuts = [G * k // parts for k in range(parts + 1)]
        return [((a * G + lo, a * G + hi), (a, a + 1))
                for a in range(audios) for lo, hi in zip(cuts, cuts[1:])]
    per = MAX_ROWS // G
    return [((a0 * G, min(a0 + per, audios) * G), (a0, min(a0 + per, audios)))
            for a0 in range(0, audios, per)]


def _int8_form(leaves, what: str) -> bool:
    """True when every leaf is int8, False when none is; raises otherwise."""
    int8 = [isinstance(a, Int8Weight) for a in leaves]
    if any(int8) and not all(int8):
        raise ValueError(f"fused decode-step kernel: all of the {what} int8, or none")
    return all(int8)


def _check_int8(leaf: Int8Weight, device) -> None:
    q, s = leaf
    if (q.dtype != torch.int8 or s.dtype != torch.float32 or tuple(s.shape) != (*q.shape[:-1], 1)
            or q.device != device or s.device != device
            or not (q.is_contiguous() and s.is_contiguous())):
        raise ValueError(
            "fused decode-step kernel: an int8 leaf is contiguous int8 values with contiguous "
            f"f32 scales (..., 1) beside them, on {device}"
        )


def _check_args(blocks, n_head, x, positions, self_k, self_v, cross_k, cross_v,
                pend_k, pend_v, pend_w) -> Tuple[bool, bool]:
    """Raise on what the kernels do not take; (int8 weights, int8 cross K/V)."""
    B, C = x.shape
    L, _, H, D, T = self_k.shape
    if (pend_k is None) != (pend_v is None):
        raise ValueError("fused decode-step kernel: a pending block has its K and its V")
    if pend_k is not None:
        W = pend_k.shape[-1]
        if (pend_v.shape != pend_k.shape or tuple(pend_k.shape[:4]) != (L, B, H, D)
                or not 1 <= W <= MAX_PEND or not 0 <= pend_w <= W):
            raise ValueError(
                f"fused decode-step kernel: pending block {tuple(pend_k.shape)} with {pend_w} "
                f"columns valid; (L, B, H, D, W) with 1 <= W <= {MAX_PEND} expected"
            )
    if D != HEAD_DIM or H != n_head or C != H * D or C % 16:
        raise ValueError(f"fused decode-step kernel: C={C}, H={H}, D={D} unsupported")
    if self_v.shape != self_k.shape or self_k.shape[1] != B:
        raise ValueError(f"fused decode-step kernel: self cache {tuple(self_k.shape)}")
    w8 = _int8_form([blocks[n] for n in PROJECTIONS], "projection weights")
    kv8 = _int8_form([cross_k, cross_v], "cross K/V")
    xk, xv = _values(cross_k), _values(cross_v)
    A = xk.shape[1]
    if xk.shape != xv.shape or A < 1 or B % A or xk.shape[:4] != (L, A, H, D):
        raise ValueError(
            f"fused decode-step kernel: cross cache {tuple(xk.shape)} "
            f"(audios must divide the {B} rows)"
        )
    if positions is not None and (positions.shape != (B,) or positions.device != x.device):
        raise ValueError(f"fused decode-step kernel: positions {tuple(positions.shape)} for {B} rows")
    if x.dtype not in _DTYPES:
        raise ValueError(f"fused decode-step kernel: dtype {x.dtype} (bf16 or f32)")
    int8 = ([blocks[n] for n in PROJECTIONS] if w8 else []) + ([cross_k, cross_v] if kv8 else [])
    dense = [self_k, self_v] + ([] if pend_k is None else [pend_k, pend_v]) + (
        [] if kv8 else [cross_k, cross_v]) + [
        blocks[n] for n in WEIGHTS if not (w8 and n in PROJECTIONS)
    ]
    for a in [x] + dense:
        if a.dtype != x.dtype or a.device != x.device or not a.is_contiguous():
            raise ValueError(
                "fused decode-step kernel: every input must be contiguous, of "
                f"x's dtype {x.dtype}, on {x.device}"
            )
    for leaf in int8:
        _check_int8(leaf, x.device)
    caches = [self_k, self_v, xk, xv] + ([] if pend_k is None else [pend_k, pend_v])
    if any(a.data_ptr() % 16 for a in caches):
        raise ValueError("fused decode-step kernel: the caches must start on a 16-byte boundary "
                         "(decode-attention copies them in 16-byte chunks)")
    if any(_values(blocks[n]).shape[0] != L for n in WEIGHTS):
        raise ValueError(f"fused decode-step kernel: {L} layers expected")
    return w8, kv8


def _layout(A: int, G: int, w8: bool, kv8: bool, pending: bool = False) -> tuple:
    """launches_by_layout's key: (A, G), with a tag for the int8 forms and
    the pending block: "int8" (weights), "kv_int8" (cross K/V) and
    "pending", joined by "+" (e.g. "int8+kv_int8+pending")."""
    tag = "+".join(name for name, on in (("int8", w8), ("kv_int8", kv8), ("pending", pending)) if on)
    return (A, G, tag) if tag else (A, G)


def fused_decoder_layers(
    blocks: Dict[str, torch.Tensor],
    n_head: int,
    x: torch.Tensor,
    t: Position,
    self_k: torch.Tensor,
    self_v: torch.Tensor,
    cross_k,
    cross_v,
    pend_k: Optional[torch.Tensor] = None,
    pend_v: Optional[torch.Tensor] = None,
    pend_w: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """All decoder layers of one step for B rows.  A CPU tensor takes
    :func:`fused_decoder_layers_plain`; a CUDA tensor launches the kernels
    (B rows of A audios, A dividing B, in launches of at most 128 rows of
    whole audios or of one audio's group (:func:`row_slices`); head_dim 64
    (:func:`takes`); bf16 or
    f32; the projections and the cross K/V each in the compute dtype or
    int8; with or without a pending block of at most 64 columns) or raises.

    ``t``: one position for every row (a host int, a kernel argument), or
    a (B,) integer tensor on x's device, one per row, which the kernel
    reads there.  A position past the cache reads the whole cache.  With
    ``pend_k, pend_v`` (L, B, H, D, W) in x's dtype, ``t`` is the block's
    start and the first ``pend_w`` (a host int) columns are attended too.
    """
    if x.device.type == "cpu":
        return fused_decoder_layers_plain(
            blocks, n_head, x, t, self_k, self_v, cross_k, cross_v, pend_k, pend_v, pend_w
        )
    if x.device.type != "cuda":
        raise ValueError(f"fused decode-step kernel: unsupported device {x.device}")
    L, B, H, _, T = self_k.shape
    if isinstance(t, int):
        shared, positions, positions_ptr = min(max(t, 0), T), None, None
    else:
        shared, positions = 0, t.to(torch.int32).contiguous()
        positions_ptr = positions.data_ptr()
    w8, kv8 = _check_args(blocks, n_head, x, positions, self_k, self_v, cross_k, cross_v,
                          pend_k, pend_v, pend_w)
    pending = pend_k is not None
    xk, xv = _values(cross_k), _values(cross_v)
    A, C = xk.shape[1], x.shape[1]
    hidden = torch.empty_like(x)
    k_new = torch.empty((L, B, C), dtype=x.dtype, device=x.device)
    v_new = torch.empty_like(k_new)
    slices = row_slices(B, A)
    # one scratch for every slice: the launches queue on one stream
    scratch = torch.empty(6 * max(r1 - r0 for (r0, r1), _ in slices) * C, dtype=x.dtype, device=x.device)
    table = (ctypes.c_void_p * len(WEIGHTS))(*(_values(blocks[n]).data_ptr() for n in WEIGHTS))
    scales = (ctypes.c_void_p * len(PROJECTIONS))(*(blocks[n].s.data_ptr() for n in PROJECTIONS)) if w8 else None
    for (r0, r1), (a0, a1) in slices:
        err = _lib.lib().fused_decoder_layers(
            _DTYPES[x.dtype], int(w8), int(kv8), L, r1 - r0, a1 - a0, r0, B, a0, A, C, H, T, shared,
            xk.shape[-1], pend_k.shape[-1] if pending else 0, pend_w if pending else 0,
            positions_ptr, x.data_ptr(), hidden.data_ptr(), k_new.data_ptr(),
            v_new.data_ptr(), self_k.data_ptr(), self_v.data_ptr(), xk.data_ptr(), xv.data_ptr(),
            cross_k.s.data_ptr() if kv8 else None, cross_v.s.data_ptr() if kv8 else None,
            ctypes.cast(table, ctypes.c_void_p), ctypes.cast(scales, ctypes.c_void_p) if w8 else None,
            pend_k.data_ptr() if pending else None, pend_v.data_ptr() if pending else None,
            scratch.data_ptr(),
            _lib.stream_ptr(x.device),
        )
        _lib.check(err, "fused_decoder_layers")
        _lib.count_launch(fused_decoder_layers,
                          layout=_layout(a1 - a0, (r1 - r0) // (a1 - a0), w8, kv8, pending))
        _lib.count_launch(mlp_fused, L)  # its MLP stage, K5's code, once per layer
        _lib.count_launch(cross_attention, L)  # its cross-attention launch, once per layer
    return hidden, k_new, v_new


fused_decoder_layers.launches = 0
# (A, G) -> launches; the int8 forms and the pending block as (A, G, tag),
# see _layout
fused_decoder_layers.launches_by_layout = collections.Counter()


def cross_attention_plain(q: torch.Tensor, cross_k, cross_v) -> torch.Tensor:
    """K2's cross-attention on its own: q (B, C) against A audios' K/V (A,
    H, D, Ta), of q's dtype or :class:`Int8Weight` with scales (A, H, D,
    1), B = A * G rows group-major; (B, C) (``_cross_attention``)."""
    H = _values(cross_k).shape[1]
    return merge_heads(_cross_attention(split_heads(q[:, None], H), cross_k, cross_v))[:, 0]


def cross_attention(q: torch.Tensor, cross_k, cross_v) -> torch.Tensor:
    """K2's cross-attention launch on its own (the step runs it once per
    layer).  A CPU tensor takes :func:`cross_attention_plain`; a CUDA
    tensor launches the kernel (bf16 or f32, head_dim 64, K/V contiguous
    and 16-byte aligned) or raises."""
    if q.device.type == "cpu":
        return cross_attention_plain(q, cross_k, cross_v)
    if q.device.type != "cuda":
        raise ValueError(f"cross-attention kernel: unsupported device {q.device}")
    kv8 = _int8_form([cross_k, cross_v], "cross K/V")
    xk, xv = _values(cross_k), _values(cross_v)
    B, C = q.shape
    A, H, D, Ta = xk.shape
    if (D != HEAD_DIM or C != H * D or xv.shape != xk.shape or B % A or q.dtype not in _DTYPES
            or not q.is_contiguous()):
        raise ValueError(f"cross-attention kernel: q {tuple(q.shape)} {q.dtype} against K/V "
                         f"{tuple(xk.shape)}")
    for leaf in (cross_k, cross_v):
        if kv8:
            _check_int8(leaf, q.device)
        elif leaf.dtype != q.dtype or leaf.device != q.device or not leaf.is_contiguous():
            raise ValueError("cross-attention kernel: K/V contiguous, of q's dtype, on q's device")
        if _values(leaf).data_ptr() % 16:
            raise ValueError("cross-attention kernel: K/V must start on a 16-byte boundary")
    out = torch.empty_like(q)
    err = _lib.lib().decode_cross_attention(
        _DTYPES[q.dtype], int(kv8), A, B // A, C, H, Ta, q.data_ptr(), xk.data_ptr(), xv.data_ptr(),
        cross_k.s.data_ptr() if kv8 else None, cross_v.s.data_ptr() if kv8 else None,
        out.data_ptr(), _lib.stream_ptr(q.device),
    )
    _lib.check(err, "decode_cross_attention")
    _lib.count_launch(cross_attention)
    return out


cross_attention.launches = 0  # its own launches, and L per launch of K2's


def int8_logits_plain(hidden: torch.Tensor, w: Int8Weight) -> torch.Tensor:
    """hidden (..., C) . q (V, C)^T in f32, times the per-row scales s (V,
    1), unrounded: whisper_tpu's ``project_logits`` with ``logits_w``."""
    return F.linear(hidden.float(), w.q.float()) * w.s[:, 0]


def int8_logits(hidden: torch.Tensor, w: Int8Weight) -> torch.Tensor:
    """The int8 logits projection, f32 (..., V).  A CPU tensor takes
    :func:`int8_logits_plain`; a CUDA tensor launches K2's GEMV with int8
    weights and an unrounded f32 epilogue, reading the (V, C) int8 matrix
    as it is, or raises."""
    if hidden.device.type == "cpu":
        return int8_logits_plain(hidden, w)
    if hidden.device.type != "cuda":
        raise ValueError(f"int8 logits kernel: unsupported device {hidden.device}")
    _check_int8(w, hidden.device)
    V, C = w.q.shape
    if hidden.dtype not in _DTYPES or hidden.shape[-1] != C or C % 16 or w.q.dim() != 2:
        raise ValueError(f"int8 logits kernel: hidden (..., {C}) bf16 or f32, C a multiple of 16; "
                         f"got {tuple(hidden.shape)} {hidden.dtype}")
    flat = hidden.reshape(-1, C).contiguous()
    out = torch.empty((flat.shape[0], V), dtype=torch.float32, device=hidden.device)
    err = _lib.lib().int8_logits(
        _DTYPES[hidden.dtype], flat.shape[0], C, V, flat.data_ptr(), w.q.data_ptr(),
        w.s.data_ptr(), out.data_ptr(), _lib.stream_ptr(hidden.device),
    )
    _lib.check(err, "int8_logits")
    _lib.count_launch(int8_logits)
    return out.reshape(*hidden.shape[:-1], V)


int8_logits.launches = 0
