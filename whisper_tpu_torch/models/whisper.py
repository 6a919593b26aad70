"""The Whisper encoder-decoder Transformer as functions on tensors.

Counterpart of ``whisper_tpu/models/whisper.py``.  Parameters are a dict
with the JAX package's keys, per-layer weights stacked on a leading layer
axis, but in torch's layouts: linear weights (L, out, in) and convolution
weights (out, in, k), as in the reference checkpoints; a linear weight may
be an int8 :class:`~whisper_tpu_torch.quantize.Int8Weight` (per output
row), and the cross-attention K/V of the decode loop int8 per (audio,
head, channel).  LayerNorm statistics, attention scores and logits are f32
whatever the compute dtype.  The KV cache is (L, B, H, D, T), time last, as
in the JAX package; the decode step's attention kernel reads it with threads
along T.
"""

import base64
import gzip
import threading
from collections import Counter
from typing import Any, Dict, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.attention import (
    encoder_attention,
    merge_heads,
    qkv_attention,
    qkv_attention_kt,
    split_heads,
)
from ..ops.kernels import encoder_block as _kernels
from ..ops.kernels.encoder_block import layer_norm_plain as layer_norm
from ..parallel.mesh import copy_to_model, current_mesh, reduce_from_model
from ..quantize import Int8Weight, take_layer
from .dims import ModelDimensions

Params = Dict[str, Any]

NEG_INF = float(np.finfo(np.float32).min)


def sinusoids(length: int, channels: int, max_timescale: int = 10000) -> np.ndarray:
    """Sinusoidal position embeddings (reference model.py:62-68)."""
    assert channels % 2 == 0
    log_timescale_increment = np.log(max_timescale) / (channels // 2 - 1)
    inv_timescales = np.exp(
        -log_timescale_increment * np.arange(channels // 2, dtype=np.float32)
    )
    scaled_time = (
        np.arange(length, dtype=np.float32)[:, None] * inv_timescales[None, :]
    )
    return np.concatenate([np.sin(scaled_time), np.cos(scaled_time)], axis=1).astype(
        np.float32
    )


def _int8_product(x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """x (..., in) . q (out, in)^T in f32, unrounded, the int8 values taken
    in x's dtype (exact in bf16).  On the card a bf16 x converts the one
    weight per call and runs a library GEMM with an f32 output: the products
    that whisper_tpu leaves to XLA (the decode step's are kernel K2's)."""
    if x.is_cuda and x.dtype != torch.float32:
        flat = x.reshape(-1, x.shape[-1])
        out = torch.mm(flat, q.to(x.dtype).t(), out_dtype=torch.float32)
        return out.reshape(*x.shape[:-1], q.shape[0])
    return F.linear(x.float(), q.float())


def _linear(x: torch.Tensor, w, b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x @ w.T, rounded to x's dtype, then + b (rounded again), as the JAX
    package's einsum-then-bias.  An int8 w: the f32 product times its
    per-output scales, rounded once to x's dtype, then + b."""
    if isinstance(w, Int8Weight):
        y = (_int8_product(x, w.q) * w.s[..., 0]).to(x.dtype)
    else:
        y = F.linear(x, w)
    if b is not None:
        y = y + b
    return y


def _linear_rows(x: torch.Tensor, w, b: Optional[torch.Tensor], partial: bool) -> torch.Tensor:
    """A row-parallel projection (o, xo, fc2).  On a model shard
    (``partial``) the product is a part of the whole one: it is summed over
    the mesh's model group (:func:`~whisper_tpu_torch.parallel.
    reduce_from_model`) before the bias, which is added once, and before
    the caller's residual, which would otherwise count once per rank.
    Otherwise :func:`_linear` as it is."""
    if not partial:
        return _linear(x, w, b)
    y = reduce_from_model(_linear(x, w))
    return y if b is None else y + b


def _rows(w) -> int:
    return (w.q if isinstance(w, Int8Weight) else w).shape[-2]


def n_heads(w, width: int, n_head: int) -> int:
    """The heads a column-parallel weight (q_w, xk_w, ...) holds: all
    ``n_head`` of a whole one, n_head / model of a rank's shard
    (``parallel.shard_params``).  Heads are split by their width, width //
    n_head, so one code path serves the whole model and a shard; a shard
    that does not hold whole heads raises."""
    d = width // n_head
    rows = _rows(w)
    if rows % d or not 0 < rows <= width:
        raise ValueError(f"a projection of {rows} output rows does not hold whole heads of {d} "
                         f"(width {width}, {n_head} heads): the model axis must divide the heads")
    return rows // d


def is_shard(p: Params, width: int) -> bool:
    """Whether a block's parameters are a model shard (its q_w holds fewer
    rows than the residual's width)."""
    return _rows(p["q_w"]) < width


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x)  # exact erf form


def _layer(blocks: Params, i: int) -> Params:
    """Layer i's parameters out of the stacked blocks."""
    return {k: take_layer(v, i) for k, v in blocks.items()}


def _layers(blocks: Params, n_layer: int) -> list:
    """Every layer's parameters out of the stacked blocks, one ``unbind``
    per stacked tensor.  In a pass that takes gradients, autograd stacks
    the layers' gradients into each leaf once; indexing one layer at a time
    would write each layer's gradient into a zero tensor of the whole stack
    and add those up, L times the traffic."""
    per_leaf = {k: v.unbind(0) if isinstance(v, torch.Tensor) else [take_layer(v, i) for i in range(n_layer)]
                for k, v in blocks.items()}
    return [{k: layers[i] for k, layers in per_leaf.items()} for i in range(n_layer)]


class KVCache(NamedTuple):
    """Decoder cache, time last.

    self_k/self_v: (L, B, H, D, T) — autoregressive self-attention, written
    in place one column per step.  cross_k/cross_v: (L, A, H, D, Ta) —
    computed once per segment, one copy per audio; the B = A * G rows are
    group-major (row = audio * G + g).  With ``kv_cache_dtype="int8"`` they
    are Int8Weight: int8 with f32 scales (L, A, H, D, 1) over time.
    """

    self_k: torch.Tensor
    self_v: torch.Tensor
    cross_k: Union[torch.Tensor, Int8Weight]
    cross_v: Union[torch.Tensor, Int8Weight]


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------


def _on_card(x: torch.Tensor) -> bool:
    return x.is_cuda


def _on_kernels(x: torch.Tensor, params) -> bool:
    """Whether the encoder's kernels (:mod:`..ops.kernels.encoder_block`)
    take x with these parameters: a bf16 CUDA activation (:func:`_on_card`,
    which a CPU test may stand in for), plain bf16 tensors (no Int8Weight)
    on its device, and no autograd (the kernels have no backward).  A CPU
    tensor, f32 and a pass that takes gradients keep the torch ops."""
    if not (_on_card(x) and x.dtype == torch.bfloat16):
        return False
    if not all(isinstance(v, torch.Tensor) and v.dtype == x.dtype and v.device == x.device for v in params):
        return False
    return not (torch.is_grad_enabled() and any(t.requires_grad for t in (x, *params)))


def _block_on_kernels(x: torch.Tensor, p: Params, n_head: int) -> bool:
    """Whether an encoder block takes the kernels: :func:`_on_kernels`, a
    whole block (not a model shard, whose o and fc2 products are reduced
    before their bias and residual) and a head dim a multiple of 64 (K1's
    layout, read and written by the kernels)."""
    return (not is_shard(p, x.shape[-1]) and (x.shape[-1] // n_head) % 64 == 0
            and _on_kernels(x, list(p.values())))


_route_lock = threading.Lock()


def _count_route(route: str) -> None:
    with _route_lock:
        encoder_apply.blocks_by_route[route] += 1


def _encoder_block(x: torch.Tensor, p: Params, n_head: int, attention=encoder_attention) -> torch.Tensor:
    """Pre-LN self-attention block (reference model.py:142-171, no
    cross-attn).  ``n_head``: the heads these parameters hold (a model
    shard's H / model).

    The route is the inputs': where :func:`_block_on_kernels` holds, the
    block runs :func:`_encoder_block_kernels`; else the torch ops below.
    Both round at the same places.  ``encoder_apply.blocks_by_route``
    counts the blocks of each route."""
    if _block_on_kernels(x, p, n_head):
        _count_route("kernels")
        return _encoder_block_kernels(x, p, n_head, attention)
    _count_route("torch")
    tp = is_shard(p, x.shape[-1])
    h = layer_norm(x, p["attn_ln_g"], p["attn_ln_b"])
    if tp:
        h = copy_to_model(h)
    q = split_heads(_linear(h, p["q_w"], p["q_b"]), n_head).contiguous()
    k = split_heads(_linear(h, p["k_w"]), n_head).contiguous()
    v = split_heads(_linear(h, p["v_w"], p["v_b"]), n_head).contiguous()
    attn = attention(q, k, v)
    x = x + _linear_rows(merge_heads(attn), p["o_w"], p["o_b"], tp)

    h = layer_norm(x, p["mlp_ln_g"], p["mlp_ln_b"])
    if tp:
        h = copy_to_model(h)
    h = _gelu(_linear(h, p["fc1_w"], p["fc1_b"]))
    return x + _linear_rows(h, p["fc2_w"], p["fc2_b"], tp)


def _encoder_block_kernels(x: torch.Tensor, p: Params, n_head: int, attention=encoder_attention) -> torch.Tensor:
    """The block on the encoder's kernels: no activation makes a trip
    through memory for a pointwise operation.  LayerNorm in one pass; q, k
    and v in one launch, stored in the (B, H, T, D) layout ``attention``
    (K1) reads; the o projection reads its output in place and adds the
    bias and residual in its epilogue; fc1 adds its bias and GELU, fc2 its
    bias and the residual.  On a CPU tensor the kernels' plain versions,
    which equal the torch route bit for bit."""
    x = x.contiguous()  # the first block's x is the positional add's, (B, C, T) in memory
    h = _kernels.layer_norm(x, p["attn_ln_g"], p["attn_ln_b"])
    q, k, v = _kernels.qkv(h, p["q_w"], p["q_b"], p["k_w"], None, p["v_w"], p["v_b"], n_head)
    x = _kernels.linear(attention(q, k, v).contiguous(), p["o_w"], p["o_b"], residual=x)
    h = _kernels.layer_norm(x, p["mlp_ln_g"], p["mlp_ln_b"])
    h = _kernels.linear(h, p["fc1_w"], p["fc1_b"], gelu=True)
    return _kernels.linear(h, p["fc2_w"], p["fc2_b"], residual=x)


def encoder_apply(
    params: Params, dims: ModelDimensions, mel: torch.Tensor, *, attention=encoder_attention
) -> torch.Tensor:
    """mel (B, n_mels, 3000) -> audio features (B, n_audio_ctx, n_audio_state).

    Two stride-1/stride-2 convs + GELU, sinusoidal positions, N pre-LN
    blocks, final LayerNorm (reference model.py:188-204); the blocks and
    the final LayerNorm take the encoder's kernels where the inputs allow
    (:func:`_encoder_block`).  ``attention``
    (q, k, v) -> out is the blocks' self-attention: by default
    :func:`encoder_attention` (kernel K1 on a CUDA tensor, which has no
    backward); a training pass gives the differentiable torch ops
    (``training.loss_fn``).  On a model shard (``parallel.shard_params``,
    under ``with mesh:``) each rank runs its H / model heads, K1 among them.
    """
    enc = params["encoder"]
    dtype = enc["conv1_w"].dtype
    x = mel.to(dtype)
    x = _gelu(F.conv1d(x, enc["conv1_w"], padding=1) + enc["conv1_b"][:, None])
    x = _gelu(F.conv1d(x, enc["conv2_w"], stride=2, padding=1) + enc["conv2_b"][:, None])
    x = x.transpose(1, 2)  # (B, T, C), feature-last

    assert x.shape[1] == dims.n_audio_ctx, "incorrect audio shape"
    x = x + enc["pos"]
    n_head = n_heads(enc["blocks"]["q_w"], dims.n_audio_state, dims.n_audio_head)
    layers = _layers(enc["blocks"], dims.n_audio_layer)
    for p in layers:
        x = _encoder_block(x, p, n_head, attention)
    g, b = enc["ln_post_g"], enc["ln_post_b"]
    # ln_post takes the route the blocks took (the torch route's output may
    # keep the first block's (B, C, T) layout)
    on_kernels = bool(layers) and _block_on_kernels(x, layers[-1], n_head) and _on_kernels(x, [g, b])
    return (_kernels.layer_norm if on_kernels else layer_norm)(x, g, b)


encoder_apply.blocks_by_route = Counter()  # "kernels" / "torch" -> encoder blocks run


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------


def compute_cross_kv(
    params: Params, dims: ModelDimensions, audio_features: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-layer cross-attention K/V from encoder output: (L, B, H, D, Ta),
    computed once per segment and reused by every decode step."""
    blocks = params["decoder"]["blocks"]
    h = n_heads(blocks["xk_w"], dims.n_text_state, dims.n_text_head)
    ks, vs = [], []
    for i in range(dims.n_text_layer):
        xk_w, xv_w = take_layer(blocks["xk_w"], i), take_layer(blocks["xv_w"], i)
        ks.append(split_heads(_linear(audio_features, xk_w), h).transpose(-1, -2))
        vs.append(split_heads(_linear(audio_features, xv_w, blocks["xv_b"][i]), h).transpose(-1, -2))
    return torch.stack(ks), torch.stack(vs)


def _int8_attention(q: torch.Tensor, k: Int8Weight, v: Int8Weight) -> torch.Tensor:
    """q (A, H, Q, D) against int8 K/V (A, H, D, Ta), as whisper_tpu's
    ``_cross_step_attention`` int8 branch: D^-0.5 and the K scales folded
    into q (rounded once), f32 scores, weights rounded, f32 PV, times the V
    scales, rounded."""
    D = q.shape[-1]
    sk = k.s[..., 0][:, :, None, :]  # (A, H, 1, D)
    sv = v.s[..., 0][:, :, None, :]
    q_eff = (q.float() * D**-0.5 * sk).to(q.dtype)
    w = torch.softmax(torch.matmul(q_eff.float(), k.q.float()), dim=-1).to(q.dtype)
    pv = torch.matmul(w.float(), v.q.float().transpose(-1, -2))
    return (pv * sv).to(q.dtype)


def _cross_step_attention_k(xq: torch.Tensor, cross_k, cross_v) -> torch.Tensor:
    """xq (B, H, K, D) against A audios' cross K/V (A, H, D, Ta), in the
    compute dtype or int8 (whisper_tpu/models/whisper.py:829-866): the G =
    B / A rows of each audio fold into its query axis, so each audio's K/V
    serves its rows.  K is 1 in a decode step (kernel K2's plain version)."""
    B, H, K, D = xq.shape
    A = (cross_k.q if isinstance(cross_k, Int8Weight) else cross_k).shape[0]
    G = B // A
    attend = _int8_attention if isinstance(cross_k, Int8Weight) else qkv_attention_kt
    if G == 1:
        return attend(xq, cross_k, cross_v)
    q = xq.reshape(A, G, H, K, D).transpose(1, 2).reshape(A, H, G * K, D)
    out = attend(q, cross_k, cross_v)
    return out.reshape(A, H, G, K, D).transpose(1, 2).reshape(B, H, K, D)


def _decoder_block(
    x: torch.Tensor,
    p: Params,
    n_head: int,
    self_k: torch.Tensor,
    self_v: torch.Tensor,
    cross_k_t,  # (A, H, D, Ta) — time-last, see KVCache; or Int8Weight
    cross_v_t,
    self_mask: Optional[torch.Tensor],
    *,
    return_cross_qk: bool = False,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One decoder block given its self-attention K/V for the query
    positions (computed by the caller, which also keeps them).  Returns the
    block's output and, with ``return_cross_qk``, the f32 pre-softmax
    cross-attention scores (B, H, T, Ta).  On a model shard the caller's
    K/V and ``n_head`` are its H / model heads; in a pass that takes
    gradients the caller passes ``h`` through ``copy_to_model`` before its
    k and v projections (the one of q is here)."""
    tp = is_shard(p, x.shape[-1])
    h = layer_norm(x, p["attn_ln_g"], p["attn_ln_b"])
    if tp:
        h = copy_to_model(h)
    q = split_heads(_linear(h, p["q_w"], p["q_b"]), n_head)
    attn, _ = qkv_attention(q, self_k, self_v, self_mask)
    x = x + _linear_rows(merge_heads(attn), p["o_w"], p["o_b"], tp)

    h = layer_norm(x, p["xattn_ln_g"], p["xattn_ln_b"])
    if tp:
        h = copy_to_model(h)
    xq = split_heads(_linear(h, p["xq_w"], p["xq_b"]), n_head)
    if return_cross_qk:
        xattn, cross_qk = qkv_attention(
            xq, cross_k_t.transpose(-1, -2), cross_v_t.transpose(-1, -2), return_qk=True
        )
    else:
        xattn, cross_qk = _cross_step_attention_k(xq, cross_k_t, cross_v_t), None
    x = x + _linear_rows(merge_heads(xattn), p["xo_w"], p["xo_b"], tp)

    h = layer_norm(x, p["mlp_ln_g"], p["mlp_ln_b"])
    if tp:
        h = copy_to_model(h)
    h = _gelu(_linear(h, p["fc1_w"], p["fc1_b"]))
    return x + _linear_rows(h, p["fc2_w"], p["fc2_b"], tp), cross_qk


def _text_heads(dec: Params, dims: ModelDimensions) -> int:
    return n_heads(dec["blocks"]["q_w"], dims.n_text_state, dims.n_text_head)


def _embed_tokens(dec: Params, tokens: torch.Tensor, length: int) -> torch.Tensor:
    return dec["tok_emb"][tokens] + dec["pos_emb"][:length][None]


def _causal_mask(n: int, device) -> torch.Tensor:
    return torch.triu(torch.full((n, n), NEG_INF, device=device), diagonal=1)


def decoder_prefill(
    params: Params,
    dims: ModelDimensions,
    tokens: torch.Tensor,  # (B, P) int64, right-padded; padding is never read back
    cross_k: torch.Tensor,
    cross_v: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Causal forward over a fixed-size prompt block.

    Returns hidden states (B, P, C) after the final LayerNorm and this
    prefix's self-attention K/V stacked per layer, (L, B, H, P, D).
    """
    dec = params["decoder"]
    n_head = _text_heads(dec, dims)
    _, P = tokens.shape
    x = _embed_tokens(dec, tokens, P)
    causal = _causal_mask(P, x.device)
    ks, vs = [], []
    for i in range(dims.n_text_layer):
        p = _layer(dec["blocks"], i)
        h = layer_norm(x, p["attn_ln_g"], p["attn_ln_b"])
        k = split_heads(_linear(h, p["k_w"]), n_head)
        v = split_heads(_linear(h, p["v_w"], p["v_b"]), n_head)
        x, _ = _decoder_block(x, p, n_head, k, v, cross_k[i], cross_v[i], causal)
        ks.append(k)
        vs.append(v)
    x = layer_norm(x, dec["ln_g"], dec["ln_b"])
    return x, torch.stack(ks), torch.stack(vs)


Position = Union[int, torch.Tensor]  # one position for every row, or (B,) per row


def _embed_step(params: Params, dims: ModelDimensions, tokens: torch.Tensor, t: Position) -> torch.Tensor:
    dec = params["decoder"]
    if isinstance(t, int):
        return dec["tok_emb"][tokens] + dec["pos_emb"][min(max(t, 0), dims.n_text_ctx - 1)]
    return dec["tok_emb"][tokens] + dec["pos_emb"][t.clamp(0, dims.n_text_ctx - 1)]


def _write_kv_column(cache: KVCache, k_new: torch.Tensor, v_new: torch.Tensor, t: Position) -> None:
    """Write one step's K/V, (L, B, C), into cache column t, in place: the
    same column for every row, or row b's own column t[b].

    The JAX package rewrites the whole cache through a mask because XLA
    cannot update it in place cheaply; here the column is written directly
    (per row: a scatter).  A position past the cache's capacity is dropped,
    as there: that row's column keeps what it held.
    """
    L, B, H, D, n_ctx = cache.self_k.shape
    if isinstance(t, int):
        if 0 <= t < n_ctx:
            cache.self_k[..., t] = k_new.view(L, B, H, D)
            cache.self_v[..., t] = v_new.view(L, B, H, D)
        return
    keep = ((t >= 0) & (t < n_ctx)).view(1, B, 1, 1, 1)
    col = t.clamp(0, n_ctx - 1).view(1, B, 1, 1, 1).expand(L, B, H, D, 1)
    for buf, new in ((cache.self_k, k_new), (cache.self_v, v_new)):
        buf.scatter_(-1, col, torch.where(keep, new.view(L, B, H, D, 1), buf.gather(-1, col)))


def _step(
    layers, params: Params, dims: ModelDimensions, tokens: torch.Tensor, t: Position, cache: KVCache
) -> Tuple[torch.Tensor, KVCache]:
    dec = params["decoder"]
    x = _embed_step(params, dims, tokens, t)
    hidden, k_new, v_new = layers(
        dec["blocks"], _text_heads(dec, dims), x, t,
        cache.self_k, cache.self_v, cache.cross_k, cache.cross_v,
    )
    _write_kv_column(cache, k_new, v_new, t)
    return layer_norm(hidden, dec["ln_g"], dec["ln_b"]), cache


def decoder_step(
    params: Params,
    dims: ModelDimensions,
    tokens: torch.Tensor,  # (B,) — the tokens at position t
    t: Position,  # position of this step: shared by the rows, or (B,) per row
    cache: KVCache,
) -> Tuple[torch.Tensor, KVCache]:
    """One autoregressive decode step at position t, the plain reference.

    Row b attends over its cache positions < t[b] plus its new token,
    writes this step's K/V into its column t[b], and returns the hidden
    state (B, C) after the final LayerNorm.  A position past the cache's
    capacity attends the whole cache and its write is dropped, as in the JAX
    step.  Rows are group-major (row = audio * G + g) and ``cache.cross_k``
    holds one copy per audio, A = B // G of them, as ``decoder_step(...,
    n_group=G)`` of the JAX package.  The layers run through the plain
    version of kernel K2 on any device.
    """
    from ..ops.kernels.fused_step import fused_decoder_layers_plain

    return _step(fused_decoder_layers_plain, params, dims, tokens, t, cache)


def decoder_step_fused(
    params: Params,
    dims: ModelDimensions,
    tokens: torch.Tensor,  # (B,)
    t: Position,
    cache: KVCache,
) -> Tuple[torch.Tensor, KVCache]:
    """:func:`decoder_step` with the layers through kernel K2
    (:mod:`..ops.kernels.fused_step`): on a CUDA tensor one host call queues
    every layer's kernels; on a CPU tensor the wrapper takes the plain
    version."""
    from ..ops.kernels.fused_step import fused_decoder_layers

    return _step(fused_decoder_layers, params, dims, tokens, t, cache)


def _step_pending(
    layers, params: Params, dims: ModelDimensions, tokens: torch.Tensor, t: Position,
    block_start: Position, w: int, pend_k: torch.Tensor, pend_v: torch.Tensor, cache: KVCache,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    dec = params["decoder"]
    x = _embed_step(params, dims, tokens, t)
    hidden, k_new, v_new = layers(
        dec["blocks"], _text_heads(dec, dims), x, block_start,
        cache.self_k, cache.self_v, cache.cross_k, cache.cross_v, pend_k, pend_v, w,
    )
    L, B, H, D, _ = pend_k.shape
    pend_k[..., w] = k_new.view(L, B, H, D)
    pend_v[..., w] = v_new.view(L, B, H, D)
    return layer_norm(hidden, dec["ln_g"], dec["ln_b"]), pend_k, pend_v


def decoder_step_pending(
    params: Params,
    dims: ModelDimensions,
    tokens: torch.Tensor,  # (B,) — the tokens at position t
    t: Position,  # position of this step: shared by the rows, or (B,) per row
    block_start: Position,  # cache position of pending column 0: shared, or (B,) per row
    w: int,  # this step's column in the pending block
    pend_k: torch.Tensor,  # (L, B, H, D, W) — the block's uncommitted K
    pend_v: torch.Tensor,
    cache: KVCache,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`decoder_step` with deferred self-K/V writes, the plain
    reference (whisper_tpu/models/whisper.py:556-680).

    Row b attends over [its cache positions < block_start[b] | pending
    columns < w | its new token] and puts this step's K/V into pending
    column w, in place; the cache is not touched (the engine commits the
    block with :func:`flush_pending` once per W steps).  Pending column w of
    row b holds its position block_start[b] + w.  Returns (hidden (B, C)
    after the final LayerNorm, pend_k, pend_v).  Beam and best-of groups of
    several audios share their audio's cross K/V, as in
    :func:`decoder_step`.
    """
    from ..ops.kernels.fused_step import fused_decoder_layers_plain

    return _step_pending(fused_decoder_layers_plain, params, dims, tokens, t, block_start, w,
                         pend_k, pend_v, cache)


def decoder_step_fused_pending(
    params: Params,
    dims: ModelDimensions,
    tokens: torch.Tensor,
    t: Position,
    block_start: Position,
    w: int,
    pend_k: torch.Tensor,
    pend_v: torch.Tensor,
    cache: KVCache,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`decoder_step_pending` with the layers through kernel K2's
    pending variant (whisper_tpu/models/whisper.py:502-553); on a CPU
    tensor the wrapper takes the plain version."""
    from ..ops.kernels.fused_step import fused_decoder_layers

    return _step_pending(fused_decoder_layers, params, dims, tokens, t, block_start, w,
                         pend_k, pend_v, cache)


def flush_pending(cache: KVCache, pend_k: torch.Tensor, pend_v: torch.Tensor,
                  block_start: Position) -> KVCache:
    """Commit a pending block of W columns into the self-K/V cache, in
    place: row b's column w goes to cache position block_start[b] + w, and
    columns at or past the cache's capacity are dropped, as whisper_tpu's
    ``flush_pending`` (whisper_tpu/models/whisper.py:683-710), which rewrites
    the whole cache through a mask.  Here it is one indexed copy: a slice for
    a shared start, else per row a gather and scatter of the W cache columns
    the block overlaps (shifted left of the capacity, so that the indices of
    a row are distinct and the copy is deterministic)."""
    L, B, H, D, n_ctx = cache.self_k.shape
    W = pend_k.shape[-1]
    if W > n_ctx:
        raise ValueError(f"a pending block of {W} columns for a cache of {n_ctx}")
    if isinstance(block_start, int):
        n = min(W, n_ctx - block_start)
        if n > 0:
            cache.self_k[..., block_start:block_start + n] = pend_k[..., :n]
            cache.self_v[..., block_start:block_start + n] = pend_v[..., :n]
        return cache
    first = block_start.clamp(max=n_ctx - W)  # (B,): W distinct columns in the cache
    cols = first[:, None] + torch.arange(W, device=first.device)  # (B, W)
    fresh = (cols >= block_start[:, None]).view(1, B, 1, 1, W)
    cols = cols.view(1, B, 1, 1, W).expand(L, B, H, D, W)
    src = (cols - block_start.view(1, B, 1, 1, 1)).clamp(0, W - 1)
    for buf, pend in ((cache.self_k, pend_k), (cache.self_v, pend_v)):
        buf.scatter_(-1, cols, torch.where(fresh, pend.gather(-1, src), buf.gather(-1, cols)))
    return cache


def decoder_step_k(
    params: Params,
    dims: ModelDimensions,
    tokens: torch.Tensor,  # (B, K) — the tokens at positions t0 .. t0 + K - 1
    t0: torch.Tensor,  # (B,) — each row's first position of the block
    cache: KVCache,
) -> Tuple[torch.Tensor, KVCache]:
    """A K-token causal step at per-row start positions, the speculative
    engine's draft resync and target verify passes
    (whisper_tpu/models/whisper.py:713-827).

    Row b's query i (position t0[b] + i) attends its cache positions
    < t0[b] and the causal prefix of its block: one f32 softmax over
    [cache | block], the weights rounded to the compute dtype before PV.
    The block's K/V go into cache columns t0[b] .. t0[b] + K - 1 in place,
    by :func:`flush_pending`'s per-row copy: a column at or past the
    capacity drops.  Columns at or past t0[b] may hold K/V of rejected
    drafts; the mask keeps them unattended and accepted rewrites overwrite
    them.  Returns hidden (B, K, C) after the final LayerNorm.  Stock torch
    ops, no kernel: whisper_tpu runs this step in XLA."""
    dec = params["decoder"]
    n_head = _text_heads(dec, dims)
    B, K = tokens.shape
    n_ctx = cache.self_k.shape[-1]
    device = tokens.device
    positions = t0[:, None] + torch.arange(K, device=device)  # (B, K)
    x = dec["tok_emb"][tokens] + dec["pos_emb"][positions.clamp(0, dims.n_text_ctx - 1)]
    committed = torch.where(torch.arange(n_ctx, device=device) < t0[:, None], 0.0, NEG_INF)
    mask = torch.cat([committed[:, None, :].expand(B, K, n_ctx),
                      _causal_mask(K, device).expand(B, K, K)], dim=-1)[:, None]  # (B, 1, K, T + K)
    ks, vs = [], []
    for i in range(dims.n_text_layer):
        p = _layer(dec["blocks"], i)
        h = layer_norm(x, p["attn_ln_g"], p["attn_ln_b"])
        k = split_heads(_linear(h, p["k_w"]), n_head)  # (B, H, K, D)
        v = split_heads(_linear(h, p["v_w"], p["v_b"]), n_head)
        keys = torch.cat([cache.self_k[i].transpose(-1, -2), k], dim=2)
        values = torch.cat([cache.self_v[i].transpose(-1, -2), v], dim=2)
        x, _ = _decoder_block(x, p, n_head, keys, values, take_layer(cache.cross_k, i),
                              take_layer(cache.cross_v, i), mask)
        ks.append(k)
        vs.append(v)
    flush_pending(cache, torch.stack(ks).transpose(-1, -2), torch.stack(vs).transpose(-1, -2), t0)
    return layer_norm(x, dec["ln_g"], dec["ln_b"]), cache


def project_logits(params: Params, hidden: torch.Tensor) -> torch.Tensor:
    """hidden (..., C) -> float32 logits (..., n_vocab) (tied embeddings).

    The products are of compute-dtype values and the logits stay f32,
    unrounded, as the JAX package's ``preferred_element_type=float32``.
    With an int8 logits copy (``decoder["logits_w"]``, from
    ``quantize_params(logits=True)``) the product reads that matrix instead,
    times its per-row scales, unrounded: on the card through K2's int8 GEMV
    (:func:`~whisper_tpu_torch.ops.kernels.fused_step.int8_logits`), which
    reads the int8 bytes as they are.
    """
    lw = params["decoder"].get("logits_w")
    if lw is not None:
        from ..ops.kernels.fused_step import int8_logits

        return int8_logits(hidden, lw)
    emb = params["decoder"]["tok_emb"]
    if hidden.dtype == torch.float32:
        return F.linear(hidden, emb)
    if hidden.is_cuda:
        flat = hidden.reshape(-1, hidden.shape[-1])
        out = torch.mm(flat, emb.t(), out_dtype=torch.float32)
        return out.reshape(*hidden.shape[:-1], emb.shape[0])
    return F.linear(hidden.float(), emb.float())


def decoder_forward(
    params: Params,
    dims: ModelDimensions,
    tokens: torch.Tensor,  # (B, T)
    audio_features: torch.Tensor,
    *,
    alignment_heads: Optional[np.ndarray] = None,
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Full teacher-forced decoder pass: float32 logits (B, T, n_vocab).

    With ``alignment_heads`` (a (K, 2) array of (layer, head) pairs) it
    returns (logits, qk): qk holds the float32 pre-softmax cross-attention
    scores of those heads, (K, B, T, Ta), in ``alignment_heads`` order, as
    whisper_tpu's ``decoder_forward`` (which replaces the reference's
    hook-based capture, timing.py:185-201).  ``alignment_heads`` index
    the whole model's heads: on a model shard each rank fills the heads it
    holds into a zero-filled stack, summed over the model group, so every
    rank returns the whole qk.
    """
    dec = params["decoder"]
    n_head = _text_heads(dec, dims)
    _, T = tokens.shape
    heads = None if alignment_heads is None else np.asarray(alignment_heads).reshape(-1, 2)
    cross_k, cross_v = compute_cross_kv(params, dims, audio_features)
    x = _embed_tokens(dec, tokens, T)
    causal = _causal_mask(T, x.device)
    layer_qk = {}
    for i in range(dims.n_text_layer):
        p = _layer(dec["blocks"], i)
        h = layer_norm(x, p["attn_ln_g"], p["attn_ln_b"])
        k = split_heads(_linear(h, p["k_w"]), n_head)
        v = split_heads(_linear(h, p["v_w"], p["v_b"]), n_head)
        want = heads is not None and bool((heads[:, 0] == i).any())
        x, qk = _decoder_block(
            x, p, n_head, k, v, cross_k[i], cross_v[i], causal, return_cross_qk=want
        )
        if want:
            layer_qk[i] = qk
    x = layer_norm(x, dec["ln_g"], dec["ln_b"])
    logits = project_logits(params, x)
    if heads is None:
        return logits
    if n_head == dims.n_text_head:
        return logits, torch.stack([layer_qk[int(l)][:, int(h)] for l, h in heads])
    mesh = current_mesh()  # (reduce_from_model raises without one)
    first = (mesh.coords["model"] if mesh is not None else 0) * n_head  # this rank's first head
    qk = torch.stack([layer_qk[int(l)][:, int(h) - first] if first <= h < first + n_head
                      else torch.zeros_like(layer_qk[int(l)][:, 0]) for l, h in heads])
    return logits, reduce_from_model(qk)


def init_kv_cache(
    dims: ModelDimensions,
    batch: int,
    cross_k: torch.Tensor,
    cross_v: torch.Tensor,
    dtype: torch.dtype,
    ctx: Optional[int] = None,
) -> KVCache:
    xk = cross_k.q if isinstance(cross_k, Int8Weight) else cross_k
    h, d = xk.shape[2], dims.n_text_state // dims.n_text_head  # a model shard's H / model heads
    shape = (dims.n_text_layer, batch, h, d, ctx or dims.n_text_ctx)
    device = xk.device
    return KVCache(
        self_k=torch.zeros(shape, dtype=dtype, device=device),
        self_v=torch.zeros(shape, dtype=dtype, device=device),
        cross_k=cross_k,
        cross_v=cross_v,
    )


# ---------------------------------------------------------------------------
# Parameter init
# ---------------------------------------------------------------------------


def init_params(
    dims: ModelDimensions,
    generator: torch.Generator,
    dtype: torch.dtype = torch.float32,
    device: Union[str, torch.device] = "cpu",
) -> Params:
    """Random parameters with the shapes and scales of the JAX package's
    ``init_params`` (normal(0, 0.02) weights, 0.01 for the positional
    embedding, zero biases, unit LayerNorm gains), drawn on ``device``
    from ``generator`` (which must live on that device)."""
    c, ca = dims.n_text_state, dims.n_audio_state

    def w(*shape, scale=0.02):
        x = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
        return (x * scale).to(dtype)

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=device)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    def blocks(n_layer, c):
        return {
            "attn_ln_g": ones(n_layer, c), "attn_ln_b": zeros(n_layer, c),
            "q_w": w(n_layer, c, c), "q_b": zeros(n_layer, c),
            "k_w": w(n_layer, c, c),
            "v_w": w(n_layer, c, c), "v_b": zeros(n_layer, c),
            "o_w": w(n_layer, c, c), "o_b": zeros(n_layer, c),
            "mlp_ln_g": ones(n_layer, c), "mlp_ln_b": zeros(n_layer, c),
            "fc1_w": w(n_layer, 4 * c, c), "fc1_b": zeros(n_layer, 4 * c),
            "fc2_w": w(n_layer, c, 4 * c), "fc2_b": zeros(n_layer, c),
        }

    n = dims.n_text_layer
    dec_blocks = blocks(n, c)
    dec_blocks.update(
        {
            "xattn_ln_g": ones(n, c), "xattn_ln_b": zeros(n, c),
            "xq_w": w(n, c, c), "xq_b": zeros(n, c),
            "xk_w": w(n, c, c),
            "xv_w": w(n, c, c), "xv_b": zeros(n, c),
            "xo_w": w(n, c, c), "xo_b": zeros(n, c),
        }
    )
    return {
        "encoder": {
            "conv1_w": w(ca, dims.n_mels, 3), "conv1_b": zeros(ca),
            "conv2_w": w(ca, ca, 3), "conv2_b": zeros(ca),
            "pos": torch.from_numpy(sinusoids(dims.n_audio_ctx, ca)).to(device, dtype),
            "blocks": blocks(dims.n_audio_layer, ca),
            "ln_post_g": ones(ca), "ln_post_b": zeros(ca),
        },
        "decoder": {
            "tok_emb": w(dims.n_vocab, c),
            "pos_emb": w(dims.n_text_ctx, c, scale=0.01),
            "blocks": dec_blocks,
            "ln_g": ones(c), "ln_b": zeros(c),
        },
    }


# ---------------------------------------------------------------------------
# Model object
# ---------------------------------------------------------------------------


class Whisper:
    """A model's dims and parameters with the reference's methods:
    ``embed_audio``, ``logits``, ``forward``, ``is_multilingual``,
    ``num_languages``, ``set_alignment_heads``; ``decode``,
    ``detect_language`` and ``transcribe`` are attached by the package."""

    def __init__(self, dims: ModelDimensions, params: Params):
        self.dims = dims
        self.params = params
        # default alignment heads: all heads of the upper half of the decoder
        mask = np.zeros((dims.n_text_layer, dims.n_text_head), dtype=bool)
        mask[dims.n_text_layer // 2 :] = True
        self.alignment_heads = np.stack(np.nonzero(mask), axis=1)  # (K, 2)

    def set_alignment_heads(self, dump: bytes):
        array = np.frombuffer(gzip.decompress(base64.b85decode(dump)), dtype=bool).copy()
        mask = array.reshape(self.dims.n_text_layer, self.dims.n_text_head)
        self.alignment_heads = np.stack(np.nonzero(mask), axis=1)

    @property
    def device(self) -> torch.device:
        return self.params["decoder"]["tok_emb"].device

    @property
    def dtype(self) -> torch.dtype:
        return self.params["decoder"]["tok_emb"].dtype

    @torch.inference_mode()
    def embed_audio(self, mel: torch.Tensor) -> torch.Tensor:
        single = mel.dim() == 2
        feats = encoder_apply(self.params, self.dims, (mel[None] if single else mel).to(self.device))
        return feats[0] if single else feats

    @torch.inference_mode()
    def logits(self, tokens: torch.Tensor, audio_features: torch.Tensor) -> torch.Tensor:
        return decoder_forward(self.params, self.dims, tokens.to(self.device), audio_features)

    def forward(self, mel: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
        return self.logits(tokens, self.embed_audio(mel))

    __call__ = forward

    @property
    def is_multilingual(self) -> bool:
        return self.dims.n_vocab >= 51865

    @property
    def num_languages(self) -> int:
        return self.dims.n_vocab - 51765 - int(self.is_multilingual)

    def num_parameters(self) -> int:
        def count(node):
            if isinstance(node, dict):
                return sum(count(v) for v in node.values())
            if isinstance(node, Int8Weight):
                return node.q.numel()
            return node.numel()

        return count(self.params)
