"""The Whisper encoder-decoder Transformer as functions on tensors.

Counterpart of ``whisper_tpu/models/whisper.py``.  Parameters are a dict
with the JAX package's keys, per-layer weights stacked on a leading layer
axis, but in torch's layouts: linear weights (L, out, in) and convolution
weights (out, in, k), as in the reference checkpoints.  LayerNorm statistics,
attention scores and logits are f32 whatever the compute dtype.  The KV
cache is (L, B, H, D, T), time last, as in the JAX package; the decode
step's attention kernel reads it with threads along T.
"""

import base64
import gzip
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


def layer_norm(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """LayerNorm with float32 statistics, output cast back to input dtype."""
    orig_dtype = x.dtype
    x = x.float()
    mean = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, correction=0)
    x = (x - mean) * torch.rsqrt(var + 1e-5)
    x = x * g.float() + b.float()
    return x.to(orig_dtype)


def _linear(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x @ w.T, rounded to x's dtype, then + b (rounded again), as the JAX
    package's einsum-then-bias."""
    y = F.linear(x, w)
    if b is not None:
        y = y + b
    return y


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x)  # exact erf form


def _layer(blocks: Params, i: int) -> Params:
    """Layer i's parameters out of the stacked blocks."""
    return {k: v[i] for k, v in blocks.items()}


class KVCache(NamedTuple):
    """Decoder cache, time last.

    self_k/self_v: (L, B, H, D, T) — autoregressive self-attention, written
    in place one column per step.  cross_k/cross_v: (L, A, H, D, Ta) —
    computed once per segment (A = 1 audio in this slice).
    """

    self_k: torch.Tensor
    self_v: torch.Tensor
    cross_k: torch.Tensor
    cross_v: torch.Tensor


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------


def _encoder_block(x: torch.Tensor, p: Params, n_head: int) -> torch.Tensor:
    """Pre-LN self-attention block (reference model.py:142-171, no cross-attn)."""
    h = layer_norm(x, p["attn_ln_g"], p["attn_ln_b"])
    q = split_heads(_linear(h, p["q_w"], p["q_b"]), n_head).contiguous()
    k = split_heads(_linear(h, p["k_w"]), n_head).contiguous()
    v = split_heads(_linear(h, p["v_w"], p["v_b"]), n_head).contiguous()
    attn = encoder_attention(q, k, v)
    x = x + _linear(merge_heads(attn), p["o_w"], p["o_b"])

    h = layer_norm(x, p["mlp_ln_g"], p["mlp_ln_b"])
    h = _gelu(_linear(h, p["fc1_w"], p["fc1_b"]))
    return x + _linear(h, p["fc2_w"], p["fc2_b"])


def encoder_apply(params: Params, dims: ModelDimensions, mel: torch.Tensor) -> torch.Tensor:
    """mel (B, n_mels, 3000) -> audio features (B, n_audio_ctx, n_audio_state).

    Two stride-1/stride-2 convs + GELU, sinusoidal positions, N pre-LN
    blocks, final LayerNorm (reference model.py:188-204).
    """
    enc = params["encoder"]
    dtype = enc["conv1_w"].dtype
    x = mel.to(dtype)
    x = _gelu(F.conv1d(x, enc["conv1_w"], padding=1) + enc["conv1_b"][:, None])
    x = _gelu(F.conv1d(x, enc["conv2_w"], stride=2, padding=1) + enc["conv2_b"][:, None])
    x = x.transpose(1, 2)  # (B, T, C), feature-last

    assert x.shape[1] == dims.n_audio_ctx, "incorrect audio shape"
    x = x + enc["pos"]
    for i in range(dims.n_audio_layer):
        x = _encoder_block(x, _layer(enc["blocks"], i), dims.n_audio_head)
    return layer_norm(x, enc["ln_post_g"], enc["ln_post_b"])


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------


def compute_cross_kv(
    params: Params, dims: ModelDimensions, audio_features: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-layer cross-attention K/V from encoder output: (L, B, H, D, Ta),
    computed once per segment and reused by every decode step."""
    blocks = params["decoder"]["blocks"]
    h = dims.n_text_head
    ks, vs = [], []
    for i in range(dims.n_text_layer):
        ks.append(split_heads(_linear(audio_features, blocks["xk_w"][i]), h).transpose(-1, -2))
        vs.append(
            split_heads(
                _linear(audio_features, blocks["xv_w"][i], blocks["xv_b"][i]), h
            ).transpose(-1, -2)
        )
    return torch.stack(ks), torch.stack(vs)


def _decoder_block(
    x: torch.Tensor,
    p: Params,
    n_head: int,
    self_k: torch.Tensor,
    self_v: torch.Tensor,
    cross_k_t: torch.Tensor,  # (B, H, D, Ta) — time-last, see KVCache
    cross_v_t: torch.Tensor,
    self_mask: Optional[torch.Tensor],
) -> torch.Tensor:
    """One decoder block given its self-attention K/V for the query
    positions (computed by the caller, which also keeps them)."""
    h = layer_norm(x, p["attn_ln_g"], p["attn_ln_b"])
    q = split_heads(_linear(h, p["q_w"], p["q_b"]), n_head)
    attn, _ = qkv_attention(q, self_k, self_v, self_mask)
    x = x + _linear(merge_heads(attn), p["o_w"], p["o_b"])

    h = layer_norm(x, p["xattn_ln_g"], p["xattn_ln_b"])
    xq = split_heads(_linear(h, p["xq_w"], p["xq_b"]), n_head)
    xattn = qkv_attention_kt(xq, cross_k_t, cross_v_t)
    x = x + _linear(merge_heads(xattn), p["xo_w"], p["xo_b"])

    h = layer_norm(x, p["mlp_ln_g"], p["mlp_ln_b"])
    h = _gelu(_linear(h, p["fc1_w"], p["fc1_b"]))
    return x + _linear(h, p["fc2_w"], p["fc2_b"])


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
    n_head = dims.n_text_head
    _, P = tokens.shape
    x = _embed_tokens(dec, tokens, P)
    causal = _causal_mask(P, x.device)
    ks, vs = [], []
    for i in range(dims.n_text_layer):
        p = _layer(dec["blocks"], i)
        h = layer_norm(x, p["attn_ln_g"], p["attn_ln_b"])
        k = split_heads(_linear(h, p["k_w"]), n_head)
        v = split_heads(_linear(h, p["v_w"], p["v_b"]), n_head)
        x = _decoder_block(x, p, n_head, k, v, cross_k[i], cross_v[i], causal)
        ks.append(k)
        vs.append(v)
    x = layer_norm(x, dec["ln_g"], dec["ln_b"])
    return x, torch.stack(ks), torch.stack(vs)


def _embed_step(params: Params, dims: ModelDimensions, tokens: torch.Tensor, t: int) -> torch.Tensor:
    dec = params["decoder"]
    return dec["tok_emb"][tokens] + dec["pos_emb"][min(max(t, 0), dims.n_text_ctx - 1)]


def _write_kv_column(cache: KVCache, k_new: torch.Tensor, v_new: torch.Tensor, t: int) -> None:
    """Write one step's K/V, (L, B, C), into cache column t, in place.

    The JAX package rewrites the whole cache through a mask because XLA
    cannot update it in place cheaply; here the column is written directly.
    A position past the cache's capacity is dropped, as there.
    """
    L, B, H, D, n_ctx = cache.self_k.shape
    if 0 <= t < n_ctx:
        cache.self_k[..., t] = k_new.view(L, B, H, D)
        cache.self_v[..., t] = v_new.view(L, B, H, D)


def _step(
    layers, params: Params, dims: ModelDimensions, tokens: torch.Tensor, t: int, cache: KVCache
) -> Tuple[torch.Tensor, KVCache]:
    dec = params["decoder"]
    x = _embed_step(params, dims, tokens, t)
    hidden, k_new, v_new = layers(
        dec["blocks"], dims.n_text_head, x, min(t, cache.self_k.shape[-1]),
        cache.self_k, cache.self_v, cache.cross_k, cache.cross_v,
    )
    _write_kv_column(cache, k_new, v_new, t)
    return layer_norm(hidden, dec["ln_g"], dec["ln_b"]), cache


def decoder_step(
    params: Params,
    dims: ModelDimensions,
    tokens: torch.Tensor,  # (B,) — the tokens at position t
    t: int,  # position of this step, shared by the rows
    cache: KVCache,
) -> Tuple[torch.Tensor, KVCache]:
    """One autoregressive decode step at position t, the plain reference.

    Attends over cache positions < t plus the new token, writes this step's
    K/V into column t of the cache, and returns the hidden state (B, C)
    after the final LayerNorm.  A position past the cache's capacity
    attends the whole cache and its write is dropped, as in the JAX step.
    The layers run through the plain version of kernel K2 on any device.
    """
    from ..ops.kernels.fused_step import fused_decoder_layers_plain

    return _step(fused_decoder_layers_plain, params, dims, tokens, t, cache)


def decoder_step_fused(
    params: Params,
    dims: ModelDimensions,
    tokens: torch.Tensor,  # (B,)
    t: int,
    cache: KVCache,
) -> Tuple[torch.Tensor, KVCache]:
    """:func:`decoder_step` with the layers through kernel K2
    (:mod:`..ops.kernels.fused_step`): on a CUDA tensor one host call queues
    every layer's kernels; on a CPU tensor the wrapper takes the plain
    version."""
    from ..ops.kernels.fused_step import fused_decoder_layers

    return _step(fused_decoder_layers, params, dims, tokens, t, cache)


def project_logits(params: Params, hidden: torch.Tensor) -> torch.Tensor:
    """hidden (..., C) -> float32 logits (..., n_vocab) (tied embeddings).

    The products are of compute-dtype values and the logits stay f32,
    unrounded, as the JAX package's ``preferred_element_type=float32``.
    """
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
) -> torch.Tensor:
    """Full teacher-forced decoder pass: float32 logits (B, T, n_vocab).
    (Alignment-head QK capture comes with word timestamps.)"""
    dec = params["decoder"]
    n_head = dims.n_text_head
    _, T = tokens.shape
    cross_k, cross_v = compute_cross_kv(params, dims, audio_features)
    x = _embed_tokens(dec, tokens, T)
    causal = _causal_mask(T, x.device)
    for i in range(dims.n_text_layer):
        p = _layer(dec["blocks"], i)
        h = layer_norm(x, p["attn_ln_g"], p["attn_ln_b"])
        k = split_heads(_linear(h, p["k_w"]), n_head)
        v = split_heads(_linear(h, p["v_w"], p["v_b"]), n_head)
        x = _decoder_block(x, p, n_head, k, v, cross_k[i], cross_v[i], causal)
    x = layer_norm(x, dec["ln_g"], dec["ln_b"])
    return project_logits(params, x)


def init_kv_cache(
    dims: ModelDimensions,
    batch: int,
    cross_k: torch.Tensor,
    cross_v: torch.Tensor,
    dtype: torch.dtype,
    ctx: Optional[int] = None,
) -> KVCache:
    h, d = dims.n_text_head, dims.n_text_state // dims.n_text_head
    shape = (dims.n_text_layer, batch, h, d, ctx or dims.n_text_ctx)
    return KVCache(
        self_k=torch.zeros(shape, dtype=dtype, device=cross_k.device),
        self_v=torch.zeros(shape, dtype=dtype, device=cross_k.device),
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
            return node.numel()

        return count(self.params)
