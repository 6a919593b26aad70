"""Weight-only int8 quantization, and int8 cross-attention K/V.

Counterpart of ``whisper_tpu/quantize.py``, with the same numerics: f32
absmax per output channel, scale ``max(absmax, 1e-12) / 127``, values
``round(w / scale)`` (half to even, as ``jnp.round``) clipped to +-127.

A quantized leaf is an :class:`Int8Weight` ``(q, s)``: ``q`` int8 in the
port's layout ``(..., out, in)``, ``s`` f32 ``(..., out, 1)``, so the absmax
runs over the last axis (whisper_tpu's axis -2, its layout being
``(..., in, out)``).  The cross-attention K/V keep whisper_tpu's shape,
``(..., D, T)`` with scales ``(..., D, 1)`` over time.  The optional int8
logits copy is ``decoder["logits_w"]``: q ``(V, C)``, s ``(V, 1)``, beside
the unchanged ``tok_emb``.  Embeddings, LayerNorms, biases and the encoder
convs stay in the compute dtype.

On a card the decode step reads the int8 values as they are (kernel K2's
int8 instances, :mod:`.ops.kernels.fused_step`), and so does the int8
logits projection; the products that whisper_tpu leaves to XLA (encoder,
cross K/V, prefill, teacher-forced pass) convert one layer's weight per
call (``models.whisper._linear``).
"""

from typing import Any, Dict, NamedTuple

import torch

# the weight leaves that carry the decode loop's bytes
_QUANT_KEYS = {
    "q_w", "k_w", "v_w", "o_w", "fc1_w", "fc2_w",
    "xq_w", "xk_w", "xv_w", "xo_w",
}


class Int8Weight(NamedTuple):
    """An int8 tensor with its f32 scales along its last axis:
    ``value ~ q * s``."""

    q: torch.Tensor  # int8 (..., out, in), or K/V (..., D, T)
    s: torch.Tensor  # f32 (..., out, 1)


def take_layer(leaf, i: int):
    """Layer i of a stacked (L, ...) leaf, quantized or not."""
    if isinstance(leaf, Int8Weight):
        return Int8Weight(leaf.q[i], leaf.s[i])
    return leaf[i]


def _quantize_last_axis(x: torch.Tensor) -> Int8Weight:
    x32 = x.float()
    absmax = x32.abs().amax(dim=-1, keepdim=True)
    scale = absmax.clamp(min=1e-12) / 127.0
    q = torch.round(x32 / scale).clamp(-127, 127).to(torch.int8)
    return Int8Weight(q, scale)


def quantize_weight(w: torch.Tensor) -> Int8Weight:
    """Symmetric per-output-channel int8 of a (..., out, in) weight:
    w ~ q * s."""
    return _quantize_last_axis(w)


def dequantize_weight(leaf: Int8Weight, dtype: torch.dtype) -> torch.Tensor:
    return (leaf.q.float() * leaf.s).to(dtype)


def is_quantized(leaf: Any) -> bool:
    return isinstance(leaf, Int8Weight)


def quantize_kv(x: torch.Tensor) -> Int8Weight:
    """Symmetric per-channel int8 of time-last K/V (..., D, T): one f32
    scale per (..., D) channel across time, shape (..., D, 1).  The cross
    K/V are computed once per segment, so this is a static quantization."""
    return _quantize_last_axis(x)


def quantize_params(
    params: Dict[str, Any],
    scopes=("encoder", "decoder"),
    *,
    logits: bool = False,
) -> Dict[str, Any]:
    """params with the matmul weights of the given scopes quantized (a new
    tree; the other leaves are shared).  ``logits=True`` also stores an int8
    copy of the tied token embedding, per vocabulary row, under
    ``decoder["logits_w"]``, which ``project_logits`` reads instead of
    ``tok_emb``; argmax ties can flip."""

    def walk(tree, in_scope):
        out = {}
        for key, value in tree.items():
            if isinstance(value, dict):
                out[key] = walk(value, in_scope or key in scopes)
            elif in_scope and key in _QUANT_KEYS and not is_quantized(value):
                out[key] = quantize_weight(value)
            else:
                out[key] = value
        return out

    out = walk(params, False)
    if logits:
        out["decoder"]["logits_w"] = _quantize_last_axis(params["decoder"]["tok_emb"])
    return out


def quantization_error(params: Dict[str, Any], quantized: Dict[str, Any]) -> float:
    """Max relative weight error across the quantized leaves (a sanity
    metric)."""
    worst = 0.0

    def walk(orig, quant):
        nonlocal worst
        for key, value in quant.items():
            if isinstance(value, dict):
                walk(orig[key], value)
            elif is_quantized(value) and key in orig:
                ref = orig[key].float()
                err = (dequantize_weight(value, torch.float32) - ref).abs().max()
                worst = max(worst, float(err / (ref.abs().max() + 1e-9)))

    walk(params, quantized)
    return worst
