"""Checkpoint loading: official torch ``.pt`` files and the JAX package's
flat ``.npz`` into the port's parameter dict.

Counterpart of ``whisper_tpu/models/load.py``.  The port keeps torch's
layouts (linear (out, in), convolution (out, in, k)), so a reference
checkpoint only needs its per-layer tensors stacked, while the JAX
package's tree (linear (in, out), convolution (k, in, out)) is transposed.
Its int8 leaves (``whisper_tpu.quantize``, ``{"q", "s"}``) become
:class:`~whisper_tpu_torch.quantize.Int8Weight` in the port's layout.
"""

import io
from typing import Any, Dict, Tuple, Union

import numpy as np
import torch

from ..quantize import Int8Weight
from .dims import ModelDimensions
from .whisper import Params, sinusoids

_LINEAR = {
    "q_w", "k_w", "v_w", "o_w", "fc1_w", "fc2_w", "xq_w", "xk_w", "xv_w", "xo_w",
}


def _unflatten(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for key, v in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def params_from_numpy(
    tree: Dict[str, Any],
    dims: ModelDimensions,
    dtype: torch.dtype = torch.float32,
    device: Union[str, torch.device] = "cpu",
) -> Params:
    """The JAX package's parameter tree, as numpy arrays, in the port's
    layout and dtype on ``device``.  An int8 leaf ``{"q": (..., in, out),
    "s": (..., 1, out)}`` keeps its storage types, int8 and f32, as
    whisper_tpu's reload does, as (..., out, in) and (..., out, 1); the
    int8 logits copy ``logits_w`` is (V, C) and (V, 1) in both packages."""
    def int8_leaf(name: str, a: Dict[str, Any]) -> Int8Weight:
        q, s = np.array(a["q"], dtype=np.int8), np.array(a["s"], dtype=np.float32)
        if name != "logits_w":
            q, s = np.swapaxes(q, -1, -2), np.swapaxes(s, -1, -2)
        return Int8Weight(
            torch.from_numpy(np.ascontiguousarray(q)).to(device),
            torch.from_numpy(np.ascontiguousarray(s)).to(device),
        )

    def leaf(name: str, a):
        if isinstance(a, dict) and set(a) == {"q", "s"}:
            return int8_leaf(name, a)
        a = np.array(a, dtype=np.float32)  # a writable copy
        if name in _LINEAR:
            a = np.swapaxes(a, -1, -2)
        elif name in ("conv1_w", "conv2_w"):
            a = a.transpose(2, 1, 0)
        return torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=dtype)

    def walk(node: Dict[str, Any]) -> Dict[str, Any]:
        return {
            k: walk(v) if isinstance(v, dict) and k in ("encoder", "decoder", "blocks")
            else leaf(k, v)
            for k, v in node.items()
        }

    params = walk(tree)
    if params["encoder"]["conv1_w"].shape[1] != dims.n_mels:
        raise ValueError("parameter tree does not match the model dimensions")
    return params


def load_npz(
    path: str, dtype: torch.dtype = torch.float32, device: Union[str, torch.device] = "cpu"
) -> Tuple[Params, ModelDimensions]:
    """Load the flat ``.npz`` written by ``whisper_tpu.models.load.save_npz``."""
    flat, dims_kw = {}, {}
    with np.load(path) as f:
        for key in f.files:
            if key.startswith("__dims__/"):
                dims_kw[key.split("/", 1)[1]] = int(f[key])
            else:
                flat[key] = f[key]
    dims = ModelDimensions(**dims_kw)
    return params_from_numpy(_unflatten(flat), dims, dtype, device), dims


def _stack_blocks(sd: Dict[str, Any], prefix: str, n_layer: int, cross: bool) -> Dict[str, Any]:
    names = {
        "attn_ln_g": "attn_ln.weight", "attn_ln_b": "attn_ln.bias",
        "q_w": "attn.query.weight", "q_b": "attn.query.bias",
        "k_w": "attn.key.weight",
        "v_w": "attn.value.weight", "v_b": "attn.value.bias",
        "o_w": "attn.out.weight", "o_b": "attn.out.bias",
        "mlp_ln_g": "mlp_ln.weight", "mlp_ln_b": "mlp_ln.bias",
        "fc1_w": "mlp.0.weight", "fc1_b": "mlp.0.bias",
        "fc2_w": "mlp.2.weight", "fc2_b": "mlp.2.bias",
    }
    if cross:
        names.update({
            "xattn_ln_g": "cross_attn_ln.weight", "xattn_ln_b": "cross_attn_ln.bias",
            "xq_w": "cross_attn.query.weight", "xq_b": "cross_attn.query.bias",
            "xk_w": "cross_attn.key.weight",
            "xv_w": "cross_attn.value.weight", "xv_b": "cross_attn.value.bias",
            "xo_w": "cross_attn.out.weight", "xo_b": "cross_attn.out.bias",
        })
    return {
        k: torch.stack([sd[f"{prefix}.{i}.{name}"] for i in range(n_layer)])
        for k, name in names.items()
    }


def convert_torch_state_dict(
    state_dict: Dict[str, Any],
    dims: ModelDimensions,
    dtype: torch.dtype = torch.float32,
    device: Union[str, torch.device] = "cpu",
) -> Params:
    """A reference-format state_dict (reference whisper/model.py:174-249)
    in the port's parameter dict; weights keep torch's layouts."""
    sd = {k: v.detach() for k, v in state_dict.items()}
    params = {
        "encoder": {
            "conv1_w": sd["encoder.conv1.weight"],
            "conv1_b": sd["encoder.conv1.bias"],
            "conv2_w": sd["encoder.conv2.weight"],
            "conv2_b": sd["encoder.conv2.bias"],
            "pos": torch.from_numpy(sinusoids(dims.n_audio_ctx, dims.n_audio_state)),
            "blocks": _stack_blocks(sd, "encoder.blocks", dims.n_audio_layer, cross=False),
            "ln_post_g": sd["encoder.ln_post.weight"],
            "ln_post_b": sd["encoder.ln_post.bias"],
        },
        "decoder": {
            "tok_emb": sd["decoder.token_embedding.weight"],
            "pos_emb": sd["decoder.positional_embedding"],
            "blocks": _stack_blocks(sd, "decoder.blocks", dims.n_text_layer, cross=True),
            "ln_g": sd["decoder.ln.weight"],
            "ln_b": sd["decoder.ln.bias"],
        },
    }

    def cast(node):
        if isinstance(node, dict):
            return {k: cast(v) for k, v in node.items()}
        return node.to(device=device, dtype=dtype).contiguous()

    return cast(params)


def load_torch_checkpoint(
    path_or_bytes: Union[str, bytes],
    dtype: torch.dtype = torch.float32,
    device: Union[str, torch.device] = "cpu",
) -> Tuple[Params, ModelDimensions]:
    """Load a reference-format ``.pt`` checkpoint."""
    fp = io.BytesIO(path_or_bytes) if isinstance(path_or_bytes, bytes) else open(
        path_or_bytes, "rb"
    )
    with fp:
        checkpoint = torch.load(fp, map_location="cpu", weights_only=True)
    dims = ModelDimensions(**checkpoint["dims"])
    params = convert_torch_state_dict(checkpoint["model_state_dict"], dims, dtype, device)
    return params, dims
