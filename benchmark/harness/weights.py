"""Seeded random weights in the official Whisper checkpoint layout.

One ``torch.randn`` call on the device fills a buffer of every parameter
in the served dtype from a generator seeded with ``--seed``; each tensor of
the ``state_dict`` is a view of it, scaled in place by the rule of its
kind (the configuration's ``assumed.weights``).  The same seed gives the
same values, so the reference can make the state_dict again after the
window instead of holding it on the card.
"""

from typing import Dict, List, Tuple

import torch


def layout(dims: Dict[str, int]) -> List[Tuple[str, Tuple[int, ...]]]:
    """(key, shape) of every tensor of an official checkpoint's
    ``model_state_dict`` (openai/whisper model.py)."""
    out = []
    C, M, L = dims["n_audio_state"], dims["n_mels"], dims["n_audio_layer"]
    out += [("encoder.conv1.weight", (C, M, 3)), ("encoder.conv1.bias", (C,)),
            ("encoder.conv2.weight", (C, C, 3)), ("encoder.conv2.bias", (C,)),
            ("encoder.positional_embedding", (dims["n_audio_ctx"], C))]

    def block(prefix, C, cross):
        parts = [("attn", "attn_ln")] + ([("cross_attn", "cross_attn_ln")] if cross else [])
        rows = []
        for attn, ln in parts:
            rows += [(f"{prefix}.{attn}.query.weight", (C, C)), (f"{prefix}.{attn}.query.bias", (C,)),
                     (f"{prefix}.{attn}.key.weight", (C, C)),
                     (f"{prefix}.{attn}.value.weight", (C, C)), (f"{prefix}.{attn}.value.bias", (C,)),
                     (f"{prefix}.{attn}.out.weight", (C, C)), (f"{prefix}.{attn}.out.bias", (C,)),
                     (f"{prefix}.{ln}.weight", (C,)), (f"{prefix}.{ln}.bias", (C,))]
        rows += [(f"{prefix}.mlp.0.weight", (4 * C, C)), (f"{prefix}.mlp.0.bias", (4 * C,)),
                 (f"{prefix}.mlp.2.weight", (C, 4 * C)), (f"{prefix}.mlp.2.bias", (C,)),
                 (f"{prefix}.mlp_ln.weight", (C,)), (f"{prefix}.mlp_ln.bias", (C,))]
        return rows

    for i in range(L):
        out += block(f"encoder.blocks.{i}", C, cross=False)
    out += [("encoder.ln_post.weight", (C,)), ("encoder.ln_post.bias", (C,))]
    C = dims["n_text_state"]
    out += [("decoder.token_embedding.weight", (dims["n_vocab"], C)),
            ("decoder.positional_embedding", (dims["n_text_ctx"], C))]
    for i in range(dims["n_text_layer"]):
        out += block(f"decoder.blocks.{i}", C, cross=True)
    out += [("decoder.ln.weight", (C,)), ("decoder.ln.bias", (C,))]
    return out


def _sinusoids(length: int, channels: int, device) -> torch.Tensor:
    increment = torch.log(torch.tensor(10000.0)) / (channels // 2 - 1)
    inv = torch.exp(-increment * torch.arange(channels // 2, dtype=torch.float32, device=device))
    t = torch.arange(length, dtype=torch.float32, device=device)[:, None] * inv[None, :]
    return torch.cat([torch.sin(t), torch.cos(t)], dim=1)


def make_state_dict(dims: Dict[str, int], rules: Dict[str, float], seed: int,
                    dtype: torch.dtype, device) -> Dict[str, torch.Tensor]:
    """The seeded official-layout state_dict.  ``rules``: "linear_gain"
    (a weight of fan-in n has standard deviation gain / sqrt(n)), "bias",
    "ln_gain_noise" and "ln_bias" (standard deviations; a LayerNorm's gain is
    1 plus its noise), "logit_std" (the token embedding's standard
    deviation times sqrt(width): the logits' standard deviation over unit
    hidden states), "positional_embedding" (a standard deviation),
    "timestamp_rows" (the factor on the token embedding's timestamp rows),
    and "timestamp_begin" (their first id)."""
    shapes = layout(dims)
    sizes = [torch.Size(s).numel() for _, s in shapes]
    gen = torch.Generator(device=device).manual_seed(seed % 2**63)
    flat = torch.randn(sum(sizes), generator=gen, dtype=dtype, device=device)
    out, at = {}, 0
    for (key, shape), n in zip(shapes, sizes):
        t = flat[at : at + n].view(shape)
        at += n
        if key == "encoder.positional_embedding":
            t.copy_(_sinusoids(*shape, device=device))
        elif key == "decoder.token_embedding.weight":
            t.mul_(rules["logit_std"] / shape[1] ** 0.5)
            t[rules["timestamp_begin"]:].mul_(rules["timestamp_rows"])
        elif key == "decoder.positional_embedding":
            t.mul_(rules["positional_embedding"])
        elif "_ln." in key or key.endswith(("ln_post.weight", "ln_post.bias", "decoder.ln.weight",
                                             "decoder.ln.bias")):
            if key.endswith(".weight"):
                t.mul_(rules["ln_gain_noise"]).add_(1.0)
            else:
                t.mul_(rules["ln_bias"])
        elif key.endswith(".bias"):
            t.mul_(rules["bias"])
        else:
            fan_in = shape[1] * (shape[2] if len(shape) == 3 else 1)
            t.mul_(rules["linear_gain"] / fan_in ** 0.5)
        out[key] = t
    return out
