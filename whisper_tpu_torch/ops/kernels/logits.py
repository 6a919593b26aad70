"""E2: the logits projection streamed over the vocabulary as a hand-written
Hopper kernel.

Replaces ``scripts/_logits_experiment.py:main``'s Pallas variants D
(``make_pallas_vc``, the (V, C) embedding) and E (``make_pallas_cv``, a
(C, V) copy): ``x . emb^T`` with f32 accumulation and an f32 output,
unrounded.  The kernels are ``whisper_tpu_torch/csrc/logits.cu`` (its
header says what bounds them and how they are laid out), one instance per
weight layout; :func:`logits_streamed_plain` is the same function in
PyTorch.  No model path calls it: the unquantized logits stay one bf16
``torch.mm`` with an f32 output, and the experiment
(:mod:`whisper_tpu_torch.experiments.logits`) times the two.
"""

import collections

import torch

from . import _lib

LAYOUTS = {"vc": 0, "cv": 1}  # the weight's layout: (V, C) or a (C, V) copy
SLAB = 32  # csrc/logits.cu SLAB: C is a multiple of it


def logits_streamed_plain(x: torch.Tensor, emb: torch.Tensor, layout: str = "vc") -> torch.Tensor:
    """x (B, C) . emb^T in f32, emb (V, C) ("vc") or (C, V) ("cv"):
    ``einsum("bc,vc->bv")`` / ``einsum("bc,cv->bv")`` with an f32 result."""
    if layout not in LAYOUTS:
        raise ValueError(f"logits: layout {layout!r}, one of {sorted(LAYOUTS)}")
    w = emb.float().t() if layout == "vc" else emb.float()
    return torch.matmul(x.float(), w)


def logits_streamed(x: torch.Tensor, emb: torch.Tensor, layout: str = "vc") -> torch.Tensor:
    """The logits (B, V) f32 of x (B, C) against emb (V, C) ("vc") or its
    (C, V) copy ("cv").  A CPU tensor takes :func:`logits_streamed_plain`;
    a CUDA tensor launches the kernel of that layout (bf16, contiguous, any
    B and V, C a multiple of 32) or raises."""
    if layout not in LAYOUTS:
        raise ValueError(f"logits: layout {layout!r}, one of {sorted(LAYOUTS)}")
    if x.device.type == "cpu":
        return logits_streamed_plain(x, emb, layout)
    if x.device.type != "cuda":
        raise ValueError(f"logits kernel: unsupported device {x.device}")
    _lib.refuse_grad("logits_streamed (E2)", x, emb)
    if x.dim() != 2 or emb.dim() != 2:
        raise ValueError(f"logits kernel: x (B, C) and a 2-d embedding, got {tuple(x.shape)}, "
                         f"{tuple(emb.shape)}")
    B, C = x.shape
    V = emb.shape[0] if layout == "vc" else emb.shape[1]
    if emb.shape[1 if layout == "vc" else 0] != C or C < SLAB or C % SLAB:
        raise ValueError(f"logits kernel: the embedding {tuple(emb.shape)} ({layout}) against C={C}, "
                         f"a multiple of {SLAB}")
    for t in (x, emb):
        if t.dtype != torch.bfloat16 or t.device != x.device or not t.is_contiguous():
            raise ValueError(f"logits kernel: x and the embedding contiguous bf16 on {x.device}")
        if t.data_ptr() % 16:
            raise ValueError("logits kernel: x and the embedding must start on a 16-byte boundary "
                             "(TMA and 16-byte copies)")
    out = torch.empty((B, V), dtype=torch.float32, device=x.device)
    err = _lib.lib().logits_streamed(
        LAYOUTS[layout], B, C, V, x.data_ptr(), emb.data_ptr(), out.data_ptr(),
        _lib.stream_ptr(x.device),
    )
    _lib.check(err, "logits_streamed")
    _lib.count_launch(logits_streamed, layout=layout)
    return out


logits_streamed.launches = 0
logits_streamed.launches_by_layout = collections.Counter()  # "vc" / "cv" -> launches
