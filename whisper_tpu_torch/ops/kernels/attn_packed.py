"""E3: the two-heads-packing experiment's kernels, hand-written for Hopper.

Replaces ``scripts/_attn_packed_experiment.py:main``'s Pallas kernels
``kernel_unpacked`` and ``kernel_packed``: per program, ``reps`` dependent
iterations of score + PV with no softmax.  Each iteration takes ``qq = q +
bf16(acc) * 1e-9`` in bf16, f32 scores ``qq . k^T``, cast to bf16, times V
in f32, and ``acc += o * 1e-9`` in f32; the output is ``bf16(acc)``.
Unpacked: q (g, Q, 2D) holds two heads side by side, each with its own K/V
(g, T, D).  Packed: one (g, 2T, 2D) K/V pair, block-diagonal in the
experiment, multiplied densely (zero blocks too).  The kernels are
``whisper_tpu_torch/csrc/attn_packed.cu`` (its header says what bounds
them and how they are laid out: a thread-block cluster holds a head's, or
a packed program's, K/V in shared memory for every rep, so T is at most
``MAX_KEYS``); :func:`attn_pairs_unpacked_plain` and
:func:`attn_pairs_packed_plain` are the same functions in PyTorch.  No
model path calls them: the experiment
(:mod:`whisper_tpu_torch.experiments.attn_packed`) times the two.
"""

import torch

from . import _lib

HEAD_DIM = 64  # the unpacked heads' D; packed, 2D = 128
# the keys a cluster of 16 blocks holds (384 or 192 a block): T unpacked,
# the packed operands' 2T
MAX_KEYS = {0: 6144, 1: 3072}


def _eps() -> torch.Tensor:
    """1e-9 as the bf16 constant the script's ``bf16 * 1e-9`` multiplies by."""
    return torch.tensor(1e-9, dtype=torch.bfloat16)


def _rep(q: torch.Tensor, acc: torch.Tensor, pairs) -> torch.Tensor:
    """One iteration for every program: acc (g, Q, 2D) f32 plus 1e-9 times
    the pairs' outputs, pairs [(columns, k, v)] reading q's and acc's
    columns."""
    eps = _eps().to(q.device)
    outs = []
    for cols, k, v in pairs:
        qq = q[..., cols] + acc[..., cols].to(q.dtype) * eps
        s = torch.matmul(qq.float(), k.float().transpose(-1, -2))
        outs.append(torch.matmul(s.to(q.dtype).float(), v.float()))
    return acc + torch.cat(outs, dim=-1) * 1e-9


def attn_pairs_unpacked_plain(q2, k1, v1, k2, v2, reps: int) -> torch.Tensor:
    """``kernel_unpacked`` in PyTorch: q2 (g, Q, 2D), k1, v1, k2, v2 (g, T,
    D) -> (g, Q, 2D) bf16."""
    D = k1.shape[-1]
    acc = torch.zeros(q2.shape, dtype=torch.float32, device=q2.device)
    pairs = [(slice(0, D), k1, v1), (slice(D, 2 * D), k2, v2)]
    for _ in range(reps):
        acc = _rep(q2, acc, pairs)
    return acc.to(q2.dtype)


def attn_pairs_packed_plain(q2, kp, vp, reps: int) -> torch.Tensor:
    """``kernel_packed`` in PyTorch: q2 (g, Q, 2D), kp, vp (g, 2T, 2D) ->
    (g, Q, 2D) bf16."""
    acc = torch.zeros(q2.shape, dtype=torch.float32, device=q2.device)
    for _ in range(reps):
        acc = _rep(q2, acc, [(slice(None), kp, vp)])
    return acc.to(q2.dtype)


def _launch(wrapper, packed: int, q2, ks, reps: int) -> torch.Tensor:
    if q2.device.type != "cuda":
        raise ValueError(f"attn_pairs kernel: unsupported device {q2.device}")
    _lib.refuse_grad("attn_pairs (E3)", q2, ks)
    if q2.dim() != 3 or q2.shape[-1] != 2 * HEAD_DIM or reps < 0:
        raise ValueError(f"attn_pairs kernel: q (g, Q, {2 * HEAD_DIM}) and reps >= 0, got "
                         f"{tuple(q2.shape)}, {reps}")
    g, Q, _ = q2.shape
    D = 2 * HEAD_DIM if packed else HEAD_DIM
    T = ks[0].shape[1]
    for t in (q2, *ks):
        if t.dtype != torch.bfloat16 or t.device != q2.device or not t.is_contiguous():
            raise ValueError(f"attn_pairs kernel: contiguous bf16 tensors on {q2.device}")
    if any(tuple(t.shape) != (g, T, D) for t in ks):
        raise ValueError(f"attn_pairs kernel: K/V ({g}, T, {D}) each, got "
                         f"{[tuple(t.shape) for t in ks]}")
    if T > MAX_KEYS[packed]:
        raise ValueError(f"attn_pairs kernel: at most {MAX_KEYS[packed]} keys (a cluster's shared "
                         f"memory), got {T}")
    if any(t.data_ptr() % 16 for t in (q2, *ks)):
        raise ValueError("attn_pairs kernel: every tensor must start on a 16-byte boundary (TMA)")
    out = torch.empty_like(q2)
    ptrs = [t.data_ptr() for t in ks] + [None] * (4 - len(ks))
    err = _lib.lib().attn_pairs(
        packed, g, Q, T, reps, float(_eps()), q2.data_ptr(), *ptrs, out.data_ptr(),
        _lib.stream_ptr(q2.device),
    )
    _lib.check(err, "attn_pairs")
    _lib.count_launch(wrapper)
    return out


def attn_pairs_unpacked(q2, k1, v1, k2, v2, reps: int) -> torch.Tensor:
    """Two (Q, T, 64) score + PV pairs per program, ``reps`` times.  A CPU
    tensor takes :func:`attn_pairs_unpacked_plain`; a CUDA tensor launches
    the kernel (bf16, contiguous, 16-byte aligned, D = 64, T <= 6144) or
    raises."""
    if q2.device.type == "cpu":
        return attn_pairs_unpacked_plain(q2, k1, v1, k2, v2, reps)
    return _launch(attn_pairs_unpacked, 0, q2, (k1, v1, k2, v2), reps)


def attn_pairs_packed(q2, kp, vp, reps: int) -> torch.Tensor:
    """One (Q, 2T, 128) score + PV pair per program, ``reps`` times, dense
    over whatever kp, vp hold.  A CPU tensor takes
    :func:`attn_pairs_packed_plain`; a CUDA tensor launches the kernel
    (bf16, contiguous, 16-byte aligned, 2T <= 3072) or raises."""
    if q2.device.type == "cpu":
        return attn_pairs_packed_plain(q2, kp, vp, reps)
    return _launch(attn_pairs_packed, 1, q2, (kp, vp), reps)


attn_pairs_unpacked.launches = 0
attn_pairs_packed.launches = 0
