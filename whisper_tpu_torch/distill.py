"""Draft-decoder distillation for speculative decoding.

Counterpart of ``whisper_tpu/distill.py`` (the distil-whisper recipe,
arXiv:2311.00430), with its public names.  Speculative decoding
(``decode(..., draft_model=)``) stays token-exact with plain greedy whatever
the draft, so a draft buys only acceptance, and the best acceptance per
operation comes from a draft distilled from the target itself:

- the student keeps the teacher's encoder, frozen and shared (at decode
  time one encoder pass serves both models),
- keeps the teacher's width (its cross-attention reads the shared features
  as they are) and cuts the decoder's depth,
- its decoder blocks start from evenly spaced teacher layers (the first
  and the last always among them),
- and it trains on KL(teacher ‖ student) over the teacher's teacher-forced
  next-token distributions on the teacher's own greedy transcripts
  (pseudo-labels), optionally with hard-label cross entropy.

The student's decoder is a dict of new leaf tensors in the teacher's
stacked layout; the step is :func:`~.training.optimizer_step` on them.  The
frozen encoder's pass on a mel batch runs under ``torch.no_grad()``, so on
the card it launches kernel K1.
"""

import dataclasses
from typing import Any, Dict, Iterable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .models.dims import ModelDimensions
from .quantize import Int8Weight
from .training import (
    _local_rows,
    _masked_mean,
    _usable,
    decoder_apply_train,
    make_optimizer,
    optimizer_step,
)

__all__ = [
    "make_draft_dims",
    "init_draft_from_teacher",
    "distill_loss",
    "distill_step",
    "DistillState",
    "distill",
    "offline_acceptance",
]


def make_draft_dims(teacher_dims: ModelDimensions, n_text_layer: int) -> ModelDimensions:
    """Student hyperparameters: the teacher with a shallower decoder.

    Width, heads and vocabulary are kept, so that the shared encoder
    features feed the student's cross-attention unchanged and
    ``DecodingTask``'s vocabulary check accepts the pair.
    """
    if not 1 <= n_text_layer <= teacher_dims.n_text_layer:
        raise ValueError(
            f"draft depth must be in [1, {teacher_dims.n_text_layer}], got {n_text_layer}"
        )
    return dataclasses.replace(teacher_dims, n_text_layer=n_text_layer)


def _leaf(x, index: Optional[torch.Tensor] = None):
    """A new leaf tensor from a teacher leaf (layers ``index`` of a stacked
    one, else a copy of the whole); an int8 leaf field by field."""
    if isinstance(x, Int8Weight):
        return Int8Weight(_leaf(x.q, index), _leaf(x.s, index))
    x = x.detach()
    return x[index.to(x.device)] if index is not None else x.clone()


def init_draft_from_teacher(
    teacher_params, teacher_dims: ModelDimensions, n_text_layer: int = 2
) -> Tuple[Any, ModelDimensions]:
    """Student params: the teacher's embeddings and final LayerNorm and
    its decoder blocks at ``round(linspace(0, L - 1, n))`` (the first and
    last teacher layers always included: the distil-whisper
    initialization), the encoder shared by reference.

    Every student decoder leaf is a new tensor: the embeddings and final
    LayerNorm are copies, never aliases, since the optimizer updates the
    student's leaves in place and must leave the teacher's as they are.
    """
    draft_dims = make_draft_dims(teacher_dims, n_text_layer)
    L = teacher_dims.n_text_layer
    idx = torch.from_numpy(np.round(np.linspace(0, L - 1, n_text_layer)).astype(np.int64))
    dec = teacher_params["decoder"]
    draft_decoder = {k: _leaf(v) for k, v in dec.items() if k != "blocks"}
    draft_decoder["blocks"] = {k: _leaf(v, idx) for k, v in dec["blocks"].items()}
    return {
        "encoder": teacher_params["encoder"],  # frozen, shared at decode
        "decoder": draft_decoder,
    }, draft_dims


def distill_loss(
    student_decoder,
    teacher_params,
    student_dims: ModelDimensions,
    teacher_dims: ModelDimensions,
    batch: Dict[str, torch.Tensor],
    ce_weight: float = 0.0,
) -> torch.Tensor:
    """KL(teacher ‖ student) on next-token distributions (+ optional CE).

    batch = {features (B, T, A) from the shared encoder, tokens (B, S)
    integer, loss_mask (B, S)}.  Teacher-forced; position i is scored on
    predicting token i + 1, masked as ``training.loss_fn``.  The teacher
    runs under ``torch.no_grad()``: only the student decoder takes
    gradients.  Under a mesh each data group scores its rows of the global
    batch, as ``training.loss_fn``.
    """
    batch = _local_rows(batch)
    feats, tokens = _usable(batch["features"]), _usable(batch["tokens"]).long()
    s_logits = decoder_apply_train({"decoder": student_decoder}, student_dims, tokens, feats)
    with torch.no_grad():
        t_logits = decoder_apply_train(teacher_params, teacher_dims, tokens, feats)
    s_lp = torch.log_softmax(s_logits[:, :-1].float(), dim=-1)
    t_lp = torch.log_softmax(t_logits[:, :-1].float(), dim=-1)
    kl = (t_lp.exp() * (t_lp - s_lp)).sum(dim=-1)  # (B, S - 1)
    loss = _masked_mean(kl, batch["loss_mask"])
    if ce_weight:
        nll = -s_lp.gather(-1, tokens[:, 1:, None])[..., 0]
        loss = loss + ce_weight * _masked_mean(nll, batch["loss_mask"])
    return loss


class DistillState(NamedTuple):
    decoder: Any  # student decoder params (the only trainables)
    opt_state: Any  # the torch.optim.AdamW over them
    step: int


def distill_step(
    state: DistillState,
    teacher_params,
    student_dims: ModelDimensions,
    teacher_dims: ModelDimensions,
    optimizer,
    batch: Dict[str, torch.Tensor],
    ce_weight: float = 0.0,
) -> Tuple[DistillState, Dict[str, torch.Tensor]]:
    """One optimization step on the student decoder, in place."""
    loss, g_norm = optimizer_step(optimizer, state.opt_state, lambda: distill_loss(
        state.decoder, teacher_params, student_dims, teacher_dims, batch, ce_weight))
    metrics = {"loss": loss, "grad_norm": g_norm}
    return DistillState(state.decoder, state.opt_state, state.step + 1), metrics


def distill(
    teacher,
    batches: Iterable[Dict[str, torch.Tensor]],
    n_text_layer: int = 2,
    learning_rate: float = 1e-4,
    ce_weight: float = 0.0,
    optimizer=None,
    verbose: bool = False,
):
    """Train a draft decoder from ``teacher`` (a Whisper); returns a Whisper
    usable directly as ``transcribe(..., draft_model=draft)``, its decoder
    leaves detached.

    ``batches`` yield {features | mel, tokens, loss_mask}: pseudo-labelled
    teacher transcripts (tokens = SOT sequence + the teacher's greedy text
    tokens + EOT, loss_mask = 1 where the model should predict).  When a
    batch carries "mel", the shared frozen encoder runs on it here, under
    ``torch.no_grad()`` (kernel K1 on the card); callers doing several
    epochs should compute the features once.
    """
    from .models.whisper import Whisper, encoder_apply

    params, dims = teacher.params, teacher.dims
    draft_params, draft_dims = init_draft_from_teacher(params, dims, n_text_layer)
    optimizer = optimizer or make_optimizer(learning_rate)
    state = DistillState(draft_params["decoder"], optimizer.init(draft_params["decoder"]), 0)
    for i, batch in enumerate(batches):
        if "features" not in batch:
            batch = dict(batch)
            with torch.no_grad():
                batch["features"] = encoder_apply(params, dims, batch.pop("mel"))
        state, metrics = distill_step(state, params, draft_dims, dims, optimizer, batch,
                                      ce_weight=ce_weight)
        if verbose:
            print(f"distill step {i}: loss={float(metrics['loss']):.4f}")
    decoder = {k: v.detach() for k, v in state.decoder.items() if k != "blocks"}
    decoder["blocks"] = {k: v.detach() for k, v in state.decoder["blocks"].items()}
    return Whisper(draft_dims, {"encoder": params["encoder"], "decoder": decoder})


def offline_acceptance(
    draft,
    target_tokens: torch.Tensor,
    features: torch.Tensor,
    loss_mask: Optional[torch.Tensor] = None,
) -> float:
    """Expected speculative acceptance: the fraction of next-token
    positions where the draft's teacher-forced argmax equals the target's
    actual next token.

    The speculative engine commits the target's own greedy tokens and keeps
    a drafted run alive exactly while the draft predicted them
    (``engine.decode_engine_speculative``'s accept scan), so this ratio on
    the target's greedy transcripts is the per-position acceptance
    probability: the number that decides whether a draft pays for itself.
    """
    with torch.no_grad():
        logits = decoder_apply_train(draft.params, draft.dims, target_tokens, features)
        pred = logits[:, :-1].float().argmax(dim=-1)
        hit = (pred == target_tokens[:, 1:].to(pred.device).long()).float()
        mask = torch.ones_like(hit) if loss_mask is None else loss_mask[:, 1:].float()
        return float((hit * mask).sum() / mask.sum().clamp(min=1.0))
