"""Fine-tuning: the teacher-forced loss and a train step on torch.optim.

Counterpart of ``whisper_tpu/training.py``, with its public names and its
call sequence::

    opt = make_optimizer(lr)
    state = init_train_state(params, opt)
    state, metrics = train_step(state, dims, opt, batch)

- the decoder runs its stacked blocks one by one, each under a
  non-reentrant ``torch.utils.checkpoint`` (whisper_tpu's ``jax.checkpoint``
  per block: the block's activations are recomputed in the backward pass);
  the encoder keeps its activations, as there;
- the encoder's self-attention is :func:`~.ops.attention.qkv_attention`
  (stock torch ops), the counterpart of whisper_tpu's XLA path: its Pallas
  kernel K1 has no backward, so its train step runs where the attention is
  XLA's, and the port's K1 has none either (its wrapper raises on an input
  that requires grad);
- the loss is label-shifted cross entropy with a padding mask, in f32;
- the optimizer is whisper_tpu's ``optax.chain(clip_by_global_norm,
  adamw)``: the gradients clipped by optax's rule, then
  ``torch.optim.AdamW`` (betas 0.9 and 0.999, eps 1e-8, decoupled weight
  decay), the same update in exact arithmetic.

The parameters are the leaves of the params dict, updated in place (the
state's ``params`` is the dict the caller passed, its leaves set to require
grad).  A batch is ``{"mel": (B, n_mels, 3000), "tokens": (B, S) integer,
"loss_mask": (B, S)}`` of tensors on the parameters' device; tensors made
under ``torch.inference_mode()`` (``Whisper.embed_audio``'s features) are
taken by a copy.

Under a mesh (``with mesh:``, parameters from ``parallel.shard_params``)
the step is whisper_tpu's DP+TP ``train_step``, which GSPMD shards there,
with each part spelled out.  Every rank is given the global batch and runs
its data group's rows (``Mesh.rows``); the model code sums the
row-parallel products over "model" (forward) and the column-parallel
inputs' gradients (backward), Megatron's g and f.  The loss is the mean
over the global batch: each group's masked sum over the all-reduced mask
count, summed over "data".  After the backward pass every gradient is
summed over "data" (a sharded leaf's too: each data group holds the same
shard), and the clipping norm is the global one: the squares of the
sharded leaves summed over "model", the replicated leaves counted once.
"""

import dataclasses
from typing import Any, Dict, List, NamedTuple, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .models.dims import ModelDimensions
from .models.whisper import (
    _causal_mask,
    _decoder_block,
    _embed_tokens,
    _layers,
    _linear,
    _text_heads,
    encoder_apply,
    is_shard,
    layer_norm,
    project_logits,
)
from .ops.attention import qkv_attention, split_heads
from .parallel.mesh import copy_to_model, current_mesh, reduce_over_data
from .parallel.sharding import param_sharding_rules
from .quantize import Int8Weight


def _usable(x):
    """x, or a copy of it outside inference mode when it was made inside
    (autograd refuses to save an inference tensor for backward)."""
    return x.clone() if isinstance(x, torch.Tensor) and x.is_inference() else x


def _attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The encoder's self-attention in a training pass: whisper_tpu's XLA
    path, differentiable."""
    return qkv_attention(q, k, v)[0]


def _local_rows(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """This data group's rows of a global batch under a mesh (the batch as
    it is without one)."""
    mesh = current_mesh()
    if mesh is None or mesh.shape["data"] == 1:
        return batch
    n = next(iter(batch.values())).shape[0]
    if n < mesh.shape["data"]:
        raise ValueError(f"a batch of {n} rows over {mesh.shape['data']} data groups")
    rows = mesh.rows(n)
    return {k: v[rows.start:rows.stop] for k, v in batch.items()}


def _block(x, p, n_head: int, audio_features, causal):
    tp = is_shard(p, x.shape[-1])
    h = layer_norm(x, p["attn_ln_g"], p["attn_ln_b"])
    if tp:  # on a model shard the k, v, xk and xv inputs' gradients sum over "model"
        h, audio_features = copy_to_model(h), copy_to_model(audio_features)
    k = split_heads(_linear(h, p["k_w"]), n_head)
    v = split_heads(_linear(h, p["v_w"], p["v_b"]), n_head)
    # cross K/V time-last, as _decoder_block expects
    xk = split_heads(_linear(audio_features, p["xk_w"]), n_head).transpose(-1, -2)
    xv = split_heads(_linear(audio_features, p["xv_w"], p["xv_b"]), n_head).transpose(-1, -2)
    return _decoder_block(x, p, n_head, k, v, xk, xv, causal)[0]


def _logits(params, x: torch.Tensor) -> torch.Tensor:
    """:func:`project_logits` with a derivative on every device: f32 logits
    of the compute dtype's products (exact in f32), summed in f32.  The
    inference path's bf16 product on the card, ``torch.mm(...,
    out_dtype=torch.float32)``, has no derivative the port relies on."""
    dec = params["decoder"]
    if "logits_w" in dec:
        return project_logits(params, x)
    return F.linear(x.float(), dec["tok_emb"].float())


def decoder_apply_train(params, dims: ModelDimensions, tokens, audio_features) -> torch.Tensor:
    """Teacher-forced decoder, f32 logits (B, S, n_vocab): each block under
    a non-reentrant checkpoint, the cross K/V computed inside it from
    ``audio_features``, no QK outputs."""
    dec = params["decoder"]
    n_head = _text_heads(dec, dims)
    tokens, audio_features = _usable(tokens).long(), _usable(audio_features)
    T = tokens.shape[1]
    x = _embed_tokens(dec, tokens, T)
    causal = _causal_mask(T, x.device)
    for p in _layers(dec["blocks"], dims.n_text_layer):
        x = checkpoint(_block, x, p, n_head, audio_features, causal, use_reentrant=False)
    x = layer_norm(x, dec["ln_g"], dec["ln_b"])
    return _logits(params, x)


def loss_fn(params, dims: ModelDimensions, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Next-token cross entropy; batch = {mel, tokens, loss_mask}.  Under a
    mesh: this data group's part of the global batch's mean, summed over
    "data" (the module's docstring)."""
    batch = _local_rows(batch)
    feats = encoder_apply(params, dims, _usable(batch["mel"]), attention=_attention)
    tokens = _usable(batch["tokens"]).long()
    logits = decoder_apply_train(params, dims, tokens, feats)
    return _masked_mean(
        -torch.log_softmax(logits[:, :-1].float(), dim=-1).gather(-1, tokens[:, 1:, None])[..., 0],
        batch["loss_mask"],
    )


def _masked_mean(values: torch.Tensor, loss_mask: torch.Tensor) -> torch.Tensor:
    """sum(values * mask) / max(sum(mask), 1), the mask shifted with the
    labels.  Under a mesh ``values`` and ``loss_mask`` are a data group's
    rows: the count is the global batch's, all-reduced, and the groups'
    parts are summed (:func:`~.parallel.mesh.reduce_over_data`)."""
    mask = _usable(loss_mask)[:, 1:].float()
    mesh = current_mesh()
    if mesh is None or mesh.shape["data"] == 1:
        return (values * mask).sum() / mask.sum().clamp(min=1.0)
    count = mesh.all_reduce(mask.sum().detach().clone(), "data")
    return reduce_over_data((values * mask).sum() / count.clamp(min=1.0))


class TrainState(NamedTuple):
    params: Any
    opt_state: Any  # the torch.optim.AdamW over the params' leaves
    step: int


def param_leaves(tree) -> List[torch.Tensor]:
    """The tensors of a params dict in a fixed order (keys sorted at every
    level, as ``jax.tree_util.tree_leaves``).  An int8 leaf raises: like
    optax, the optimizer has no update rule for int8 values."""
    return [t for _, t in _named_leaves(tree, "")]


def _named_leaves(tree, name: str) -> List[Tuple[str, torch.Tensor]]:
    if isinstance(tree, Int8Weight):
        raise ValueError("int8 parameters cannot be trained (load the model unquantized)")
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _named_leaves(tree[k], k)]
    return [(name, tree)]


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """whisper_tpu's ``make_optimizer`` as an object that carries its
    hyperparameters; ``init(params)`` gives the optimizer state."""

    learning_rate: float = 1e-5
    weight_decay: float = 0.01
    max_grad_norm: float = 1.0

    def init(self, params) -> torch.optim.AdamW:
        """A ``torch.optim.AdamW`` over the params' leaves, each set to
        require grad."""
        named = _named_leaves(params, "")
        for _, p in named:
            p.requires_grad_(True)
        opt = torch.optim.AdamW([p for _, p in named], lr=self.learning_rate, betas=(0.9, 0.999),
                                eps=1e-8, weight_decay=self.weight_decay)
        # which leaves the sharding rules split over "model", for a mesh's norm
        opt.split_by_rules = ["model" in param_sharding_rules(n, p.dim()) for n, p in named]
        return opt

    def apply(self, opt_state: torch.optim.AdamW) -> torch.Tensor:
        """Clip the leaves' gradients by their global norm and take the
        AdamW step; returns the norm before clipping (f32).

        optax's ``clip_by_global_norm``: g / g_norm * max_norm when
        g_norm >= max_norm, else g unchanged, with no epsilon
        (``torch.nn.utils.clip_grad_norm_`` divides by g_norm + 1e-6).  A
        leaf without a gradient takes zeros, as ``jax.grad`` gives it, so
        that its weight still decays.  Under a mesh the gradients are first
        summed over "data", and the norm is the global one (the module's
        docstring): a model axis above 1 means parameters from
        ``shard_params``."""
        leaves = [p for group in opt_state.param_groups for p in group["params"]]
        for p in leaves:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in leaves]
        mesh = current_mesh()
        if mesh is None:
            g_norm = torch.sqrt(sum(g.float().square().sum() for g in grads))
        else:
            for g in grads:
                mesh.all_reduce(g, "data")
            split = opt_state.split_by_rules if mesh.shape["model"] > 1 else [False] * len(grads)
            squares = [sum((g.float().square().sum() for g, s in zip(grads, split) if s == part),
                           torch.zeros((), device=grads[0].device)) for part in (True, False)]
            g_norm = torch.sqrt(mesh.all_reduce(squares[0], "model") + squares[1])
        if not bool(g_norm < self.max_grad_norm):
            for g in grads:
                g.div_(g_norm.to(g.dtype)).mul_(self.max_grad_norm)
        opt_state.step()
        return g_norm.detach()


def make_optimizer(
    learning_rate: float = 1e-5, weight_decay: float = 0.01, max_grad_norm: float = 1.0
) -> Optimizer:
    return Optimizer(learning_rate, weight_decay, max_grad_norm)


def init_train_state(params, optimizer: Optimizer) -> TrainState:
    return TrainState(params, optimizer.init(params), 0)


def optimizer_step(optimizer: Optimizer, opt_state: torch.optim.AdamW, loss_of) -> Tuple[torch.Tensor, torch.Tensor]:
    """One step: the loss ``loss_of()`` and its gradients under grad mode,
    then :meth:`Optimizer.apply`; returns (loss, grad_norm), detached."""
    opt_state.zero_grad(set_to_none=True)
    with torch.enable_grad():
        loss = loss_of()
        loss.backward()
    return loss.detach(), optimizer.apply(opt_state)


def train_step(
    state: TrainState,
    dims: ModelDimensions,
    optimizer: Optimizer,
    batch: Dict[str, torch.Tensor],
) -> Tuple[TrainState, Dict[str, Any]]:
    """One optimization step; metrics: loss, the global gradient norm
    before clipping, and the step count after it."""
    loss, g_norm = optimizer_step(optimizer, state.opt_state,
                                  lambda: loss_fn(state.params, dims, batch))
    metrics = {"loss": loss, "grad_norm": g_norm, "step": state.step + 1}
    return TrainState(state.params, state.opt_state, state.step + 1), metrics
