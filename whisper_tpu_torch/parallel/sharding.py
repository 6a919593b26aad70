"""Parameter sharding rules: Megatron-style tensor parallelism over "model".

Counterpart of ``whisper_tpu/parallel/sharding.py``, with its rules keyed by
leaf name, on the port's (L, out, in) layout (``params_from_numpy``
transposes whisper_tpu's (L, in, out)):

- q/k/v, fc1 and the cross-attention's xq/xk/xv are column-parallel: their
  output features (dim 1) and biases split, so a rank holds H / model heads
  and F / model hidden units;
- o, fc2 and xo are row-parallel: their input features (dim 2) split, and
  the model code sums their partial products over "model" before the bias
  (``parallel.reduce_from_model``);
- LayerNorms, embeddings, convolutions and the row-parallel biases are
  replicated (``tok_emb`` must be whole: every rank computes the whole
  logits and makes the same pick).

Where GSPMD gives each array a sharding and reshards between them, a rank
here holds its local shard as a plain tensor, so a shard must be whole
heads.  Two differences follow: a head count that the model axis does not
divide raises (GSPMD pads the split), and an int8 leaf
(:class:`~whisper_tpu_torch.quantize.Int8Weight`) stays whole, as under
whisper_tpu's rules (its ``{"q", "s"}`` leaves match no rule), together with
its bias, which here cannot be split while its weight is whole.
"""

from typing import Any, Dict, Optional, Tuple

import torch

from ..quantize import Int8Weight
from .mesh import Mesh

_COLUMN_PARALLEL = {"q_w", "k_w", "v_w", "fc1_w", "xq_w", "xk_w", "xv_w"}
_COLUMN_BIAS = {"q_b", "v_b", "fc1_b", "xq_b", "xv_b"}
_ROW_PARALLEL = {"o_w", "fc2_w", "xo_w"}
# a column-parallel bias splits with its weight
_WEIGHT_OF = {"q_b": "q_w", "v_b": "v_w", "fc1_b": "fc1_w", "xq_b": "xq_w", "xv_b": "xv_w"}


def param_sharding_rules(name: str, ndim: int) -> Tuple[Optional[str], ...]:
    """The spec of one parameter leaf (stacked layer axis first): one entry
    per dim, "model" on the dim that splits, as whisper_tpu's PartitionSpec
    on the (L, out, in) layout."""
    if name in _COLUMN_PARALLEL:  # (L, out, in): shard out
        return (None, "model", None)
    if name in _COLUMN_BIAS:  # (L, out): shard out
        return (None, "model")
    if name in _ROW_PARALLEL:  # (L, out, in): shard in
        return (None, None, "model")
    return (None,) * ndim  # replicate


def _spec_tree(params: Dict[str, Any]) -> Dict[str, Any]:
    """Each leaf's spec, as :func:`shard_params` splits it: the rules', but
    an int8 leaf whole (an :class:`Int8Weight` of two empty specs), and so
    the bias of an int8 weight."""
    out: Dict[str, Any] = {}
    for key, value in params.items():
        if isinstance(value, dict):
            out[key] = _spec_tree(value)
        elif isinstance(value, Int8Weight):
            out[key] = Int8Weight((), ())
        elif isinstance(params.get(_WEIGHT_OF.get(key)), Int8Weight):
            out[key] = ()
        else:
            out[key] = param_sharding_rules(key, value.dim())
    return out


def _shard(leaf: torch.Tensor, spec, where: str, mesh: Mesh) -> torch.Tensor:
    M, m = mesh.shape["model"], mesh.coords["model"]
    leaf = leaf.detach()
    if "model" in spec and M > 1:
        dim = spec.index("model")
        size = leaf.shape[dim]
        if size % M:
            raise ValueError(f"shard_params: {where} {tuple(leaf.shape)}: the model axis of {M} "
                             f"does not divide dim {dim} ({size})")
        leaf = leaf.narrow(dim, m * (size // M), size // M)
    return leaf.to(mesh.device).clone(memory_format=torch.contiguous_format)


def shard_params(params: Dict[str, Any], mesh: Mesh) -> Dict[str, Any]:
    """This rank's local shards of a parameter tree under the rules above,
    as new tensors on the mesh's device (the input is not changed).  A
    batch's rows split over "data" by :meth:`Mesh.rows`, the counterpart of
    whisper_tpu's ``data_sharding``."""

    def walk(tree: Dict[str, Any], specs: Dict[str, Any], path: str) -> Dict[str, Any]:
        out = {}
        for key, value in tree.items():
            where = f"{path}/{key}" if path else key
            if isinstance(value, dict):
                out[key] = walk(value, specs[key], where)
            elif isinstance(value, Int8Weight):
                out[key] = Int8Weight(*(_shard(t, (), where, mesh) for t in value))
            else:
                out[key] = _shard(value, specs[key], where, mesh)
        return out

    return walk(params, _spec_tree(params), "")
