"""Multi-device execution: a ("data", "model") mesh over torch.distributed.

Counterpart of ``whisper_tpu/parallel/``: :func:`make_mesh`,
:func:`shard_params` and :func:`param_sharding_rules` with whisper_tpu's
names, the Megatron operators the model code calls
(:func:`reduce_from_model`, :func:`copy_to_model`) and
:func:`~.launch.run_ranks`, which starts one process per rank.
"""

from .mesh import Mesh, copy_to_model, current_mesh, make_mesh, reduce_from_model
from .sharding import param_sharding_rules, shard_params

__all__ = ["make_mesh", "shard_params", "param_sharding_rules", "Mesh", "current_mesh",
           "reduce_from_model", "copy_to_model"]
