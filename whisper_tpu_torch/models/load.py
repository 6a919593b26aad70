"""Checkpoint loading: official torch ``.pt`` files and the JAX package's
flat ``.npz`` into the port's parameter dict.

Counterpart of ``whisper_tpu/models/load.py``.  The port keeps torch's
layouts (linear (out, in), convolution (out, in, k)), so a reference
checkpoint only needs its per-layer tensors stacked, while the JAX
package's tree (linear (in, out), convolution (k, in, out)) is transposed.
Its int8 leaves (``whisper_tpu.quantize``, ``{"q", "s"}``) become
:class:`~whisper_tpu_torch.quantize.Int8Weight` in the port's layout.
:func:`save_npz` writes that ``.npz`` back, in the JAX package's layouts.
"""

import io
from typing import Any, Dict, Optional, Tuple, Union

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
        # a copy of its own in float16 or float32 (any other float, such as
        # bfloat16, widened to float32), moved as it is, then cast and laid
        # out by torch on the device
        a = np.asarray(a)
        a = np.array(a, dtype=a.dtype if a.dtype in (np.float16, np.float32) else np.float32)
        t = torch.from_numpy(a).to(device=device).to(dtype)
        return _layout(name, t).contiguous()

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


def _layout(name: str, t: torch.Tensor) -> torch.Tensor:
    """A leaf between the two packages' layouts (its own inverse):
    linear (out, in) <-> (in, out), convolution (out, in, k) <-> (k, in,
    out)."""
    if name in _LINEAR:
        return t.transpose(-1, -2)
    if name in ("conv1_w", "conv2_w"):
        return t.permute(2, 1, 0)
    return t


def _host(t: torch.Tensor) -> np.ndarray:
    """A tensor as a contiguous numpy array on the host; bfloat16, which
    numpy cannot hold without ml_dtypes, as float32 (exact)."""
    t = t.detach()
    return (t.float() if t.dtype == torch.bfloat16 else t).contiguous().cpu().numpy()


def save_npz(path, params: Params, dims: ModelDimensions) -> None:
    """Write a parameter tree as whisper_tpu's flat ``.npz``
    (whisper_tpu/models/load.py:134-138), which both packages'
    ``load_npz`` read.  ``path``: a file name or a binary file.

    Keys are ``"encoder/blocks/q_w"``-style, in whisper_tpu's layouts: the
    inverse of :func:`params_from_numpy`'s transposes (linear (in, out),
    convolution (k, in, out)).  An int8 leaf is ``<key>/q`` (int8, (...,
    in, out)) and ``<key>/s`` (f32, (..., 1, out)); the int8 logits copy
    ``logits_w`` keeps (V, C) and (V, 1).  The dims are ``__dims__/<field>``
    int64 entries.  Floating values keep float32 or float16; bfloat16 is
    written as float32."""
    flat: Dict[str, np.ndarray] = {}

    def walk(node: Dict[str, Any], path: str) -> None:
        for name, value in node.items():
            key = f"{path}/{name}" if path else name
            if isinstance(value, dict):
                walk(value, key)
            elif isinstance(value, Int8Weight):
                q, s = value
                if name != "logits_w":
                    q, s = q.transpose(-1, -2), s.transpose(-1, -2)
                flat[f"{key}/q"], flat[f"{key}/s"] = _host(q), _host(s)
            else:  # laid out by torch, on the tensor's device
                flat[key] = _host(_layout(name, value))

    walk(params, "")
    meta = {f"__dims__/{k}": np.int64(v) for k, v in dims.__dict__.items()}
    np.savez(path, **flat, **meta)


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


def cast_params(node, dtype: Optional[torch.dtype], device: Union[str, torch.device]):
    """A parameter tree's tensors on ``device`` in ``dtype`` (None: their
    own), contiguous."""
    if isinstance(node, dict):
        return {k: cast_params(v, dtype, device) for k, v in node.items()}
    return node.to(device=device, dtype=dtype).contiguous()


def encoder_params(sd: Dict[str, Any], dims: ModelDimensions) -> Dict[str, Any]:
    """The encoder's part of the port's parameter dict from the
    ``encoder.*`` keys of a reference-format state_dict, uncast."""
    return {
        "conv1_w": sd["encoder.conv1.weight"],
        "conv1_b": sd["encoder.conv1.bias"],
        "conv2_w": sd["encoder.conv2.weight"],
        "conv2_b": sd["encoder.conv2.bias"],
        "pos": torch.from_numpy(sinusoids(dims.n_audio_ctx, dims.n_audio_state)),
        "blocks": _stack_blocks(sd, "encoder.blocks", dims.n_audio_layer, cross=False),
        "ln_post_g": sd["encoder.ln_post.weight"],
        "ln_post_b": sd["encoder.ln_post.bias"],
    }


def convert_torch_state_dict(
    state_dict: Dict[str, Any],
    dims: ModelDimensions,
    dtype: Optional[torch.dtype] = torch.float32,
    device: Union[str, torch.device] = "cpu",
) -> Params:
    """A reference-format state_dict (reference whisper/model.py:174-249)
    in the port's parameter dict; weights keep torch's layouts.  ``dtype``
    None keeps the checkpoint's own (the positional sinusoids are f32)."""
    sd = {k: v.detach() for k, v in state_dict.items()}
    params = {
        "encoder": encoder_params(sd, dims),
        "decoder": {
            "tok_emb": sd["decoder.token_embedding.weight"],
            "pos_emb": sd["decoder.positional_embedding"],
            "blocks": _stack_blocks(sd, "decoder.blocks", dims.n_text_layer, cross=True),
            "ln_g": sd["decoder.ln.weight"],
            "ln_b": sd["decoder.ln.bias"],
        },
    }
    return cast_params(params, dtype, device)


def load_torch_checkpoint(
    path_or_bytes: Union[str, bytes],
    dtype: Optional[torch.dtype] = torch.float32,
    device: Union[str, torch.device] = "cpu",
) -> Tuple[Params, ModelDimensions]:
    """Load a reference-format ``.pt`` checkpoint (``dtype`` None: in its
    own dtype)."""
    fp = io.BytesIO(path_or_bytes) if isinstance(path_or_bytes, bytes) else open(
        path_or_bytes, "rb"
    )
    with fp:
        checkpoint = torch.load(fp, map_location="cpu", weights_only=True)
    dims = ModelDimensions(**checkpoint["dims"])
    params = convert_torch_state_dict(checkpoint["model_state_dict"], dims, dtype, device)
    return params, dims


# ---------------------------------------------------------------------------
# The sharded checkpoint
# ---------------------------------------------------------------------------

_DIMS_FILE = "dims.json"


def _flatten(tree: Dict[str, Any], path: str = "") -> Dict[str, Any]:
    """{"encoder/blocks/q_w": leaf, ...}; an int8 leaf as ".../q" and ".../s"."""
    out: Dict[str, Any] = {}
    for key, value in tree.items():
        where = f"{path}/{key}" if path else key
        if isinstance(value, dict):
            out.update(_flatten(value, where))
        elif isinstance(value, Int8Weight):
            out[f"{where}/q"], out[f"{where}/s"] = value.q, value.s
        else:
            out[where] = value
    return out


def _tree(flat: Dict[str, Any]) -> Dict[str, Any]:
    """:func:`_flatten`'s inverse: a {"q", "s"} node is an int8 leaf."""
    def rebuild(node):
        if set(node) == {"q", "s"}:
            return Int8Weight(node["q"], node["s"])
        return {k: rebuild(v) if isinstance(v, dict) else v for k, v in node.items()}

    return rebuild(_unflatten(flat))


def _specs(params: Params) -> Dict[str, tuple]:
    """Each flat key's sharding spec, as ``parallel.shard_params`` splits it."""
    from ..parallel.sharding import _spec_tree

    return _flatten(_spec_tree(params))


def _device_mesh(mesh):
    """The DeviceMesh over the mesh's ranks that the checkpoint's DTensors
    name: on the CPU for a gloo mesh (its groups carry host tensors), on
    the card for NCCL."""
    from torch.distributed.device_mesh import DeviceMesh

    kind = "cpu" if mesh.backend == "gloo" else mesh.device.type
    grid = torch.arange(mesh.size).reshape(mesh.shape["data"], mesh.shape["model"])
    return DeviceMesh(kind, grid, mesh_dim_names=("data", "model")), kind


def _placements(spec) -> list:
    from torch.distributed.tensor import Replicate, Shard

    return [Replicate(), Shard(spec.index("model")) if "model" in spec else Replicate()]


def save_sharded(path: str, params: Params, dims: ModelDimensions) -> None:
    """Checkpoint a parameter tree with ``torch.distributed.checkpoint``:
    the counterpart of whisper_tpu's ``save_orbax`` (orbax, sharded params
    on a mesh; whisper_tpu/models/load.py:169-178).  Under a mesh (``with
    mesh:``) every rank calls it with its shards (``parallel.shard_params``),
    each wrapped as a ``DTensor`` with its placements (replicated over
    "data", split over "model" by the sharding rules) only to be written;
    DCP writes each distinct shard once.  Without a mesh the whole tree is
    written from this process.  The directory also holds ``dims.json``."""
    import json
    import os

    import torch.distributed.checkpoint as dcp

    from ..parallel.mesh import current_mesh

    mesh = current_mesh()
    flat = _flatten(params)
    os.makedirs(path, exist_ok=True)
    if mesh is None or mesh.size == 1:
        dcp.save({k: v.detach().cpu() for k, v in flat.items()}, checkpoint_id=path, no_dist=True)
    else:
        from torch.distributed.tensor import DTensor

        device_mesh, kind = _device_mesh(mesh)
        specs = _specs(params)
        state = {k: DTensor.from_local(v.detach().to(kind), device_mesh, _placements(specs[k]),
                                       run_check=False)
                 for k, v in flat.items()}
        dcp.save(state, checkpoint_id=path, process_group=mesh.cpu_groups["world"])
    if mesh is None or mesh.rank == 0:
        with open(os.path.join(path, _DIMS_FILE), "w") as f:
            json.dump(dims.__dict__, f)
    if mesh is not None and mesh.size > 1:
        import torch.distributed as dist

        dist.barrier(group=mesh.cpu_groups["world"])  # dims.json is there before any rank returns


def load_sharded(path: str, dtype: torch.dtype = torch.float32, *,
                 device: Union[str, torch.device, None] = None) -> Tuple[Params, ModelDimensions]:
    """Load a :func:`save_sharded` checkpoint (whisper_tpu's ``load_orbax``):
    under a mesh of several ranks, this rank's shards for that mesh, read
    by DCP from whatever mesh wrote them; without one (or on a mesh of one)
    the whole tree.  Floating leaves are cast to ``dtype``, int8 leaves keep
    their int8 values and f32 scales; the tensors go to ``device`` (the
    mesh's device, else the card)."""
    import json
    import os

    import torch.distributed.checkpoint as dcp

    from ..parallel.mesh import current_mesh

    mesh = current_mesh()
    with open(os.path.join(path, _DIMS_FILE)) as f:
        dims = ModelDimensions(**{k: int(v) for k, v in json.load(f).items()})
    device = torch.device(device if device is not None else
                          mesh.device if mesh is not None else "cuda")
    meta = dcp.FileSystemReader(path).read_metadata().state_dict_metadata
    shapes = {k: (tuple(m.size), m.properties.dtype) for k, m in meta.items()}
    if mesh is None or mesh.size == 1:
        state = {k: torch.empty(size, dtype=dt) for k, (size, dt) in shapes.items()}
        dcp.load(state, checkpoint_id=path, no_dist=True)
    else:
        from torch.distributed.tensor import DTensor

        device_mesh, kind = _device_mesh(mesh)
        M = mesh.shape["model"]
        specs = _specs(_tree({k: torch.empty(size, dtype=dt, device="meta")
                              for k, (size, dt) in shapes.items()}))
        state = {}
        for k, (size, dt) in shapes.items():
            spec = specs[k]
            local = list(size)
            if "model" in spec:
                if size[spec.index("model")] % M:
                    raise ValueError(f"load_sharded: {k} {size}: the model axis of {M} does not divide it")
                local[spec.index("model")] //= M
            state[k] = DTensor.from_local(torch.empty(local, dtype=dt, device=kind), device_mesh,
                                          _placements(spec), run_check=False)
        dcp.load(state, checkpoint_id=path, process_group=mesh.cpu_groups["world"])
        state = {k: v.to_local() for k, v in state.items()}
    cast = {k: v.to(device=device, dtype=dtype if v.is_floating_point() and not k.endswith("/s")
                    else v.dtype).contiguous() for k, v in state.items()}
    return _tree(cast), dims
