"""whisper_tpu_torch's save_npz and load_model's converted-checkpoint cache,
against whisper_tpu's, on the CPU.

``save_npz`` writes whisper_tpu's flat ``.npz``: a file the port writes
loads in whisper_tpu's ``load_npz`` to whisper_tpu's parameters, and one
whisper_tpu writes loads in the port's to the port's, exactly, in f32 and
with int8 leaves (the weights: whisper_tpu's ``init_params`` at
tests/_reference.py's TINY_DIMS).  ``load_model(name)`` converts a named
model's ``.pt`` once and caches it as ``<checkpoint>.npz`` beside it
(whisper_tpu/__init__.py:186-210): the download is stood in for by a
torch-saved ``.pt`` of random fp16 weights (no network), and the reloaded
parameters must equal the converted ones bit for bit, in f32, in bf16 and
quantized.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import whisper_tpu.models.whisper as jw
from whisper_tpu.models.dims import ModelDimensions as JDims
from whisper_tpu.models.load import load_npz as j_load_npz
from whisper_tpu.models.load import save_npz as j_save_npz
from whisper_tpu.quantize import quantize_params as j_quantize_params

import whisper_tpu_torch
import whisper_tpu_torch.models.load as tload
import whisper_tpu_torch.models.whisper as tw
from whisper_tpu_torch.models.dims import ModelDimensions
from whisper_tpu_torch.quantize import Int8Weight

from _reference import TINY_DIMS

torch.set_num_threads(2)
DIMS = ModelDimensions(**TINY_DIMS)
JDIMS = JDims(**TINY_DIMS)
# tiny's decoder shape (4 layers of 6 heads, the shape of its alignment-head
# mask) at a narrow width: load_model("tiny") sets those heads
TINY_PT_DIMS = ModelDimensions(**dict(TINY_DIMS, n_audio_layer=1, n_text_state=96,
                                      n_text_head=6, n_text_layer=4))


def _leaves(tree, path=()):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        elif isinstance(v, Int8Weight):
            yield path + (k, "q"), v.q
            yield path + (k, "s"), v.s
        else:
            yield path + (k,), v


def _jleaves(tree):
    return {p: np.asarray(v) for p, v in _leaves(jax.tree.map(np.asarray, tree))}


def _equal_trees(a, b):
    la, lb = dict(_leaves(a)), dict(_leaves(b))
    assert la.keys() == lb.keys()
    for k in la:
        assert la[k].dtype == lb[k].dtype and la[k].shape == lb[k].shape, k
        assert torch.equal(la[k], lb[k]), k


@pytest.fixture(scope="module")
def jparams():
    return jw.init_params(JDIMS, jax.random.PRNGKey(0), jnp.float32)


@pytest.mark.parametrize("quantize", [None, "int8", "int8+logits"])
def test_port_npz_loads_in_whisper_tpu(tmp_path, jparams, quantize):
    """The port's save_npz of whisper_tpu's weights (through
    params_from_numpy, so in the port's layouts) loads in whisper_tpu's
    load_npz to those weights, exactly; int8 leaves too."""
    jtree = jparams if quantize is None else j_quantize_params(jparams, logits=quantize == "int8+logits")
    tparams = tload.params_from_numpy(jax.tree.map(np.asarray, jtree), DIMS)
    path = str(tmp_path / "port.npz")
    tload.save_npz(path, tparams, DIMS)
    back, dims = j_load_npz(path, jnp.float32)
    assert dims == JDIMS
    want, got = _jleaves(jtree), _jleaves(back)
    assert want.keys() == got.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


@pytest.mark.parametrize("quantize", [None, "int8", "int8+logits"])
def test_whisper_tpu_npz_loads_in_the_port(tmp_path, jparams, quantize):
    """whisper_tpu's save_npz loads in the port's load_npz to the port's
    conversion of the same tree, and the port writes that file back byte
    for byte in its arrays."""
    jtree = jparams if quantize is None else j_quantize_params(jparams, logits=quantize == "int8+logits")
    path = str(tmp_path / "jax.npz")
    j_save_npz(path, jtree, JDIMS)
    params, dims = tload.load_npz(path)
    assert dims == DIMS
    _equal_trees(params, tload.params_from_numpy(jax.tree.map(np.asarray, jtree), DIMS))
    again = str(tmp_path / "again.npz")
    tload.save_npz(again, params, dims)
    with np.load(path) as a, np.load(again) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


def test_save_npz_keeps_float16_and_widens_bfloat16(tmp_path):
    """float16 stays float16; bfloat16, which numpy cannot hold without
    ml_dtypes, is written as float32, and the value survives."""
    params = tw.init_params(DIMS, torch.Generator().manual_seed(1))
    for dtype, stored in ((torch.float16, np.float16), (torch.bfloat16, np.float32)):
        path = str(tmp_path / f"{dtype}.npz")
        tload.save_npz(path, tload.cast_params(params, dtype, "cpu"), DIMS)
        with np.load(path) as f:
            assert f["decoder/blocks/q_w"].dtype == stored
            assert f["__dims__/n_text_state"].dtype == np.int64
        back, _ = tload.load_npz(path, dtype)
        _equal_trees(back, tload.cast_params(params, dtype, "cpu"))


def _state_dict(params):
    """A reference-format state dict of the port's parameter tree (the
    inverse of convert_torch_state_dict, with the encoder's sinusoid buffer
    an official checkpoint carries)."""
    enc, dec = params["encoder"], params["decoder"]
    sd = {"encoder.positional_embedding": enc["pos"],
          "encoder.ln_post.weight": enc["ln_post_g"], "encoder.ln_post.bias": enc["ln_post_b"],
          "decoder.token_embedding.weight": dec["tok_emb"],
          "decoder.positional_embedding": dec["pos_emb"],
          "decoder.ln.weight": dec["ln_g"], "decoder.ln.bias": dec["ln_b"]}
    for i in (1, 2):
        sd[f"encoder.conv{i}.weight"], sd[f"encoder.conv{i}.bias"] = enc[f"conv{i}_w"], enc[f"conv{i}_b"]
    names = {"attn_ln": "attn_ln", "attn.query": "q", "attn.key": "k", "attn.value": "v",
             "attn.out": "o", "mlp_ln": "mlp_ln", "mlp.0": "fc1", "mlp.2": "fc2",
             "cross_attn_ln": "xattn_ln", "cross_attn.query": "xq", "cross_attn.key": "xk",
             "cross_attn.value": "xv", "cross_attn.out": "xo"}
    for prefix, blocks in (("encoder.blocks", enc["blocks"]), ("decoder.blocks", dec["blocks"])):
        for torch_name, ours in names.items():
            ln = ours.endswith("_ln")
            for part, suffix in (("weight", "_g" if ln else "_w"), ("bias", "_b")):
                for i, x in enumerate(blocks.get(ours + suffix, ())):
                    sd[f"{prefix}.{i}.{torch_name}.{part}"] = x
    return sd


@pytest.fixture
def tiny_pt(tmp_path, monkeypatch):
    """A download stand-in: load_model("tiny") gets an official-layout .pt
    of random fp16 weights in a directory of its own; returns its path and
    the list of load_torch_checkpoint's calls."""
    params = tw.init_params(TINY_PT_DIMS, torch.Generator().manual_seed(2))
    sd = {k: v.half().contiguous() for k, v in _state_dict(params).items()}
    folder = tmp_path / "whisper"
    folder.mkdir()
    path = str(folder / "tiny.pt")
    torch.save({"dims": TINY_PT_DIMS.__dict__, "model_state_dict": sd}, path)
    monkeypatch.setattr(whisper_tpu_torch, "_download", lambda url, root, in_memory: path)
    calls = []
    real = tload.load_torch_checkpoint

    def counted(*args, **kwargs):
        calls.append(args[0])
        return real(*args, **kwargs)

    monkeypatch.setattr(tload, "load_torch_checkpoint", counted)
    return path, calls


@pytest.mark.parametrize("dtype,quantize", [(torch.float32, None), (torch.bfloat16, None),
                                            (torch.float32, "int8")], ids=["f32", "bf16", "int8"])
def test_load_model_caches_the_conversion(tiny_pt, dtype, quantize):
    """The first load converts the .pt and writes <checkpoint>.npz; the
    second reads it and converts nothing; the parameters are bit-equal,
    and equal those of the .pt loaded as a file path."""
    path, calls = tiny_pt
    first = whisper_tpu_torch.load_model("tiny", device="cpu", dtype=dtype, quantize=quantize)
    assert calls == [path] and os.path.isfile(path + ".npz")
    with np.load(path + ".npz") as f:  # the checkpoint's own fp16, written before the cast
        assert f["decoder/blocks/fc1_w"].dtype == np.float16
    second = whisper_tpu_torch.load_model("tiny", device="cpu", dtype=dtype, quantize=quantize)
    assert calls == [path]
    _equal_trees(second.params, first.params)
    assert first.dims == second.dims == TINY_PT_DIMS
    assert np.array_equal(first.alignment_heads, second.alignment_heads)
    direct = whisper_tpu_torch.load_model(path, device="cpu", dtype=dtype, quantize=quantize)
    _equal_trees(direct.params, first.params)
    assert sorted(os.listdir(os.path.dirname(path))) == ["tiny.pt", "tiny.pt.npz"]


def test_load_model_from_a_path_writes_no_cache(tiny_pt):
    path, calls = tiny_pt
    whisper_tpu_torch.load_model(path, device="cpu")
    whisper_tpu_torch.load_model(path, device="cpu")
    assert calls == [path, path] and os.listdir(os.path.dirname(path)) == ["tiny.pt"]


def test_load_model_without_a_writable_cache(tiny_pt):
    """A cache that cannot be written (here a directory in its place: the
    write fails with an OSError even for root, whom a read-only mode does
    not stop) loads without an error and without a cache, every time."""
    path, calls = tiny_pt
    os.mkdir(path + ".npz")
    a = whisper_tpu_torch.load_model("tiny", device="cpu")
    b = whisper_tpu_torch.load_model("tiny", device="cpu")
    assert calls == [path, path]
    assert sorted(os.listdir(os.path.dirname(path))) == ["tiny.pt", "tiny.pt.npz"]
    assert os.listdir(path + ".npz") == []
    _equal_trees(a.params, b.params)
