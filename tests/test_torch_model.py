"""whisper_tpu_torch model modules against whisper_tpu on the CPU.

Both packages get the same weights (whisper_tpu's init_params, through
save_npz -> load_npz or params_from_numpy) and the same inputs (numpy,
seeded).  Tolerances are whisper_tpu's own: log-mel 1e-4, activations 5e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import whisper_tpu.audio as jaudio
import whisper_tpu.models.whisper as jw
from whisper_tpu.models.dims import ModelDimensions as JDims
from whisper_tpu.models.load import save_npz

import whisper_tpu_torch.audio as taudio
import whisper_tpu_torch.models.whisper as tw
from whisper_tpu_torch.models.dims import ModelDimensions
from whisper_tpu_torch.models.load import (
    convert_torch_state_dict,
    load_npz,
    params_from_numpy,
)

from _reference import TINY_DIMS
from conftest import JFK

torch.set_num_threads(2)
DIMS = ModelDimensions(**TINY_DIMS)
JDIMS = JDims(**TINY_DIMS)


@pytest.fixture(autouse=True, scope="module")
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@pytest.fixture(scope="module")
def jparams():
    return jw.init_params(JDIMS, jax.random.PRNGKey(0), jnp.float32)


@pytest.fixture(scope="module")
def tparams(jparams):
    return params_from_numpy(jax.tree.map(np.asarray, jparams), DIMS)


@pytest.fixture(scope="module")
def mel():
    return np.random.RandomState(0).randn(1, 80, 3000).astype(np.float32)


@pytest.fixture(scope="module")
def feats(jparams, tparams, mel):
    j = np.array(jw.encoder_apply(jparams, JDIMS, jnp.asarray(mel)))
    t = tw.encoder_apply(tparams, DIMS, torch.from_numpy(mel)).numpy()
    return j, t


def test_log_mel_matches_jax_on_jfk():
    ref = np.asarray(jaudio.log_mel_spectrogram(JFK, 80))
    got = taudio.log_mel_spectrogram(JFK, 80).numpy()
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= 1e-4


@pytest.mark.parametrize("n_mels", [80, 128])
def test_log_mel_padding_and_batch(n_mels):
    rng = np.random.RandomState(1)
    audio = (rng.randn(2, 16000) * 0.1).astype(np.float32)
    ref = np.asarray(jaudio.log_mel_spectrogram(audio, n_mels, padding=4000))
    got = taudio.log_mel_spectrogram(audio, n_mels, padding=4000).numpy()
    assert got.shape == ref.shape == (2, n_mels, 125)
    assert np.abs(got - ref).max() <= 1e-4


def test_pad_or_trim_matches_jax():
    x = np.arange(10, dtype=np.float32).reshape(2, 5)
    for length in (3, 5, 8):
        ref = np.asarray(jaudio.pad_or_trim(jnp.asarray(x), length))
        np.testing.assert_array_equal(taudio.pad_or_trim(torch.from_numpy(x), length).numpy(), ref)
        np.testing.assert_array_equal(taudio.pad_or_trim(x, length), ref)


def test_load_audio_is_the_jax_decoder():
    np.testing.assert_array_equal(taudio.load_audio(JFK), jaudio.load_audio(JFK))


def test_encoder_apply(feats):
    j, t = feats
    assert t.shape == j.shape == (1, DIMS.n_audio_ctx, DIMS.n_audio_state)
    assert np.abs(t - j).max() <= 5e-4


def test_cross_kv_and_prefill(jparams, tparams, feats):
    jf, tf = feats
    jxk, jxv = jw.compute_cross_kv(jparams, JDIMS, jnp.asarray(jf))
    txk, txv = tw.compute_cross_kv(tparams, DIMS, torch.from_numpy(jf))
    assert txk.shape == jxk.shape
    assert np.abs(txk.numpy() - np.asarray(jxk)).max() <= 5e-4
    assert np.abs(txv.numpy() - np.asarray(jxv)).max() <= 5e-4

    tokens = np.array([[50258, 50259, 50359, 50363, 440, 7177, 300, 0]], np.int32)
    jh, jk, jv = jw.decoder_prefill(jparams, JDIMS, jnp.asarray(tokens), jxk, jxv)
    th, tk, tv = tw.decoder_prefill(tparams, DIMS, torch.from_numpy(tokens).long(), txk, txv)
    for a, b in ((th, jh), (tk, jk), (tv, jv)):
        assert a.shape == b.shape
        assert np.abs(a.numpy() - np.asarray(b)).max() <= 5e-4


def test_decoder_forward_and_logits(jparams, tparams, feats):
    jf, _ = feats
    tokens = np.array([[50258, 50259, 50359, 50363, 440, 7177]], np.int32)
    j, _ = jw.decoder_forward(jparams, JDIMS, jnp.asarray(tokens), jnp.asarray(jf))
    t = tw.decoder_forward(tparams, DIMS, torch.from_numpy(tokens).long(), torch.from_numpy(jf))
    assert t.dtype == torch.float32 and t.shape == j.shape
    assert np.abs(t.numpy() - np.asarray(j)).max() <= 5e-4


def test_incremental_matches_full_forward(tparams, feats):
    """The port's cached step (prefill, then decoder_step) against its own
    teacher-forced forward: the JAX suite's step-vs-full bound, 2e-4."""
    _, tf = feats
    f = torch.from_numpy(tf)
    tokens = torch.tensor([[50258, 50259, 50359, 50363, 440, 7177, 300]])
    full = tw.decoder_forward(tparams, DIMS, tokens, f)
    xk, xv = tw.compute_cross_kv(tparams, DIMS, f)
    cache = tw.init_kv_cache(DIMS, 1, xk, xv, torch.float32, ctx=64)
    P = 4
    hid, pk, pv = tw.decoder_prefill(tparams, DIMS, tokens[:, :P], xk, xv)
    cache.self_k[..., :P] = pk.transpose(-1, -2)
    cache.self_v[..., :P] = pv.transpose(-1, -2)
    assert (tw.project_logits(tparams, hid) - full[:, :P]).abs().max() <= 2e-4
    for t in range(P, tokens.shape[1]):
        h, cache = tw.decoder_step(tparams, DIMS, tokens[:, t], t, cache)
        assert (tw.project_logits(tparams, h)[0] - full[0, t]).abs().max() <= 2e-4


def test_load_npz_roundtrip(tmp_path, jparams, tparams):
    path = str(tmp_path / "tiny.npz")
    save_npz(path, jparams, JDIMS)
    params, dims = load_npz(path)
    assert dims == DIMS
    flat_a, flat_b = _flatten(params), _flatten(tparams)
    assert flat_a.keys() == flat_b.keys()
    for k in flat_a:
        torch.testing.assert_close(flat_a[k], flat_b[k], rtol=0, atol=0)


def test_convert_torch_state_dict(tparams):
    """A reference-format state dict built from the port's parameters
    converts back to them exactly."""
    sd = {}
    enc, dec = tparams["encoder"], tparams["decoder"]
    for i in (1, 2):
        sd[f"encoder.conv{i}.weight"] = enc[f"conv{i}_w"]
        sd[f"encoder.conv{i}.bias"] = enc[f"conv{i}_b"]
    sd["encoder.ln_post.weight"], sd["encoder.ln_post.bias"] = enc["ln_post_g"], enc["ln_post_b"]
    sd["decoder.token_embedding.weight"] = dec["tok_emb"]
    sd["decoder.positional_embedding"] = dec["pos_emb"]
    sd["decoder.ln.weight"], sd["decoder.ln.bias"] = dec["ln_g"], dec["ln_b"]
    names = {
        "attn_ln": "attn_ln", "attn.query": "q", "attn.key": "k", "attn.value": "v",
        "attn.out": "o", "mlp_ln": "mlp_ln", "mlp.0": "fc1", "mlp.2": "fc2",
        "cross_attn_ln": "xattn_ln", "cross_attn.query": "xq", "cross_attn.key": "xk",
        "cross_attn.value": "xv", "cross_attn.out": "xo",
    }
    for prefix, blocks in (("encoder.blocks", enc["blocks"]), ("decoder.blocks", dec["blocks"])):
        for torch_name, ours in names.items():
            ln = ours.endswith("_ln")
            for part, suffix in (("weight", "_g" if ln else "_w"), ("bias", "_b")):
                if ours + suffix not in blocks:
                    continue
                for i, x in enumerate(blocks[ours + suffix]):
                    sd[f"{prefix}.{i}.{torch_name}.{part}"] = x
    converted = _flatten(convert_torch_state_dict(sd, DIMS))
    expected = _flatten(tparams)
    assert converted.keys() == expected.keys()
    for k in expected:
        torch.testing.assert_close(converted[k], expected[k], rtol=0, atol=0)


def test_init_params_shapes_match_jax(jparams):
    tp = tw.init_params(DIMS, torch.Generator().manual_seed(0))
    ref = params_from_numpy(jax.tree.map(np.asarray, jparams), DIMS)
    a, b = _flatten(tp), _flatten(ref)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].shape == b[k].shape and a[k].dtype == torch.float32, k


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(_flatten(v, key) if isinstance(v, dict) else {key: v})
    return out
