"""int8 weights, the int8 logits and int8 cross K/V in whisper_tpu_torch
against whisper_tpu, on the CPU in float32.

The same numpy-seeded inputs and the same weights (whisper_tpu's
init_params, through save_npz -> load_npz or params_from_numpy) go through
both packages.  Tolerances: the int8 values equal, the f32 scales within 1
ulp; products 1e-5 absolute (f32 sums in another order); the decode step
atol 3e-5 and rtol 1e-4 on the hidden state and 1e-5 on the cache column,
the bounds of tests/test_fused_step.py; decodes token-exact, log-prob sums
within 1e-5 (relative above 1); the divergence proxy's token agreement and
top-1 match equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import whisper_tpu
import whisper_tpu.models.whisper as jw
import whisper_tpu.quantize as jq
from whisper_tpu.decoding import DecodingOptions as JOptions
from whisper_tpu.decoding import DecodingTask as JTask
from whisper_tpu.evaluation import int8_divergence_proxy as jproxy
from whisper_tpu.models.dims import ModelDimensions as JDims
from whisper_tpu.models.load import load_npz as jload
from whisper_tpu.models.load import save_npz
from whisper_tpu.ops.kernels.fused_step_pallas import pack_fused_weights, pad_cross_kv

import whisper_tpu_torch
import whisper_tpu_torch.models.whisper as tw
import whisper_tpu_torch.quantize as tq
from whisper_tpu_torch.decoding import DecodingOptions, DecodingTask
from whisper_tpu_torch.evaluation import int8_divergence_proxy as tproxy
from whisper_tpu_torch.models.dims import ModelDimensions
from whisper_tpu_torch.models.load import load_npz, params_from_numpy
from whisper_tpu_torch.ops.kernels import fused_step as k2

from _reference import TINY_DIMS
from conftest import JFK

torch.set_num_threads(2)
# head_dim 64, as the CUDA kernel takes
STEP_KW = dict(TINY_DIMS, n_text_state=128, n_audio_state=128)


@pytest.fixture(autouse=True, scope="module")
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _port_leaf(leaf) -> tq.Int8Weight:
    """whisper_tpu's {"q": (..., in, out), "s": (..., 1, out)} in the port's
    layout, the same int8 values."""
    q, s = (np.swapaxes(np.asarray(leaf[k]), -1, -2) for k in ("q", "s"))
    return tq.Int8Weight(torch.from_numpy(q.copy()), torch.from_numpy(s.copy()))


def _port_kv(leaf) -> tq.Int8Weight:
    """quantize_kv's dict: the same layout in both packages."""
    return tq.Int8Weight(*(torch.from_numpy(np.array(leaf[k])) for k in ("q", "s")))


def _assert_same_int8(port: tq.Int8Weight, q: np.ndarray, s: np.ndarray) -> None:
    np.testing.assert_array_equal(port.q.numpy(), q)
    assert port.q.dtype == torch.int8 and port.s.dtype == torch.float32
    np.testing.assert_array_max_ulp(port.s.numpy(), s, maxulp=1)


# -- quantization ------------------------------------------------------------


def test_quantize_weight_and_kv_equal_jax():
    rng = np.random.RandomState(0)
    w = (rng.randn(3, 96, 160) * 0.05).astype(np.float32)  # (L, in, out), whisper_tpu's layout
    w[1, :, 7] = 0.0  # an all-zero channel: its scale is 1e-12 / 127
    w[2, 5, 9] = 1.0  # one outlier sets a channel's scale
    ref = jq.quantize_weight(jnp.asarray(w))
    got = tq.quantize_weight(torch.from_numpy(np.swapaxes(w, -1, -2).copy()))
    assert got.q.shape == (3, 160, 96) and got.s.shape == (3, 160, 1)
    _assert_same_int8(got, np.swapaxes(np.asarray(ref["q"]), -1, -2), np.swapaxes(np.asarray(ref["s"]), -1, -2))
    np.testing.assert_allclose(
        tq.dequantize_weight(got, torch.float32).numpy(),
        np.swapaxes(np.asarray(jq.dequantize_weight(ref, jnp.float32)), -1, -2), rtol=0, atol=0,
    )

    x = (rng.randn(2, 3, 2, 64, 1500) * 0.5).astype(np.float32)  # (L, A, H, D, Ta)
    ref = jq.quantize_kv(jnp.asarray(x))
    got = tq.quantize_kv(torch.from_numpy(x))
    assert got.s.shape == (2, 3, 2, 64, 1)
    _assert_same_int8(got, np.asarray(ref["q"]), np.asarray(ref["s"]))


@pytest.fixture(scope="module")
def jparams():
    return jw.init_params(JDims(**TINY_DIMS), jax.random.PRNGKey(0), jnp.float32)


@pytest.fixture(scope="module")
def npz_paths(tmp_path_factory, jparams):
    """whisper_tpu's weights, and their "int8+logits" quantization, each
    written by whisper_tpu's save_npz."""
    dims = JDims(**TINY_DIMS)
    root = tmp_path_factory.mktemp("ckpt")
    paths = str(root / "tiny.npz"), str(root / "tiny_int8.npz")
    save_npz(paths[0], jparams, dims)
    save_npz(paths[1], jq.quantize_params(jparams, logits=True), dims)
    return paths


def test_quantize_params_equals_jax_and_loads_its_npz(npz_paths):
    """The port's quantize_params(logits=True) of the float tree equals
    whisper_tpu's quantization of it, carried over by load_npz (int8
    values, f32 scales and every float leaf)."""
    ours = tq.quantize_params(load_npz(npz_paths[0])[0], logits=True)
    theirs, dims = load_npz(npz_paths[1])
    assert dims == ModelDimensions(**TINY_DIMS)

    def walk(a, b, path=""):
        assert set(a) == set(b), path
        for k in a:
            if isinstance(a[k], dict):
                walk(a[k], b[k], f"{path}/{k}")
            elif isinstance(a[k], tq.Int8Weight):
                assert isinstance(b[k], tq.Int8Weight), f"{path}/{k}"
                _assert_same_int8(b[k], a[k].q.numpy(), a[k].s.numpy())
            else:
                torch.testing.assert_close(b[k], a[k], rtol=0, atol=0)

    walk(ours, theirs)
    blocks = ours["decoder"]["blocks"]
    assert {k for k, v in blocks.items() if tq.is_quantized(v)} == tq._QUANT_KEYS
    assert ours["decoder"]["logits_w"].q.shape == (TINY_DIMS["n_vocab"], TINY_DIMS["n_text_state"])
    assert not tq.is_quantized(ours["decoder"]["tok_emb"])
    assert 0 < tq.quantization_error(load_npz(npz_paths[0])[0], ours) < 0.01


def test_load_model_quantize(npz_paths):
    model = whisper_tpu_torch.load_model(npz_paths[0], device="cpu", quantize="int8+logits")
    dec = model.params["decoder"]
    assert tq.is_quantized(dec["blocks"]["fc1_w"]) and tq.is_quantized(model.params["encoder"]["blocks"]["q_w"])
    assert tq.is_quantized(dec["logits_w"]) and model.dtype == torch.float32
    plain = whisper_tpu_torch.load_model(npz_paths[0], device="cpu", quantize="int8")
    assert "logits_w" not in plain.params["decoder"]
    assert model.num_parameters() == plain.num_parameters() + dec["logits_w"].q.numel()
    with pytest.raises(ValueError, match="quantize mode"):
        whisper_tpu_torch.load_model(npz_paths[0], device="cpu", quantize="int4")


# -- the int8 products ---------------------------------------------------------


def test_int8_linear_matches_jax():
    rng = np.random.RandomState(1)
    x = rng.randn(2, 7, 96).astype(np.float32)
    w = (rng.randn(96, 160) * 0.05).astype(np.float32)
    b = (rng.randn(160) * 0.1).astype(np.float32)
    leaf = jq.quantize_weight(jnp.asarray(w))
    ref = np.asarray(jw._linear(jnp.asarray(x), leaf, jnp.asarray(b)))
    got = tw._linear(torch.from_numpy(x), _port_leaf(leaf), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


def test_int8_project_logits_matches_jax(jparams):
    qparams = jq.quantize_params(jparams, logits=True)
    hidden = np.random.RandomState(2).randn(3, 4, TINY_DIMS["n_text_state"]).astype(np.float32)
    ref = np.asarray(jw.project_logits(qparams, jnp.asarray(hidden)))
    lw = qparams["decoder"]["logits_w"]  # (V, C): the same layout in both packages
    params = {"decoder": {"tok_emb": None, "logits_w": _port_kv(lw)}}
    got = tw.project_logits(params, torch.from_numpy(hidden))
    assert got.dtype == torch.float32 and got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("A,G", [(1, 1), (3, 1), (1, 3), (2, 3)])
def test_int8_cross_step_attention_matches_jax(A, G):
    """whisper_tpu's _cross_step_attention on quantize_kv's K/V against the
    plain K2's cross-attention: D^-0.5 and the K scales folded into q, the V
    scales on the output."""
    rng = np.random.RandomState(A * 10 + G)
    H, D, Ta = 2, 64, 1500
    xq = rng.randn(A * G, H, 1, D).astype(np.float32)
    xk, xv = (rng.randn(A, H, D, Ta).astype(np.float32) * 0.5 for _ in range(2))
    jk, jv = jq.quantize_kv(jnp.asarray(xk)), jq.quantize_kv(jnp.asarray(xv))
    ref = np.asarray(jw._cross_step_attention(jnp.asarray(xq), jk, jv, H, G))
    got = k2._cross_attention(torch.from_numpy(xq), _port_kv(jk), _port_kv(jv)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


# -- the decode step -----------------------------------------------------------


@pytest.fixture(scope="module")
def step_params():
    jdims = JDims(**STEP_KW)
    jparams = jw.init_params(jdims, jax.random.PRNGKey(1), jnp.float32)
    return jparams, jq.quantize_params(jparams, scopes=("decoder",))


LAYOUTS = [(1, 1, False), (1, 3, False), (3, 1, True), (2, 3, True)]
FORMS = [(True, False), (False, True), (True, True)]


@pytest.mark.parametrize("w8,kv8", FORMS, ids=["int8", "kv_int8", "int8+kv_int8"])
@pytest.mark.parametrize("A,G,per_row", LAYOUTS, ids=["1x1", "1x3", "3x1_per_row", "2x3_per_row"])
def test_int8_step_matches_jax_decoder_step(step_params, A, G, per_row, w8, kv8):
    """decoder_step with quantize_params(scopes=("decoder",)) and
    quantize_kv against the port's decode step (K2's plain version); for
    one audio with int8 weights also against whisper_tpu's fused kernel in
    interpret mode (tests/test_fused_step.py holds that kernel to
    decoder_step with int8 K/V alone)."""
    jdims, dims = JDims(**STEP_KW), ModelDimensions(**STEP_KW)
    jparams = step_params[1] if w8 else step_params[0]
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), dims)
    B, T, L, H = A * G, 64, dims.n_text_layer, dims.n_text_head
    rng = np.random.RandomState(A * 10 + G)
    feats = jnp.asarray(rng.randn(A, 1500, 128) * 0.3, jnp.float32)
    xk, xv = jw.compute_cross_kv(jparams, jdims, feats)
    if kv8:
        xk, xv = jq.quantize_kv(xk), jq.quantize_kv(xv)
    sk = (rng.randn(L, B, H, 64, T) * 0.1).astype(np.float32)
    sv = (rng.randn(L, B, H, 64, T) * 0.1).astype(np.float32)
    t = np.array([3, 20, 41, 7, 63, 12][:B]) if per_row else np.full(B, 9)
    sk[..., int(t.max()):] = 0  # the columns at and past the positions stay empty
    sv[..., int(t.max()):] = 0
    tokens = rng.randint(0, 50000, B)
    t_arg = jnp.asarray(t, jnp.int32) if per_row else jnp.int32(int(t[0]))
    jcache = jw.KVCache(jnp.asarray(sk), jnp.asarray(sv), xk, xv)
    refs = [jw.decoder_step(jparams, jdims, jnp.asarray(tokens, jnp.int32), t_arg, jcache, n_group=G)]
    if A == 1 and w8:  # the TPU kernel itself, run by the Pallas interpreter
        xkp, xvp, xks, xvs = pad_cross_kv(xk, xv)
        refs.append(jw.decoder_step_fused(jparams, pack_fused_weights(jparams, jdims), jdims,
                                          jnp.asarray(tokens, jnp.int32), t_arg, jcache,
                                          xkp, xvp, xks, xvs))

    port_cross = [_port_kv(a) if kv8 else torch.from_numpy(np.array(a)) for a in (xk, xv)]
    tcache = tw.KVCache(torch.from_numpy(sk.copy()), torch.from_numpy(sv.copy()), *port_cross)
    assert tq.is_quantized(tparams["decoder"]["blocks"]["fc2_w"]) == w8
    h, tcache = tw.decoder_step_fused(
        tparams, dims, torch.from_numpy(tokens), torch.from_numpy(t) if per_row else int(t[0]), tcache
    )
    for ref_h, ref_cache in refs:
        np.testing.assert_allclose(h.numpy(), np.asarray(ref_h), atol=3e-5, rtol=1e-4)
        np.testing.assert_allclose(tcache.self_k.numpy(), np.asarray(ref_cache.self_k), atol=1e-5)
        np.testing.assert_allclose(tcache.self_v.numpy(), np.asarray(ref_cache.self_v), atol=1e-5)


# -- decoding end to end -------------------------------------------------------


@pytest.fixture(scope="module")
def models(npz_paths):
    """(whisper_tpu, the port) per quantize mode, each package quantizing
    the same float weights itself."""
    jparams, jdims = jload(npz_paths[0])
    out = {}
    for mode in ("int8", "int8+logits"):
        jmodel = jw.Whisper(jdims, jq.quantize_params(jparams, logits=mode == "int8+logits"))
        out[mode] = jmodel, whisper_tpu_torch.load_model(npz_paths[0], device="cpu", quantize=mode)
    return out


@pytest.fixture(scope="module")
def mels():
    audio = whisper_tpu.load_audio(JFK)
    noise = np.random.RandomState(0).randn(16000 * 8).astype(np.float32) * 0.05
    return np.stack([
        np.array(whisper_tpu.log_mel_spectrogram(whisper_tpu.pad_or_trim(w), 80))
        for w in (audio, noise, audio[3 * 16000:])
    ])


def _same(jres, tres):
    assert len(jres) == len(tres)
    for jr, tr in zip(jres, tres):
        assert tr.tokens == [int(x) for x in jr.tokens]
        assert tr.text == jr.text and tr.language == jr.language
        js, ts = (r.avg_logprob * (len(r.tokens) + 1) for r in (jr, tr))
        assert abs(js - ts) <= 1e-5 * max(1.0, abs(js))
        assert abs(tr.no_speech_prob - jr.no_speech_prob) <= 1e-5


RUNS = [
    ("int8", dict(language="en", sample_len=24, kv_cache_dtype="int8")),
    ("int8+logits", dict(language="en", sample_len=24, without_timestamps=True, kv_cache_dtype="int8")),
    ("int8+logits", dict(language="en", sample_len=24)),
    ("int8", dict(language="en", sample_len=16, beam_size=5, kv_cache_dtype="int8")),
    ("int8+logits", dict(language="en", sample_len=16, beam_size=5, kv_cache_dtype="int8")),
]


@pytest.mark.parametrize("mode,kw", RUNS, ids=["greedy", "greedy_no_ts", "greedy_int8_kv_off",
                                               "beam5", "beam5_int8_logits"])
def test_int8_decoding_task_run_matches_jax(models, mels, mode, kw):
    jmodel, tmodel = models[mode]
    jres = JTask(jmodel, JOptions(temperature=0.0, **kw)).run(jnp.asarray(mels[:1]))
    tres = DecodingTask(tmodel, DecodingOptions(temperature=0.0, **kw)).run(torch.from_numpy(mels[:1]))
    _same(jres, tres)


def test_int8_run_with_prompts_matches_jax(models, mels):
    """Three windows with prompts of 0, 5 and 40 tokens in one decode."""
    jmodel, tmodel = models["int8+logits"]
    rng = np.random.RandomState(5)
    prompts = [[], list(map(int, rng.randint(1000, 20000, 5))), list(map(int, rng.randint(1000, 20000, 40)))]
    kw = dict(language="en", temperature=0.0, sample_len=24, kv_cache_dtype="int8")
    jres = JTask(jmodel, JOptions(**kw)).run_with_prompts(jnp.asarray(mels), prompts)
    tres = DecodingTask(tmodel, DecodingOptions(**kw)).run_with_prompts(torch.from_numpy(mels), prompts)
    _same(jres, tres)


def test_int8_transcribe_matches_jax(models):
    """transcribe(jfk.flac) with word timestamps: the segments' tokens,
    seeks and times, and the words within 0.02 s."""
    jmodel, tmodel = models["int8+logits"]
    kw = dict(language="en", temperature=0.0, verbose=None, compression_ratio_threshold=None,
              logprob_threshold=None, no_speech_threshold=None, kv_cache_dtype="int8",
              word_timestamps=True)
    audio = whisper_tpu.load_audio(JFK)
    jr, tr = jmodel.transcribe(audio, **kw), tmodel.transcribe(audio, **kw)
    assert tr["text"] == jr["text"] and len(tr["segments"]) == len(jr["segments"]) > 0
    for js, ts in zip(jr["segments"], tr["segments"]):
        assert ts["tokens"] == js["tokens"] and ts["seek"] == js["seek"]
        assert abs(ts["start"] - js["start"]) < 1e-6 and abs(ts["end"] - js["end"]) < 1e-6
        assert [w["word"] for w in ts["words"]] == [w["word"] for w in js["words"]]
        for jw_, tw_ in zip(js["words"], ts["words"]):
            assert abs(tw_["start"] - jw_["start"]) <= 0.02 and abs(tw_["end"] - jw_["end"]) <= 0.02


def test_int8_divergence_proxy_matches_jax(npz_paths, models, mels):
    jfull = jw.Whisper(*reversed(jload(npz_paths[0])))
    tfull = whisper_tpu_torch.load_model(npz_paths[0], device="cpu")
    jmodel, tmodel = models["int8+logits"]
    kw = dict(sample_len=8, batch_size=2, int8_decode_options={"kv_cache_dtype": "int8"})
    ref = jproxy(jfull, jmodel, mels[:2], **kw)
    got = tproxy(tfull, tmodel, mels[:2], **kw)
    assert got["n_windows"] == ref["n_windows"] == 2
    for key in ("token_agreement", "token_agreement_min", "top1_match"):
        assert got[key] == ref[key], key
    for key in ("logit_absdiff_max", "logit_absdiff_mean"):
        assert abs(got[key] - ref[key]) <= 1e-4 * max(1.0, ref[key]), key
