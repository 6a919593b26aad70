"""Speculative greedy decoding in whisper_tpu_torch against whisper_tpu.

The same weights in both packages (whisper_tpu's init_params through
params_from_numpy) at tests/test_speculative.py's dims: the target, an
independent draft (its own encoder), a shared-encoder draft, and a draft
of head dim 64, the shape kernel K2 takes on the card.  Tolerances:

- ``decoder_step_k`` against whisper_tpu's: hidden within 5e-4 in f32 and
  the written cache columns within 1e-5; with int8 weights and int8 cross
  K/V, the JAX suite's 3e-5 / 1e-4 on the hidden state (the bounds of
  tests/test_fused_step.py); bf16, max error relative to max |JAX| within
  2e-2 (K2's bf16 bound: both packages round every product of four
  layers); rows whose block runs past the cache drop those columns;
- ``decode_engine_speculative`` against whisper_tpu's: tokens and seq_len
  equal, sum_logprobs within 1e-4;
- the cases of tests/test_speculative.py against the port's own plain
  greedy decode: equal tokens, avg_logprob within 1e-4, no_speech_prob
  within 1e-5.
"""

import importlib
import json
import math
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import whisper_tpu.decoding as jdec
import whisper_tpu.models.whisper as jw
import whisper_tpu.quantize as jq
from whisper_tpu.decoding import DecodingOptions as JOptions
from whisper_tpu.decoding import DecodingTask as JTask
from whisper_tpu.models.dims import ModelDimensions as JDims

import whisper_tpu_torch
import whisper_tpu_torch.decoding as tdec
import whisper_tpu_torch.engine as te
import whisper_tpu_torch.models.whisper as tw
import whisper_tpu_torch.quantize as tq
from whisper_tpu_torch.decoding import DecodingOptions, DecodingTask
from whisper_tpu_torch.models.dims import ModelDimensions
from whisper_tpu_torch.models.load import params_from_numpy

torch.set_num_threads(2)

TGT = dict(n_mels=80, n_audio_ctx=1500, n_audio_state=64, n_audio_head=4, n_audio_layer=2,
           n_vocab=51865, n_text_ctx=448, n_text_state=64, n_text_head=4, n_text_layer=3)
# independent draft: other audio dims, so it runs its own encoder
DRF = dict(TGT, n_audio_state=32, n_audio_head=2, n_audio_layer=1, n_text_state=32,
           n_text_head=2, n_text_layer=1)
# shared-encoder draft: the target's (n_audio_ctx, n_audio_state)
DRF_SHARED = dict(DRF, n_audio_state=64, n_audio_head=4, n_text_state=64, n_text_head=4)
# head dim 64: on the card its one-token steps run kernel K2
DRF_K2 = dict(DRF_SHARED, n_text_head=1)
DRAFTS = {"independent": (DRF, 1), "shared": (DRF_SHARED, 2), "k2": (DRF_K2, 4)}


@pytest.fixture(autouse=True, scope="module")
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _pair(kw: dict, seed: int, jdtype=jnp.float32, tdtype=torch.float32):
    jdims = JDims(**kw)
    jparams = jw.init_params(jdims, jax.random.PRNGKey(seed), jdtype)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), ModelDimensions(**kw), tdtype)
    return jw.Whisper(jdims, jparams), tw.Whisper(ModelDimensions(**kw), tparams)


@pytest.fixture(scope="module")
def models():
    """name -> (whisper_tpu model, port model); "target" and the drafts."""
    out = {"target": _pair(TGT, 0)}
    out.update({name: _pair(kw, seed) for name, (kw, seed) in DRAFTS.items()})
    return out


@pytest.fixture(scope="module")
def mel():
    return (np.random.RandomState(0).randn(3, 80, 3000) * 0.4).astype(np.float32)


def _same(plain, spec):
    assert len(plain) == len(spec)
    for p, s in zip(plain, spec):
        assert s.tokens == [int(x) for x in p.tokens]
        assert abs(p.avg_logprob - s.avg_logprob) < 1e-4
        assert abs(p.no_speech_prob - s.no_speech_prob) < 1e-5


# -- the K-token step ----------------------------------------------------------

T_CACHE, K = 448, 5
# per-row block starts: the prompt's start, inside, and blocks that cross or
# start at the capacity (their columns there drop, their positions clip)
STARTS = [0, 7, 200, 445, 448]
FORMS = ["f32", "bf16", "int8+kv_int8"]


@pytest.fixture(scope="module")
def step_models():
    f32 = _pair(TGT, 5)
    bf16 = _pair(TGT, 5, jnp.bfloat16, torch.bfloat16)
    jq8 = jq.quantize_params(f32[0].params, scopes=("decoder",))
    int8 = (jw.Whisper(f32[0].dims, jq8),
            tw.Whisper(f32[1].dims, params_from_numpy(jax.tree.map(np.asarray, jq8), f32[1].dims)))
    return {"f32": f32, "bf16": bf16, "int8+kv_int8": int8}


def _port_leaf(a, int8: bool, dtype):
    if int8:
        return tq.Int8Weight(*(torch.from_numpy(np.array(a[k])) for k in ("q", "s")))
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


@pytest.mark.parametrize("form", FORMS)
def test_decoder_step_k_matches_jax(step_models, form):
    jmodel, tmodel = step_models[form]
    dims, B = tmodel.dims, len(STARTS)
    L, H, D = dims.n_text_layer, dims.n_text_head, dims.n_text_state // dims.n_text_head
    jdtype = jnp.bfloat16 if form == "bf16" else jnp.float32
    tdtype = tmodel.dtype
    rng = np.random.RandomState(len(form))
    feats = jnp.asarray(rng.randn(B, 1500, dims.n_audio_state) * 0.3, jdtype)
    xk, xv = jw.compute_cross_kv(jmodel.params, jmodel.dims, feats)
    int8 = form == "int8+kv_int8"
    if int8:
        xk, xv = jq.quantize_kv(xk), jq.quantize_kv(xv)
    # every column holds values, those at and past a row's start included
    # (rejected drafts): the mask must keep them unattended
    sk = (rng.randn(L, B, H, D, T_CACHE) * 0.1).astype(np.float32)
    sv = (rng.randn(L, B, H, D, T_CACHE) * 0.1).astype(np.float32)
    tokens = rng.randint(0, 50000, (B, K))
    t0 = np.array(STARTS)

    jcache = jw.KVCache(jnp.asarray(sk, jdtype), jnp.asarray(sv, jdtype), xk, xv)
    ref_h, ref_cache = jw.decoder_step_k(jmodel.params, jmodel.dims, jnp.asarray(tokens, jnp.int32),
                                         jnp.asarray(t0, jnp.int32), jcache)
    cross = [_port_leaf(a, int8, tdtype) for a in (xk, xv)]

    def port(sk, sv):
        cache = tw.KVCache(torch.from_numpy(sk.copy()).to(tdtype),
                           torch.from_numpy(sv.copy()).to(tdtype), *cross)
        h, cache = tw.decoder_step_k(tmodel.params, dims, torch.from_numpy(tokens),
                                     torch.from_numpy(t0), cache)
        return h.float().numpy(), cache.self_k.float().numpy(), cache.self_v.float().numpy()

    h, got_k, got_v = port(sk, sv)
    ref_h = np.asarray(ref_h, np.float32)
    if form == "bf16":
        assert np.abs(h - ref_h).max() / np.abs(ref_h).max() <= 2e-2
    elif int8:
        np.testing.assert_allclose(h, ref_h, atol=3e-5, rtol=1e-4)
    else:
        np.testing.assert_allclose(h, ref_h, atol=5e-4, rtol=0)
    for got, ref, old in ((got_k, ref_cache.self_k, sk), (got_v, ref_cache.self_v, sv)):
        ref = np.asarray(ref, np.float32)
        old = np.asarray(jnp.asarray(old, jdtype), np.float32)
        for b, s in enumerate(STARTS):
            block = slice(s, min(s + K, T_CACHE))
            np.testing.assert_array_equal(got[:, b, ..., :s], old[:, b, ..., :s])
            np.testing.assert_array_equal(got[:, b, ..., block.stop:], old[:, b, ..., block.stop:])
            if form == "bf16":
                scale = np.abs(ref[:, b, ..., block]).max(initial=1e-30)
                assert np.abs(got[:, b, ..., block] - ref[:, b, ..., block]).max(initial=0) <= 2e-2 * scale
            else:
                np.testing.assert_allclose(got[:, b, ..., block], ref[:, b, ..., block], atol=1e-5)

    # other values at and past the starts change nothing that is attended
    sk2, sv2 = sk.copy(), sv.copy()
    for b, s in enumerate(STARTS):
        sk2[:, b, ..., s:] = rng.randn(*sk2[:, b, ..., s:].shape)
        sv2[:, b, ..., s:] = rng.randn(*sv2[:, b, ..., s:].shape)
    np.testing.assert_array_equal(port(sk2, sv2)[0], h)


def test_decoder_step_k_equals_one_token_steps(models):
    """K tokens in one pass give what K plain decode steps give."""
    tmodel = models["target"][1]
    dims = tmodel.dims
    rng = np.random.RandomState(3)
    feats = torch.from_numpy((rng.randn(2, 1500, 64) * 0.3).astype(np.float32))
    xk, xv = tw.compute_cross_kv(tmodel.params, dims, feats)
    tokens = torch.from_numpy(rng.randint(0, 50000, (2, K)))
    t0 = torch.tensor([4, 30])
    fresh = lambda: tw.init_kv_cache(dims, 2, xk, xv, torch.float32, ctx=64)  # noqa: E731
    ca, cb = fresh(), fresh()
    for c in (ca, cb):
        c.self_k.normal_(generator=torch.Generator().manual_seed(0))
        c.self_v.normal_(generator=torch.Generator().manual_seed(1))
    h, ca = tw.decoder_step_k(tmodel.params, dims, tokens, t0, ca)
    for i in range(K):
        hi, cb = tw.decoder_step(tmodel.params, dims, tokens[:, i], t0 + i, cb)
        torch.testing.assert_close(h[:, i], hi, atol=2e-4, rtol=0)
    torch.testing.assert_close(ca.self_k, cb.self_k, atol=1e-5, rtol=0)


# -- the engine against whisper_tpu's ------------------------------------------


def _engine_results(monkeypatch, models, mel, draft, prompts=None, **kw):
    """The EngineResult of whisper_tpu's and the port's speculative engine
    for one DecodingTask configuration."""
    got = {}

    def spy(module, key):
        real = module.decode_engine_speculative

        def wrapped(*args, **kwargs):
            got[key] = real(*args, **kwargs)
            return got[key]
        monkeypatch.setattr(module, "decode_engine_speculative", wrapped)

    spy(jdec, "jax")
    spy(tdec, "port")
    jt, tt = models["target"]
    jd, td = models[draft] if draft != "self" else models["target"]
    opts = {"language": "en", "temperature": 0.0, "sample_len": 20, **kw}
    jtask, ttask = JTask(jt, JOptions(**opts), draft_model=jd), DecodingTask(tt, DecodingOptions(**opts), draft_model=td)
    if prompts is None:
        jtask.run(jnp.asarray(mel))
        ttask.run(torch.from_numpy(mel))
    else:
        jtask.run_with_prompts(jnp.asarray(mel), prompts)
        ttask.run_with_prompts(torch.from_numpy(mel), prompts)
    return got["jax"], got["port"]


@pytest.mark.parametrize("draft,kw", [
    ("independent", {}),
    ("shared", {}),
    ("k2", {}),
    ("self", {}),
    ("independent", {"kv_cache_dtype": "int8", "prompt": "some previous context"}),
    ("shared", {"without_timestamps": True, "draft_len": 7}),
])
def test_engine_matches_jax(monkeypatch, models, mel, draft, kw):
    ref, got = _engine_results(monkeypatch, models, mel, draft, **kw)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_array_equal(got.seq_len.numpy(), np.asarray(ref.seq_len))
    np.testing.assert_allclose(got.sum_logprobs.numpy(), np.asarray(ref.sum_logprobs), atol=1e-4)
    np.testing.assert_allclose(got.no_speech_probs.numpy(), np.asarray(ref.no_speech_probs), atol=1e-5)


def test_engine_per_row_prompts_matches_jax(monkeypatch, models, mel):
    ref, got = _engine_results(monkeypatch, models, mel, "independent",
                               prompts=[[], [300, 301, 302], [400] * 9], sample_len=16)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_array_equal(got.seq_len.numpy(), np.asarray(ref.seq_len))
    np.testing.assert_allclose(got.sum_logprobs.numpy(), np.asarray(ref.sum_logprobs), atol=1e-4)


# -- the cases of tests/test_speculative.py against the port -------------------


@pytest.mark.parametrize("draft", list(DRAFTS))
@pytest.mark.parametrize("kw", [
    {},
    {"prompt": "some previous context"},
    {"without_timestamps": True},
    {"sample_len": 7},
    {"draft_len": 1},
    {"draft_len": 7},
], ids=["default", "prompt", "no_timestamps", "sample_len_7", "draft_len_1", "draft_len_7"])
def test_speculative_matches_greedy(models, mel, kw, draft):
    tt = models["target"][1]
    kw = dict(kw)
    opts = DecodingOptions(language="en", temperature=0.0, sample_len=kw.pop("sample_len", 20), **kw)
    plain = whisper_tpu_torch.decode(tt, torch.from_numpy(mel), opts)
    spec = whisper_tpu_torch.decode(tt, torch.from_numpy(mel), opts, draft_model=models[draft][1])
    _same(plain, spec)


def test_speculative_self_draft_accepts_everything(monkeypatch, models, mel):
    """The target drafting for itself is exact, and on the CPU, where the
    draft's steps and the verify pass are both torch, it accepts every
    draft: as many rounds as the all-accept ceiling (``_force_accept``)."""
    tt = models["target"][1]
    opts = DecodingOptions(language="en", temperature=0.0, sample_len=20)
    rounds = []
    real = te.decoder_step_k

    def counting(params, *args):
        rounds.append(params is tt.params)  # a verify pass, once per round
        return real(params, *args)

    monkeypatch.setattr(te, "decoder_step_k", counting)
    plain = DecodingTask(tt, opts).run(torch.from_numpy(mel))
    spec = DecodingTask(tt, opts, draft_model=tt).run(torch.from_numpy(mel))
    n_spec = sum(rounds) // 2  # the self-draft's resync passes also hold tt.params
    _same(plain, spec)
    rounds.clear()
    ceiling = DecodingTask(tt, opts, draft_model=tt)
    ceiling._force_accept = True
    _same(plain, ceiling.run(torch.from_numpy(mel)))
    assert n_spec == sum(rounds) // 2 <= math.ceil(20 / 5) + 1


def test_speculative_per_row_prompts(models, mel):
    tt, td = models["target"][1], models["independent"][1]
    opts = DecodingOptions(language="en", temperature=0.0, sample_len=16)
    prompts = [[], [300, 301, 302], [400] * 9]
    plain = DecodingTask(tt, opts).run_with_prompts(torch.from_numpy(mel), prompts)
    spec = DecodingTask(tt, opts, draft_model=td).run_with_prompts(torch.from_numpy(mel), prompts)
    _same(plain, spec)


@pytest.mark.parametrize("draft", ["independent", "k2"])
def test_speculative_buffer_cap(models, mel, draft):
    """Rows that run into the context cap freeze as the plain decode's:
    the draft's steps and the verify pass reach past the cache there."""
    tt = models["target"][1]
    long_prompt = [int(x) for x in np.random.RandomState(3).randint(100, 5000, 210)]
    opts = DecodingOptions(language="en", temperature=0.0, sample_len=220, prompt=long_prompt)
    plain = whisper_tpu_torch.decode(tt, torch.from_numpy(mel), opts)
    spec = whisper_tpu_torch.decode(tt, torch.from_numpy(mel), opts, draft_model=models[draft][1])
    for p, s in zip(plain, spec):
        assert p.tokens == s.tokens


def test_vocab_mismatch_rejected(models):
    bad_kw = dict(DRF, n_vocab=51866)
    bad = tw.Whisper(ModelDimensions(**bad_kw),
                     tw.init_params(ModelDimensions(**bad_kw), torch.Generator().manual_seed(3)))
    with pytest.raises(ValueError, match="vocab"):
        DecodingTask(models["target"][1], DecodingOptions(language="en", temperature=0.0),
                     draft_model=bad)


def test_draft_ignored_for_beam_and_sampling(models):
    tt, td = models["target"][1], models["independent"][1]
    beam = DecodingTask(tt, DecodingOptions(language="en", temperature=0.0, beam_size=2, sample_len=8),
                        draft_model=td)
    assert beam.draft_model is None
    sample = DecodingTask(tt, DecodingOptions(language="en", temperature=0.7, sample_len=8),
                          draft_model=td)
    assert sample.draft_model is None


TRANSCRIBE_KW = dict(language="en", temperature=0.0, sample_len=16, no_speech_threshold=None,
                     logprob_threshold=None, compression_ratio_threshold=None)


def test_transcribe_with_draft(models):
    tt, td = models["target"][1], models["independent"][1]
    audio = (np.random.RandomState(7).randn(16000 * 8) * 0.1).astype(np.float32)
    plain = tt.transcribe(audio, **TRANSCRIBE_KW)
    spec = tt.transcribe(audio, draft_model=td, **TRANSCRIBE_KW)
    assert plain["text"] == spec["text"]
    assert [s["tokens"] for s in plain["segments"]] == [s["tokens"] for s in spec["segments"]]


def test_features_with_nonshared_draft_rejected(models, mel):
    tt, td = models["target"][1], models["independent"][1]
    feats = tt.embed_audio(torch.from_numpy(mel))
    task = DecodingTask(tt, DecodingOptions(language="en", sample_len=4, temperature=0.0),
                        draft_model=td)
    with pytest.raises(ValueError, match="share_encoder"):
        task.run(feats)


def test_language_detection_with_a_draft(models, mel):
    """language=None: the features of language detection feed a shared
    draft, and a draft with its own encoder reads the mel."""
    tt = models["target"][1]
    opts = DecodingOptions(language=None, temperature=0.0, sample_len=12)
    plain = DecodingTask(tt, opts).run(torch.from_numpy(mel))
    for draft in ("independent", "shared"):
        spec = DecodingTask(tt, opts, draft_model=models[draft][1]).run(torch.from_numpy(mel))
        _same(plain, spec)
        assert [s.language for s in spec] == [p.language for p in plain]


def test_transcribe_batch_with_draft(models):
    tt, td = models["target"][1], models["k2"][1]
    rng = np.random.RandomState(11)
    files = [(rng.randn(16000 * n) * 0.1).astype(np.float32) for n in (5, 34, 12)]
    kw = dict(TRANSCRIBE_KW, batch_size=2)
    plain = whisper_tpu_torch.transcribe_batch(tt, files, **kw)
    spec = whisper_tpu_torch.transcribe_batch(tt, files, draft_model=td, **kw)
    for p, s in zip(plain, spec):
        assert p["text"] == s["text"]
        assert [x["tokens"] for x in p["segments"]] == [x["tokens"] for x in s["segments"]]
        assert [x["seek"] for x in p["segments"]] == [x["seek"] for x in s["segments"]]


def test_cli_draft_model(models, tmp_path, monkeypatch):
    """``--draft_model NAME`` loads the draft with load_model on the
    model's device (monkeypatched here to give the random models for two
    placeholder files) and writes what the decode without it writes."""
    from conftest import JFK

    paths = {str(tmp_path / f"{name}.npz"): name for name in ("target", "shared")}
    for path in paths:
        open(path, "wb").close()
    loads = []

    def load_model(name, device=None, download_root=None, **kw):
        loads.append((paths[name], device))
        return models[paths[name]][1]

    monkeypatch.setattr(whisper_tpu_torch, "load_model", load_model)
    target, draft = paths
    common = [JFK, "--model", target, "--device", "cpu", "--language", "en", "-f", "json",
              "--beam_size", "None", "--temperature_increment_on_fallback", "None",
              "--clip_timestamps", "0,4", "--verbose", "False"]
    tmod = importlib.import_module("whisper_tpu_torch.transcribe")
    for out, extra in (("plain", []), ("spec", ["--draft_model", draft])):
        monkeypatch.setattr(sys, "argv", ["whisper", *common, "-o", str(tmp_path / out), *extra])
        tmod.cli()
    assert loads == [("target", "cpu"), ("target", "cpu"), ("shared", "cpu")]
    plain, spec = (json.loads((tmp_path / d / "jfk.json").read_text()) for d in ("plain", "spec"))
    assert spec["text"] == plain["text"] and len(spec["segments"]) == len(plain["segments"]) > 0
    for p, s in zip(plain["segments"], spec["segments"]):
        assert (s["tokens"], s["seek"], s["start"], s["end"]) == (p["tokens"], p["seek"], p["start"], p["end"])
        assert abs(s["avg_logprob"] - p["avg_logprob"]) < 1e-4
