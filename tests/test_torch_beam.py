"""Beam search and best-of in whisper_tpu_torch against whisper_tpu.

Float32 at tests/_reference.py's TINY_DIMS, the same weights in both
packages (whisper_tpu's init_params through save_npz -> the port's
load_npz).  Beam search at temperature 0 must be token-exact, with
avg_logprob within 1e-4; a second checkpoint whose EOT embedding is scaled
up (as tests/test_decoding.py's eot_models) makes beams finish, so the
finished buffer, patience and the ranking run.  ``_beam_update`` alone must
give whisper_tpu's permutation, scores and finished buffer.  Best-of at
T > 0 cannot match JAX's random stream, so its ranking is tested on the
same engine outputs, and a seed must reproduce it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import whisper_tpu
import whisper_tpu.engine as je
from whisper_tpu.decoding import DecodingOptions as JOptions
from whisper_tpu.decoding import DecodingTask as JTask
from whisper_tpu.models.dims import ModelDimensions as JDims
from whisper_tpu.models.load import load_npz as jload
from whisper_tpu.models.load import save_npz
from whisper_tpu.models.whisper import KVCache as JCache
from whisper_tpu.models.whisper import Whisper as JWhisper
from whisper_tpu.models.whisper import init_params

import whisper_tpu_torch
import whisper_tpu_torch.engine as te
from whisper_tpu_torch.decoding import DecodingOptions, DecodingTask
from whisper_tpu_torch.models.whisper import KVCache
from whisper_tpu_torch.tokenizer import get_tokenizer

from _reference import TINY_DIMS
from conftest import JFK

torch.set_num_threads(2)
TOK = get_tokenizer(True, num_languages=99, language="en", task="transcribe")


@pytest.fixture(autouse=True, scope="module")
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _pair(tmp_path_factory, eot_scale: float):
    dims = JDims(**TINY_DIMS)
    params = jax.tree.map(np.asarray, init_params(dims, jax.random.PRNGKey(3), jnp.float32))
    params["decoder"]["tok_emb"] = params["decoder"]["tok_emb"].copy()
    params["decoder"]["tok_emb"][TOK.eot] *= eot_scale
    path = str(tmp_path_factory.mktemp("ckpt") / "tiny.npz")
    save_npz(path, params, dims)
    return JWhisper(*reversed(jload(path))), whisper_tpu_torch.load_model(path, device="cpu")


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    return _pair(tmp_path_factory, 1.0)


@pytest.fixture(scope="module")
def eot_models(tmp_path_factory):
    """EOT's embedding scaled up, so beams finish before sample_len."""
    return _pair(tmp_path_factory, 12.0)


@pytest.fixture(scope="module")
def mel():
    audio = whisper_tpu.load_audio(JFK)
    return np.array(whisper_tpu.log_mel_spectrogram(whisper_tpu.pad_or_trim(audio), 80))[None]


def _run_both(pair, mel, **kw):
    jmodel, tmodel = pair
    jres = JTask(jmodel, JOptions(language="en", **kw)).run(jnp.asarray(mel))[0]
    task = DecodingTask(tmodel, DecodingOptions(language="en", **kw))
    return jres, task.run(torch.from_numpy(mel))[0]


CASES = [
    ("plain", dict(beam_size=2, sample_len=48)),
    ("plain", dict(beam_size=5, sample_len=64)),
    ("plain", dict(beam_size=5, without_timestamps=True, sample_len=32)),
    ("eot", dict(beam_size=5)),
    ("eot", dict(beam_size=3, patience=2.0)),
    ("eot", dict(beam_size=5, length_penalty=0.6)),
    ("eot", dict(beam_size=2, without_timestamps=True)),
]


@pytest.mark.parametrize("which,kw", CASES, ids=[f"{w}-{kw}" for w, kw in CASES])
def test_beam_search_matches_jax(models, eot_models, mel, which, kw):
    jres, tres = _run_both(eot_models if which == "eot" else models, mel, **kw)
    assert tres.tokens == [int(t) for t in jres.tokens]
    assert tres.text == jres.text
    assert abs(tres.avg_logprob - jres.avg_logprob) <= 1e-4
    assert abs(tres.no_speech_prob - jres.no_speech_prob) <= 1e-5
    if which == "eot":  # the finished buffer, not the top-up, decided these
        assert len(tres.tokens) < 224


def test_beams_finish_before_sample_len(eot_models, mel):
    """The EOT checkpoint fills the finished buffer: the loop stops early."""
    _, tmodel = eot_models
    task = DecodingTask(tmodel, DecodingOptions(language="en", beam_size=5))
    seen = []
    update = te._beam_update

    def spy(spec, state, logits):
        state = update(spec, state, logits)
        seen.append(int(state.fin_count[0]))
        return state

    te._beam_update = spy
    try:
        task.run(torch.from_numpy(mel))
    finally:
        te._beam_update = update
    assert seen[-1] >= task.spec.max_candidates == 5 and len(seen) < task.sample_len


def _specs(beam: int, max_candidates: int, n_ctx: int):
    kw = dict(
        prefill_len=8, argmax=True, use_ts_rules=True, eot=TOK.eot, no_speech=TOK.no_speech,
        no_timestamps=TOK.no_timestamps, timestamp_begin=TOK.timestamp_begin, ctx_len=n_ctx,
        beam_size=beam, n_group=beam, max_candidates=max_candidates,
    )
    return je.EngineSpec(sot=TOK.sot, **kw), te.EngineSpec(**kw)


@pytest.mark.parametrize("step,fin_count,capped", [(0, 0, False), (3, 1, False), (5, 3, False), (4, 0, True)])
def test_beam_update_matches_jax(step, fin_count, capped):
    beam, max_cand, n_ctx, V = 4, 4, 24, TOK.eot + 1600
    rng = np.random.RandomState(step + 10 * fin_count)
    logits = (rng.randn(beam, V) * 2).astype(np.float32)
    logits[:, TOK.eot] += rng.rand(beam).astype(np.float32) * 6  # some EOT candidates
    tokens = rng.randint(0, TOK.eot, (beam, n_ctx + 1)).astype(np.int64)
    t = np.full(beam, n_ctx + 1 if capped else 6 + step, np.int64)
    lp = -rng.rand(beam).astype(np.float32) * 3
    fin_tokens = rng.randint(0, TOK.eot, (1, max_cand, n_ctx + 1)).astype(np.int64)
    fin_scores = np.full((1, max_cand), -np.inf, np.float32)
    fin_scores[0, :fin_count] = -rng.rand(fin_count) * 5
    cache_k = rng.randn(2, beam, 1, 2, n_ctx).astype(np.float32)
    cache_v = rng.randn(2, beam, 1, 2, n_ctx).astype(np.float32)
    jspec, tspec = _specs(beam, max_cand, n_ctx)

    ref = je._beam_update(jspec, je._LoopState(
        tokens=jnp.asarray(tokens, jnp.int32), t=jnp.asarray(t, jnp.int32), step=jnp.int32(step),
        cache=JCache(jnp.asarray(cache_k), jnp.asarray(cache_v), None, None), cur_logits=None,
        sum_logprobs=jnp.asarray(lp), completed=jnp.array(False), key=jax.random.PRNGKey(0),
        fin_tokens=jnp.asarray(fin_tokens, jnp.int32), fin_scores=jnp.asarray(fin_scores),
        fin_count=jnp.asarray([fin_count], jnp.int32),
    ), jnp.asarray(logits))

    spare = np.zeros((1, 1, n_ctx + 1), np.int64)  # the port's slot for dropped writes
    got = te._beam_update(tspec, te._LoopState(
        tokens=torch.from_numpy(tokens), t=torch.from_numpy(t), step=step,
        sum_logprobs=torch.from_numpy(lp), completed=torch.tensor(False),
        cache=KVCache(torch.from_numpy(cache_k), torch.from_numpy(cache_v), None, None),
        fin_tokens=torch.from_numpy(np.concatenate([fin_tokens, spare], axis=1)),
        fin_scores=torch.from_numpy(np.concatenate([fin_scores, [[-np.inf]]], axis=1).astype(np.float32)),
        fin_count=torch.tensor([fin_count]),
    ), torch.from_numpy(logits))

    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_array_equal(got.t.numpy(), np.asarray(ref.t))
    np.testing.assert_allclose(got.sum_logprobs.numpy(), np.asarray(ref.sum_logprobs), rtol=1e-6)
    np.testing.assert_array_equal(got.cache.self_k.numpy(), np.asarray(ref.cache.self_k))
    np.testing.assert_array_equal(got.cache.self_v.numpy(), np.asarray(ref.cache.self_v))
    np.testing.assert_array_equal(got.fin_count.numpy(), np.asarray(ref.fin_count))
    np.testing.assert_array_equal(got.fin_tokens[:, :max_cand].numpy(), np.asarray(ref.fin_tokens))
    np.testing.assert_allclose(got.fin_scores[:, :max_cand].numpy(), np.asarray(ref.fin_scores), rtol=1e-6)
    assert bool(got.completed) == bool(ref.completed)
    if step == 0:  # the first step draws every beam from beam 0's candidates
        assert (got.cache.self_k.numpy() == cache_k[:, :1]).all()


@pytest.mark.parametrize("length_penalty", [None, 0.5])
def test_best_of_ranking_matches_jax(models, length_penalty):
    """_assemble ranks best-of samples as whisper_tpu's does, on the same
    engine outputs: sum_logprob over a length (or Google-NMT) penalty."""
    jmodel, tmodel = models
    G, n_ctx = 5, 32
    kw = dict(language="en", temperature=0.6, best_of=G, length_penalty=length_penalty)
    jtask, ttask = JTask(jmodel, JOptions(**kw)), DecodingTask(tmodel, DecodingOptions(**kw))
    sb = ttask.sample_begin
    rng = np.random.RandomState(0)
    tokens = np.zeros((G, n_ctx + 1), np.int64)
    tokens[:, :sb] = ttask.initial_tokens
    lengths = rng.randint(1, n_ctx - sb, G)
    for j in range(G):
        tokens[j, sb : sb + lengths[j]] = rng.randint(0, TOK.eot, lengths[j])
        tokens[j, sb + lengths[j]] = TOK.eot
    seq_len = np.full(G, n_ctx + 1)
    sums = (-rng.rand(G) * lengths).astype(np.float32)
    feats = np.zeros((1, 1500, TINY_DIMS["n_text_state"]), np.float32)
    jres = je.EngineResult(
        jnp.asarray(tokens, jnp.int32), jnp.asarray(seq_len, jnp.int32), jnp.asarray(sums),
        jnp.zeros(1), jnp.asarray(feats), jnp.zeros((1, 1, 1), jnp.int32), jnp.zeros((1, 1)),
        jnp.zeros(1, jnp.int32),
    )
    tres = te.EngineResult(
        torch.from_numpy(tokens), torch.from_numpy(seq_len), torch.from_numpy(sums),
        torch.zeros(1), torch.from_numpy(feats), torch.zeros((1, 1, 1), dtype=torch.int64),
        torch.zeros((1, 1)), torch.zeros(1, dtype=torch.int64),
    )
    ref = jtask._assemble(jres, ["en"], None, 1)[0]
    got = ttask._assemble(tres, ["en"], None)[0]
    assert got.tokens == [int(t) for t in ref.tokens]
    assert abs(got.avg_logprob - ref.avg_logprob) <= 1e-6


def test_best_of_is_reproducible_from_its_seed(models, mel):
    _, tmodel = models
    opts = DecodingOptions(language="en", temperature=0.7, best_of=4, seed=5, sample_len=24)
    a = DecodingTask(tmodel, opts).run(torch.from_numpy(mel))[0]
    b = DecodingTask(tmodel, opts).run(torch.from_numpy(mel))[0]
    assert a.tokens == b.tokens and a.avg_logprob == b.avg_logprob
    assert DecodingTask(tmodel, opts).spec.n_group == 4


def test_option_checks(models):
    _, tmodel = models
    with pytest.raises(ValueError, match="together"):
        DecodingTask(tmodel, DecodingOptions(beam_size=5, best_of=5))
    with pytest.raises(ValueError, match="T=0"):
        DecodingTask(tmodel, DecodingOptions(best_of=5))
    with pytest.raises(ValueError, match="patience"):
        DecodingTask(tmodel, DecodingOptions(patience=2.0))
    task = DecodingTask(tmodel, DecodingOptions(language="en", beam_size=4, patience=1.5))
    assert (task.spec.beam_size, task.spec.n_group, task.spec.max_candidates) == (4, 4, 6)
    DecodingTask._forced_tokens = [TOK.eot]
    try:
        with pytest.raises(ValueError, match="greedy-only"):
            task._bench_forced()
    finally:
        DecodingTask._forced_tokens = None
