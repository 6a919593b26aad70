"""whisper_tpu_torch's engine and transcribe helpers against whisper_tpu's,
piece by piece, on synthetic inputs (numpy, seeded).

Logit filters and the greedy update must agree exactly: they are masks,
an argmax and one logsumexp over the same float32 logits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import whisper_tpu.engine as je
from whisper_tpu.decoding import DecodingResult as JResult
from whisper_tpu.transcribe import needs_fallback as j_needs_fallback
from whisper_tpu.transcribe import segment_window as j_segment_window

import whisper_tpu_torch.engine as te
from whisper_tpu_torch.decoding import DecodingResult
from whisper_tpu_torch.transcribe import needs_fallback, segment_window
from whisper_tpu_torch.tokenizer import get_tokenizer

torch.set_num_threads(2)
TOK = get_tokenizer(True, num_languages=99, language="en", task="transcribe")
V = 51865
N_CTX = 64
SAMPLE_BEGIN = 4


@pytest.fixture(autouse=True, scope="module")
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _specs(use_ts_rules: bool):
    kw = dict(
        prefill_len=8, argmax=True, use_ts_rules=use_ts_rules, eot=TOK.eot,
        no_speech=TOK.no_speech, no_timestamps=TOK.no_timestamps,
        timestamp_begin=TOK.timestamp_begin,
    )
    jspec = je.EngineSpec(beam_size=0, n_group=1, max_candidates=0, sot=TOK.sot, **kw)
    return jspec, te.EngineSpec(**kw, ctx_len=N_CTX)


def _case(seed: int, n_sampled: int, B: int = 3):
    """Random logits and token buffers: an SOT prefix, then n_sampled
    tokens mixing text and (mostly increasing) timestamps."""
    rng = np.random.RandomState(seed)
    logits = (rng.randn(B, V) * 3).astype(np.float32)
    logits[:, TOK.timestamp_begin:] += rng.randn(B, 1).astype(np.float32) * 4
    tokens = np.zeros((B, N_CTX + 1), np.int64)
    tokens[:, :SAMPLE_BEGIN] = [TOK.sot, TOK.sot + 1, TOK.transcribe, TOK.no_timestamps - 1]
    for b in range(B):
        ts = 0
        for i in range(n_sampled):
            if rng.rand() < 0.5:
                ts += rng.randint(0, 3)
                tokens[b, SAMPLE_BEGIN + i] = TOK.timestamp_begin + ts
            else:
                tokens[b, SAMPLE_BEGIN + i] = rng.randint(0, TOK.eot)
    t = np.full(B, SAMPLE_BEGIN + n_sampled, np.int64)
    return logits, tokens, t


def _masks(rng):
    sup = np.zeros(V, bool)
    sup[rng.choice(TOK.eot, 40, replace=False)] = True
    blank = np.zeros(V, bool)
    blank[[220, TOK.eot]] = True
    return sup, blank


@pytest.mark.parametrize("use_ts_rules", [True, False])
@pytest.mark.parametrize("n_sampled", [0, 1, 2, 5, 12])
@pytest.mark.parametrize("max_initial", [-1, 50])
def test_logit_filters_match_jax(use_ts_rules, n_sampled, max_initial):
    jspec, tspec = _specs(use_ts_rules)
    logits, tokens, t = _case(n_sampled, n_sampled)
    sup, blank = _masks(np.random.RandomState(7))
    jf = je.FilterArgs(
        suppress_mask=jnp.asarray(sup), blank_mask=jnp.asarray(blank),
        sample_begin=jnp.full((3,), SAMPLE_BEGIN, jnp.int32),
        max_initial_ts_index=jnp.int32(max_initial),
    )
    tf = te.FilterArgs(
        suppress_mask=torch.from_numpy(sup), blank_mask=torch.from_numpy(blank),
        sample_begin=SAMPLE_BEGIN, max_initial_ts_index=max_initial,
    )
    ref = je.apply_logit_filters(
        jspec, jnp.asarray(logits), jnp.asarray(tokens, jnp.int32), jnp.asarray(t, jnp.int32), jf
    )
    got = te.apply_logit_filters(
        tspec, torch.from_numpy(logits), torch.from_numpy(tokens), torch.from_numpy(t), tf
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def _jax_state(tokens, t, step, sum_logprobs):
    z = jnp.zeros(())
    return je._LoopState(
        tokens=jnp.asarray(tokens, jnp.int32), t=jnp.asarray(t, jnp.int32),
        step=jnp.int32(step), cache=None, cur_logits=None,
        sum_logprobs=jnp.asarray(sum_logprobs), completed=jnp.array(False),
        key=jax.random.PRNGKey(0), fin_tokens=z, fin_scores=z, fin_count=z,
    )


@pytest.mark.parametrize("forced", [None, [TOK.timestamp_begin, 440, TOK.eot]])
@pytest.mark.parametrize("step", [0, 2, 5])
def test_greedy_update_matches_jax(forced, step):
    jspec, tspec = _specs(True)
    logits, tokens, t = _case(step, 6)
    tokens[1, t[1] - 1] = TOK.eot  # a finished row keeps writing EOT
    t[2] = N_CTX + 1  # a capped row freezes
    lp = np.array([-1.5, -2.0, -0.5], np.float32)
    jforced = None if forced is None else jnp.asarray(forced, jnp.int32)
    ref = je._greedy_update(
        jspec, _jax_state(tokens, t, step, lp), jnp.asarray(logits), jnp.float32(0.0),
        forced=jforced,
    )
    state = te._LoopState(
        tokens=torch.from_numpy(tokens.copy()), t=torch.from_numpy(t.copy()), step=step,
        sum_logprobs=torch.from_numpy(lp), completed=torch.tensor(False),
    )
    got = te._greedy_update(tspec, state, torch.from_numpy(logits), 0.0, None, forced)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_array_equal(got.t.numpy(), np.asarray(ref.t))
    np.testing.assert_allclose(got.sum_logprobs.numpy(), np.asarray(ref.sum_logprobs), rtol=1e-6)
    assert bool(got.completed) == bool(ref.completed)
    assert got.step == step + 1


def test_buckets_match_jax():
    for n in range(1, 449, 7):
        assert te.prefill_bucket(n, 448) == je.prefill_bucket(n, 448)
        for sample_len in (1, 100, 224, 448):
            assert te.ctx_bucket(n, sample_len, 448) == je.ctx_bucket(n, sample_len, 448)


def _result(cls, tokens):
    return cls(audio_features=None, language="en", tokens=tokens, temperature=0.0,
               avg_logprob=-0.3, no_speech_prob=0.1, compression_ratio=1.2)


@pytest.mark.parametrize("seed", range(6))
def test_segment_window_matches_jax(seed):
    rng = np.random.RandomState(seed)
    ts = TOK.timestamp_begin
    tokens, pos = [], 0
    for _ in range(rng.randint(1, 5)):  # timestamp pairs around text
        start = pos + rng.randint(0, 5)
        pos = start + rng.randint(1, 40)
        tokens += [ts + start, *rng.randint(0, TOK.eot, rng.randint(1, 6)), ts + pos]
    if seed % 2:
        tokens = tokens[:-1]  # no closing timestamp
    if seed % 3 == 0:
        tokens = tokens + [ts + pos]  # a repeated final timestamp pair
    kw = dict(tokenizer=TOK, seek=300, segment_size=2500, time_offset=3.0,
              segment_duration=25.0, input_stride=2, time_precision=0.02)
    ref = j_segment_window(result=_result(JResult, tokens), **kw)
    got = segment_window(result=_result(DecodingResult, tokens), **kw)
    assert got == ref


@pytest.mark.parametrize(
    "cr,lp,ns", [(3.0, -0.2, 0.1), (1.0, -1.5, 0.1), (1.0, -1.5, 0.9), (1.0, -0.5, 0.9)]
)
def test_needs_fallback_matches_jax(cr, lp, ns):
    for thresholds in [(2.4, -1.0, 0.6), (None, None, None), (2.4, None, 0.6)]:
        r = DecodingResult(audio_features=None, language="en", avg_logprob=lp,
                           no_speech_prob=ns, compression_ratio=cr)
        assert needs_fallback(r, *thresholds) == j_needs_fallback(r, *thresholds)
