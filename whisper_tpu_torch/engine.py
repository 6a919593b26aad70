"""Segment decoding engine: encoder, cross K/V, prompt prefill and the greedy
token loop.

Counterpart of ``whisper_tpu/engine.py`` for its greedy, per-step branch.
The JAX engine runs the token loop as one ``lax.while_loop`` on the device;
here it is a Python loop that queues each step's work (logit filters,
selection, the decode step through kernel K2, the logits) on the device and
reads the stop flag back once per step.  The filters are vectorised masks
recomputed from the token buffer every step, as there.  Beam search, the
deferred write block and the speculative engine are later slices.
"""

from dataclasses import dataclass
from typing import List, NamedTuple, Optional, Tuple

import torch

from .models.dims import ModelDimensions
from .models.whisper import (
    NEG_INF,
    compute_cross_kv,
    decoder_forward,
    decoder_prefill,
    decoder_step_fused,
    encoder_apply,
    init_kv_cache,
    project_logits,
)

PREFILL_BUCKETS = (8, 16, 32, 64, 128, 256, 448)


def prefill_bucket(initial_len: int, n_text_ctx: int) -> int:
    for b in PREFILL_BUCKETS:
        if initial_len <= b and b <= n_text_ctx:
            return b
    return n_text_ctx


def ctx_bucket(prefill_len: int, sample_len: int, n_text_ctx: int) -> int:
    """Time capacity of the token loop: prefill + sample_len rounded up to
    a multiple of 64, at most n_text_ctx (the self-KV cache is this wide,
    and every step's self-attention reads it)."""
    need = min(prefill_len + sample_len, n_text_ctx)
    return min((need + 63) // 64 * 64, n_text_ctx)


@dataclass(frozen=True)
class EngineSpec:
    """Static configuration of one greedy (or sampled) decode."""

    prefill_len: int  # bucketed initial-token block size
    argmax: bool  # temperature == 0
    use_ts_rules: bool  # timestamp rules active (not without_timestamps)
    eot: int
    no_speech: int  # -1 if absent
    no_timestamps: int
    timestamp_begin: int
    ctx_len: int = 0  # token-loop time capacity (0 => dims.n_text_ctx)


class FilterArgs(NamedTuple):
    """Inputs to the logit-filter chain."""

    suppress_mask: torch.Tensor  # (V,) bool — SuppressTokens set
    blank_mask: torch.Tensor  # (V,) bool — " " + EOT, applied at sample start
    sample_begin: int  # initial token length
    max_initial_ts_index: int  # -1 if unlimited


class EngineResult(NamedTuple):
    tokens: torch.Tensor  # (B, n_ctx+1) token buffer
    seq_len: torch.Tensor  # (B,) — per-row total length written
    sum_logprobs: torch.Tensor  # (B,) f32
    no_speech_probs: torch.Tensor  # (n_audio,) f32
    audio_features: torch.Tensor  # (n_audio, Ta, C)


class _LoopState(NamedTuple):
    tokens: torch.Tensor
    t: torch.Tensor  # (B,) — per-row write positions (initial_len + step)
    step: int  # shared sampling-step counter
    sum_logprobs: torch.Tensor
    completed: torch.Tensor  # () bool


# ---------------------------------------------------------------------------
# Logit filters (vectorized parity with reference decoding.py:423-505)
# ---------------------------------------------------------------------------


def _latest_timestamp(
    tokens: torch.Tensor, t: torch.Tensor, sample_begin: int, ts_begin: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Most recent timestamp token in the sampled region [sample_begin, t).

    Returns (has_any (B,) bool, value (B,) int64).
    """
    positions = torch.arange(tokens.shape[1], device=tokens.device)[None, :]
    mask = (positions >= sample_begin) & (positions < t[:, None]) & (tokens >= ts_begin)
    last_pos = torch.where(mask, positions, -1).amax(dim=1)
    has_any = last_pos >= 0
    value = tokens.gather(1, last_pos.clamp(min=0)[:, None])[:, 0]
    return has_any, value


def apply_logit_filters(
    spec: EngineSpec,
    logits: torch.Tensor,  # (B, V) f32
    tokens: torch.Tensor,  # (B, n_ctx+1)
    t: torch.Tensor,  # (B,): current length (next write position)
    f: FilterArgs,
) -> torch.Tensor:
    """SuppressBlank, SuppressTokens and ApplyTimestampRules as one mask
    applied in one pass (the rules of ``whisper_tpu.engine``)."""
    V = logits.shape[1]
    vocab = torch.arange(V, device=logits.device)
    at_start = (t == f.sample_begin)[:, None]

    suppress = f.suppress_mask[None, :] | (at_start & f.blank_mask[None, :])
    if not spec.use_ts_rules:
        return logits.masked_fill(suppress, NEG_INF)

    ts_begin = spec.timestamp_begin
    is_ts = vocab[None, :] >= ts_begin  # (1, V)
    # <|notimestamps|> is never sampled when rules are active
    suppress = suppress | (vocab[None, :] == spec.no_timestamps)

    prev = tokens.gather(1, (t - 1).clamp(min=0)[:, None])[:, 0]
    penult = tokens.gather(1, (t - 2).clamp(min=0)[:, None])[:, 0]
    sampled_len = t - f.sample_begin
    last_was_ts = (sampled_len >= 1) & (prev >= ts_begin)
    # fewer than two sampled tokens counts as "penultimate was timestamp"
    penult_was_ts = (sampled_len < 2) | (penult >= ts_begin)

    # timestamps come in pairs: after a lone timestamp, force a non-timestamp;
    # after a completed pair, forbid text (only EOT/specials/timestamps)
    force_text = last_was_ts & penult_was_ts
    force_non_text = last_was_ts & ~penult_was_ts
    suppress = suppress | (force_text[:, None] & is_ts)
    suppress = suppress | (force_non_text[:, None] & (vocab[None, :] < spec.eot))

    # monotonicity: no timestamp below the most recent one; strictly above
    # it unless mid-pair
    has_ts, last_ts = _latest_timestamp(tokens, t, f.sample_begin, ts_begin)
    ts_floor = torch.where(last_was_ts & ~penult_was_ts, last_ts, last_ts + 1)
    suppress = suppress | (has_ts[:, None] & is_ts & (vocab[None, :] < ts_floor[:, None]))

    # at the very start: timestamps only, capped by max_initial_timestamp
    suppress = suppress | (at_start & ~is_ts)
    if f.max_initial_ts_index >= 0:
        suppress = suppress | (at_start & (vocab[None, :] > ts_begin + f.max_initial_ts_index))

    logits = logits.masked_fill(suppress, NEG_INF)

    # sample a timestamp if the total timestamp probability outweighs any
    # single text token (compared on the masked logits: both sides of the
    # reference's log_softmax comparison shift by the same logsumexp)
    ts_logsumexp = torch.logsumexp(logits.masked_fill(~is_ts, NEG_INF), dim=-1)
    max_text_logit = logits.masked_fill(is_ts, NEG_INF).amax(dim=-1)
    force_ts = ts_logsumexp > max_text_logit
    return logits.masked_fill(force_ts[:, None] & ~is_ts, NEG_INF)


# ---------------------------------------------------------------------------
# Token selection
# ---------------------------------------------------------------------------


def _greedy_update(
    spec: EngineSpec,
    state: _LoopState,
    logits: torch.Tensor,
    temperature: float,
    generator: Optional[torch.Generator],
    forced: Optional[List[int]] = None,
) -> _LoopState:
    """GreedyDecoder.update parity (reference decoding.py:277-293).

    A row whose buffer is full (t > n_ctx) is "capped": its tokens and
    logprob sum freeze.  ``forced`` (benchmark hook): sampling step s < F
    commits ``forced[s]`` in every row instead of the argmax/sample; every
    per-step computation still runs, so random weights can be driven through
    production-shaped token sequences.
    """
    tokens, t = state.tokens, state.t
    n_ctx1 = tokens.shape[1]  # n_ctx + 1

    if spec.argmax:
        next_tokens = logits.argmax(dim=-1)
    else:
        probs = torch.softmax(logits / temperature, dim=-1)
        next_tokens = torch.multinomial(probs, 1, generator=generator)[:, 0]
    if forced is not None and state.step < len(forced):
        next_tokens = torch.full_like(next_tokens, int(forced[state.step]))

    # selected-token logprob: log_softmax(x)[i] == x[i] - logsumexp(x)
    lse = torch.logsumexp(logits, dim=-1)
    current = logits.gather(1, next_tokens[:, None])[:, 0] - lse
    prev = tokens.gather(1, (t - 1).clamp(min=0)[:, None])[:, 0]
    capped = t >= n_ctx1
    not_finished = (prev != spec.eot) & ~capped
    sum_logprobs = state.sum_logprobs + current * not_finished
    next_tokens = torch.where(prev != spec.eot, next_tokens, spec.eot)

    # write at t; a capped row's write is dropped (rewrites what is there)
    col = t.clamp(max=n_ctx1 - 1)[:, None]
    kept = tokens.gather(1, col)[:, 0]
    tokens.scatter_(1, col, torch.where(capped, kept, next_tokens)[:, None])
    completed = ((next_tokens == spec.eot) | capped).all()
    return state._replace(
        tokens=tokens,
        t=t + 1,
        step=state.step + 1,
        sum_logprobs=sum_logprobs,
        completed=completed,
    )


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------


@torch.inference_mode()
def decode_engine(
    params,
    dims: ModelDimensions,
    spec: EngineSpec,
    mel_or_features: torch.Tensor,  # (1, n_mels, 3000) or (1, Ta, C)
    initial_tokens: torch.Tensor,  # (1, prefill_len) int64, right-padded
    initial_len: int,
    sot_index: int,
    sample_len: int,
    temperature: float,
    filter_args: FilterArgs,
    generator: Optional[torch.Generator] = None,
    features_given: bool = False,
    forced_tokens: Optional[List[int]] = None,
) -> EngineResult:
    """Decode one 30-second segment, greedy (or sampled at T > 0), one row.

    The token loop reads ``completed`` back to the host once per step, after
    queueing that step's decode step, so the host's launches overlap the
    device's work on the step before.  Its last decode step is computed and
    never used, as in the JAX engine.
    """
    n_audio = mel_or_features.shape[0]
    if n_audio != 1:
        raise NotImplementedError("batched decoding: ROADMAP.md, Queue 1, 'Batch and chunked'")
    n_ctx = spec.ctx_len or dims.n_text_ctx  # token-loop time capacity
    P = spec.prefill_len
    compute_dtype = params["decoder"]["tok_emb"].dtype
    device = mel_or_features.device

    # 1) encoder (or passthrough of precomputed features)
    if features_given:
        audio_features = mel_or_features.to(compute_dtype)
    else:
        audio_features = encoder_apply(params, dims, mel_or_features)

    # 2) cross K/V once per audio, then prefill the prompt block
    xk, xv = compute_cross_kv(params, dims, audio_features)
    hidden, pk, pv = decoder_prefill(params, dims, initial_tokens, xk, xv)

    # no-speech probability from the unfiltered logits at the SOT position
    if spec.no_speech >= 0:
        sot_probs = torch.softmax(project_logits(params, hidden[:, sot_index]), dim=-1)
        no_speech_probs = sot_probs[:, spec.no_speech]
    else:
        no_speech_probs = torch.full((n_audio,), float("nan"), device=device)

    cur_logits = project_logits(params, hidden[:, initial_len - 1])  # (1, V)

    cache = init_kv_cache(dims, 1, xk, xv, compute_dtype, ctx=n_ctx)
    # prefill K/V arrive (L, B, H, P, D); the cache stores time-last
    cache.self_k[..., :P] = pk.transpose(-1, -2)
    cache.self_v[..., :P] = pv.transpose(-1, -2)

    tokens = torch.zeros((1, n_ctx + 1), dtype=torch.int64, device=device)
    tokens[:, :P] = initial_tokens
    state = _LoopState(
        tokens=tokens,
        t=torch.full((1,), initial_len, dtype=torch.int64, device=device),
        step=0,
        sum_logprobs=torch.zeros(1, dtype=torch.float32, device=device),
        completed=torch.zeros((), dtype=torch.bool, device=device),
    )

    while state.step < sample_len:
        filtered = apply_logit_filters(spec, cur_logits, state.tokens, state.t, filter_args)
        state = _greedy_update(spec, state, filtered, temperature, generator, forced_tokens)
        # the step for the token just chosen, at its (uniform) position
        pos = initial_len + state.step - 1
        h, cache = decoder_step_fused(params, dims, state.tokens[:, min(pos, n_ctx)], pos, cache)
        cur_logits = project_logits(params, h)
        if bool(state.completed):  # the loop's one host sync per step
            break

    return EngineResult(
        tokens=state.tokens,
        seq_len=state.t,
        sum_logprobs=state.sum_logprobs,
        no_speech_probs=no_speech_probs,
        audio_features=audio_features,
    )


@torch.inference_mode()
def detect_language_engine(
    params,
    dims: ModelDimensions,
    mel_or_features: torch.Tensor,
    language_mask: torch.Tensor,  # (V,) bool — True at language tokens
    sot: int,
    features_given: bool = False,
):
    """Single decoder step from <|sot|>, masked to language tokens.

    Returns (language_tokens (n_audio,), language_probs (n_audio, V),
    audio_features).  Parity with reference decoding.py:18-77.
    """
    if features_given:
        audio_features = mel_or_features.to(params["decoder"]["tok_emb"].dtype)
    else:
        audio_features = encoder_apply(params, dims, mel_or_features)
    n_audio = audio_features.shape[0]
    tokens = torch.full((n_audio, 1), sot, dtype=torch.int64, device=audio_features.device)
    logits = decoder_forward(params, dims, tokens, audio_features)[:, 0]
    logits = logits.masked_fill(~language_mask[None, :], NEG_INF)
    return logits.argmax(dim=-1), torch.softmax(logits, dim=-1), audio_features
