"""Segment decoding engine: encoder, cross K/V, prompt prefill and the token
loop (greedy, best-of sampling, beam search).

Counterpart of ``whisper_tpu/engine.py``, its per-step branch and its
write-block branch.  The JAX engine runs the token loop as one
``lax.while_loop`` on the device; here it is a Python loop that queues each
step's work (logit filters, selection, the decode step through kernel K2,
the logits) on the device and reads the stop flag back once per step, or,
with ``EngineSpec.write_block`` W > 1 (greedy and sampled rows), once per
block of W steps: each step's K/V goes to a small pending block that is
copied into the cache at the block's end, and the steps of a block past the
stop run inactive, changing nothing that is kept (whisper_tpu/engine.py:
599-662).  The filters are vectorised masks recomputed from the token
buffer every step, as there, so beam reordering carries no extra state.  A
batch holds n_audio audios of n_group rows each (a beam or best-of group,
or one greedy row), group-major, sharing their audio's cross K/V; each
audio's window carries its own prompt length, so every row runs at its own
position, held on the device.  :func:`decode_engine_speculative` is the
greedy engine with a draft model: the draft proposes a few tokens a round,
the target verifies them in one pass, and the output is the target's own
greedy decode (whisper_tpu/engine.py:712-975).
"""

import contextlib
from dataclasses import dataclass
from typing import List, NamedTuple, Optional, Sequence, Tuple, Union

import torch

from .models.dims import ModelDimensions
from .models.whisper import (
    NEG_INF,
    KVCache,
    compute_cross_kv,
    decoder_forward,
    decoder_prefill,
    decoder_step,
    decoder_step_fused,
    decoder_step_fused_pending,
    decoder_step_k,
    decoder_step_pending,
    encoder_apply,
    flush_pending,
    init_kv_cache,
    project_logits,
)
from .ops.kernels import fused_step
from .quantize import quantize_kv

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
    """Static configuration of one decode."""

    prefill_len: int  # bucketed initial-token block size
    argmax: bool  # temperature == 0
    use_ts_rules: bool  # timestamp rules active (not without_timestamps)
    eot: int
    no_speech: int  # -1 if absent
    no_timestamps: int
    timestamp_begin: int
    ctx_len: int = 0  # token-loop time capacity (0 => dims.n_text_ctx)
    beam_size: int = 0  # 0 => greedy/sampling
    n_group: int = 1  # beam_size or best_of or 1
    max_candidates: int = 0  # beam finished-buffer size (round(beam * patience))
    kv_int8: bool = False  # the token loop's cross K/V in int8 (kv_cache_dtype="int8")
    # greedy/sampling: defer the self-K/V writes in blocks of this many steps
    # (0 or 1: a cache column per step); beam search always writes per step
    write_block: int = 0


class FilterArgs(NamedTuple):
    """Inputs to the logit-filter chain."""

    suppress_mask: torch.Tensor  # (V,) bool — SuppressTokens set
    blank_mask: torch.Tensor  # (V,) bool — " " + EOT, applied at sample start
    # initial token length: shared, one per audio (decode_engine's input),
    # or a (B,) tensor per row (what the filters see)
    sample_begin: Union[int, Sequence[int], torch.Tensor]
    max_initial_ts_index: int  # -1 if unlimited


class EngineResult(NamedTuple):
    tokens: torch.Tensor  # (B, n_ctx+1) token buffer
    seq_len: torch.Tensor  # (B,) — per-row total length written
    sum_logprobs: torch.Tensor  # (B,) f32
    no_speech_probs: torch.Tensor  # (n_audio,) f32
    audio_features: torch.Tensor  # (n_audio, Ta, C)
    # beam-only finished buffers (size-1 placeholders in greedy mode)
    fin_tokens: torch.Tensor  # (n_audio, max_cand, n_ctx+1)
    fin_scores: torch.Tensor  # (n_audio, max_cand) f32
    fin_count: torch.Tensor  # (n_audio,)


class _LoopState(NamedTuple):
    tokens: torch.Tensor
    t: torch.Tensor  # (B,) — per-row write positions (initial_len + step)
    step: int  # shared sampling-step counter
    sum_logprobs: torch.Tensor
    completed: torch.Tensor  # () bool
    cache: Optional[KVCache] = None  # beam search permutes its self K/V
    fin_tokens: Optional[torch.Tensor] = None
    fin_scores: Optional[torch.Tensor] = None
    fin_count: Optional[torch.Tensor] = None


# ---------------------------------------------------------------------------
# Logit filters (vectorized parity with reference decoding.py:423-505)
# ---------------------------------------------------------------------------


def _column(x: Union[int, torch.Tensor]) -> Union[int, torch.Tensor]:
    """A per-row (B,) tensor as (B, 1), to broadcast over a row's columns;
    an int as it is."""
    return x[:, None] if isinstance(x, torch.Tensor) else x


def _latest_timestamp(
    tokens: torch.Tensor, t: torch.Tensor, sample_begin: Union[int, torch.Tensor], ts_begin: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Most recent timestamp token in the sampled region [sample_begin, t).

    t and sample_begin are per row ((B,); sample_begin may be one int).
    Returns (has_any (B,) bool, value (B,) int64).
    """
    positions = torch.arange(tokens.shape[1], device=tokens.device)[None, :]
    mask = (positions >= _column(sample_begin)) & (positions < t[:, None]) & (tokens >= ts_begin)
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
    applied in one pass (the rules of ``whisper_tpu.engine``), per row:
    ``f.sample_begin`` is one int or a (B,) tensor."""
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

    # a row past the buffer (capped, frozen while other rows run) reads its
    # last column; whisper_tpu's gather reads a fill value there, and either
    # way the row's filtered logits choose nothing that is kept
    last = tokens.shape[1] - 1
    prev = tokens.gather(1, (t - 1).clamp(0, last)[:, None])[:, 0]
    penult = tokens.gather(1, (t - 2).clamp(0, last)[:, None])[:, 0]
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
    active: Optional[torch.Tensor] = None,
) -> _LoopState:
    """GreedyDecoder.update parity (reference decoding.py:277-293).

    A row whose buffer is full (t > n_ctx) is "capped": its tokens and
    logprob sum freeze.  ``active`` (a () bool tensor, write-block mode
    only): when False the step is an overrun past the stop inside a block,
    and everything except the step counter freezes, so the kept state is the
    per-step engine's; the sampling generator still draws, as whisper_tpu's
    key still splits.  ``forced`` (benchmark hook): sampling step s < F
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
    prev = tokens.gather(1, (t - 1).clamp(0, n_ctx1 - 1)[:, None])[:, 0]
    capped = t >= n_ctx1
    not_finished = (prev != spec.eot) & ~capped
    sum_logprobs = state.sum_logprobs + current * not_finished
    next_tokens = torch.where(prev != spec.eot, next_tokens, spec.eot)

    # write at t; a capped row's write is dropped (rewrites what is there),
    # as is every write of an inactive step
    col = t.clamp(max=n_ctx1 - 1)[:, None]
    kept = tokens.gather(1, col)[:, 0]
    dropped = capped if active is None else capped | ~active
    tokens.scatter_(1, col, torch.where(dropped, kept, next_tokens)[:, None])
    completed = ((next_tokens == spec.eot) | capped).all()
    if active is not None:
        t = t + active.long()
        sum_logprobs = torch.where(active, sum_logprobs, state.sum_logprobs)
        completed = torch.where(active, completed, state.completed)
    else:
        t = t + 1
    return state._replace(
        tokens=tokens,
        t=t,
        step=state.step + 1,
        sum_logprobs=sum_logprobs,
        completed=completed,
    )


def _top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest entries of each row of f32 x, descending, equal values
    lowest index first (XLA's TopK order).  The ranking runs on int64 keys,
    the value's IEEE total-order bits above the reversed index, which are
    all distinct, so no tie is left to the sort's implementation."""
    bits = x.contiguous().view(torch.int32)
    order = (bits ^ ((bits >> 31) & 0x7FFFFFFF)).to(torch.int64)
    V = x.shape[-1]
    reverse_index = (V - 1) - torch.arange(V, device=x.device)
    _, idx = torch.topk(order * (1 << 32) + reverse_index, k, dim=-1)
    return x.gather(-1, idx), idx


def _beam_update(spec: EngineSpec, state: _LoopState, logits: torch.Tensor) -> _LoopState:
    """BeamSearchDecoder.update parity (reference decoding.py:323-382), fixed
    shapes, as whisper_tpu's ``_beam_update``.

    Candidate order (beam-major, top-k rank within beam) plus a stable sort
    reproduces the reference's sorted-dict iteration; the first update only
    draws candidates from beam 0, which is equivalent to the reference's
    dict-dedup across initially identical beams.  An audio group whose
    buffer is full freezes entirely (no new candidates, no reordering).
    The finished buffers carry one spare slot at index max_candidates that
    takes the writes the JAX package drops.
    """
    beam = spec.beam_size
    k = beam + 1
    tokens, t = state.tokens, state.t
    B, n_ctx1 = tokens.shape
    n_audio = B // beam
    dev = tokens.device
    capped_row = t >= n_ctx1  # (B,), group-constant

    logprobs = torch.log_softmax(logits, dim=-1)  # (B, V)
    top_lp, top_tok = _top_k(logprobs, k)  # (B, k)
    cand_scores = state.sum_logprobs[:, None] + top_lp
    if state.step == 0:  # all beams are identical: only beam 0 contributes
        beam_idx = torch.arange(B, device=dev) % beam
        cand_scores = cand_scores.masked_fill((beam_idx > 0)[:, None], NEG_INF)

    cand_scores = cand_scores.reshape(n_audio, beam * k)
    cand_tok = top_tok.reshape(n_audio, beam * k)
    neg_sorted, order = torch.sort(-cand_scores, dim=1, stable=True)
    s_scores = -neg_sorted
    s_tok = cand_tok.gather(1, order)
    s_src = order // k  # source beam within the audio group

    is_eot = s_tok == spec.eot
    not_eot = (~is_eot).long()
    saved_before = not_eot.cumsum(1) - not_eot
    processed = saved_before < beam  # the reference stops after beam non-EOT saves

    # new live beams: the first `beam` non-EOT candidates in score order (at
    # least that many exist: each top-k row holds at most one EOT)
    rank = (processed & ~is_eot).long().cumsum(1)
    targets = torch.arange(1, beam + 1, device=dev)
    sel = (rank[:, None, :] >= targets[None, :, None]).long().argmax(-1)  # (n_audio, beam)
    sel_tok = s_tok.gather(1, sel)
    sel_src = s_src.gather(1, sel)
    sel_score = s_scores.gather(1, sel)

    # capped groups freeze: their beams keep their slots and scores
    capped_audio = capped_row.reshape(n_audio, beam)[:, 0]
    own_src = torch.arange(beam, device=dev).expand(n_audio, beam)
    sel_src = torch.where(capped_audio[:, None], own_src, sel_src)
    sel_score = torch.where(
        capped_audio[:, None], state.sum_logprobs.reshape(n_audio, beam), sel_score
    )
    audio = torch.arange(n_audio, device=dev)[:, None]
    src_global = (audio * beam + sel_src).reshape(B)

    # finished sequences: EOT candidates above the cut, appended in score
    # order until the patience budget is full (decoding.py:367-375); at most
    # `beam` finish per step
    fin_rank = (processed & is_eot & ~capped_audio[:, None]).long().cumsum(1)
    slot = torch.arange(1, beam + 1, device=dev)
    cand_idx = (fin_rank[:, None, :] >= slot[None, :, None]).long().argmax(-1)  # (n_audio, beam)
    has = fin_rank[:, -1:] >= slot[None, :]  # the j-th EOT exists at all
    src_small = s_src.gather(1, cand_idx)
    scores_small = s_scores.gather(1, cand_idx)
    write_pos = state.fin_count[:, None] + torch.arange(beam, device=dev)[None, :]
    valid = has & (write_pos < spec.max_candidates)
    write_pos = torch.where(valid, write_pos, spec.max_candidates)  # the spare slot
    # finished row content: the source beam's tokens with EOT at position t
    fin_rows = tokens[audio * beam + src_small]  # (n_audio, beam, n_ctx+1)
    t_audio = t.reshape(n_audio, beam)[:, 0]
    cols = torch.arange(n_ctx1, device=dev)
    fin_rows = torch.where(cols[None, None, :] == t_audio[:, None, None], spec.eot, fin_rows)
    rows = audio.expand(n_audio, beam)
    fin_tokens = state.fin_tokens.index_put((rows, write_pos), fin_rows)
    fin_scores = state.fin_scores.index_put((rows, write_pos), scores_small)
    fin_count = state.fin_count + valid.sum(1)

    # the beam permutation of tokens and of the self-KV cache (a gather of
    # whole rows, as in the JAX engine)
    new_tokens = torch.where(
        cols[None, :] == t[:, None], sel_tok.reshape(B)[:, None], tokens[src_global]
    )
    cache = state.cache._replace(
        self_k=state.cache.self_k[:, src_global], self_v=state.cache.self_v[:, src_global]
    )
    completed = ((fin_count >= spec.max_candidates) | capped_audio).all()
    return state._replace(
        tokens=new_tokens,
        t=t + 1,
        step=state.step + 1,
        cache=cache,
        sum_logprobs=sel_score.reshape(B),
        completed=completed,
        fin_tokens=fin_tokens,
        fin_scores=fin_scores,
        fin_count=fin_count,
    )


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------


def decoder_steps(params, dims: ModelDimensions):
    """The token loop's step and its pending form, chosen by the decoder's
    shape once per decode, before any launch, as whisper_tpu's
    ``_fused_ok`` (``whisper_tpu/decoding.py:324-328``): through kernel K2
    where it takes the shape (``fused_step.takes``: every published model),
    else the PyTorch step, the way ``ops.attention`` sends K1 only the head
    dims it takes.  This is a dispatch by shape: a K2 launch that fails
    raises."""
    dtype = params["decoder"]["tok_emb"].dtype
    if fused_step.takes(dims.n_text_head, dims.n_text_state, dtype):
        return decoder_step_fused, decoder_step_fused_pending
    return decoder_step, decoder_step_pending


def _per_audio(x: Union[int, Sequence[int]], n_audio: int) -> List[int]:
    return [int(x)] * n_audio if isinstance(x, int) else [int(v) for v in x]


@torch.inference_mode()
def decode_engine(
    params,
    dims: ModelDimensions,
    spec: EngineSpec,
    mel_or_features: torch.Tensor,  # (n_audio, n_mels, 3000) or (n_audio, Ta, C)
    initial_tokens: torch.Tensor,  # (n_audio, prefill_len) int64, right-padded
    initial_len: Union[int, Sequence[int]],  # shared, or one per audio
    sot_index: Union[int, Sequence[int]],  # shared, or one per audio
    sample_len: int,
    temperature: float,
    filter_args: FilterArgs,
    generator: Optional[torch.Generator] = None,
    features_given: bool = False,
    forced_tokens: Optional[List[int]] = None,
) -> EngineResult:
    """Decode one batch of 30-second segments: greedy or sampled (T > 0)
    rows, n_group of them per audio for best-of, or a beam search of
    n_group beams per audio.

    Audios may have prompts of different lengths: ``initial_len``,
    ``sot_index`` and ``filter_args.sample_begin`` are host values, one int
    for every audio or one per audio, as whisper_tpu's per-row vectors
    (``whisper_tpu/engine.py:497-591``).  Each prompt is prefilled once and
    its K/V, tokens and first logits (at its own ``initial_len - 1``) are
    tiled to its group's rows, which share the audio's cross K/V.  Each step
    runs every row at its own position ``t - 1``, a device tensor that
    kernel K2 reads there; when every prompt has the same length (every
    single-file decode) the rows share one position, a host int, and the
    step needs no per-row gather or scatter.  The token loop reads
    ``completed`` back to the host once per step, after queueing that
    step's decode step, so the host's launches overlap the device's work on
    the step before; with ``spec.write_block`` (:func:`_block_loop`) once per
    block.  Its last decode step is computed and never used, as in the JAX
    engine.
    """
    n_audio = mel_or_features.shape[0]
    G = spec.n_group
    B = n_audio * G
    n_ctx = spec.ctx_len or dims.n_text_ctx  # token-loop time capacity
    P = spec.prefill_len
    compute_dtype = params["decoder"]["tok_emb"].dtype
    device = mel_or_features.device
    lens = _per_audio(initial_len, n_audio)
    begins = _per_audio(filter_args.sample_begin, n_audio)
    # one host-to-device copy for the per-audio values
    lens_dev, sots_dev, begins_dev = torch.tensor(
        [lens, _per_audio(sot_index, n_audio), begins], dtype=torch.int64
    ).to(device)
    audios = torch.arange(n_audio, device=device)

    # 1) encoder (or passthrough of precomputed features)
    if features_given:
        audio_features = mel_or_features.to(compute_dtype)
    else:
        audio_features = encoder_apply(params, dims, mel_or_features)

    # 2) cross K/V once per audio, then prefill the prompt blocks
    xk, xv = compute_cross_kv(params, dims, audio_features)
    hidden, pk, pv = decoder_prefill(params, dims, initial_tokens, xk, xv)

    # no-speech probability from the unfiltered logits at each row's SOT
    if spec.no_speech >= 0:
        sot_probs = torch.softmax(project_logits(params, hidden[audios, sots_dev]), dim=-1)
        no_speech_probs = sot_probs[:, spec.no_speech]
    else:
        no_speech_probs = torch.full((n_audio,), float("nan"), device=device)

    # 3) tile to n_audio * n_group rows; cross K/V stay at one per audio
    cur_logits = project_logits(params, hidden[audios, lens_dev - 1]).repeat_interleave(G, 0)
    uniform = min(lens) == max(lens)  # every row at lens[0] + step
    if min(begins) != max(begins):
        filter_args = filter_args._replace(sample_begin=begins_dev.repeat_interleave(G))
    else:
        filter_args = filter_args._replace(sample_begin=begins[0])
    # the token loop's cross K/V, optionally int8 per (audio, head, channel)
    # as whisper_tpu's (engine.py:545-554): the prefill, no_speech and the
    # first logits above ran at full precision
    if spec.kv_int8:
        xk, xv = quantize_kv(xk), quantize_kv(xv)
    cache = init_kv_cache(dims, B, xk, xv, compute_dtype, ctx=n_ctx)
    # prefill K/V arrive (L, n_audio, H, P, D); the cache stores time-last
    L, _, H, D, _ = cache.self_k.shape
    for buf, pre in ((cache.self_k, pk), (cache.self_v, pv)):
        buf.view(L, n_audio, G, H, D, n_ctx)[..., :P] = pre.transpose(-1, -2)[:, :, None]

    tokens = torch.zeros((B, n_ctx + 1), dtype=torch.int64, device=device)
    tokens[:, :P] = initial_tokens.repeat_interleave(G, 0)
    n_fin = max(spec.max_candidates, 1)
    state = _LoopState(
        tokens=tokens,
        t=lens_dev.repeat_interleave(G),
        step=0,
        sum_logprobs=torch.zeros(B, dtype=torch.float32, device=device),
        completed=torch.zeros((), dtype=torch.bool, device=device),
        cache=cache,
        # one spare slot past n_fin takes the finished writes that miss
        fin_tokens=torch.zeros((n_audio, n_fin + 1, n_ctx + 1), dtype=torch.int64, device=device),
        fin_scores=torch.full((n_audio, n_fin + 1), float("-inf"), device=device),
        fin_count=torch.zeros(n_audio, dtype=torch.int64, device=device),
    )

    step, step_pending = decoder_steps(params, dims)
    if spec.write_block > 1 and spec.beam_size == 0:
        state = _block_loop(params, dims, spec, state, cur_logits, lens[0] if uniform else None,
                            sample_len, temperature, filter_args, generator, forced_tokens,
                            step_pending)
    else:
        while state.step < sample_len:
            filtered = apply_logit_filters(spec, cur_logits, state.tokens, state.t, filter_args)
            if spec.beam_size > 0:
                state = _beam_update(spec, state, filtered)
            else:
                state = _greedy_update(spec, state, filtered, temperature, generator, forced_tokens)
            # the step for the tokens just chosen, each row at its own position
            if uniform:
                pos = lens[0] + state.step - 1
                prev = state.tokens[:, min(pos, n_ctx)]
            else:
                pos = state.t - 1
                prev = state.tokens.gather(1, pos.clamp(0, n_ctx)[:, None])[:, 0]
            h, cache = step(params, dims, prev, pos, state.cache)
            state = state._replace(cache=cache)
            cur_logits = project_logits(params, h)
            if bool(state.completed):  # the loop's one host sync per step
                break

    return EngineResult(
        tokens=state.tokens,
        seq_len=state.t,
        sum_logprobs=state.sum_logprobs,
        no_speech_probs=no_speech_probs,
        audio_features=audio_features,
        fin_tokens=state.fin_tokens[:, :n_fin],
        fin_scores=state.fin_scores[:, :n_fin],
        fin_count=state.fin_count,
    )


def _block_loop(
    params,
    dims: ModelDimensions,
    spec: EngineSpec,
    state: _LoopState,
    cur_logits: torch.Tensor,
    base: Optional[int],  # every row's prompt length when they share it, else None
    sample_len: int,
    temperature: float,
    filter_args: FilterArgs,
    generator: Optional[torch.Generator],
    forced_tokens: Optional[List[int]],
    step_pending,
) -> _LoopState:
    """The greedy/sampled token loop in blocks of W = spec.write_block
    steps (whisper_tpu/engine.py:599-662).  A block zeroes the pending
    buffers, runs W steps whose K/V go to pending column w (each step
    attends [cache < block start | pending columns < w | new]), then copies
    the block into the cache.  The block starts at base + step (a host
    int) when the rows share their prompt length, else at each row's t.  A
    step of a block past sample_len or past every row's stop runs with
    active False and keeps nothing; the stop flag is read once per block."""
    cache = state.cache
    L, B, H, D, n_ctx = cache.self_k.shape
    W = spec.write_block
    pend_k = torch.zeros((L, B, H, D, W), dtype=cache.self_k.dtype, device=cache.self_k.device)
    pend_v = torch.zeros_like(pend_k)
    inactive = torch.zeros((), dtype=torch.bool, device=cache.self_k.device)
    while state.step < sample_len:
        block_start = base + state.step if base is not None else state.t
        pend_k.zero_()
        pend_v.zero_()
        for w in range(W):
            active = ~state.completed if state.step < sample_len else inactive
            filtered = apply_logit_filters(spec, cur_logits, state.tokens, state.t, filter_args)
            state = _greedy_update(spec, state, filtered, temperature, generator, forced_tokens,
                                   active=active)
            if base is not None:
                pos = base + state.step - 1
                prev = state.tokens[:, min(pos, n_ctx)]
            else:
                pos = state.t - 1
                prev = state.tokens.gather(1, pos.clamp(0, n_ctx)[:, None])[:, 0]
            h, pend_k, pend_v = step_pending(
                params, dims, prev, pos, block_start, w, pend_k, pend_v, cache)
            cur_logits = project_logits(params, h)
        flush_pending(cache, pend_k, pend_v, block_start)
        if bool(state.completed):  # the loop's one host sync per block
            break
    return state


# ---------------------------------------------------------------------------
# Speculative greedy decoding (a draft model proposes, the target verifies)
# ---------------------------------------------------------------------------


class _SpecState(NamedTuple):
    tokens: torch.Tensor  # (B, n_ctx+1): committed and provisional draft tokens
    t: torch.Tensor  # (B,): committed length per row
    cache: KVCache  # the target's
    draft_cache: KVCache
    sum_logprobs: torch.Tensor  # (B,) f32
    done: torch.Tensor  # (B,) bool: EOT committed, budget reached or capped


def _put(tokens: torch.Tensor, pos: torch.Tensor, values: torch.Tensor,
         where: Optional[torch.Tensor] = None) -> None:
    """tokens[b, pos[b]] = values[b] in place, for the rows of ``where``;
    a position past the buffer drops its write (JAX's ``mode="drop"``)."""
    last = tokens.shape[1] - 1
    keep = pos <= last if where is None else where & (pos <= last)
    col = pos.clamp(max=last)[:, None]
    tokens.scatter_(1, col, torch.where(keep, values, tokens.gather(1, col)[:, 0])[:, None])


def _gather_cols(tokens: torch.Tensor, start: torch.Tensor, k: int) -> torch.Tensor:
    """tokens[b, start[b] + i] for i < k, the columns clamped into the buffer."""
    cols = start[:, None] + torch.arange(k, device=tokens.device)
    return tokens.gather(1, cols.clamp(0, tokens.shape[1] - 1))


def _prefilled_cache(dims, B, xk, xv, pk, pv, dtype, n_ctx) -> KVCache:
    """A cache of B = n_audio rows with the prompt's K/V, (L, B, H, P, D),
    in its first P columns."""
    cache = init_kv_cache(dims, B, xk, xv, dtype, ctx=n_ctx)
    P = pk.shape[-2]
    cache.self_k[..., :P] = pk.transpose(-1, -2)
    cache.self_v[..., :P] = pv.transpose(-1, -2)
    return cache


@torch.inference_mode()
def decode_engine_speculative(
    params,
    draft_params,
    dims: ModelDimensions,
    draft_dims: ModelDimensions,
    spec: EngineSpec,
    mel_or_features: torch.Tensor,  # (n_audio, n_mels, 3000) or (n_audio, Ta, C)
    initial_tokens: torch.Tensor,  # (n_audio, prefill_len) int64, right-padded
    initial_len: Union[int, Sequence[int]],  # shared, or one per audio
    sot_index: Union[int, Sequence[int]],
    sample_len: int,
    filter_args: FilterArgs,
    draft_len: int = 4,
    features_given: bool = False,
    share_encoder: bool = True,
    force_accept: bool = False,
    stage_timer=None,
) -> EngineResult:
    """Greedy decoding with a draft model proposing ``draft_len`` tokens a
    round (whisper_tpu/engine.py:712-975).

    Each round, per row at its committed length t: the draft's W = S + 2
    token resync pass (:func:`decoder_step_k` at max(t - W, 0)) brings its
    cache up to the committed prefix and gives its logits at t; S - 1
    one-token draft steps (:func:`decoder_steps`: kernel K2 where it takes
    the draft's shape) propose the rest, each written provisionally past t
    so that the filters see it; the target scores [last committed, d_1 ..
    d_S] in one (S+1)-token pass; a sequential scan then commits the
    target's own filtered argmax at each position while the draft matched,
    under the budget, cap and EOT rules.  So the output is the target's
    plain greedy decode for any draft; the draft only sets how many tokens
    a round commits.  ``force_accept`` (benchmark only) pretends every
    draft matched: the all-accept ceiling on random weights, whose outputs
    mean nothing.  The draft shares the target's encoder output when
    ``share_encoder``, else runs its own encoder on the mel.

    The host queues a round's work and reads ``done`` back once per round,
    after the verify pass and the scan.  Greedy only: one row per audio.
    ``stage_timer`` (any object whose ``.stage(name)`` is a context manager,
    e.g. :class:`~whisper_tpu_torch.profiling.StageTimer`) takes the
    encoder, prefill, draft (resync and draft steps), verify and accept
    stages.
    """
    def stage(name):
        return stage_timer.stage(name) if stage_timer is not None else contextlib.nullcontext()

    if spec.n_group != 1 or spec.beam_size or not spec.argmax:
        raise ValueError("speculative decoding is greedy only: one row per audio at temperature 0")
    if features_given and not share_encoder:
        # the draft's own encoder needs the raw mel
        raise ValueError(
            "speculative decoding with precomputed encoder features requires "
            "share_encoder=True (a non-shared draft encoder needs the raw mel)"
        )
    B = mel_or_features.shape[0]
    n_ctx = spec.ctx_len or dims.n_text_ctx
    S = draft_len
    W = S + 2  # the resync window covers the largest advance of a round
    compute_dtype = params["decoder"]["tok_emb"].dtype
    draft_dtype = draft_params["decoder"]["tok_emb"].dtype
    device = mel_or_features.device
    begins = _per_audio(filter_args.sample_begin, B)
    lens_dev, sots_dev, begins_dev = torch.tensor(
        [_per_audio(initial_len, B), _per_audio(sot_index, B), begins], dtype=torch.int64
    ).to(device)
    rows = torch.arange(B, device=device)
    filter_args = filter_args._replace(
        sample_begin=begins[0] if min(begins) == max(begins) else begins_dev)

    with stage("encoder"):
        if features_given:
            audio_features = mel_or_features.to(compute_dtype)
        else:
            audio_features = encoder_apply(params, dims, mel_or_features)
        if share_encoder:
            draft_features = audio_features.to(draft_dtype)
        else:
            draft_features = encoder_apply(draft_params, draft_dims, mel_or_features)
    with stage("prefill"):  # cross K/V and prefill of both models
        xk, xv = compute_cross_kv(params, dims, audio_features)
        hidden, pk, pv = decoder_prefill(params, dims, initial_tokens, xk, xv)
        dxk, dxv = compute_cross_kv(draft_params, draft_dims, draft_features)
        _, dpk, dpv = decoder_prefill(draft_params, draft_dims, initial_tokens, dxk, dxv)
    if spec.no_speech >= 0:
        sot_probs = torch.softmax(project_logits(params, hidden[rows, sots_dev]), dim=-1)
        no_speech_probs = sot_probs[:, spec.no_speech]
    else:
        no_speech_probs = torch.full((B,), float("nan"), device=device)
    if spec.kv_int8:  # the target's loop reads int8 cross K/V (whisper_tpu/engine.py:807-810)
        xk, xv = quantize_kv(xk), quantize_kv(xv)

    tokens = torch.zeros((B, n_ctx + 1), dtype=torch.int64, device=device)
    tokens[:, :spec.prefill_len] = initial_tokens
    state = _SpecState(
        tokens=tokens,
        t=lens_dev.clone(),
        cache=_prefilled_cache(dims, B, xk, xv, pk, pv, compute_dtype, n_ctx),
        draft_cache=_prefilled_cache(draft_dims, B, dxk, dxv, dpk, dpv, draft_dtype, n_ctx),
        sum_logprobs=torch.zeros(B, dtype=torch.float32, device=device),
        done=torch.zeros(B, dtype=torch.bool, device=device),
    )
    draft_step, _ = decoder_steps(draft_params, draft_dims)

    def round_(s: _SpecState) -> _SpecState:
        tokens, t = s.tokens, s.t
        with stage("draft"):
            # the draft's resync: the tokens committed last round were never
            # through the draft; its logits at t give the first proposal.
            # Early rounds (t < W) rewrite prompt columns 0..W-1, as whisper_tpu
            start0 = (t - W).clamp(min=0)
            sync_h, draft_cache = decoder_step_k(
                draft_params, draft_dims, _gather_cols(tokens, start0, W), start0, s.draft_cache)
            d_logits = project_logits(draft_params, sync_h[rows, t - 1 - start0])
            prev = apply_logit_filters(spec, d_logits, tokens, t, filter_args).argmax(dim=-1)
            _put(tokens, t, prev)
            drafts, pos = [prev], t
            for _ in range(S - 1):  # the last proposal needs no step of its own
                h, draft_cache = draft_step(draft_params, draft_dims, prev, pos, draft_cache)
                logits = project_logits(draft_params, h)
                prev = apply_logit_filters(spec, logits, tokens, pos + 1, filter_args).argmax(dim=-1)
                _put(tokens, pos + 1, prev)
                drafts.append(prev)
                pos = pos + 1

        with stage("verify"):  # the target's pass over [last committed, d_1 .. d_S] at t - 1 ..
            ver_h, cache = decoder_step_k(params, dims, _gather_cols(tokens, t - 1, S + 1), t - 1,
                                          s.cache)
            ver_logits = project_logits(params, ver_h)  # (B, S + 1, V) f32

        with stage("accept"):
            # position i commits the target's greedy token; the scan goes on
            # only while the draft predicted that token
            acc, done, sum_lp, t_cur = ~s.done, s.done, s.sum_logprobs, t
            for i in range(S + 1):
                filtered = apply_logit_filters(spec, ver_logits[:, i], tokens, t_cur, filter_args)
                tok = filtered.argmax(dim=-1)
                lp = torch.log_softmax(filtered, dim=-1).gather(1, tok[:, None])[:, 0]
                capped = t_cur >= n_ctx + 1
                budget_ok = (t_cur - lens_dev) < sample_len
                commit = acc & ~done & budget_ok & ~capped
                _put(tokens, t_cur, tok, commit)
                sum_lp = sum_lp + torch.where(commit, lp, 0.0)
                t_cur = t_cur + commit.long()
                done = done | (commit & (tok == spec.eot)) | ~budget_ok | capped
                if i < S:  # the bonus position i == S never continues
                    matched = torch.ones_like(commit) if force_accept else tok == drafts[i]
                    acc = commit & matched & (tok != spec.eot)
        return _SpecState(tokens, t_cur, cache, draft_cache, sum_lp, done)

    for _ in range(sample_len):
        state = round_(state)
        if bool(state.done.all()):  # the loop's one host sync per round
            break

    # provisional draft tokens past each row's length become EOT
    cols = torch.arange(n_ctx + 1, device=device)[None, :]
    n_fin = max(spec.max_candidates, 1)
    return EngineResult(
        tokens=torch.where(cols >= state.t[:, None], spec.eot, state.tokens),
        seq_len=state.t,
        sum_logprobs=state.sum_logprobs,
        no_speech_probs=no_speech_probs,
        audio_features=audio_features,
        fin_tokens=torch.zeros((B, n_fin, n_ctx + 1), dtype=torch.int64, device=device),
        fin_scores=torch.full((B, n_fin), float("-inf"), device=device),
        fin_count=torch.zeros(B, dtype=torch.int64, device=device),
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
