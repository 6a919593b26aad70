"""Uni-MoE-2.0-Omni's speech-to-text path in whisper_tpu_torch
(``models/uni_moe.py``, ``engine.decode_lm``, ``transcribe_batch``'s LM
path) against the plain float32 reference ``benchmark/reference/uni_moe_ref.py``,
at a tiny width on the CPU, on seeded random weights (the benchmark
family's ``make_state_dict``, the configuration's weight rules).

Tolerances, float32 on both sides: the port and the reference compute the
same products in other orders (q, k and v in one product, every expert in
one, attention by ``scaled_dot_product_attention``), so they agree to
float32 rounding: logits of spread about 8 within 1e-3, a layer's MoE
output of unit scale within 1e-5; a batched decode and each file alone
run other shapes, so their log-probabilities agree within 1e-5 nats.
"""

import numpy as np
import pytest
import torch

from benchmark.harness import spec
from benchmark.reference import uni_moe_ref as ref
from benchmark.reference import whisper_ref
from whisper_tpu_torch import engine, transcribe_batch
from whisper_tpu_torch.models import uni_moe
from whisper_tpu_torch.serve import BatchingTranscriber

FAMILY = spec.module("families", "uni_moe")
RULES = spec.Cell("uni-moe.batch16").config["assumed"]["weights"]
TINY = dict(n_mels=128, n_audio_ctx=1500, n_audio_state=64, n_audio_head=2, n_audio_layer=2, n_audio_tokens=8,
            n_state=64, n_layer=2, n_head=4, n_kv_head=2, n_vocab=512, n_ctx=48, n_expert=4, n_null_expert=1,
            expert_width=32, n_shared=2, shared_width=16, top_k=2, top_p=0.7, rope_theta=1e6, rms_eps=1e-6,
            eos=511)
DIMS = uni_moe.UniMoeDims(**TINY)
PROMPT = ([3, 17, 101], [9, 44])
FORCED = [int(x) for x in np.random.default_rng(5).integers(0, 500, size=12)] + [TINY["eos"]]
OTHER = [int(x) for x in np.random.default_rng(6).integers(0, 500, size=12)] + [TINY["eos"]]
LOGIT_ATOL = 1e-3
MOE_ATOL = 1e-5
LOGPROB_ATOL = 1e-5
SR = 16000


def _state(seed: int = 7):
    return FAMILY.make_state_dict(TINY, RULES, seed, torch.float32, torch.device("cpu"))


def _model(state) -> uni_moe.UniMoe:
    return uni_moe.UniMoe(DIMS, uni_moe.convert_state_dict(dict(state), DIMS), prompt=PROMPT)


def _wave(seconds: float, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * SR)) / SR
    return (0.3 * np.sin(2 * np.pi * rng.uniform(100, 900) * t) + 0.1 * rng.standard_normal(t.size)).astype(np.float32)


@pytest.fixture(scope="module")
def tiny():
    state = _state()
    return state, _model(state)


@pytest.fixture
def pinned():
    engine.LmPins.forced = lambda file, seek: FORCED
    yield
    engine.LmPins.forced = None


def _mel_window(seed: int) -> torch.Tensor:
    return whisper_ref.log_mel(_wave(12.0, seed), 128, torch.device("cpu"))[:, :3000]


def test_prefill_then_cached_decode_match_the_full_forward(tiny):
    state, model = tiny
    mels = [_mel_window(1), _mel_window(2)]
    P = len(PROMPT[0]) + DIMS.n_audio_tokens + len(PROMPT[1])
    cache, step = model.decoder(2)
    with torch.inference_mode():
        h, _ = uni_moe.prefill(model, model.encode(torch.stack(mels)), *PROMPT, cache)
        got = [uni_moe.logits(model.params, DIMS, h)]
        for s in range(len(FORCED) - 1):
            h, _ = step(torch.tensor([FORCED[s], OTHER[s]]), P + s)
            got.append(uni_moe.logits(model.params, DIMS, h))
    got = torch.stack(got, dim=1)  # (B, F, V)
    want = ref.Model(state, TINY, torch.device("cpu")).logits(mels, *PROMPT, [FORCED, OTHER])
    for b in range(2):
        assert want[b].std() > 4  # the logits spread as the rules set them
        torch.testing.assert_close(got[b], want[b], atol=LOGIT_ATOL, rtol=0)


def _layer(state, i: int = 0):
    return {k[len(f"layers.{i}."):]: v for k, v in state.items() if k.startswith(f"layers.{i}.")}


def _swiglu(x, w, name):
    return F_linear(F_silu(F_linear(x, w[name + ".gate.weight"])) * F_linear(x, w[name + ".up.weight"]),
                    w[name + ".down.weight"])


F_linear, F_silu = torch.nn.functional.linear, torch.nn.functional.silu


def _routed_x(logits: torch.Tensor, seed: int = 3):
    """Rows whose first five entries are the router's logits under a router
    that reads them alone (an identity on them), the rest random."""
    x = torch.randn(logits.shape[0], DIMS.n_state, generator=torch.Generator().manual_seed(seed))
    x[:, :5] = logits
    router = torch.zeros(5, DIMS.n_state)
    router[:, :5] = torch.eye(5)
    return x, router


def _logits_for(p: list) -> torch.Tensor:
    return torch.tensor(p).log()[None]


@pytest.mark.parametrize("probs,picked", [
    ([0.8, 0.1, 0.05, 0.03, 0.02], [0]),  # p1 >= top_p: one pick
    ([0.7, 0.2, 0.05, 0.03, 0.02], [0]),  # at top_p itself: one pick
    ([0.5, 0.3, 0.1, 0.05, 0.05], [0, 1]),  # below it: two
    ([0.3, 0.25, 0.2, 0.15, 0.1], [0, 1]),  # the mass of two still under top_p: never three
    ([0.1, 0.05, 0.05, 0.2, 0.6], [4, 3]),  # the null expert first
])
def test_the_router_picks_top_p_capped_at_two(probs, picked):
    x, router = _routed_x(_logits_for(probs))
    weights = uni_moe.route(x, router, DIMS.top_p, DIMS.top_k)[0]
    assert sorted(weights.nonzero()[:, 0].tolist()) == sorted(picked)
    torch.testing.assert_close(weights[picked], torch.tensor(probs)[picked])  # not renormalised
    assert ref.picks(torch.tensor([probs]), DIMS.top_p, DIMS.top_k)[0].nonzero()[:, 0].tolist() == sorted(picked)


def test_the_router_never_picks_three_and_agrees_with_the_reference():
    x = torch.randn(4000, DIMS.n_state, generator=torch.Generator().manual_seed(1))
    router = torch.randn(5, DIMS.n_state, generator=torch.Generator().manual_seed(2)) * 1.5 / 8
    weights = uni_moe.route(x, router, DIMS.top_p, DIMS.top_k)
    n = (weights > 0).sum(-1)
    assert n.min() == 1 and n.max() == 2 and (n == 1).any() and (n == 2).any()
    probs = torch.softmax(x @ router.T, dim=-1)
    assert torch.equal(weights > 0, ref.picks(probs, DIMS.top_p, DIMS.top_k))


@pytest.mark.parametrize("probs,routed", [
    ([0.5, 0.05, 0.03, 0.02, 0.4], [0]),  # a routed expert and the null one: the null adds nothing
    ([0.1, 0.05, 0.03, 0.02, 0.8], []),  # the null alone: the shared experts alone
])
def test_a_picked_null_expert_adds_nothing(tiny, probs, routed):
    state, model = tiny
    x, router = _routed_x(_logits_for(probs))
    p = dict(model.params["layers"][0], router_w=router)
    h = torch.randn(1, DIMS.n_state, generator=torch.Generator().manual_seed(4))
    out, weights = uni_moe.moe(h, x, p, DIMS)
    w = _layer(state)
    want = h + sum(_swiglu(x, w, f"moe.shared.{s}") for s in range(DIMS.n_shared))
    for e in routed:
        want = want + probs[e] * _swiglu(x, w, f"moe.experts.{e}")
    torch.testing.assert_close(out, want, atol=MOE_ATOL, rtol=0)


def test_the_fixed_shape_experts_equal_a_loop_over_each_tokens_picks(tiny):
    state, model = tiny
    w = _layer(state, 1)
    x = torch.randn(9, DIMS.n_state, generator=torch.Generator().manual_seed(6))
    h = torch.randn(9, DIMS.n_state, generator=torch.Generator().manual_seed(7))
    out, weights = uni_moe.moe(h, x, model.params["layers"][1], DIMS)
    probs = torch.softmax(x @ w["moe.router.weight"].T, dim=-1)
    picked = ref.picks(probs, DIMS.top_p, DIMS.top_k)
    assert torch.equal(weights > 0, picked) and picked[:, :4].any()
    for t in range(9):
        want = h[t] + sum(_swiglu(x[t], w, f"moe.shared.{s}") for s in range(DIMS.n_shared))
        for e in picked[t].nonzero()[:, 0].tolist():
            if e < DIMS.n_expert:
                want = want + probs[t, e] * _swiglu(x[t], w, f"moe.experts.{e}")
        torch.testing.assert_close(out[t], want, atol=MOE_ATOL, rtol=0)


def test_the_conversion_empties_the_state_into_fused_weights(tiny):
    state, _ = tiny
    part = dict(state)
    params = uni_moe.convert_state_dict(part, DIMS)
    assert not part and len(params["layers"]) == DIMS.n_layer
    layer, F, Fs = params["layers"][0], DIMS.expert_width, DIMS.shared_width
    assert torch.equal(layer["experts_gu_w"][F : 2 * F], state["layers.0.moe.experts.1.gate.weight"])
    up0 = DIMS.fused_width + DIMS.routed_width + Fs
    assert torch.equal(layer["experts_gu_w"][up0 : up0 + Fs], state["layers.0.moe.shared.1.up.weight"])
    assert torch.equal(layer["experts_down_w"][:, 3 * F : 4 * F], state["layers.0.moe.experts.3.down.weight"])
    assert layer["router_w"].dtype == torch.float32


def _segments(results):
    return [[(s["seek"], s["start"], s["end"], s["tokens"]) for s in r["segments"]] for r in results]


def test_transcribe_batch_gives_a_segment_a_window_as_each_file_alone(tiny, pinned):
    _, model = tiny
    waves = [_wave(70, 1), _wave(20, 2), np.zeros(0, np.float32), _wave(45, 3)]
    results = transcribe_batch(model, waves, batch_size=2, temperature=0.0)
    alone = [transcribe_batch(model, [w], batch_size=1, temperature=0.0)[0] for w in waves]
    assert [len(r["segments"]) for r in results] == [3, 1, 0, 2]
    assert _segments(results) == _segments(alone)
    for r, a in zip(results, alone):
        for s, t in zip(r["segments"], a["segments"]):
            assert s["tokens"] == FORCED[:-1] and s["text"] == ""
            assert s["avg_logprob"] == pytest.approx(t["avg_logprob"], abs=LOGPROB_ATOL)
            assert s["token_logprobs"] == pytest.approx(t["token_logprobs"], abs=LOGPROB_ATOL)
            assert s["avg_logprob"] == pytest.approx(np.mean(s["token_logprobs"]), abs=LOGPROB_ATOL)
            assert s["prompt_tokens"] == 13 and 0 < s["routed_picks"] <= 2 * DIMS.n_layer * (13 + len(FORCED))
    assert results[0]["segments"][2]["end"] == pytest.approx(70.0)


def test_the_counters_count_what_a_window_routed(tiny, pinned):
    _, model = tiny
    before = model.moe_counts.read()
    out = transcribe_batch(model, [_wave(20, 4)], batch_size=1, temperature=0.0)[0]["segments"][0]
    after = model.moe_counts.read()
    tokens = 13 + len(FORCED)  # prefill, then a step a forced token
    assert after["token_layers"] - before["token_layers"] == DIMS.n_layer * tokens
    assert after["decode_layers"] - before["decode_layers"] == DIMS.n_layer * len(FORCED)
    assert after["decode_token_layers"] - before["decode_token_layers"] == DIMS.n_layer * len(FORCED)
    picks = [a - b for a, b in zip(after["picks"], before["picks"])]
    assert sum(picks[:4]) == out["routed_picks"]
    assert DIMS.n_layer * tokens <= sum(picks) <= 2 * DIMS.n_layer * tokens
    assert 1 <= (after["experts_hit"] - before["experts_hit"]) / (DIMS.n_layer * len(FORCED)) <= 2


@pytest.mark.parametrize("option", [
    {"temperature": (0.0, 0.2)}, {"temperature": 0.5}, {"beam_size": 5}, {"word_timestamps": True},
    {"initial_prompt": "hello"}, {"prompt": [1, 2]}, {"condition_on_previous_text": False},
    {"language": "en"}, {"clip_timestamps": "1,5"},
])
def test_an_option_the_lm_path_does_not_implement_raises(tiny, option):
    _, model = tiny
    with pytest.raises(NotImplementedError):
        transcribe_batch(model, [_wave(5)], batch_size=1, **option)


def test_a_model_without_its_chat_template_is_refused(tiny):
    state, _ = tiny
    model = uni_moe.UniMoe(DIMS, uni_moe.convert_state_dict(dict(state), DIMS))
    with pytest.raises(ValueError, match="chat template"):
        transcribe_batch(model, [_wave(5)], temperature=0.0)


def test_the_batching_server_serves_the_model(tiny, pinned):
    _, model = tiny
    wave = _wave(35, 5)
    want = transcribe_batch(model, [wave], batch_size=1, temperature=0.0)[0]
    with BatchingTranscriber(model, batch_size=2, max_wait_s=0.01, temperature=0.0) as server:
        got = server.transcribe(wave, timeout=120)
    assert _segments([got]) == _segments([want]) and len(got["segments"]) == 2
    assert server.stats["batches"] == 1 and server.stats["errors"] == 0


def test_each_window_decodes_the_ids_pinned_for_its_file_and_seek(tiny):
    """The pin is read per row: a round's rows commit their own ids, and
    each token's log-probability is the reference's."""
    state, model = tiny

    def forced(file, seek):
        ids = np.random.default_rng([file, seek]).integers(0, 500, size=5 + file)
        return [int(x) for x in ids] + [TINY["eos"]]

    waves = [_wave(40, 6), _wave(25, 7)]
    engine.LmPins.forced = forced
    try:
        results = transcribe_batch(model, waves, batch_size=2, temperature=0.0)
    finally:
        engine.LmPins.forced = None
    want = ref.judge_files(ref.Model(state, TINY, torch.device("cpu")), waves, *PROMPT, forced)
    assert [len(r["segments"]) for r in results] == [2, 1]
    for k, (r, windows) in enumerate(zip(results, want)):
        for s, w in zip(r["segments"], windows):
            assert s["tokens"] == forced(k, s["seek"])[:-1] == w["tokens"]
            assert len(s["token_logprobs"]) == len(forced(k, s["seek"]))
            torch.testing.assert_close(torch.tensor(s["token_logprobs"]), torch.tensor(w["token_logprobs"]),
                                       atol=LOGIT_ATOL, rtol=0)
    assert results[0]["segments"][0]["tokens"] != results[1]["segments"][0]["tokens"]
