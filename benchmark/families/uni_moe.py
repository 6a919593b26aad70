"""The Uni-MoE family (``"family": "uni_moe"`` in a configuration):
Uni-MoE-2.0-Omni's speech-to-text path, the port's
``whisper_tpu_torch.models.uni_moe``.

- ``layout`` and ``make_state_dict``: seeded random weights, one tensor a
  part (the layout of ``reference/uni_moe_ref.py``), and ``build_model``:
  the port's model from them;
- ``pin`` / ``unpin``: the chat template's ids around the audio and each
  window's forced output, drawn from the seed (and the window's file and
  seek) and pinned in the port's hook ``engine.LmPins``;
- ``judge``: the comparison with the plain float32 reference
  (``reference``, ``reference/uni_moe_ref.py``);
- ``window_work`` and ``window_ops``: each 30 s window's prompt, decode
  steps and routed picks (which the port reports in each segment), and its
  model operations (``mfu_pct.batch``);
- ``FAULTS``: faults planted in the port's timed path, each of which the
  comparison has to see.

The port is imported when this module is: a port without the model fails
the cell at once.
"""

import gc
import math
import statistics
from typing import Dict, List, Sequence, Tuple
from unittest import mock

import torch

from benchmark.harness import check, traffic
from benchmark.reference import uni_moe_ref as reference
from whisper_tpu_torch import engine
from whisper_tpu_torch.models import uni_moe

TIME_TOLERANCE = 1e-6  # s; a window's times are multiples of 10 ms

# -- weights ------------------------------------------------------------------


def layout(dims: Dict) -> List[Tuple[str, Tuple[int, ...]]]:
    """(key, shape) of every tensor of the state_dict, in the order they
    are drawn: the tower in openai/whisper's keys (its positional
    embedding, sinusoids, is not a weight), then the language model."""
    Ca, M, C = dims["n_audio_state"], dims["n_mels"], dims["n_state"]
    D = C // dims["n_head"]
    out = [("encoder.conv1.weight", (Ca, M, 3)), ("encoder.conv1.bias", (Ca,)),
           ("encoder.conv2.weight", (Ca, Ca, 3)), ("encoder.conv2.bias", (Ca,))]
    for i in range(dims["n_audio_layer"]):
        b = f"encoder.blocks.{i}"
        out += [(f"{b}.attn.query.weight", (Ca, Ca)), (f"{b}.attn.query.bias", (Ca,)),
                (f"{b}.attn.key.weight", (Ca, Ca)),
                (f"{b}.attn.value.weight", (Ca, Ca)), (f"{b}.attn.value.bias", (Ca,)),
                (f"{b}.attn.out.weight", (Ca, Ca)), (f"{b}.attn.out.bias", (Ca,)),
                (f"{b}.attn_ln.weight", (Ca,)), (f"{b}.attn_ln.bias", (Ca,)),
                (f"{b}.mlp.0.weight", (4 * Ca, Ca)), (f"{b}.mlp.0.bias", (4 * Ca,)),
                (f"{b}.mlp.2.weight", (Ca, 4 * Ca)), (f"{b}.mlp.2.bias", (Ca,)),
                (f"{b}.mlp_ln.weight", (Ca,)), (f"{b}.mlp_ln.bias", (Ca,))]
    out += [("encoder.ln_post.weight", (Ca,)), ("encoder.ln_post.bias", (Ca,)),
            ("connector.weight", (C, Ca)), ("connector.bias", (C,)),
            ("embed_tokens.weight", (dims["n_vocab"], C))]
    F, Fs = dims["expert_width"], dims["shared_width"]
    for i in range(dims["n_layer"]):
        b = f"layers.{i}"
        out += [(f"{b}.input_norm.weight", (C,))]
        for n, heads in (("q", dims["n_head"]), ("k", dims["n_kv_head"]), ("v", dims["n_kv_head"])):
            out += [(f"{b}.attn.{n}.weight", (heads * D, C)), (f"{b}.attn.{n}.bias", (heads * D,))]
        out += [(f"{b}.attn.o.weight", (C, dims["n_head"] * D)), (f"{b}.post_norm.weight", (C,)),
                (f"{b}.moe.router.weight", (dims["n_expert"] + dims["n_null_expert"], C))]
        for name, n, width in (("experts", dims["n_expert"], F), ("shared", dims["n_shared"], Fs)):
            for e in range(n):
                out += [(f"{b}.moe.{name}.{e}.gate.weight", (width, C)),
                        (f"{b}.moe.{name}.{e}.up.weight", (width, C)),
                        (f"{b}.moe.{name}.{e}.down.weight", (C, width))]
    out += [("norm.weight", (C,)), ("lm_head.weight", (dims["n_vocab"], C))]
    return out


def make_state_dict(dims: Dict, rules: Dict[str, float], seed: int, dtype: torch.dtype,
                    device) -> Dict[str, torch.Tensor]:
    """The seeded state_dict: each tensor drawn in :func:`layout`'s order
    by ``torch.randn`` on the device from one generator seeded with the
    run's seed, in the served dtype (the router in float32), and scaled in
    place by the rule of its kind, so that the reference can make it again
    after the window.  ``rules`` (the configuration's
    ``assumed.weights``): "linear_gain" (a weight of fan-in n has standard
    deviation gain / sqrt(n)), "qk_gain" (the same for the query and key
    projections), "router_gain" (the same for the router), "bias",
    "norm_gain_noise" (a norm's gain is 1 plus it), "ln_bias" (the tower's
    LayerNorm biases), "embed_std" (the token embedding's), and
    "logit_std" (the head's standard deviation times sqrt(width): the
    logits' standard deviation over unit hidden states)."""
    gen = torch.Generator(device=device).manual_seed(seed % 2**63)
    out = {}
    for key, shape in layout(dims):
        router = key.endswith("moe.router.weight")
        t = torch.randn(shape, generator=gen, dtype=torch.float32 if router else dtype, device=device)
        if key.endswith(("norm.weight", "_ln.weight", "ln_post.weight")):
            t.mul_(rules["norm_gain_noise"]).add_(1.0)
        elif key.endswith(("_ln.bias", "ln_post.bias")):
            t.mul_(rules["ln_bias"])
        elif key.endswith(".bias"):
            t.mul_(rules["bias"])
        elif key == "embed_tokens.weight":
            t.mul_(rules["embed_std"])
        elif key == "lm_head.weight":
            t.mul_(rules["logit_std"] / shape[1] ** 0.5)
        else:
            gain = rules["router_gain"] if router else rules["qk_gain"] if key.endswith(
                ("attn.q.weight", "attn.k.weight")) else rules["linear_gain"]
            t.mul_(gain / (shape[1] * (shape[2] if len(shape) == 3 else 1)) ** 0.5)
        out[key] = t
    return out


def _state_dict(cell, seed: int, device) -> Dict[str, torch.Tensor]:
    return make_state_dict(cell.dims, cell.config["assumed"]["weights"], seed,
                           getattr(torch, cell.config["dtype"]), device)


def build_model(cell, seed: int, device):
    """The port's model from the seeded state_dict
    (``uni_moe.convert_state_dict``, which empties it layer by layer), in
    the configuration's dtype; its chat template is the one pinned."""
    dims = uni_moe.UniMoeDims(**cell.dims)
    return uni_moe.UniMoe(dims, uni_moe.convert_state_dict(_state_dict(cell, seed, device), dims))


# -- the pinned ids --------------------------------------------------------------


def pin(run) -> None:
    """The chat template's ids before and after the audio, drawn from the
    seed among the ordinary ids (the configuration's
    ``assumed.chat_template``; its lengths are the template's), as
    ``run.prompt``, and each window's forced output, drawn from the seed,
    the file's number in its ``transcribe_batch`` call and the window's
    seek (the mix's ``forced.text_tokens`` ids and the stop token), as
    ``run.forced(file, seek)``: pinned in the port, so that the rows of a
    step decode texts of their own, as users' files do."""
    template, seed = run.cell.config["assumed"]["chat_template"], run.seed
    ids = lambda size, *stream: [int(x) for x in traffic.rng(seed, 2, *stream).integers(
        0, template["ordinary_ids"], size=size)]
    run.prompt = (ids(template["ids_before_audio"], 0), ids(template["ids_after_audio"], 1))
    n, eos = run.cell.mix["forced"]["text_tokens"], run.dims["eos"]
    run.forced = lambda file, seek: ids(n, 2, file, seek) + [eos]
    engine.LmPins.prompt, engine.LmPins.forced = run.prompt, run.forced


def unpin() -> None:
    engine.LmPins.prompt = engine.LmPins.forced = None


# -- the comparison ---------------------------------------------------------------


def median_abs(gaps: List[float]) -> float:
    """The median size of the gaps; a NaN or an infinity makes it
    infinite."""
    if any(not math.isfinite(g) for g in gaps):
        return math.inf
    return statistics.median(abs(g) for g in gaps) if gaps else 0.0


def compare(expected: List[Dict], result) -> Dict:
    """One request's readings: its port result (a dict, or an exception, or
    None if it never came) against the reference's windows; the gaps of
    each window's mean log-probability and of each of its tokens', signed
    (port less reference)."""
    out = {"tokens_wrong": 0, "logprob": [], "token_logprob": []}
    if not isinstance(result, dict):
        out["tokens_wrong"] = len(expected)
        return out
    segments = result["segments"]
    for k, e in enumerate(expected):
        if k >= len(segments):
            out["tokens_wrong"] += 1
            continue
        s = segments[k]
        if (s["seek"] != e["seek"] or abs(s["start"] - e["start"]) > TIME_TOLERANCE
                or abs(s["end"] - e["end"]) > TIME_TOLERANCE or list(s["tokens"]) != e["tokens"]):
            out["tokens_wrong"] += 1
        out["logprob"].append(s["avg_logprob"] - e["avg_logprob"])
        if len(s["token_logprobs"]) == len(e["token_logprobs"]):
            out["token_logprob"] += [a - b for a, b in zip(s["token_logprobs"], e["token_logprobs"])]
    out["tokens_wrong"] += max(0, len(segments) - len(expected))
    return out


def judge(run, picked: Sequence[int], products=None):
    """The readings of the sampled requests ``picked`` and a line for the
    log.  Once the window has closed and the port's state is freed, each
    is served again by the plain float32 reference from the same waveform,
    the same seeded state_dict (made again on the device, in the served
    dtype; the reference reads one layer at a time in float32) and the
    same pinned ids.  ``products="fp8"`` judges the reference computed with
    float8 products in the port's place (the comparison's control).  The
    readings:

    - ``tokens_wrong``: windows whose segment differs from the reference's
      (seek, start, end, tokens: the forced ids) or is missing or extra;
      exact;
    - ``failed``: requests that raised or never came;
    - ``token_gap_median``: the median size, over every forced token of
      the sampled windows, of the gap between the port's log-probability of
      the token and the reference's, in nats: the rounding of every token,
      which a few tokens whose router picks flipped under rounding do not
      move;
    - ``logprob_gap``: the mean size, over the sampled windows, of the gap
      between the port's average log-probability of the forced tokens and
      the reference's, in nats a token; ``logprob_gap_max`` the widest."""
    cell, device = run.cell, run.device
    reference.use_float32()
    waves = [run.files[i] for i in picked]
    per_call = cell.mix["files_per_call"]  # run.files holds the calls' files in turn
    forced = lambda k, seek: run.forced(picked[k] % per_call, seek)
    state = _state_dict(cell, run.seed, device)
    expected = reference.judge_files(reference.Model(state, cell.dims, device), waves, *run.prompt, forced)
    results = [run.results[i] for i in picked]
    if products:
        low = reference.judge_files(reference.Model(state, cell.dims, device, products=products), waves,
                                    *run.prompt, forced)
        results = [{"segments": windows} for windows in low]
    del state
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    wrong, logprob, token_logprob = 0, [], []
    for e, result in zip(expected, results):
        one = compare(e, result)
        wrong += one["tokens_wrong"]
        logprob += one["logprob"]
        token_logprob += one["token_logprob"]
    readings = {"tokens_wrong": wrong, "failed": run.failed, "token_gap_median": median_abs(token_logprob),
                "logprob_gap": check.mean_abs(logprob), "logprob_gap_max": check.max_abs(logprob)}
    log = (f"reference: {sum(len(e) for e in expected)} windows of {len(picked)} requests; "
           + ", ".join(f"{k} {v!r}" for k, v in readings.items() if k not in cell.limits))
    return readings, log


# -- the work of a window -----------------------------------------------------------


def window_work(results: list) -> List[tuple]:
    """(prompt positions, decode steps, routed picks) of every window of
    the results that came, as the port reports them in each segment; a
    window's steps are its ids and the stop token's."""
    return [(s["prompt_tokens"], len(s["tokens"]) + 1, s["routed_picks"])
            for r in results if isinstance(r, dict) for s in r["segments"]]


def window_ops(dims: Dict, prompt: int, steps: int, routed: int) -> float:
    """Model operations of one 30 s window: the tower (two convolutions,
    the blocks' projections, MLP and attention), the connector, the
    prefill of the prompt's positions (each token's projections, shared
    experts and router, causal attention, the last position's logits), per
    decode step the same for one token at its position and the logits, and
    the routed experts' picks that the port reports for the window."""
    M, Ta, Ca, Le = dims["n_mels"], dims["n_audio_ctx"], dims["n_audio_state"], dims["n_audio_layer"]
    C, L, H, KVH, V = dims["n_state"], dims["n_layer"], dims["n_head"], dims["n_kv_head"], dims["n_vocab"]
    D = C // H
    tower = 2 * 3 * M * Ca * 2 * Ta + 2 * 3 * Ca * Ca * Ta + Le * (2 * Ta * 12 * Ca * Ca + 4 * Ta * Ta * Ca)
    connector = 2 * dims["n_audio_tokens"] * Ca * C
    per_token = L * (2 * C * (H + 2 * KVH) * D + 2 * H * D * C  # q, k, v, o
                     + 2 * 3 * C * dims["shared_width"] * dims["n_shared"]
                     + 2 * C * (dims["n_expert"] + dims["n_null_expert"]))
    attention = lambda keys: L * 4 * H * D * keys  # scores and values of one query
    prefill = prompt * per_token + sum(attention(t + 1) for t in range(prompt)) + 2 * V * C
    decode = sum(per_token + attention(prompt + s + 1) + 2 * V * C for s in range(steps))
    return float(tower + connector + prefill + decode + routed * 2 * 3 * C * dims["expert_width"])


# -- planted faults ------------------------------------------------------------------
# Each is a context manager that patches the port while it is open:
# ``benchmark/tests/test_portbench_uni_moe.py`` plants them on the CPU at a
# tiny width, ``calibrate.py --fault-seeds`` on the card at the cell's size.


def _patched(owner, name: str, make):
    """``owner.name`` replaced by ``make(original)`` while open."""
    return mock.patch.object(owner, name, make(getattr(owner, name)))


def token_altered():
    """A token changed where the LM loop commits it (row 0, step 5): the
    row's output and the next step's input."""

    def make(update):
        def altered(eos, state, tokens, logprobs, s, *a, **kw):
            out = update(eos, state, tokens, logprobs, s, *a, **kw)
            if s == 5:
                tokens[0, s] += 1
            return out

        return altered

    return _patched(engine, "_lm_update", make)


def half_the_batch():
    """Half of an LM round's windows decoded; the other half answered with
    the decoded half's results."""

    def make(decode):
        def half(model, mel, prompt, forced=None):
            n = max(1, mel.shape[0] // 2)
            out = decode(model, mel[:n], prompt, None if forced is None else forced[:n])
            return [out[i % n] for i in range(mel.shape[0])]

        return half

    return _patched(engine, "decode_lm", make)


def second_expert_dropped():
    """The MoE layer's picks capped at one: a token's second routed expert
    never adds its part."""

    def make(route):
        def capped(h, router_w, top_p, top_k):
            return route(h, router_w, top_p, 1)

        return capped

    return _patched(uni_moe, "route", make)


def shared_dropped():
    """The shared experts' activations zeroed: they add nothing."""

    def make(weigh):
        def without_shared(act, weights, dims):
            act = weigh(act, weights, dims)
            act[:, dims.routed_width:] = 0
            return act

        return without_shared

    return _patched(uni_moe, "weigh_experts", make)


FAULTS = {f.__name__: f for f in (token_altered, half_the_batch, second_expert_dropped, shared_dropped)}
