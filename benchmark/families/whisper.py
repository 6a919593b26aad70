"""The Whisper family (``"family": "whisper"`` in a configuration): every
piece of a run that depends on Whisper's architecture.

- ``vocabulary``: the frozen vocabulary facts, ``reference/vocab_<n_vocab>.json``;
- ``make_state_dict``: seeded random weights in the official checkpoint
  layout, and ``build_model``: the port's model from them;
- ``pin`` / ``unpin``: the forced sequence drawn from the seed, pinned in
  the port's benchmark hook ``DecodingTask._forced_tokens``;
- ``judge``: the comparison with the plain float32 reference
  (``reference``, ``reference/whisper_ref.py``);
- ``window_work`` and ``window_ops``: each 30 s window's prompt and tokens,
  and its model operations (``mfu_pct.batch``, ``mfu_pct.serve``);
- ``FAULTS``: faults planted in the port's timed path, each of which the
  comparison has to see.
"""

import contextlib
import functools
import gc
import json
import math
import os
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from benchmark.harness import check, spec, traffic
from benchmark.reference import whisper_ref as reference

PROMPT_MAX = 223  # n_text_ctx // 2 - 1 tokens of the previous text
TIME_PRECISION = 0.02  # s a timestamp token
TIME_TOLERANCE = 1e-6  # s; the segment times are exact multiples of 0.02 s
MARGIN = 1.0  # nats


def vocabulary(config: Dict) -> Dict:
    with open(os.path.join(spec.BENCH_DIR, "reference", f"vocab_{config['dims']['n_vocab']}.json")) as f:
        return json.load(f)


# -- weights ------------------------------------------------------------------


def layout(dims: Dict[str, int]) -> List[Tuple[str, Tuple[int, ...]]]:
    """(key, shape) of every tensor of an official checkpoint's
    ``model_state_dict`` (openai/whisper model.py)."""
    out = []
    C, M, L = dims["n_audio_state"], dims["n_mels"], dims["n_audio_layer"]
    out += [("encoder.conv1.weight", (C, M, 3)), ("encoder.conv1.bias", (C,)),
            ("encoder.conv2.weight", (C, C, 3)), ("encoder.conv2.bias", (C,)),
            ("encoder.positional_embedding", (dims["n_audio_ctx"], C))]

    def block(prefix, C, cross):
        parts = [("attn", "attn_ln")] + ([("cross_attn", "cross_attn_ln")] if cross else [])
        rows = []
        for attn, ln in parts:
            rows += [(f"{prefix}.{attn}.query.weight", (C, C)), (f"{prefix}.{attn}.query.bias", (C,)),
                     (f"{prefix}.{attn}.key.weight", (C, C)),
                     (f"{prefix}.{attn}.value.weight", (C, C)), (f"{prefix}.{attn}.value.bias", (C,)),
                     (f"{prefix}.{attn}.out.weight", (C, C)), (f"{prefix}.{attn}.out.bias", (C,)),
                     (f"{prefix}.{ln}.weight", (C,)), (f"{prefix}.{ln}.bias", (C,))]
        rows += [(f"{prefix}.mlp.0.weight", (4 * C, C)), (f"{prefix}.mlp.0.bias", (4 * C,)),
                 (f"{prefix}.mlp.2.weight", (C, 4 * C)), (f"{prefix}.mlp.2.bias", (C,)),
                 (f"{prefix}.mlp_ln.weight", (C,)), (f"{prefix}.mlp_ln.bias", (C,))]
        return rows

    for i in range(L):
        out += block(f"encoder.blocks.{i}", C, cross=False)
    out += [("encoder.ln_post.weight", (C,)), ("encoder.ln_post.bias", (C,))]
    C = dims["n_text_state"]
    out += [("decoder.token_embedding.weight", (dims["n_vocab"], C)),
            ("decoder.positional_embedding", (dims["n_text_ctx"], C))]
    for i in range(dims["n_text_layer"]):
        out += block(f"decoder.blocks.{i}", C, cross=True)
    out += [("decoder.ln.weight", (C,)), ("decoder.ln.bias", (C,))]
    return out


def _sinusoids(length: int, channels: int, device) -> torch.Tensor:
    increment = torch.log(torch.tensor(10000.0)) / (channels // 2 - 1)
    inv = torch.exp(-increment * torch.arange(channels // 2, dtype=torch.float32, device=device))
    t = torch.arange(length, dtype=torch.float32, device=device)[:, None] * inv[None, :]
    return torch.cat([torch.sin(t), torch.cos(t)], dim=1)


def make_state_dict(dims: Dict[str, int], rules: Dict[str, float], seed: int,
                    dtype: torch.dtype, device) -> Dict[str, torch.Tensor]:
    """The seeded official-layout state_dict.  One ``torch.randn`` call on
    the device fills a buffer of every parameter in the served dtype from a
    generator seeded with the run's seed; each tensor is a view of it,
    scaled in place by the rule of its kind, so the reference can make it
    again after the window.  ``rules`` (the configuration's
    ``assumed.weights``): "linear_gain" (a weight of fan-in n has standard
    deviation gain / sqrt(n)), "bias", "ln_gain_noise" and "ln_bias"
    (standard deviations; a LayerNorm's gain is 1 plus its noise),
    "logit_std" (the token embedding's standard deviation times
    sqrt(width): the logits' standard deviation over unit hidden states),
    "positional_embedding" (a standard deviation), "timestamp_rows" (the
    factor on the token embedding's timestamp rows), and "timestamp_begin"
    (their first id)."""
    shapes = layout(dims)
    sizes = [torch.Size(s).numel() for _, s in shapes]
    gen = torch.Generator(device=device).manual_seed(seed % 2**63)
    flat = torch.randn(sum(sizes), generator=gen, dtype=dtype, device=device)
    out, at = {}, 0
    for (key, shape), n in zip(shapes, sizes):
        t = flat[at : at + n].view(shape)
        at += n
        if key == "encoder.positional_embedding":
            t.copy_(_sinusoids(*shape, device=device))
        elif key == "decoder.token_embedding.weight":
            t.mul_(rules["logit_std"] / shape[1] ** 0.5)
            t[rules["timestamp_begin"]:].mul_(rules["timestamp_rows"])
        elif key == "decoder.positional_embedding":
            t.mul_(rules["positional_embedding"])
        elif "_ln." in key or key.endswith(("ln_post.weight", "ln_post.bias", "decoder.ln.weight",
                                             "decoder.ln.bias")):
            if key.endswith(".weight"):
                t.mul_(rules["ln_gain_noise"]).add_(1.0)
            else:
                t.mul_(rules["ln_bias"])
        elif key.endswith(".bias"):
            t.mul_(rules["bias"])
        else:
            fan_in = shape[1] * (shape[2] if len(shape) == 3 else 1)
            t.mul_(rules["linear_gain"] / fan_in ** 0.5)
        out[key] = t
    return out


def _state_dict(cell, seed: int, device) -> Dict[str, torch.Tensor]:
    return make_state_dict(cell.dims, cell.config["assumed"]["weights"], seed,
                           getattr(torch, cell.config["dtype"]), device)


def build_model(cell, seed: int, device):
    """The port's model from the seeded state_dict
    (``models.load.convert_torch_state_dict``), in the configuration's
    dtype; quantized where the configuration names a ``quantize`` mode of
    the port's (``quantize.quantize_params``)."""
    from whisper_tpu_torch.models import ModelDimensions, Whisper
    from whisper_tpu_torch.models.load import convert_torch_state_dict

    dims = ModelDimensions(**cell.dims)
    state = _state_dict(cell, seed, device)
    params = convert_torch_state_dict(state, dims, dtype=getattr(torch, cell.config["dtype"]), device=device)
    del state
    quantize = cell.config.get("quantize")
    if quantize is not None:
        from whisper_tpu_torch.quantize import quantize_params

        params = quantize_params(params, logits=quantize == "int8+logits")
    return Whisper(dims, params)


# -- the pinned sequence --------------------------------------------------------


def forced_sequence(seed: int, forced: Dict, vocab: Dict) -> List[int]:
    """The pinned greedy sequence: the timestamp 0.00, text ids drawn from
    the seed among the ordinary tokens that no filter suppresses, a closing
    timestamp, EOT."""
    banned = set(vocab["suppress"]) | set(vocab["blank"])
    allowed = np.array([i for i in range(vocab["eot"]) if i not in banned])
    text = traffic.rng(seed, 2).choice(allowed, size=forced["text_tokens"])
    tsb = vocab["timestamp_begin"]
    close = tsb + round(forced["closing_timestamp_s"] / TIME_PRECISION)
    return [tsb] + [int(x) for x in text] + [close, vocab["eot"]]


def pin(run) -> None:
    """The mix's forced sequence for the run's seed, as ``run.forced``,
    pinned for every window the port decodes."""
    from whisper_tpu_torch.decoding import DecodingTask

    run.forced = forced_sequence(run.seed, run.cell.mix["forced"], vocabulary(run.cell.config))
    DecodingTask._forced_tokens = run.forced


def unpin() -> None:
    from whisper_tpu_torch.decoding import DecodingTask

    DecodingTask._forced_tokens = None


# -- the comparison ---------------------------------------------------------------


def compare(expected: List[Dict], result) -> Dict:
    """One request's readings: its port result (a dict, or an exception, or
    None if it never came) against the reference's windows; the gaps of
    each window, signed (port less reference)."""
    out = {"segments_wrong": 0, "logprob": [], "no_speech": [], "left_out": 0}
    if not isinstance(result, dict):
        out["segments_wrong"] = len(expected)
        return out
    segments = result["segments"]
    for k, e in enumerate(expected):
        if k >= len(segments):
            out["segments_wrong"] += 1
            continue
        s = segments[k]
        if (s["seek"] != e["seek"] or abs(s["start"] - e["start"]) > TIME_TOLERANCE
                or abs(s["end"] - e["end"]) > TIME_TOLERANCE or list(s["tokens"]) != list(e["tokens"])):
            out["segments_wrong"] += 1
        if e["min_margin"] >= MARGIN:
            out["logprob"].append(s["avg_logprob"] - e["avg_logprob"])
        else:
            out["left_out"] += 1
        p = s["no_speech_prob"]
        out["no_speech"].append(math.log(p) - e["no_speech_logprob"] if p > 0 else -math.inf)
    out["segments_wrong"] += max(0, len(segments) - len(expected))
    return out


def as_result(windows: List[Dict]) -> Dict:
    """The reference's windows in the shape of a transcription result."""
    return {"segments": [dict(seek=w["seek"], start=w["start"], end=w["end"], tokens=w["tokens"],
                              avg_logprob=w["avg_logprob"],
                              no_speech_prob=math.exp(w["no_speech_logprob"])) for w in windows]}


def judge(run, picked: Sequence[int], products=None):
    """The readings of the sampled requests ``picked`` and a line for the
    log.  Once the window has closed and the port's state is freed, each
    is served again by the plain float32 reference from the same waveform,
    the same seeded state_dict (made again on the device) and the same
    forced sequence.  ``products="fp8"`` judges the reference computed
    with float8 products in the port's place (the comparison's control)
    instead of the port's results.  The readings:

    - ``segments_wrong``: windows whose segment differs from the
      reference's (seek, start, end, tokens) or is missing; exact;
    - ``failed``: requests that raised or never came;
    - ``logprob_gap``: the mean size, over the sampled windows, of the gap
      between the port's average log-probability of the forced tokens
      (under the greedy timestamp filters) and the reference's, in nats a
      token.  A window in which the reference's timestamp-probability rule
      comes within ``MARGIN`` nats of suppressing a forced token is left
      out of this gap alone (rounding could then decide the rule either
      way, and a suppressed token's log-probability is minus infinity);
      the weights make that rare, and the log says how many were left out;
    - ``no_speech_gap``: the mean size of the gap between the port's
      log P(no speech) at a window's SOT and the reference's, in nats;
    - the widest gaps, ``*_max``."""
    cell, device = run.cell, run.device
    words = vocabulary(cell.config)
    reference.use_float32()
    state = _state_dict(cell, run.seed, device)
    model = reference.Model(state, cell.dims, device)
    low = reference.Model(state, cell.dims, device, products=products) if products else None
    del state
    wrong, logprob, no_speech = 0, [], []
    margin, left_out, windows = math.inf, 0, 0
    with torch.inference_mode():
        for i in picked:
            wave, result = run.files[i], run.results[i]
            expected = reference.judge_file(model, wave, run.forced, words)
            if low is not None:
                result = as_result(reference.judge_file(low, wave, run.forced, words))
            margin = min([margin] + [e["min_margin"] for e in expected])
            one = compare(expected, result)
            wrong += one["segments_wrong"]
            logprob += one["logprob"]
            no_speech += one["no_speech"]
            left_out, windows = left_out + one["left_out"], windows + len(expected)
    del model, low
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    readings = {"segments_wrong": wrong, "failed": run.failed,
                "logprob_gap": check.mean_abs(logprob), "logprob_gap_max": check.max_abs(logprob),
                "no_speech_gap": check.mean_abs(no_speech), "no_speech_gap_max": check.max_abs(no_speech)}
    log = (f"reference: {windows} windows of {len(picked)} requests; the timestamp rule's least "
           f"margin {margin:.3f} nats, {left_out} windows within {MARGIN} of it; "
           + ", ".join(f"{k} {v!r}" for k, v in readings.items() if k not in cell.limits))
    return readings, log


# -- the work of a window -----------------------------------------------------------


def window_work(results: list) -> List[tuple]:
    """(prompt length, decoded tokens) of every window of the results that
    came, the prompt as transcribe builds it from the file's earlier
    segments."""
    out = []
    for r in results:
        if not isinstance(r, dict):
            continue
        history: List[int] = []
        for s in r["segments"]:
            prompt = history[-PROMPT_MAX:]
            out.append(((1 + len(prompt) if prompt else 0) + 3, len(s["tokens"]) + 1))
            history += list(s["tokens"])
    return out


def window_ops(dims: Dict[str, int], prompt: int, steps: int) -> float:
    """Model operations of one 30 s window: the encoder (two convolutions,
    the blocks' projections, MLP and attention), the cross K/V, the prompt
    prefill (causal self-attention, cross-attention, its logits at the SOT
    and the last position), and per decoded token the decoder at its
    position and the logits."""
    M, Ta, C, Le = dims["n_mels"], dims["n_audio_ctx"], dims["n_audio_state"], dims["n_audio_layer"]
    Cd, Ld, V = dims["n_text_state"], dims["n_text_layer"], dims["n_vocab"]
    frames = 2 * Ta
    encoder = (2 * 3 * M * C * frames + 2 * 3 * C * C * Ta
               + Le * (2 * Ta * 12 * C * C + 4 * Ta * Ta * C))
    cross_kv = Ld * 2 * Ta * 2 * Cd * C
    per_layer = 2 * 14 * Cd * Cd  # q, k, v, o, xq, xo, fc1, fc2 per token
    prefill = Ld * (prompt * per_layer + 2 * prompt * prompt * Cd + 4 * prompt * Ta * Cd) + 2 * 2 * V * Cd
    decode = sum(Ld * (per_layer + 4 * (prompt + s) * Cd + 4 * Ta * Cd) + 2 * V * Cd for s in range(steps))
    return float(encoder + cross_kv + prefill + decode)


# -- planted faults ------------------------------------------------------------------
# Each is a context manager that patches the port while it is open:
# ``tests/test_portbench_reference.py`` plants them on the CPU at a tiny
# width, ``calibrate.py --fault-seeds`` on the card at a cell's own size.


@contextlib.contextmanager
def _patched(owner, name: str, make):
    """``owner.name`` replaced by ``make(original)`` while open."""
    original = getattr(owner, name)
    setattr(owner, name, make(original))
    try:
        yield
    finally:
        setattr(owner, name, original)


def token_altered():
    """A token changed where the engine commits it (row 0, step 5)."""
    from whisper_tpu_torch import engine

    def make(update):
        def altered(spec, state, *a, **kw):
            out = update(spec, state, *a, **kw)
            if state.step == 5:
                col = (out.t[0] - 1).clamp(min=0)
                out.tokens[0, col] = out.tokens[0, col] + 1
            return out

        return altered

    return _patched(engine, "_greedy_update", make)


def half_the_batch():
    """Half of a round's windows decoded; the other half answered with the
    decoded half's results."""
    from whisper_tpu_torch.decoding import DecodingTask

    def make(run):
        def half(self, mel, prompts, *a, **kw):
            n = max(1, len(prompts) // 2)
            out = run(self, mel[:n], prompts[:n], *a, **kw)
            return [out[i % n] for i in range(len(prompts))]

        return half

    return _patched(DecodingTask, "run_with_prompts", make)


def state_unchanged():
    """The decoder step's layers (K2 on the card, its plain version on the
    CPU) leave the hidden state as it came."""
    from whisper_tpu_torch.ops.kernels import fused_step

    def make(layers):
        @functools.wraps(layers)  # keeps its launch counters
        def unchanged(blocks, n_head, x, *a, **kw):
            _, k_new, v_new = layers(blocks, n_head, x, *a, **kw)
            return x.clone(), k_new, v_new

        return unchanged

    return _patched(fused_step, "fused_decoder_layers", make)


FAULTS = {f.__name__: f for f in (token_altered, half_the_batch, state_unchanged)}
