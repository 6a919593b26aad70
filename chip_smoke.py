#!/usr/bin/env python3
"""Smoke run of whisper_tpu_torch's main path on one CUDA card.

    python3 chip_smoke.py [--profile]

Phases, each of which must pass (any failure exits non-zero):
  1. the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from whisper_tpu_torch/csrc (nvcc, sm_90a);
  3. K1, encoder self-attention, against its plain PyTorch version at
     large-v3-turbo encoder shapes (1, 20, 1500, 64), bf16 and f32;
  4. K2, the fused decode step, against its plain version at
     large-v3-turbo decoder shapes (L=4, C=1280, H=20, T=256, Ta=1500, B=1),
     bf16 and f32;
  5. end to end: a large-v3-turbo model with random weights (init_params
     from a seeded generator, bf16, on the card; the repo holds no
     checkpoint for load_model), transcribe tests/jfk.flac with language
     detection, check that both kernels ran on that path; then decode the
     window again with a pinned production-shaped 110-token sequence and
     time it;
  6. with --profile only: the pinned window under torch.profiler and
     cProfile (device idle share, host time per token step).
The line before the last is a JSON summary of the kernels; the last line
is {"ok": true, "device": {...}}.  Without a CUDA device it exits non-zero
and prints no result.
"""

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
AUDIO = os.path.join(REPO, "tests", "jfk.flac")

# kernel against plain, as tests/test_torch_cuda.py holds them.  K1 f32: max
# abs error on outputs of unit scale.  K1 bf16, relative to the plain
# output: RMS error and max error over max |plain|.  On an H100 the kernel
# reads at most 2.3e-3 and 5.2e-3 at the shapes of those tests; a kernel
# that stops masking the keys past T = 1500 reads an RMS error of 1.45e-2.
# K2: max error relative to max |plain| (bf16: a few bf16 ulps after four
# layers; f32: summation order only).
K1_F32_ATOL = 1e-5
K1_BF16_REL_RMS, K1_BF16_REL_MAX = 5e-3, 1e-2
K2_REL_TOL = {"bfloat16": 2e-2, "float32": 1e-4}


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int = 20) -> float:
    """Mean device time of fn() over iters launches, after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def check_k1(gen, device):
    import torch

    from whisper_tpu_torch.ops.kernels.attention import attention, attention_plain

    rows = {}
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = (
            torch.randn((1, 20, 1500, 64), generator=gen, device=device).to(dtype)
            for _ in range(3)
        )
        out = attention(q, k, v).float()
        ref = attention_plain(q, k, v).float()
        diff = out - ref
        err = diff.abs().max().item()
        rel_rms = diff.norm().item() / ref.norm().item()
        rel_max = err / ref.abs().max().item()
        name = str(dtype).split(".")[-1]
        ms = time_ms(lambda: attention(q, k, v))
        plain_ms = time_ms(lambda: attention_plain(q, k, v))
        if dtype == torch.float32:
            bound, ok = f"tol {K1_F32_ATOL:.0e}", err <= K1_F32_ATOL
        else:
            bound = f"tol {K1_BF16_REL_RMS:.0e} / {K1_BF16_REL_MAX:.0e}"
            ok = rel_rms <= K1_BF16_REL_RMS and rel_max <= K1_BF16_REL_MAX
        log(f"K1 encoder_attention {name}: max_abs_err {err:.3e}; relative errors "
            f"rms/max {rel_rms:.3e}/{rel_max:.3e} ({bound}) "
            f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms")
        if not ok:
            raise RuntimeError(f"K1 {name} disagrees with its plain version: "
                               f"{err}, {rel_rms}, {rel_max}")
        rows[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
    return rows


def check_k2(gen, device):
    import torch

    from whisper_tpu_torch.ops.kernels.fused_step import (
        WEIGHTS,
        fused_decoder_layers,
        fused_decoder_layers_plain,
    )

    L, C, H, T, Ta, t = 4, 1280, 20, 256, 1500, 200
    D = C // H

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=device) * scale

    shapes = {
        "q_w": (C, C), "k_w": (C, C), "v_w": (C, C), "o_w": (C, C),
        "xq_w": (C, C), "xo_w": (C, C), "fc1_w": (4 * C, C), "fc2_w": (C, 4 * C),
        "fc1_b": (4 * C,),
    }
    base = {}
    for n in WEIGHTS:
        shape = (L, *shapes.get(n, (C,)))
        if n.endswith("_g"):
            base[n] = 1.0 + randn(*shape, scale=0.1)
        else:
            base[n] = randn(*shape, scale=0.02)
    x32 = randn(1, C, scale=0.5)
    sk32, sv32 = randn(L, 1, H, D, T), randn(L, 1, H, D, T)
    xk32, xv32 = randn(L, 1, H, D, Ta), randn(L, 1, H, D, Ta)

    rows = {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        blocks = {n: w.to(dtype).contiguous() for n, w in base.items()}
        args = (blocks, H, x32.to(dtype), t, sk32.to(dtype), sv32.to(dtype),
                xk32.to(dtype), xv32.to(dtype))
        out = fused_decoder_layers(*args)
        ref = fused_decoder_layers_plain(*args)
        torch.cuda.synchronize()
        errs = []
        for a, b in zip(out, ref):
            errs.append((a.float() - b.float()).abs().max().item() / b.float().abs().max().item())
        ms = time_ms(lambda: fused_decoder_layers(*args))
        plain_ms = time_ms(lambda: fused_decoder_layers_plain(*args))
        err_abs = (out[0].float() - ref[0].float()).abs().max().item()
        log(f"K2 fused_decoder_layers {name}: max_abs_err hidden {err_abs:.3e}; "
            f"relative errors hidden/k_new/v_new {errs[0]:.3e}/{errs[1]:.3e}/{errs[2]:.3e} "
            f"(tol {K2_REL_TOL[name]:.0e}) kernel {ms:.4f} ms plain {plain_ms:.4f} ms")
        if not max(errs) <= K2_REL_TOL[name]:
            raise RuntimeError(f"K2 {name} disagrees with its plain version: {errs}")
        rows[name] = dict(max_abs_err=err_abs, ms=ms, plain_ms=plain_ms)
    return rows


def end_to_end(device, name: str = "turbo"):
    import numpy as np
    import torch

    import whisper_tpu_torch
    from whisper_tpu_torch.decoding import DecodingTask
    from whisper_tpu_torch.models import KNOWN_MODELS
    from whisper_tpu_torch.models.whisper import init_params
    from whisper_tpu_torch.ops.kernels.attention import attention
    from whisper_tpu_torch.ops.kernels.fused_step import fused_decoder_layers
    from whisper_tpu_torch.tokenizer import LANGUAGES, get_tokenizer

    t0 = time.perf_counter()
    dims = KNOWN_MODELS[name]
    gen = torch.Generator(device=device).manual_seed(0)
    model = whisper_tpu_torch.Whisper(dims, init_params(dims, gen, torch.bfloat16, device))
    torch.cuda.synchronize()
    log(f"random {name} weights (init_params, seed 0): {time.perf_counter() - t0:.3f} s, "
        f"{model.num_parameters()} parameters, {model.dtype}")
    t0 = time.perf_counter()
    audio = whisper_tpu_torch.load_audio(AUDIO)
    audio_s = len(audio) / 16000
    log(f"load_audio(jfk.flac) on the host: {time.perf_counter() - t0:.3f} s for {audio_s:.3f} s")

    attention.launches = 0
    fused_decoder_layers.launches = 0
    t0 = time.perf_counter()
    result = model.transcribe(AUDIO, language=None, seed=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"encoder_attention": attention.launches,
                "fused_decoder_layers": fused_decoder_layers.launches}
    n_tokens = sum(len(s["tokens"]) for s in result["segments"])
    log(f"transcribe(jfk.flac, language=None): language {result['language']!r}, "
        f"{len(result['segments'])} segments, {n_tokens} tokens kept, "
        f"audio {audio_s:.3f} s, wall {wall:.3f} s, launches {launches}")
    if result["language"] not in LANGUAGES or not isinstance(result["text"], str):
        raise RuntimeError(f"bad transcribe result: {result['language']!r}")
    if not result["segments"] or any(
        not 0 <= tok < model.dims.n_vocab for s in result["segments"] for tok in s["tokens"]
    ):
        raise RuntimeError("transcribe produced no segments or out-of-range tokens")
    if min(launches.values()) <= 0:
        raise RuntimeError(f"a kernel of the main path never launched: {launches}")

    # production-shaped window: timestamp, 107 text tokens, final window
    # timestamp, EOT (the JAX package's bench.py forced sequence)
    tok = get_tokenizer(model.is_multilingual, num_languages=model.num_languages,
                        language="en", task="transcribe")
    text = np.random.RandomState(0).randint(1000, 20000, size=107)
    forced = [tok.timestamp_begin, *map(int, text), tok.timestamp_begin + 1500, tok.eot]
    DecodingTask._forced_tokens = forced
    try:
        walls = []
        for _ in range(4):  # from the decoded waveform; the first run is cold
            t0 = time.perf_counter()
            pinned = model.transcribe(audio, language="en", temperature=0.0)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
    finally:
        DecodingTask._forced_tokens = None
    got = [t for s in pinned["segments"] for t in s["tokens"]]
    if got != forced[:-1]:
        raise RuntimeError("the pinned window did not decode the pinned sequence once")
    warm = sorted(walls[1:])[1]
    log(f"pinned window (mel, encoder, prefill, {len(forced)} steps, segmentation): "
        f"audio {audio_s:.3f} s, wall {walls[0]:.4f} s cold, {warm:.4f} s warm "
        f"(median of {len(walls) - 1}), tokens decoded {len(forced)}, "
        f"{1000 * warm / len(forced):.4f} ms per token (window wall / tokens)")
    log(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    return launches, model, audio, forced


def profile_window(model, audio, forced) -> None:
    """--profile: wall, device busy time and idle share of the pinned window
    and of its encoder and decode parts, then the host's time per token
    step.  Wall is the median of three runs without a profiler; busy is the
    sum of kernel and copy time under torch.profiler (device activity only);
    idle share is 1 - busy / wall.  The host split is cProfile's, which
    slows the host itself: its shares, not its sums, carry over."""
    import cProfile
    import pstats

    import torch
    from torch.profiler import ProfilerActivity, profile

    from whisper_tpu_torch import log_mel_spectrogram, pad_or_trim
    from whisper_tpu_torch.decoding import DecodingOptions, DecodingTask

    mel = log_mel_spectrogram(pad_or_trim(audio), model.dims.n_mels, device=model.device)
    features = model.embed_audio(mel[None])
    options = DecodingOptions(language="en", temperature=0.0)
    parts = {
        "window: transcribe(waveform)": lambda: model.transcribe(audio, language="en", temperature=0.0),
        "encoder: embed_audio(mel)": lambda: model.embed_audio(mel[None]),
        f"decode from features: prefill + {len(forced)} steps": lambda: DecodingTask(model, options).run(features),
    }
    DecodingTask._forced_tokens = forced
    try:
        for label, fn in parts.items():
            walls = []
            for _ in range(4):  # the first is a warm-up
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                walls.append(1e3 * (time.perf_counter() - t0))
            wall = sorted(walls[1:])[1]
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            busy = sum(e.self_device_time_total for e in prof.key_averages()) / 1e3
            log(f"profile {label}: wall {wall:.3f} ms, device busy {busy:.3f} ms, "
                f"idle share {1 - busy / wall:.3f}")
            table = prof.key_averages().table(sort_by="self_device_time_total", row_limit=8,
                                              max_name_column_width=60)
            for line in table.splitlines():
                log(f"  {line}")

        profiler = cProfile.Profile()
        profiler.enable()
        DecodingTask(model, options).run(features)
        torch.cuda.synchronize()
        profiler.disable()
    finally:
        DecodingTask._forced_tokens = None
    per_step = {}
    for (_, _, fn_name), (_, calls, own, cum, _) in pstats.Stats(profiler).stats.items():
        if fn_name in ("apply_logit_filters", "_greedy_update", "decoder_step_fused",
                       "fused_decoder_layers", "project_logits"):
            per_step[fn_name] = (calls, 1e3 * cum)
        elif fn_name == "decode_engine":  # its own time holds completed's read-back
            per_step["decode_engine (own time)"] = (calls, 1e3 * own)
    log(f"profile host per step (cProfile, total ms / calls over {len(forced)} steps): " + ", ".join(
        f"{k} {ms / len(forced):.3f} ms ({calls} calls)" for k, (calls, ms) in sorted(per_step.items())))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--profile", action="store_true",
                        help="after the phases, profile the pinned window (device idle share, host time per step)")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)

    from whisper_tpu_torch.ops.kernels import build

    log(card_line())  # name, power limit: nvidia-smi's own words
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    ptxas = build(verbose=True)
    log(f"kernel build: {time.perf_counter() - t0:.2f} s")
    for line in ptxas.splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

    gen = torch.Generator(device=device).manual_seed(0)
    k1 = check_k1(gen, device)
    k2 = check_k2(gen, device)
    launches, model, audio, forced = end_to_end(device)
    if args.profile:
        profile_window(model, audio, forced)

    kernels = [
        dict(name="encoder_attention", route="cuda",
             source="whisper_tpu_torch/csrc/attention.cu",
             replaces="whisper_tpu/ops/kernels/attention_pallas.py:62",
             launches=launches["encoder_attention"], **k1["bfloat16"]),
        dict(name="fused_decoder_layers", route="cuda",
             source="whisper_tpu_torch/csrc/fused_step.cu",
             replaces="whisper_tpu/ops/kernels/fused_step_pallas.py:301",
             launches=launches["fused_decoder_layers"], **k2["bfloat16"]),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
