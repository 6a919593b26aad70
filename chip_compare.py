#!/usr/bin/env python3
"""Time one tree's single-file decode paths on one CUDA card, so that two
versions of the port can be compared in one call, in turns.

    python3 chip_compare.py TREE [--runs N]

TREE is a checkout of this repository (``.`` for this one, or another
version unpacked with ``git archive`` into a git-ignored directory such as
``build/``).  The script imports that tree's ``whisper_tpu_torch`` and
drives it through calls that every version since the greedy path has
(``init_params``, ``transcribe``, ``DecodingTask``, the K2 wrapper with
one shared position), on random large-v3-turbo weights (seed 0, bf16):

  K2 at one row and at a group of five rows at t = 200 (L=4, C=1280,
      T=256, Ta=1500), device time per step;
  the pinned window: transcribe(jfk waveform) decoding a pinned 110-token
      sequence (mel, encoder, prefill, 110 steps, segmentation);
  the beam-5 window: DecodingTask(beam_size=5).run on jfk's encoder
      features (random weights run all 224 steps);
  the CLI default path: transcribe(jfk.flac) with beam 5, best-of 5 on
      the 0.2-step ladder and word timestamps.

``--only`` picks parts (k2, k5, e2, e3, words, windows, cli; all by
default).
It also times, through the K2, K5 and E2 wrappers' calls (the same in
every version of the port that has E2), K2 at every row of PERF.md's
kernel table (one and five rows at t = 200, 16 x 1, 3 x 5, 16 x 5, 32 x 5
and 160 x 1 at per-row positions, 5 x 5 and 4 x 5 at t = 200, the
int8+kv_int8 form, the pending block at T = 448 with 7 of 8 columns), K5
(mlp_fused) at 1, 5, 16 and 125 rows with bf16 and int8 weights, and E2
in both layouts at B = 1, 5 and 16 beside bf16 torch.mm: device time per
call (a CUDA graph replayed) and the time of back-to-back calls (CUDA
events); and the word-timing kernels, K3 at (40, 1, 256, 1500) width 7 and
K4 at n = 253, m = 1500 for one matrix and 16, the same two ways.  The
``e3`` part times E3 (the packing experiment's score + PV pairs) through
the two wrappers every version since E3's port has, unpacked and packed,
at Q = 128, T = 1536, D = 64 for g = 28, 30, 32, 280, 300 and 320
programs and reps = 8 and 64: CUDA events over a few calls, and the time
per program.  At g = 32 every program's K/V fits in L2, at g = 320 it does
not; g = 30 and 300 (unpacked) and 28 and 280 (packed) fill whole waves of
the clusters of E3's kernel an H100 holds at once (30 of 4 blocks, 7 of
16).

Walls are medians of N runs after a warm-up.  The last line is one JSON
object with the tree's numbers.  Run it for two trees in turns in one call
(old, new, new, old): the card and the host are then the same for both.
"""

import argparse
import json
import os
import subprocess
import sys
import time


def log(msg: str) -> None:
    print(msg, flush=True)


def median_wall(fn, runs: int) -> float:
    """Median wall in seconds of fn() over runs calls, after a warm-up."""
    import torch

    walls = []
    for _ in range(runs + 1):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return sorted(walls[1:])[runs // 2]


def k2_ms(device, B: int, iters: int = 50) -> float:
    """K2's device time per step at turbo decoder shapes, B rows of one
    audio at the shared position 200, bf16."""
    import torch

    from whisper_tpu_torch.ops.kernels.fused_step import WEIGHTS, fused_decoder_layers

    L, C, H, T, Ta = 4, 1280, 20, 256, 1500
    gen = torch.Generator(device=device).manual_seed(B)

    def randn(*shape, scale=0.02):
        return (torch.randn(shape, generator=gen, device=device) * scale).to(torch.bfloat16)

    shapes = {"fc1_w": (4 * C, C), "fc2_w": (C, 4 * C), "fc1_b": (4 * C,)}
    blocks = {n: randn(L, *shapes.get(n, (C, C) if n.endswith("_w") else (C,))) for n in WEIGHTS}
    for n in blocks:
        if n.endswith("_g"):
            blocks[n] += 1.0
    args = (blocks, H, randn(B, C, scale=0.5), 200, randn(L, B, H, 64, T, scale=1.0),
            randn(L, B, H, 64, T, scale=1.0), randn(L, 1, H, 64, Ta, scale=1.0),
            randn(L, 1, H, 64, Ta, scale=1.0))
    fused_decoder_layers(*args)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fused_decoder_layers(*args)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 50) -> float:
    """fn's device time: captured once in a CUDA graph, replayed."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def events_ms(fn, iters: int = 20) -> float:
    """fn's time per call, iters calls back to back after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# (label, audios, rows per audio, positions: "shared" (t = 200) or
# "per-row", form, pending columns valid of 8 or None); T = 256, or 448
# with a pending block
K2_ROWS = (
    ("B=1", 1, 1, "shared", "", None), ("1 x 5", 1, 5, "shared", "", None),
    ("16 x 1", 16, 1, "per-row", "", None), ("3 x 5", 3, 5, "per-row", "", None),
    ("16 x 5", 16, 5, "per-row", "", None), ("5 x 5", 5, 5, "shared", "", None),
    ("4 x 5", 4, 5, "shared", "", None), ("32 x 5", 32, 5, "per-row", "", None),
    ("160 x 1", 160, 1, "per-row", "", None),
    ("int8 B=1", 1, 1, "shared", "int8+kv_int8", None), ("int8 1 x 5", 1, 5, "shared", "int8+kv_int8", None),
    ("int8 16 x 1", 16, 1, "per-row", "int8+kv_int8", None), ("int8 5 x 5", 5, 5, "shared", "int8+kv_int8", None),
    ("pending 16 x 1", 16, 1, "per-row", "", 7), ("pending int8 B=1", 1, 1, "shared", "int8+kv_int8", 7),
    ("pending 3 x 5", 3, 5, "per-row", "", 7),
)


def k2_table(device) -> dict:
    """K2 at K2_ROWS, turbo decoder widths (L=4, C=1280, H=20, Ta=1500),
    bf16, random inputs from a seed: {label: [device ms, events ms]}."""
    import torch

    from whisper_tpu_torch.ops.kernels.fused_step import PROJECTIONS, WEIGHTS, fused_decoder_layers
    from whisper_tpu_torch.quantize import quantize_kv, quantize_weight

    L, C, H, Ta, W = 4, 1280, 20, 1500, 8
    out = {}
    for label, A, G, positions, form, pend_w in K2_ROWS:
        B, T = A * G, 256 if pend_w is None else 448
        gen = torch.Generator(device=device).manual_seed(B)

        def randn(*shape, scale=1.0):
            return (torch.randn(shape, generator=gen, device=device) * scale).to(torch.bfloat16)

        shapes = {"fc1_w": (4 * C, C), "fc2_w": (C, 4 * C), "fc1_b": (4 * C,)}
        blocks = {n: randn(L, *shapes.get(n, (C, C) if n.endswith("_w") else (C,)), scale=0.02) for n in WEIGHTS}
        for n in blocks:
            if n.endswith("_g"):
                blocks[n] += 1.0
        xk, xv = randn(L, A, H, 64, Ta), randn(L, A, H, 64, Ta)
        if form:
            blocks.update({n: quantize_weight(blocks[n]) for n in PROJECTIONS})
            xk, xv = quantize_kv(xk), quantize_kv(xv)
        t = 200 if positions == "shared" else torch.randint(0, T + 1, (B,), generator=gen, device=device)
        args = (blocks, H, randn(B, C, scale=0.5), t, randn(L, B, H, 64, T), randn(L, B, H, 64, T), xk, xv)
        if pend_w is not None:
            args += (randn(L, B, H, 64, W), randn(L, B, H, 64, W), pend_w)
        out[label] = [device_ms(lambda: fused_decoder_layers(*args)), events_ms(lambda: fused_decoder_layers(*args))]
        log(f"K2 {label}: {out[label][0]:.4f} ms device, {out[label][1]:.4f} ms back to back")
    return out


def k5_table(device) -> dict:
    """K5 (mlp_fused: K2's MLP stage alone) at turbo's width (C = 1280, F =
    5120) for 1, 5, 16 and 125 rows (K2's first 32 x 5 slice), bf16 and
    int8 weights, bf16 compute, random inputs from a seed: {label: [device
    ms, events ms]}."""
    import torch

    from whisper_tpu_torch.ops.kernels.mlp import mlp_fused
    from whisper_tpu_torch.quantize import quantize_weight

    C, F = 1280, 5120
    out = {}
    for B in (1, 5, 16, 125):
        gen = torch.Generator(device=device).manual_seed(B)

        def randn(*shape, scale=1.0):
            return (torch.randn(shape, generator=gen, device=device) * scale).to(torch.bfloat16)

        x, g, b = randn(B, C, scale=0.5), 1.0 + randn(C, scale=0.1), randn(C, scale=0.02)
        w1, b1, w2, b2 = randn(F, C, scale=0.02), randn(F, scale=0.02), randn(C, F, scale=0.02), randn(C, scale=0.02)
        for weights in ("bf16", "int8"):
            ws = (w1, w2) if weights == "bf16" else (quantize_weight(w1), quantize_weight(w2))
            args = (x, g, b, ws[0], b1, ws[1], b2)
            label = f"{weights} B={B}"
            out[label] = [device_ms(lambda: mlp_fused(*args)), events_ms(lambda: mlp_fused(*args))]
            log(f"K5 {label}: {out[label][0]:.4f} ms device, {out[label][1]:.4f} ms back to back")
    return out


def e2_table(device) -> dict:
    """E2 in both layouts and bf16 torch.mm (f32 out) at turbo's vocabulary
    (51866 x 1280), B = 1, 5, 16: {label: [device ms, events ms]}."""
    import torch

    from whisper_tpu_torch.ops.kernels.logits import logits_streamed

    V, C = 51866, 1280
    gen = torch.Generator(device=device).manual_seed(0)
    emb = (torch.randn((V, C), generator=gen, device=device) * 0.02).to(torch.bfloat16)
    weights = {"vc": emb, "cv": emb.t().contiguous()}
    out = {}
    for B in (1, 5, 16):
        x = torch.randn((B, C), generator=gen, device=device).to(torch.bfloat16)
        calls = {f"{layout} B={B}": (lambda w=w, layout=layout: logits_streamed(x, w, layout))
                 for layout, w in weights.items()}
        calls[f"torch.mm B={B}"] = lambda: torch.mm(x, emb.t(), out_dtype=torch.float32)
        for label, fn in calls.items():
            out[label] = [device_ms(fn), events_ms(fn)]
            log(f"E2 {label}: {out[label][0]:.4f} ms device, {out[label][1]:.4f} ms back to back")
    return out


def word_timing_table(device) -> dict:
    """K3 (median_filter) at the word-timing shape (40, 1, 256, 1500) f32,
    width 7, and K4 (dtw_trace) at n = 253, m = 1500 for one matrix and 16,
    random inputs from a seed, through the wrappers' calls every version of
    the port has: {label: [device ms, events ms]}."""
    import torch

    from whisper_tpu_torch.ops.kernels.dtw import dtw_trace
    from whisper_tpu_torch.ops.kernels.median import median_filter

    gen = torch.Generator(device=device).manual_seed(0)
    x3 = torch.randn((40, 1, 256, 1500), generator=gen, device=device)
    calls = {"K3 (40,1,256,1500) w7": lambda: median_filter(x3, 7)}
    for B in (1, 16):
        x4 = torch.randn((B, 253, 1500), generator=gen, device=device)
        calls[f"K4 B={B} 253 x 1500"] = lambda x4=x4: dtw_trace(x4, 253, 1500)
    out = {}
    for label, fn in calls.items():
        out[label] = [device_ms(fn), events_ms(fn)]
        log(f"{label}: {out[label][0]:.4f} ms device, {out[label][1]:.4f} ms back to back")
    return out


def e3_table(device, calls: int = 3) -> dict:
    """E3 unpacked and packed (block-diagonal K/V) at Q = 128, T = 1536,
    D = 64 for g = 28, 30, 32, 280, 300 and 320 programs and reps = 8 and
    64, random inputs from a seed: {label: [events ms, ms per program]}."""
    import torch

    from whisper_tpu_torch.experiments.attn_packed import block_diagonal
    from whisper_tpu_torch.ops.kernels.attn_packed import attn_pairs_packed, attn_pairs_unpacked

    Q, T, D = 128, 1536, 64
    out = {}
    for g in (28, 30, 32, 280, 300, 320):
        gen = torch.Generator(device=device).manual_seed(g)

        def randn(*shape):
            return (torch.randn(shape, generator=gen, device=device) * 0.1).to(torch.bfloat16)

        q2 = randn(g, Q, 2 * D)
        k1, v1, k2, v2 = (randn(g, T, D) for _ in range(4))
        kp, vp = block_diagonal(k1, k2), block_diagonal(v1, v2)
        for reps in (8, 64):
            for name, fn in (("unpacked", lambda: attn_pairs_unpacked(q2, k1, v1, k2, v2, reps)),
                             ("packed", lambda: attn_pairs_packed(q2, kp, vp, reps))):
                label = f"{name} g={g} reps={reps}"
                ms = events_ms(fn, iters=calls)
                out[label] = [ms, ms / g]
                log(f"E3 {label}: {ms:.4f} ms, {1e3 * ms / g:.3f} us per program")
    return out


PARTS = ("k2", "k5", "e2", "e3", "words", "windows", "cli")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("tree", help="root of the checkout to time")
    parser.add_argument("--runs", type=int, default=5, help="timed runs of each window")
    parser.add_argument("--only", default=",".join(PARTS),
                        help=f"comma-separated parts to time, of {','.join(PARTS)} (default: all)")
    args = parser.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_compare: no CUDA device", file=sys.stderr)
        return 1
    import whisper_tpu_torch
    from whisper_tpu_torch import log_mel_spectrogram, pad_or_trim
    from whisper_tpu_torch.decoding import DecodingOptions, DecodingTask
    from whisper_tpu_torch.models import KNOWN_MODELS
    from whisper_tpu_torch.models.whisper import init_params
    from whisper_tpu_torch.ops.kernels import _lib
    from whisper_tpu_torch.ops.kernels.fused_step import fused_decoder_layers
    from whisper_tpu_torch.tokenizer import get_tokenizer

    if not whisper_tpu_torch.__file__.startswith(tree):
        raise RuntimeError(f"imported {whisper_tpu_torch.__file__}, not the tree {tree}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    log(f"tree {args.tree}: {card.splitlines()[0]}")
    t0 = time.perf_counter()
    _lib.lib()  # built from the tree's sources when missing or stale
    log(f"kernel library ready: {time.perf_counter() - t0:.2f} s")

    parts = set(args.only.split(","))
    if not parts <= set(PARTS):
        raise SystemExit(f"--only: parts of {PARTS}, got {sorted(parts - set(PARTS))}")
    row = {"tree": args.tree}
    if "k2" in parts:
        row.update(k2_b1_ms=k2_ms(device, 1), k2_b5_ms=k2_ms(device, 5), k2=k2_table(device))
    for part, table in (("k5", k5_table), ("e2", e2_table), ("e3", e3_table), ("words", word_timing_table)):
        if part in parts:
            row[part] = table(device)
    if not parts & {"windows", "cli"}:
        print(json.dumps(row))
        return 0
    dims = KNOWN_MODELS["turbo"]
    model = whisper_tpu_torch.Whisper(
        dims, init_params(dims, torch.Generator(device=device).manual_seed(0), torch.bfloat16, device)
    )
    audio_path = os.path.join(tree, "tests", "jfk.flac")
    audio = whisper_tpu_torch.load_audio(audio_path)

    if "windows" in parts:
        # the pinned window: timestamp, 107 text tokens, final timestamp, EOT
        tok = get_tokenizer(model.is_multilingual, num_languages=model.num_languages,
                            language="en", task="transcribe")
        text = np.random.RandomState(0).randint(1000, 20000, size=107)
        forced = [tok.timestamp_begin, *map(int, text), tok.timestamp_begin + 1500, tok.eot]
        DecodingTask._forced_tokens = forced
        try:
            row["pinned_s"] = median_wall(
                lambda: model.transcribe(audio, language="en", temperature=0.0), args.runs)
        finally:
            DecodingTask._forced_tokens = None
        row["pinned_ms_per_token"] = 1e3 * row["pinned_s"] / len(forced)

        mel = log_mel_spectrogram(pad_or_trim(audio), model.dims.n_mels, device=model.device)
        features = model.embed_audio(mel[None])
        task = DecodingTask(model, DecodingOptions(language="en", beam_size=5))
        before = fused_decoder_layers.launches
        task.run(features)
        steps = fused_decoder_layers.launches - before
        row["beam5_s"] = median_wall(lambda: task.run(features), args.runs)
        row["beam5_ms_per_step"] = 1e3 * row["beam5_s"] / steps
        log(f"pinned window {row['pinned_s']:.4f} s ({row['pinned_ms_per_token']:.4f} ms per token); "
            f"beam-5 window {row['beam5_s']:.4f} s ({steps} steps, {row['beam5_ms_per_step']:.4f} ms "
            f"per step)")

    def cli_path():
        np.random.seed(0)  # the best-of rungs draw their seeds from numpy's RNG
        return model.transcribe(
            audio_path, verbose=None, temperature=tuple(np.arange(0.0, 1.0 + 1e-6, 0.2)),
            word_timestamps=True, language=None, best_of=5, beam_size=5,
            condition_on_previous_text=True, compression_ratio_threshold=2.4,
            logprob_threshold=-1.0, no_speech_threshold=0.6,
        )

    if "cli" in parts:
        row["cli_s"] = median_wall(cli_path, max(1, args.runs // 2))
        log(f"CLI default path {row['cli_s']:.3f} s")
    print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
