#!/usr/bin/env python3
"""Smoke run of whisper_tpu_torch's main path on one CUDA card.

    python3 chip_smoke.py [--profile]

Phases, each of which must pass (any failure exits non-zero):
  1. the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from whisper_tpu_torch/csrc (nvcc, sm_90a, one
     process per source), with ptxas's registers and spills in short; K1's
     and E1's bf16 instances and E3's (TMA + wgmma) must use wgmma (HGMMA
     in the SASS), spill nothing and draw no "serialized" report from
     ptxas, and
     no instance of K2's, K5's, E2's, K3's or K4's kernels may spill;
  3. K1, encoder self-attention, against its plain PyTorch version at
     large-v3-turbo encoder shapes (1, 20, 1500, 64), bf16 and f32, and at
     the 16-window batch (16, 20, 1500, 64) in bf16, beside SDPA, with
     TFLOP/s and the share of the bound reached;
  4. K2, the fused decode step, against its plain version at
     large-v3-turbo decoder shapes (L=4, C=1280, H=20, T=256, Ta=1500) for
     one row (B=1, greedy) and a group of five (B=5, beam or best-of), bf16
     and f32; each kernel's line also gives its bound (bytes at 3.35 TB/s or
     operations at the peak of their type, whichever takes longer) and,
     where one PyTorch call computes the same function, that call's time;
  5. K3, the median filter, against its plain version at the word-timing
     shape (40 heads, 1, 256 tokens, 1500 frames) f32, width 7, with signed
     zeros and NaN payloads planted: bit-equal; its time beside its bound;
  6. K4, the DTW trace, against its plain version at n = 253, m = 1500,
     one matrix and 16: bit-equal; its time beside its byte bound and its
     latency bound (n + m - 1 cell updates at the time one takes in a
     dependent chain, measured by dtw_chain);
  7. the greedy path end to end: a large-v3-turbo model with random weights
     (init_params from a seeded generator, bf16, on the card; the repo holds
     no checkpoint for load_model), transcribe tests/jfk.flac with language
     detection, check that K1 and K2 (B=1) ran on that path; then decode the
     window again with a pinned production-shaped 110-token sequence and
     time it;
  8. the CLI's default path end to end (what ``cli()`` does after
     load_model): transcribe jfk.flac with language detection, beam 5 at
     T = 0, best-of 5 on the 0.2-step ladder above it and word timestamps,
     then write every format with highlighted words; check that K1, K2 at
     B=5, K3 and K4 ran on that path, that the files were written and that
     every word lies inside its segment (its first and last word within the
     0.7 s that add_word_timestamps may move them past its edges);
  9. a beam-5 window (DecodingTask.run from jfk's encoder features; random
     weights run all 224 steps): wall and ms per step;
 10. K2 for several audios against its plain version, bf16 and f32:
     sixteen audios of one row at sixteen positions, three and sixteen
     audios of five rows (80 rows) at per-row positions, and five and four
     audios of five rows at one shared position (the --chunked path's
     layouts), with each case's bound (run before phase 7, with the other
     kernel checks);
 11. DecodingTask.run_with_prompts on 16 windows with prompts of 0, 7, 64
     and 223 tokens: wall, ms/step; then one more run with K2's positions
     recorded, each step's equal to the rows' prompt-derived lengths + step
     (sixteen rows, four positions);
 12. transcribe_batch on 20 files cut and tiled from jfk.flac (4-70 s),
     batch_size 16, T = 0, prompts carried: well-formed results, K1 and the
     multi-audio K2 launched, each round's prompt lengths;
 13. the --chunked CLI path at its defaults on jfk tiled to 110 s (five
     chunks, beam 5 and best-of 5: 25 rows), word timestamps, every
     writer: K2 at 5 x 5 rows, K3 and K4 launched, words in their segments;
 14. align(segments=...) of that result's text on the same audio (K3, K4);
 15. the per-row K/V column write at B=16 timed beside K2's step;
 16. K2's int8 instances against the plain version on the same int8 values,
     bf16 and f32, in two forms (int8 weights with the cross K/V in the
     compute dtype; int8 weights and int8 cross K/V): B=1, one group of 5,
     16 audios x 1 at per-row positions, 5 x 5, and 16 x 5 at per-row
     positions; each case's bound counts every tensor at its own element
     size;
 17. K5 (K2's MLP stage on its own: in bf16 two launches of
     mlp_stream_kernel) at C=1280 for B = 1, 5 and 16 rows and the 125 rows
     of K2's first 32 x 5 slice, bf16 and int8 weights, with its share of
     the bound and one F.linear of each product's weight as a yardstick;
     the int8 logits (51866 x 1280) against the dequantised matmul, beside
     one bf16 torch.mm of the same rows;
 18. the int8 configuration end to end at full depth: the random turbo
     weights quantized "int8+logits" on the card (the model's bytes, bf16
     and int8), kv_cache_dtype="int8": the greedy transcribe(jfk.flac) with
     its launches of K1, K2's int8 instance, K5's stage and the int8
     logits; the pinned window in turns with bf16; the beam-5 window, the
     16-window run_with_prompts and transcribe_batch on the 20 files, each
     beside phase 9's, 11's and 12's bf16 number; int8_divergence_proxy on
     three windows; the --chunked CLI path (K2 int8 at 5 x 5 and 4 x 5);
 19. with --profile only: the pinned greedy window, the beam-5 window and
     the 16-window run_with_prompts, bf16 and int8, under torch.profiler
     (device idle share), and the bf16 ones under cProfile (host time per
     token step);
 20. K2's pending block (the write-block engine's step) against its plain
     version at turbo shapes, T = 448 (beside the same layouts at T = 448
     without a block), W = 8 with 0, 3 and 7 columns valid,
     bf16 and f32: one row in the "int8+kv_int8" form (int8 streaming), 16
     audios x 1 at 16 per-row block starts (the server's batch), 3 x 5 at
     per-row block starts (best-of groups of a batch), each with its bound
     and time (run with the other kernel checks);
 21. the write path at B=16, T=448 (phase 15's): eight pending-column
     writes and one flush per block, per step, beside the per-step column
     write;
 22. the write-block engine against the per-step engine: phase 11's
     16-window run_with_prompts with write_block 8 and 0 in turns (wall, ms
     per step, K2's pending and per-step launches), bf16 and int8 (phase
     18), and the int8 pinned window in turns; in f32 without timestamps,
     with a pinned 110-token sequence no filter masks, equal tokens and
     avg_logprob within 1e-5, and the free-running tokens' agreement;
 23. the HTTP server end to end (with --profile, its 20 requests again
     under torch.profiler: the card's idle share): make_server(model,
     port=0, batch_size=16,
     max_wait_s=0.25) in a thread on 127.0.0.1 with the random bf16 turbo
     model; phase 12's 20 files as WAV bodies from 20 client threads
     (language en, T = 0): every answer 200 and well-formed, /healthz,
     the batcher's stats, K1 and K2's multi-audio pending layout launched;
     requests per second, audio seconds per wall second, p50/p95 latency,
     mean batch occupancy; then a stream=true request and a
     chunked=true&stream=true request on jfk tiled to 70 s (NDJSON ending
     in "done"; time to the first line against the whole answer);
 24. StreamingTranscriber on phase 18's int8 model with
     kv_cache_dtype="int8", fed jfk tiled to 44 s in 5 s pushes: K2's
     one-row int8 pending instance launched;
 25. K1 at head dim 128 against its plain version at (1, 10, 1500, 128) and
     (16, 10, 1500, 128), bf16 and f32, K1's tolerances (with the other
     kernel checks); then the encoder at turbo's widths with 10 heads of
     128 (the turbo weights, bf16) on jfk's mel: K1 launched once per layer
     (32), the features finite, its wall beside the 20-head encoder's;
 26. E1 (matmul with the residual epilogue) against its plain version at
     large-v3's encoder fc2 at batch 16 (24000 x 5120 x 1280) in bf16 and
     at (3000, 1280, 640) in f32, beside addmm + add; bf16 each element
     within the plain version's three roundings (bf16_rounding_bound), on
     the phase's inputs and on 20 more seeds;
 27. E2 (the streamed logits) in both weight layouts against its plain
     version at B = 1, 5 and 16 of turbo's vocabulary, beside bf16 torch.mm;
 28. E3 (the packing experiment's pairs) unpacked and packed against their
     plain versions at g = 320, reps 2 and 64, and packed against unpacked;
     at reps = 64 on chain-visible inputs (K and V at chain_scale: every
     rep's feedback moves qq); times at reps = 64 (and device times),
     packed/unpacked, and 64 reps of torch.bmm as a yardstick that is not
     the same function (26-28 with the other kernel checks); then the
     three experiments' entry points at their defaults on the card
     (encoder_ops at --d 128), each kernel launched;
 29. K2 above 128 rows: 32 x 5 and 160 x 1 at per-row positions against
     its plain version (with the other kernel checks); then
     transcribe_batch on 32 files cut from jfk with batch_size 32 and beam
     5: well-formed results, K2 launched in slices of 25 and 7 audios;
 30. one K2 step split by launch (with the other kernel checks): the step
     captured in a CUDA graph and replayed under torch.profiler, each
     launch's device time and the gap before it (negative where
     programmatic dependent launch overlaps it with the one before), per
     role (q|k|v, self-attention, o, xq, cross-attention, xo, fc1, fc2),
     at one row, one audio of five and 16 x 1 at t = 200, bf16 and
     int8+kv_int8;
 31. K2's cross-attention launch alone at turbo shapes (one row, one audio
     of five, 16 audios of one) against its plain version, beside
     F.scaled_dot_product_attention on (T, D) copies of the K/V (a
     yardstick the port never calls); its launches on the greedy path (L
     per K2 step);
 32. K5's two launches, fc1 and fc2, split as phase 30 splits a K2 step
     (with the other kernel checks), at 1, 5 and 16 rows, bf16 and int8
     weights: each launch's device time and the gap before it;
 33. K2 for one audio's group wider than a launch: 1 x 129 and 1 x 200
     rows at per-row positions against its plain version (launched in two
     parts of the group), with the other kernel checks; then a best-of-129
     and a best-of-200 decode of jfk's window on the turbo weights at
     T = 0.7: K2 launched in parts of 65 + 64 and 100 + 100 rows;
 34. a decoder K2 does not take (head dim 32, the tests' tiny dims) decodes
     on the card through the PyTorch step, chosen by shape, greedy and
     beam 5 in f32: no K2 launch, the tokens of the same decode on the CPU;
 35. speculative greedy decoding at full width: large-v3 drafted for by
     large-v3-turbo's decoder, the encoder shared, random weights on the
     card; in f32 (TF32 off) the turbo draft and the self-draft equal the
     plain greedy decode token for token, every draft step a K2 launch;
     in bf16 the plain window, the turbo draft, the self-draft and the
     all-accept ceiling in turns (ms per token, rounds, tokens per round,
     K1 and K2 launches), the turbo draft equal to plain greedy or apart
     only at a near-tie (K2's bf16 bound, re-scored by decoder_forward);
     its stages on profiling.StageTimer, its idle share, the allocator's
     statistics; one window of the int8 target with int8 cross K/V; and
     K2 at the draft's step shape (B = 1, L = 4, T = 448, a per-row
     position) against its plain version, with the other kernel checks.
The line before the last is a JSON summary of the kernels; the last line
is {"ok": true, "device": {...}}.  Without a CUDA device it exits non-zero
and prints no result.
"""

import argparse
import contextlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import torch

# bound: each kernel's least time on an H100; time_ms: mean CUDA-event time after a warm-up
from whisper_tpu_torch.experiments._common import bound, time_ms

REPO = os.path.dirname(os.path.abspath(__file__))
CUDA = torch.device("cuda")
AUDIO = os.path.join(REPO, "tests", "jfk.flac")

# kernel against plain, as tests/test_torch_cuda.py holds them.  K1 f32: max
# abs error on outputs of unit scale.  K1 bf16, relative to the plain
# output: RMS error and max error over max |plain|.  On an H100 the kernel
# reads at most 2.3e-3 and 5.2e-3 at the shapes of those tests; a kernel
# that stops masking the keys past T = 1500 reads an RMS error of 1.45e-2.
# K2: max error relative to max |plain| (bf16: a few bf16 ulps after four
# layers; f32: summation order only), for one row and for a group of rows.
# K3 and K4 select and compare, they do no arithmetic that could round
# otherwise: their outputs must equal the plain versions' bit for bit.
K1_F32_ATOL = 1e-5
K1_BF16_REL_RMS, K1_BF16_REL_MAX = 5e-3, 1e-2
K2_REL_TOL = {"bfloat16": 2e-2, "float32": 1e-4}
# K2's int8 instances and K5 are held to K2's bounds.  The int8 logits: max
# error relative to max |plain|; both sum exact products in f32, only the
# order differs.
INT8_LOGITS_REL_TOL = 1e-5
# E2 (the streamed logits) is held to the int8 logits' bound: exact bf16
# products summed in f32.  E1 f32: max error relative to max |plain|, 1e-4
# (sums over K = 5120 in another order).  E1 bf16: per element, within
# matmul_residual.bf16_rounding_bound.  The plain version rounds three
# times, y = bf16(x @ w), t = bf16(y + bias), out = bf16(t + res); the
# kernel's f32 product, summed in another order, may round to the bf16
# neighbour of y (one ulp of |y|), and each later add may round the two
# sides apart by one more ulp (of |t|, then of |out|): ulp(y) + ulp(t) +
# ulp(out), each at the plain value's binade (the next one up within an ulp
# of a power of two).  A global bound of one ulp of the largest output
# (8e-3, the earlier check) is narrower than that where |y| nears the
# output's magnitude: 1.053e-2 read at (24000, 5120, 1280) on one draw.
# The bf16 check runs on E1_BF16_SEEDS draws of its own.  E3: max error
# relative to max |plain|, 8e-3 (a score rounded to bf16 may land one ulp
# apart and move an output across a rounding boundary).
E1_F32_REL_TOL = 1e-4
E1_BF16_SEEDS = 20
E3_REL_TOL = 8e-3

def log(msg: str) -> None:
    print(msg, flush=True)


def ptxas_kernels(log: str) -> dict:
    """ptxas -v's report: {mangled kernel name: [registers, spill-store bytes]}."""
    import re

    kernels, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            kernels[name] = [0, 0]
        elif name and (m := re.search(r"Used (\d+) registers", line)):
            kernels[name][0] = int(m.group(1))
        elif name and (m := re.search(r"(\d+) bytes spill stores", line)):
            kernels[name][1] = int(m.group(1))
    return kernels


def ptxas_summary(log: str) -> list:
    """ptxas -v's report, short: the kernel count, the highest register
    count, the B=1 GEMVs' registers, and every kernel that spills (named
    by c++filt where the machine has it)."""
    import re
    import shutil

    kernels = ptxas_kernels(log)
    out = [f"{len(kernels)} kernels, at most {max(r for r, _ in kernels.values())} registers"]
    gemv1 = sorted({r for n, (r, _) in kernels.items() if "gemv_kernel" in n and "Li1ELb" in n})
    out.append(f"one-row GEMVs (gemv_kernel<..., 1, ...>): registers {gemv1}")
    spills = [(n, s) for n, (_, s) in kernels.items() if s]
    if spills and shutil.which("c++filt"):
        names = subprocess.run(["c++filt"], input="\n".join(n for n, _ in spills), capture_output=True,
                               text=True, timeout=60).stdout.splitlines()
        spills = [(re.sub(r"\(anonymous namespace\)::|\(.*", "", d), s) for d, (_, s) in zip(names, spills)]
    return out + [f"spills {s} bytes: {n}" for n, s in spills]


# K1's and E1's bf16 kernels, and E3's (each instance: head dim, cluster size)
WGMMA_KERNELS = ("encoder_attention_wgmma_kernel", "matmul_residual_wgmma_kernel", "attn_pairs_cluster_kernel")
# K2's, K5's, E2's, K3's and K4's kernels, redesigned for Hopper: none may spill
SPILL_FREE_KERNELS = ("gemv_kernel", "gemv_tc_kernel", "decode_attention_kernel", "mlp_stream_kernel",
                      "logits_vc_kernel", "logits_cv_kernel", "median_kernel", "dtw_trace_kernel")


def wgmma_check(log: str, lib_path: str) -> list:
    """K1's, E1's bf16 and E3's instances, the wgmma kernels: their registers and
    spills from ptxas -v, and their HGMMA (wgmma) instructions in the
    library's SASS (cuobjdump).  Raises on ptxas's "wgmma.mma_async
    instructions are serialized" report for any kernel, on a spill in one
    of them or in any instance of K2's, K5's, E2's, K3's or K4's kernels
    (SPILL_FREE_KERNELS), or on a wgmma instance without HGMMA."""
    import re
    import shutil

    serialized = [line.strip() for line in log.splitlines() if "wgmma" in line and "serializ" in line]
    if serialized:
        raise RuntimeError("ptxas serialized the wgmma instructions:\n" + "\n".join(serialized))
    kernels = ptxas_kernels(log)
    spilled = {n: s for n, (_, s) in kernels.items() if s and any(k in n for k in SPILL_FREE_KERNELS)}
    if spilled:
        raise RuntimeError(f"K2/K5/E2/K3/K4 instances spill (mangled name: bytes): {spilled}")
    checked = [n for n in kernels if any(k in n for k in SPILL_FREE_KERNELS)]
    regs = {n: rs for n, rs in kernels.items() if any(k in n for k in WGMMA_KERNELS)}
    cuobjdump = shutil.which("cuobjdump") or os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin",
                                                          "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", lib_path], capture_output=True, text=True, check=True,
                          timeout=300).stdout
    hgmma, fn = dict.fromkeys(regs, 0), None
    for line in sass.splitlines():
        if m := re.search(r"Function : (\S+)", line):
            fn = m.group(1) if m.group(1) in hgmma else None
        elif fn and "HGMMA" in line:
            hgmma[fn] += 1
    if len(regs) < len(WGMMA_KERNELS) or any(s for _, s in regs.values()) or not all(hgmma.values()):
        raise RuntimeError(f"wgmma kernels (registers, spill bytes) {regs}, HGMMA instructions {hgmma}")
    def short(n):  # the kernel's name and template arguments
        kernel = next(k for k in WGMMA_KERNELS if k in n)
        return kernel + (f"<{', '.join(re.findall(r'Li(\d+)E', n))}>" if "Li" in n else "")

    return [f"{short(n)}: {r} registers, {s} bytes spilled, {hgmma[n]} HGMMA" for n, (r, s) in regs.items()] + [
        f"{len(checked)} instances of {', '.join(SPILL_FREE_KERNELS)}: no spill"]


def graph_ms(fn, iters: int = 50) -> float:
    """fn's device time alone: its launches captured once in a CUDA graph
    and replayed, so that the host's enqueue does not pace them (time_ms's
    back-to-back launches are host-paced where a call's device work is
    shorter than its enqueue)."""
    import torch

    fn()  # warm-up outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return time_ms(graph.replay, CUDA, iters=iters)


def device_events(prof) -> list:
    """The device activity (kernels, copies, fills) of a torch.profiler run,
    from its Chrome trace: events with "ts" and "dur" in us, in time order."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    return sorted((e for e in trace["traceEvents"] if e.get("ph") == "X"
                   and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")), key=lambda e: e["ts"])


def busy_ms(events) -> float:
    """The time in ms the device was doing something: the union of the
    events' intervals.  Under programmatic dependent launch a launch starts
    while the one before it drains, so the sum of their durations counts
    the overlap twice."""
    busy, end = 0.0, -float("inf")
    for e in events:
        start, stop = e["ts"], e["ts"] + e["dur"]
        busy += max(0.0, stop - max(start, end))
        end = max(end, stop)
    return busy / 1e3


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def k1_case(gen, device, shape, dtype):
    """K1 against its plain version at one shape and dtype, beside SDPA
    (one PyTorch call of the same function: its default scale D^-0.5 is
    the kernel's D^-0.25 on q and on k; the port never calls it): the
    errors against K1's bounds, the kernel's time (CUDA events) and device
    time (graph_ms), TFLOP/s and the share of the bound reached."""
    import torch

    from whisper_tpu_torch.ops.kernels.attention import attention, attention_plain

    q, k, v = (torch.randn(shape, generator=gen, device=device).to(dtype) for _ in range(3))
    out, ref = attention(q, k, v).float(), attention_plain(q, k, v).float()
    diff = out - ref
    err = diff.abs().max().item()
    rel_rms, rel_max = diff.norm().item() / ref.norm().item(), err / ref.abs().max().item()
    del out, ref, diff
    ms = time_ms(lambda: attention(q, k, v), CUDA)
    device_ms = graph_ms(lambda: attention(q, k, v))
    plain_ms = time_ms(lambda: attention_plain(q, k, v), CUDA, iters=5)
    library_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v), CUDA)
    B, H, T, D = shape
    name = str(dtype).split(".")[-1]
    flops = 4 * B * H * T * T * D  # QK^T and PV; q, k, v read and the output written once
    kb = bound(4 * q.numel() * q.element_size(), flops, name)
    if dtype == torch.float32:
        tol, ok = f"tol {K1_F32_ATOL:.0e}", err <= K1_F32_ATOL
    else:
        tol = f"tol {K1_BF16_REL_RMS:.0e} / {K1_BF16_REL_MAX:.0e}"
        ok = rel_rms <= K1_BF16_REL_RMS and rel_max <= K1_BF16_REL_MAX
    log(f"K1 encoder_attention {shape} {name}: max_abs_err {err:.3e}; relative errors rms/max "
        f"{rel_rms:.3e}/{rel_max:.3e} ({tol}) kernel {ms:.4f} ms [device {device_ms:.4f}] plain "
        f"{plain_ms:.4f} ms library (SDPA) {library_ms:.4f} ms bound {kb['bound_ms']:.4f} ms by "
        f"{kb['bound_by']}; {flops / ms / 1e9:.1f} TFLOP/s, {kb['bound_ms'] / ms:.3f} of the bound")
    if not ok:
        raise RuntimeError(f"K1 {shape} {name} disagrees with its plain version: {err}, {rel_rms}, {rel_max}")
    return dict(max_abs_err=err, ms=ms, device_ms=device_ms, plain_ms=plain_ms, library_ms=library_ms, **kb)


def check_k1(gen, device):
    """K1 at large-v3-turbo's encoder shape (1, 20, 1500, 64) in bf16 and
    f32, and at (16, 20, 1500, 64) in bf16 (the batch of the 16-window
    decode and of transcribe_batch).  Returns the rows by (batch, dtype)."""
    import torch

    cases = (((1, 20, 1500, 64), torch.bfloat16), ((1, 20, 1500, 64), torch.float32),
             ((16, 20, 1500, 64), torch.bfloat16))
    return {(shape[0], str(dtype).split(".")[-1]): k1_case(gen, device, shape, dtype) for shape, dtype in cases}


def check_k1_d128(gen, device):
    """K1's head-dim-128 instance at (1, 10, 1500, 128) and (16, 10, 1500,
    128), bf16 and f32.  Returns the rows by (batch, dtype)."""
    import torch

    return {(b, str(dtype).split(".")[-1]): k1_case(gen, device, (b, 10, 1500, 128), dtype)
            for b in (1, 16) for dtype in (torch.bfloat16, torch.float32)}


def e1_errors(x, w, bias, res):
    """E1 against its plain version: the max abs error and its check, f32
    relative to max |plain|, bf16 the largest ratio of error to
    bf16_rounding_bound over the elements."""
    import torch

    from whisper_tpu_torch.ops.kernels.matmul_residual import (bf16_rounding_bound, matmul_residual,
                                                                matmul_residual_plain)

    out, ref = matmul_residual(x, w, bias, res).float(), matmul_residual_plain(x, w, bias, res).float()
    diff = (out - ref).abs()
    if x.dtype == torch.float32:
        return diff.max().item(), diff.max().item() / ref.abs().max().item()
    return diff.max().item(), (diff / bf16_rounding_bound(x, w, bias, res)).max().item()


def check_e1(gen, device):
    """E1 against its plain version at large-v3's encoder fc2 at batch 16
    (M = 24000, K = 5120, N = 1280) in bf16 and at (3000, 1280, 640) in f32,
    beside addmm + add (the library's fc2 with its residual); then the bf16
    check on E1_BF16_SEEDS more draws of inputs, each from a generator of
    its own.  Returns the bf16 row."""
    import torch

    from whisper_tpu_torch.ops.kernels.matmul_residual import matmul_residual, matmul_residual_plain

    def inputs(gen, M, K, N, dtype):
        def randn(*shape, scale):
            return (torch.randn(shape, generator=gen, device=device) * scale).to(dtype)

        return randn(M, K, scale=0.3), randn(K, N, scale=0.02), randn(N, scale=0.1), randn(M, N, scale=0.3)

    rows = {}
    for (M, K, N), dtype in (((24000, 5120, 1280), torch.bfloat16), ((3000, 1280, 640), torch.float32)):
        x, w, bias, res = inputs(gen, M, K, N, dtype)
        err, ratio = e1_errors(x, w, bias, res)
        name = str(dtype).split(".")[-1]
        ms = time_ms(lambda: matmul_residual(x, w, bias, res), CUDA)
        device_ms = graph_ms(lambda: matmul_residual(x, w, bias, res))
        plain_ms = time_ms(lambda: matmul_residual_plain(x, w, bias, res), CUDA)
        library_ms = time_ms(lambda: torch.addmm(bias, x, w) + res, CUDA)
        size = x.element_size()
        kb = bound((M * K + K * N + N + 2 * M * N) * size, 2 * M * K * N, name)
        check = (f"relative {ratio:.3e} (tol {E1_F32_REL_TOL:.0e})" if dtype == torch.float32 else
                 f"largest error over its rounding bound {ratio:.3f} (tol 1)")
        log(f"E1 matmul_residual M={M} K={K} N={N} {name}: max_abs_err {err:.3e}, {check} kernel {ms:.4f} ms "
            f"[device {device_ms:.4f}] plain {plain_ms:.4f} ms library (addmm + add) {library_ms:.4f} ms bound "
            f"{kb['bound_ms']:.4f} ms by {kb['bound_by']}; {2 * M * K * N / ms / 1e9:.1f} TFLOP/s, "
            f"{kb['bound_ms'] / ms:.3f} of the bound")
        if not ratio <= (E1_F32_REL_TOL if dtype == torch.float32 else 1.0):
            raise RuntimeError(f"E1 {name} disagrees with its plain version: {ratio}")
        rows[name] = dict(max_abs_err=err, ms=ms, device_ms=device_ms, plain_ms=plain_ms, library_ms=library_ms,
                          **kb)
        del x, w, bias, res
    ratios = [e1_errors(*inputs(torch.Generator(device=device).manual_seed(1000 + s), 24000, 5120, 1280,
                                torch.bfloat16))[1] for s in range(E1_BF16_SEEDS)]
    log(f"E1 bf16 at (24000, 5120, 1280) on {E1_BF16_SEEDS} more seeds: largest error over its rounding bound "
        f"{max(ratios):.3f} (each seed: {', '.join(f'{r:.3f}' for r in ratios)})")
    if not max(ratios) <= 1.0:
        raise RuntimeError(f"E1 bf16 outside its rounding bound on some seed: {ratios}")
    return rows["bfloat16"]


def check_e2(gen, device):
    """E2 in both layouts against its plain version at B = 1, 5 and 16 of
    turbo's vocabulary (51866 x 1280, bf16), beside the bf16 torch.mm the
    unquantized path calls (f32 out).  Returns the rows by (layout, B)."""
    import torch

    from whisper_tpu_torch.ops.kernels.logits import logits_streamed, logits_streamed_plain

    V, C = 51866, 1280
    emb = (torch.randn((V, C), generator=gen, device=device) * 0.02).to(torch.bfloat16)
    weights = {"vc": emb, "cv": emb.t().contiguous()}
    rows = {}
    for B in (1, 5, 16):
        x = torch.randn((B, C), generator=gen, device=device).to(torch.bfloat16)
        library_ms = time_ms(lambda: torch.mm(x, emb.t(), out_dtype=torch.float32), CUDA)
        library_device_ms = graph_ms(lambda: torch.mm(x, emb.t(), out_dtype=torch.float32))
        for layout, w in weights.items():
            out, ref = logits_streamed(x, w, layout), logits_streamed_plain(x, w, layout)
            torch.cuda.synchronize()
            err = (out - ref).abs().max().item()
            rel = err / ref.abs().max().item()
            ms = time_ms(lambda: logits_streamed(x, w, layout), CUDA)
            device_ms = graph_ms(lambda: logits_streamed(x, w, layout))
            plain_ms = time_ms(lambda: logits_streamed_plain(x, w, layout), CUDA)
            kb = bound(2 * (V * C + B * C) + 4 * B * V, 2 * B * V * C, "bfloat16")
            log(f"E2 logits_streamed {layout} V={V} C={C} B={B} bf16: max_abs_err {err:.3e}, relative "
                f"{rel:.3e} (tol {INT8_LOGITS_REL_TOL:.0e}) kernel {ms:.4f} ms ({device_ms:.4f} ms "
                f"replayed from a CUDA graph) plain {plain_ms:.4f} ms, bf16 torch.mm logits "
                f"{library_ms:.4f} ms ({library_device_ms:.4f} ms replayed), bound {kb['bound_ms']:.4f} ms "
                f"by {kb['bound_by']}")
            if not rel <= INT8_LOGITS_REL_TOL:
                raise RuntimeError(f"E2 {layout} B={B} disagrees with its plain version: {rel}")
            rows[layout, B] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms, **kb)
    return rows


def e3_yardstick(q2, pairs, reps: int):
    """E3's products as torch.bmm calls, reps times: per pair, the bf16
    scores qq k^T and their f32 product with v.  Not the same function (no
    feedback, q stands for qq): a yardstick of the library's rate on the
    same shapes, which the port never calls."""
    import torch

    for _ in range(reps):
        for cols, k, v in pairs:
            s = torch.bmm(q2[..., cols], k.transpose(1, 2))
            torch.bmm(s, v, out_dtype=torch.float32)


def check_e3(gen, device):
    """E3 unpacked and packed against their plain versions at g = 320, Q =
    128, T = 1536, D = 64, reps 2 and 64, packed against unpacked on
    block-diagonal operands; then at reps = 64 on chain-visible inputs (K
    and V at chain_scale, where every rep's feedback moves qq, so that a
    kernel skipping reps disagrees; the plain outputs at 63 and 64 reps lie
    beyond the tolerance); the times at reps = 64 (CUDA events, and the
    device time from a CUDA graph), packed/unpacked and the torch.bmm
    yardstick.  Returns the rows by variant (reps = 64)."""
    import torch

    from whisper_tpu_torch.experiments.attn_packed import block_diagonal, chain_scale
    from whisper_tpu_torch.ops.kernels import attn_packed as e3

    g, Q, T, D = 320, 128, 1536, 64

    def randn(*shape, scale=0.1):
        return (torch.randn(shape, generator=gen, device=device) * scale).to(torch.bfloat16)

    def variants(q2, k1, v1, k2, v2):
        kp, vp = block_diagonal(k1, k2), block_diagonal(v1, v2)
        return {
            "unpacked": (lambda r: e3.attn_pairs_unpacked(q2, k1, v1, k2, v2, r),
                         lambda r: e3.attn_pairs_unpacked_plain(q2, k1, v1, k2, v2, r),
                         [(slice(0, D), k1, v1), (slice(D, 2 * D), k2, v2)], 1),
            "packed": (lambda r: e3.attn_pairs_packed(q2, kp, vp, r),
                       lambda r: e3.attn_pairs_packed_plain(q2, kp, vp, r), [(slice(None), kp, vp)], 2),
        }

    def rel_err(out, ref):
        return (out.float() - ref.float()).abs().max().item() / ref.float().abs().max().item()

    q2 = randn(g, Q, 2 * D)
    k1, v1, k2, v2 = (randn(g, T, D) for _ in range(4))
    rows, outs = {}, {}
    for name, (kernel, plain, pairs, work) in variants(q2, k1, v1, k2, v2).items():
        for reps in (2, 64):
            out, ref = kernel(reps), plain(reps)
            torch.cuda.synchronize()
            err, rel = (out.float() - ref.float()).abs().max().item(), rel_err(out, ref)
            log(f"E3 attn_pairs_{name} g={g} Q={Q} T={T} D={D} reps={reps} bf16: max_abs_err {err:.3e}, "
                f"relative {rel:.3e} (tol {E3_REL_TOL:.0e})")
            if not rel <= E3_REL_TOL:
                raise RuntimeError(f"E3 {name} reps={reps} disagrees with its plain version: {rel}")
        outs[name] = out
        ms = time_ms(lambda: kernel(64), CUDA, iters=5)
        device_ms = graph_ms(lambda: kernel(64), iters=10)
        plain_ms = time_ms(lambda: plain(64), CUDA, iters=2)
        yardstick_ms = time_ms(lambda: e3_yardstick(q2, pairs, 64), CUDA, iters=2)
        # 4 Q T D products per head pair per rep (packed: 4x one (Q, 2T, 2D) pair's
        # worth, the zero blocks included); K/V and q read, the output written
        ops = work * 8 * g * Q * T * D * 64
        kv_bytes = 2 * (4 * g * T * D) * work
        kb = bound(kv_bytes + 2 * 2 * g * Q * 2 * D, ops, "bfloat16")
        log(f"E3 attn_pairs_{name} reps=64: kernel {ms:.4f} ms [device {device_ms:.4f}] plain {plain_ms:.4f} ms "
            f"bound {kb['bound_ms']:.4f} ms by {kb['bound_by']} ({ops / ms / 1e9:.1f} TFLOP/s, "
            f"{kb['bound_ms'] / ms:.3f} of the bound); yardstick, not the same function: 64 reps of "
            f"torch.bmm (bf16 scores, f32 o) {yardstick_ms:.4f} ms")
        rows[name] = dict(max_abs_err=err, ms=ms, device_ms=device_ms, plain_ms=plain_ms, library_ms=None,
                          yardstick_ms=yardstick_ms,
                          yardstick="64 reps of torch.bmm (bf16 scores, f32 o): not the same function", **kb)
    rel = rel_err(outs["packed"], outs["unpacked"])
    log(f"E3 packed/unpacked at reps=64: {rows['packed']['ms'] / rows['unpacked']['ms']:.3f}; packed "
        f"against unpacked on block-diagonal operands: relative {rel:.3e} (tol {E3_REL_TOL:.0e})")
    if not rel <= E3_REL_TOL:
        raise RuntimeError(f"E3 packed departs from unpacked on block-diagonal operands: {rel}")
    del outs
    scale = chain_scale(T)
    k1, v1, k2, v2 = (randn(g, T, D, scale=scale) for _ in range(4))
    for name, (kernel, plain, _, _) in variants(q2, k1, v1, k2, v2).items():
        ref = plain(64)
        apart, rel = rel_err(plain(63), ref), rel_err(kernel(64), ref)
        log(f"E3 attn_pairs_{name} reps=64, chain-visible (K, V at {scale:.3e}): relative {rel:.3e} (tol "
            f"{E3_REL_TOL:.0e}); the plain version at 63 reps lies {apart:.3e} from it")
        if not apart > E3_REL_TOL:
            raise RuntimeError(f"E3 {name}: the chain-visible inputs leave reps 63 and 64 within the tolerance")
        if not rel <= E3_REL_TOL:
            raise RuntimeError(f"E3 {name} disagrees with its plain version on chain-visible inputs: {rel}")
    return rows


def nbytes(leaf) -> int:
    """A tensor's bytes, or an int8 leaf's: its int8 values and f32 scales."""
    from whisper_tpu_torch.quantize import Int8Weight

    if isinstance(leaf, Int8Weight):
        return leaf.q.numel() + 4 * leaf.s.numel()
    return leaf.numel() * leaf.element_size()


def k2_bound(blocks, dims: tuple, positions, dtype: str, cross_k, cross_v, pend_w: int = 0) -> dict:
    """K2's bound for one step: every weight read once; each audio's cross
    K/V read once; row b's self K/V at its min(t[b], T) positions read once,
    and its pend_w pending columns; x read and hidden, k_new, v_new
    written; each tensor at its own element size (int8 weights and K/V with
    their f32 scales).  Operations: the GEMVs (two per weight element per
    row) and the attention products."""
    from whisper_tpu_torch.quantize import Int8Weight

    L, B, A, C, T, Ta = dims
    n_ctx = sum(min(max(int(t), 0), T) + pend_w for t in positions)
    act = blocks["attn_ln_g"].element_size()  # the compute dtype's
    moved = (sum(nbytes(w) for w in blocks.values()) + nbytes(cross_k) + nbytes(cross_v)
             + act * (2 * L * C * n_ctx + 2 * B * C + 2 * L * B * C))
    gemv = 2 * B * sum((w.q if isinstance(w, Int8Weight) else w).numel()
                       for n, w in blocks.items() if n.endswith("_w"))
    attention = 4 * L * C * (n_ctx + B) + 4 * L * B * C * Ta
    return bound(moved, gemv + attention, dtype)


K2_DIMS = dict(L=4, C=1280, H=20, Ta=1500, W=8)  # large-v3-turbo's decoder; a pending block's W


def k2_inputs(gen, device, A: int = 1, G: int = 1, t=200, T: int = 256, pend_w=None) -> dict:
    """K2's inputs at turbo decoder shapes for A audios of G rows, in f32:
    random weights, x, each row's own self cache (L, B, H, D, T), each
    audio's cross K/V (L, A, H, D, Ta), a pending block (L, B, H, D, W)
    when pend_w is given; t one position for every row or a list, one per
    row."""
    import torch

    from whisper_tpu_torch.ops.kernels.fused_step import WEIGHTS

    L, C, H, Ta, W = (K2_DIMS[k] for k in ("L", "C", "H", "Ta", "W"))
    D, B = C // H, A * G
    positions = [t] * B if isinstance(t, int) else list(t)

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
        base[n] = 1.0 + randn(*shape, scale=0.1) if n.endswith("_g") else randn(*shape, scale=0.02)
    inputs = dict(A=A, G=G, B=B, T=T, t=t, positions=positions, pend_w=pend_w, base=base,
                  x=randn(B, C, scale=0.5), sk=randn(L, B, H, D, T), sv=randn(L, B, H, D, T),
                  xk=randn(L, A, H, D, Ta), xv=randn(L, A, H, D, Ta))
    if pend_w is not None:
        inputs["pk"], inputs["pv"] = randn(L, B, H, D, W), randn(L, B, H, D, W)
    inputs["pos"] = t if isinstance(t, int) else torch.tensor(positions, device=device)
    return inputs


def k2_args(inputs: dict, dtype, form: str = ""):
    """(blocks, the wrapper's positional arguments) of k2_inputs in dtype;
    form "int8": the eight projections int8 (quantize_weight of the same
    values); "int8+kv_int8": the cross K/V int8 too (quantize_kv)."""
    from whisper_tpu_torch.ops.kernels.fused_step import PROJECTIONS
    from whisper_tpu_torch.quantize import quantize_kv, quantize_weight

    blocks = {n: w.to(dtype).contiguous() for n, w in inputs["base"].items()}
    xk, xv = inputs["xk"].to(dtype), inputs["xv"].to(dtype)
    if form:
        blocks.update({n: quantize_weight(blocks[n]) for n in PROJECTIONS})
    if "kv_int8" in form:
        xk, xv = quantize_kv(xk), quantize_kv(xv)
    args = (blocks, K2_DIMS["H"], inputs["x"].to(dtype), inputs["pos"], inputs["sk"].to(dtype),
            inputs["sv"].to(dtype), xk, xv)
    if inputs["pend_w"] is not None:
        args += (inputs["pk"].to(dtype), inputs["pv"].to(dtype), inputs["pend_w"])
    return blocks, args


def check_k2(gen, device, A: int = 1, G: int = 1, t=200, label: str = "", form: str = "",
             T: int = 256, pend_w=None):
    """K2 against its plain version at turbo decoder shapes for A audios of
    G rows; t is one position for every row, or a list, one per row.  form
    "int8": the eight projections int8 (quantize_weight of the same random
    weights); "int8+kv_int8": the cross K/V int8 too (quantize_kv).  With
    pend_w, the pending variant: a random (L, B, H, D, 8) pending block of
    which pend_w columns are valid, t the rows' block starts."""
    import torch

    from whisper_tpu_torch.ops.kernels.fused_step import fused_decoder_layers, fused_decoder_layers_plain

    L, C, Ta, W = (K2_DIMS[k] for k in ("L", "C", "Ta", "W"))
    inputs = k2_inputs(gen, device, A, G, t, T, pend_w)
    B, positions = inputs["B"], inputs["positions"]
    rows = {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        blocks, args = k2_args(inputs, dtype, form)
        xk, xv = args[6], args[7]
        out = fused_decoder_layers(*args)
        ref = fused_decoder_layers_plain(*args)
        torch.cuda.synchronize()
        errs = []
        for a, b in zip(out, ref):
            errs.append((a.float() - b.float()).abs().max().item() / b.float().abs().max().item())
        ms = time_ms(lambda: fused_decoder_layers(*args), CUDA)
        device_ms = graph_ms(lambda: fused_decoder_layers(*args))
        plain_ms = time_ms(lambda: fused_decoder_layers_plain(*args), CUDA)
        err_abs = (out[0].float() - ref[0].float()).abs().max().item()
        kb = k2_bound(blocks, (L, B, A, C, T, Ta), positions, name, xk, xv, pend_w or 0)
        where = f"t={t}" if isinstance(t, int) else f"{len(set(positions))} positions in [{min(positions)}, {max(positions)}]"
        if pend_w is not None:
            where = f"pending {pend_w} of {W} columns, block start {where}"
        log(f"K2 fused_decoder_layers{label} A={A} G={G} B={B} T={T} {where} {name}"
            f"{' ' + form if form else ''}: max_abs_err hidden "
            f"{err_abs:.3e}; relative errors hidden/k_new/v_new {errs[0]:.3e}/{errs[1]:.3e}/{errs[2]:.3e} "
            f"(tol {K2_REL_TOL[name]:.0e}) kernel {ms:.4f} ms ({device_ms:.4f} ms replayed from a "
            f"CUDA graph) plain {plain_ms:.4f} ms bound {kb['bound_ms']:.4f} ms by {kb['bound_by']}")
        if not max(errs) <= K2_REL_TOL[name]:
            raise RuntimeError(f"K2 A={A} G={G} {name} disagrees with its plain version: {errs}")
        rows[name] = dict(max_abs_err=err_abs, ms=ms, plain_ms=plain_ms, library_ms=None, **kb)
    return rows


def check_cross_attention(gen, device) -> dict:
    """K2's cross-attention launch alone at turbo shapes (H = 20, D = 64, Ta
    = 1500) for one audio of one row and of five, and sixteen audios of one
    row, bf16, against its plain version, beside one
    F.scaled_dot_product_attention call on (T, D) copies of the K/V made
    outside the timing (its default scale D^-0.5 is the kernel's D^-0.25 on
    q and on k; the port never calls it).  Returns the rows by (A, G)."""
    import torch

    from whisper_tpu_torch.ops.kernels.fused_step import cross_attention, cross_attention_plain

    H, D, Ta = K2_DIMS["H"], 64, K2_DIMS["Ta"]
    rows = {}
    for A, G in ((1, 1), (1, 5), (16, 1)):
        B = A * G
        q = torch.randn((B, H * D), generator=gen, device=device).to(torch.bfloat16)
        xk, xv = (torch.randn((A, H, D, Ta), generator=gen, device=device).to(torch.bfloat16) for _ in range(2))
        out, ref = cross_attention(q, xk, xv), cross_attention_plain(q, xk, xv)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        rel = err / ref.float().abs().max().item()
        qs = q.view(A, G, H, D).transpose(1, 2).contiguous()  # (A, H, G, D)
        ks, vs = xk.transpose(-1, -2).contiguous(), xv.transpose(-1, -2).contiguous()  # (A, H, Ta, D)
        ms = time_ms(lambda: cross_attention(q, xk, xv), CUDA)
        device_ms = graph_ms(lambda: cross_attention(q, xk, xv))
        plain_ms = time_ms(lambda: cross_attention_plain(q, xk, xv), CUDA)
        library_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(qs, ks, vs), CUDA)
        library_device_ms = graph_ms(lambda: torch.nn.functional.scaled_dot_product_attention(qs, ks, vs))
        # K and V read once, q read and the output written; QK^T and PV
        kb = bound(2 * (2 * A * H * D * Ta + 2 * B * H * D), 4 * B * H * D * Ta, "bfloat16")
        log(f"K2 cross-attention alone A={A} G={G} H={H} Ta={Ta} bf16: max_abs_err {err:.3e}, relative "
            f"{rel:.3e} (tol {K2_REL_TOL['bfloat16']:.0e}) kernel {ms:.4f} ms ({device_ms:.4f} ms replayed "
            f"from a CUDA graph) plain {plain_ms:.4f} ms library (SDPA on (T, D) copies) {library_ms:.4f} ms "
            f"({library_device_ms:.4f} ms replayed) bound {kb['bound_ms']:.4f} ms by {kb['bound_by']}")
        if not rel <= K2_REL_TOL["bfloat16"]:
            raise RuntimeError(f"K2's cross-attention A={A} G={G} disagrees with its plain version: {rel}")
        rows[A, G] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms, **kb)
    return rows


K2_ROLES = ("q|k|v", "self-attention", "o", "xq", "cross-attention", "xo", "fc1", "fc2")


def replay_split(fn, roles, iters: int = 20) -> dict:
    """fn's launches split by launch: captured in a CUDA graph, replayed
    iters times under torch.profiler (so the host's enqueue is out of the
    numbers), each launch's device time and the gap between the end of the
    launch before it and its start (negative: the two overlap), averaged
    over the replays after the first and over the launches of one role.
    roles(n) names the n launches of one call in order.  Returns {role:
    (us, gap us), "step": (span us, busy us), "replay": replay ms}."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            graph.replay()
        torch.cuda.synchronize()
    events = device_events(prof)
    n = len(events) // iters
    if n == 0 or len(events) % iters:
        raise RuntimeError(f"launch split: {len(events)} device events in {iters} replays")
    names = roles(n)
    per_role = {r: [0.0, 0.0, 0] for r in dict.fromkeys(names)}
    spans, busy = [], []
    for i in range(1, iters):
        step = events[i * n:(i + 1) * n]
        prev_end = events[i * n - 1]["ts"] + events[i * n - 1]["dur"]
        for role, e in zip(names, step):
            acc = per_role[role]
            acc[0] += e["dur"]
            acc[1] += e["ts"] - prev_end
            acc[2] += 1
            prev_end = e["ts"] + e["dur"]
        spans.append(max(e["ts"] + e["dur"] for e in step) - step[0]["ts"])
        busy.append(1e3 * busy_ms(step))
    split = {r: (a[0] / a[2], a[1] / a[2]) for r, a in per_role.items()}
    split["step"] = (sum(spans) / len(spans), sum(busy) / len(busy))
    split["replay"] = time_ms(graph.replay, CUDA, iters=50)
    return split


def split_line(split: dict) -> str:
    launches = {r: v for r, v in split.items() if r not in ("step", "replay")}
    return ("; ".join(f"{r} {us:.2f} [{gap:+.2f}]" for r, (us, gap) in launches.items())
            + f"; span {split['step'][0]:.2f} us, busy {split['step'][1]:.2f} us, "
            f"replay {1000 * split['replay']:.2f} us")


def k2_launch_split(gen, device, iters: int = 20) -> dict:
    """One K2 step split by launch (replay_split): a leading copy, if the
    step has one, then K2_ROLES per layer.  Cases: one row, one audio of
    five rows and 16 audios of one row at t = 200, bf16 and int8+kv_int8.
    Returns {(case, form): replay_split's dict}."""
    import torch

    from whisper_tpu_torch.ops.kernels.fused_step import fused_decoder_layers

    L = K2_DIMS["L"]
    cases = {"B=1": dict(), "1 x 5": dict(G=5), "16 x 1": dict(A=16)}
    inputs = {name: k2_inputs(gen, device, **kw) for name, kw in cases.items()}

    def roles(n):  # a leading device-to-device copy (an older step) may show as a kernel
        if not len(K2_ROLES) * L <= n <= len(K2_ROLES) * L + 1:
            raise RuntimeError(f"K2 launch split: {n} launches a step, {len(K2_ROLES) * L} expected")
        return ["copy"] * (n - len(K2_ROLES) * L) + list(K2_ROLES) * L

    out = {}
    for form in ("", "int8+kv_int8"):
        for name in cases:
            _, args = k2_args(inputs[name], torch.bfloat16, form)
            split = replay_split(lambda: fused_decoder_layers(*args), roles, iters)
            log(f"K2 launch split {name} bf16{' ' + form if form else ''} (graph replays under "
                f"torch.profiler, us per launch, gap before it): {split_line(split)}")
            out[name, form] = split
    return out


K5_DIMS = dict(C=1280, F=5120)  # large-v3-turbo's decoder MLP


def k5_inputs(gen, device, B: int, weights: str):
    """K5's arguments at turbo's width for B rows, bf16 compute, weights
    "bfloat16" or "int8" (quantize_weight of the same values)."""
    import torch

    from whisper_tpu_torch.quantize import quantize_weight

    C, F = K5_DIMS["C"], K5_DIMS["F"]

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=device) * scale).to(torch.bfloat16)

    x, g, b = randn(B, C, scale=0.5), 1.0 + randn(C, scale=0.1), randn(C, scale=0.02)
    w1, b1, w2, b2 = randn(F, C, scale=0.02), randn(F, scale=0.02), randn(C, F, scale=0.02), randn(C, scale=0.02)
    if weights == "int8":
        w1, w2 = quantize_weight(w1), quantize_weight(w2)
    return x, g, b, w1, b1, w2, b2


def k5_launch_split(gen, device, iters: int = 20) -> dict:
    """K5's two launches, fc1 (LayerNorm prologue, GELU) and fc2 (+
    residual), split by launch (replay_split) at turbo's width, 1, 5 and 16
    rows, bf16 and int8 weights.  Returns {(B, weights): replay_split's
    dict}."""
    from whisper_tpu_torch.ops.kernels.mlp import mlp_fused

    def roles(n):
        if n != 2:
            raise RuntimeError(f"K5 launch split: {n} launches a call, 2 expected")
        return ["fc1", "fc2"]

    out = {}
    for weights in ("bfloat16", "int8"):
        for B in (1, 5, 16):
            args = k5_inputs(gen, device, B, weights)
            split = replay_split(lambda: mlp_fused(*args), roles, iters)
            log(f"K5 launch split B={B} {weights} weights (graph replays under torch.profiler, us per "
                f"launch, gap before it): {split_line(split)}")
            out[B, weights] = split
    return out


def check_k2_pending(gen, device):
    """K2's pending variant at turbo shapes, T = 448, W = 8, pend_w 0, 3
    and 7, bf16 and f32: one row in the int8+kv_int8 form at one block
    start; 16 audios x 1 row and 3 x 5 rows at per-row block starts (two
    of them at or past the cache's end).  Returns the pend_w = 7 rows by
    layout."""
    import torch

    starts16 = [int(p) for p in torch.randperm(441, generator=torch.Generator().manual_seed(1))[:16]]
    starts16[-1] = 448
    layouts = {"int8": dict(form="int8+kv_int8", t=300), "multi": dict(A=16, t=starts16),
               "groups": dict(A=3, G=5, t=[5, 120, 448, 447, 0] * 3)}
    rows = {}
    for name, kw in layouts.items():  # the same layouts at T = 448 without a block
        check_k2(gen, device, T=448, label=" (no block)", **kw)
    for pend_w in (0, 3, 7):
        for name, kw in layouts.items():
            rows[name] = check_k2(gen, device, T=448, pend_w=pend_w, label=" pending", **kw)
    return rows


def check_k3(gen, device):
    import torch

    from whisper_tpu_torch.ops.kernels.median import median_filter, median_filter_plain

    x = torch.randn((40, 1, 256, 1500), generator=gen, device=device)
    x[..., ::97] = 0.0  # equal values and signed zeros: the order rule decides
    x[..., 5::89] = -0.0
    x.view(torch.int32)[..., 7::101] = 0x7FC00001  # NaNs of two payloads
    x.view(torch.int32)[..., 8::103] = -0x00400001
    out = median_filter(x, 7)
    ref = median_filter_plain(x, 7)
    torch.cuda.synchronize()
    mismatches = int((out.view(torch.int32) != ref.view(torch.int32)).sum().item())
    finite = torch.isfinite(ref)
    err = (out[finite] - ref[finite]).abs().max().item()
    ms = time_ms(lambda: median_filter(x, 7), CUDA)
    device_ms = graph_ms(lambda: median_filter(x, 7))
    plain_ms = time_ms(lambda: median_filter_plain(x, 7), CUDA, iters=5)

    def library():  # one PyTorch call chain: reflect pad, windows, median
        rows = torch.nn.functional.pad(x.reshape(-1, 1, x.shape[-1]), (3, 3), mode="reflect")
        return torch.median(rows.unfold(-1, 7, 1), -1).values

    library_ms = time_ms(library, CUDA, iters=5)
    # read once, written once; per output 14 32-bit min/max (a pair's 12
    # compare-exchanges of its six shared keys and one clamp each), counted
    # at the f32 rate
    kb = bound(2 * x.numel() * 4, 14 * x.numel(), "float32")
    log(f"K3 median_filter (40,1,256,1500) f32 width 7: {mismatches} outputs differ in any bit "
        f"(bound 0), max_abs_err {err:.3e}, kernel {ms:.4f} ms ({device_ms:.4f} ms replayed from a "
        f"CUDA graph) plain {plain_ms:.4f} ms library (torch.median of unfolded windows) "
        f"{library_ms:.4f} ms bound {kb['bound_ms']:.4f} ms by {kb['bound_by']} "
        f"({kb['bound_ms'] / ms:.3f} of it)")
    if mismatches:
        raise RuntimeError(f"K3 disagrees with its plain version in {mismatches} outputs")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms, **kb)


def dtw_update_us(device, iters: int = 1 << 20) -> float:
    """K4's cell update as one dependent chain (csrc/dtw.cu dtw_chain: each
    update's cost the next one's upper neighbour) in one thread: us per
    update, from CUDA events over one launch of `iters` updates."""
    import torch

    from whisper_tpu_torch.ops.kernels.dtw import dtw_chain

    seed = torch.tensor([0.5, 0.25, 2.0, 0.125], device=device)
    ms = time_ms(lambda: dtw_chain(seed, iters), CUDA, iters=3)
    return 1e3 * ms / iters


def check_k4(gen, device):
    import torch

    from whisper_tpu_torch.ops.kernels.dtw import dtw_trace, dtw_trace_plain

    n, m = 253, 1500
    rows = {}
    # 16 matrices from a generator of their own: the phases after this one
    # keep the inputs they had before it was added
    gen16 = torch.Generator(device=device).manual_seed(16)
    for kind, B in (("random", 1), ("ties", 1), ("random", 16)):
        x = torch.randn((B, n, m), generator=gen if B == 1 else gen16, device=device)
        if kind == "ties":  # integer costs: the tie rule decides many cells
            x = torch.randint(0, 3, (B, n, m), generator=gen, device=device).float()
        out = dtw_trace(x, n, m)
        ref = dtw_trace_plain(x, n, m)
        torch.cuda.synchronize()
        mismatches = int((out != ref).sum().item())
        log(f"K4 dtw_trace B={B} n={n} m={m} {kind} costs: {mismatches} trace codes differ (bound 0)")
        if mismatches:
            raise RuntimeError(f"K4 disagrees with its plain version in {mismatches} codes")
        rows[kind, B] = x
    x, x16 = rows["random", 1], rows["random", 16]
    ms = time_ms(lambda: dtw_trace(x, n, m), CUDA)
    device_ms = graph_ms(lambda: dtw_trace(x, n, m))
    ms16 = time_ms(lambda: dtw_trace(x16, n, m), CUDA)
    plain_ms = time_ms(lambda: dtw_trace_plain(x, n, m), CUDA, iters=2)
    # the cost matrix read once, the (n+m+1, n+1) int32 trace written once;
    # three adds and two compares per cell
    kb = bound(4 * n * m + 4 * (n + m + 1) * (n + 1), 5 * n * m, "float32")
    # the latency bound: n + m - 1 dependent cell updates, at the chain's
    # measured time per update
    update_us = dtw_update_us(device)
    chain_ms = 1e-3 * update_us * (n + m - 1)
    log(f"K4 dtw_trace n={n} m={m}: kernel {ms:.4f} ms ({device_ms:.4f} ms replayed from a CUDA "
        f"graph), B=16 {ms16:.4f} ms; plain {plain_ms:.4f} ms; bound {kb['bound_ms']:.4f} ms by "
        f"{kb['bound_by']}; latency bound {chain_ms:.4f} ms ({n + m - 1} dependent cell updates at "
        f"{1e3 * update_us:.3f} ns each, dtw_chain), the kernel at {chain_ms / ms:.3f} of it "
        f"({1e6 * ms / (n + m - 1):.1f} ns a diagonal)")
    return dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, library_ms=None, **kb)


K5_ROWS = {"B=1": 1, "B=5": 5, "B=16": 16, "32 x 5 slice": 125}  # 32 x 5: K2's first slice, 25 audios


def check_k5(gen, device):
    """K5 against its plain version at turbo's width (C = 1280, F = 5120)
    for 1, 5 and 16 rows and the 125 rows of K2's first 32 x 5 slice, bf16
    weights and int8 weights (bf16 compute): the kernel's time (CUDA
    events, and its device time from a CUDA graph), its share of the
    bound, and, beside each product alone, one F.linear of the same
    weight (bf16; int8: its bf16 values) on the same rows as a yardstick
    (device time; the port never calls it).  Returns {(rows, weights):
    kernel row}."""
    import torch
    import torch.nn.functional as F

    from whisper_tpu_torch.models.whisper import layer_norm
    from whisper_tpu_torch.ops.kernels.mlp import mlp_fused, mlp_fused_plain
    from whisper_tpu_torch.quantize import Int8Weight

    C, F_ = K5_DIMS["C"], K5_DIMS["F"]
    rows = {}
    for label, B in K5_ROWS.items():
        for weights in ("bfloat16", "int8"):
            args = k5_inputs(gen, device, B, weights)
            x, g, b, w1, b1, w2, b2 = args
            out, ref = mlp_fused(*args), mlp_fused_plain(*args)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            rel = err / ref.float().abs().max().item()
            ms = time_ms(lambda: mlp_fused(*args), CUDA)
            device_ms = graph_ms(lambda: mlp_fused(*args))
            plain_ms = time_ms(lambda: mlp_fused_plain(*args), CUDA)
            dense = [(w.q.float() * w.s).to(torch.bfloat16) if isinstance(w, Int8Weight) else w for w in (w1, w2)]
            h1 = layer_norm(x, g, b)
            h2 = torch.randn((B, F_), generator=gen, device=device).to(torch.bfloat16)
            fc1_ms = graph_ms(lambda: F.linear(h1, dense[0]))
            fc2_ms = graph_ms(lambda: F.linear(h2, dense[1]))
            # weights (and scales), LayerNorm weights and biases read once, x
            # read and out written; two products
            kb = bound(nbytes(w1) + nbytes(w2) + 2 * (2 * F_ + 3 * C) + 2 * 2 * B * C, 2 * B * 2 * F_ * C,
                       "bfloat16")
            log(f"K5 mlp_fused C={C} F={F_} {label} ({B} rows) bf16, {weights} weights: max_abs_err {err:.3e}, "
                f"relative {rel:.3e} (tol {K2_REL_TOL['bfloat16']:.0e}) kernel {ms:.4f} ms "
                f"({device_ms:.4f} ms replayed from a CUDA graph, {kb['bound_ms'] / device_ms:.3f} of the "
                f"bound) plain {plain_ms:.4f} ms bound {kb['bound_ms']:.4f} ms by {kb['bound_by']}; "
                f"yardstick F.linear fc1 {fc1_ms:.4f} ms, fc2 {fc2_ms:.4f} ms (device)")
            if not rel <= K2_REL_TOL["bfloat16"]:
                raise RuntimeError(f"K5 {label} {weights} disagrees with its plain version: {rel}")
            rows[label, weights] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None, **kb)
    return rows


def check_int8_logits(gen, device):
    """The int8 logits (K2's GEMV, f32 epilogue) against the dequantised
    matmul at turbo's vocabulary (51866 x 1280) for 1, 5 and 16 rows; beside
    them one bf16 torch.mm of the same rows with the bf16 embedding, f32
    out (the unquantized path's call)."""
    import torch

    from whisper_tpu_torch.ops.kernels.fused_step import int8_logits, int8_logits_plain
    from whisper_tpu_torch.quantize import quantize_weight

    V, C = 51866, 1280
    emb = (torch.randn((V, C), generator=gen, device=device) * 0.02).to(torch.bfloat16)
    w = quantize_weight(emb)
    rows = {}
    for B in (1, 5, 16):
        hidden = torch.randn((B, C), generator=gen, device=device).to(torch.bfloat16)
        out, ref = int8_logits(hidden, w), int8_logits_plain(hidden, w)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        rel = err / ref.abs().max().item()
        ms = time_ms(lambda: int8_logits(hidden, w), CUDA)
        device_ms = graph_ms(lambda: int8_logits(hidden, w))
        plain_ms = time_ms(lambda: int8_logits_plain(hidden, w), CUDA)
        library_ms = time_ms(lambda: torch.mm(hidden, emb.t(), out_dtype=torch.float32), CUDA)
        library_device_ms = graph_ms(lambda: torch.mm(hidden, emb.t(), out_dtype=torch.float32))
        kb = bound(nbytes(w) + 2 * B * C + 4 * B * V, 2 * B * V * C, "bfloat16")
        log(f"int8 logits V={V} C={C} B={B} bf16: max_abs_err {err:.3e}, relative {rel:.3e} "
            f"(tol {INT8_LOGITS_REL_TOL:.0e}) kernel {ms:.4f} ms ({device_ms:.4f} ms replayed from a "
            f"CUDA graph) plain (dequantised matmul) {plain_ms:.4f} ms, bf16 torch.mm logits "
            f"{library_ms:.4f} ms ({library_device_ms:.4f} ms replayed), bound {kb['bound_ms']:.4f} ms "
            f"by {kb['bound_by']}")
        if not rel <= INT8_LOGITS_REL_TOL:
            raise RuntimeError(f"the int8 logits B={B} disagree with their plain version: {rel}")
        rows[B] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms, **kb)
    return rows


def reset_launches():
    from whisper_tpu_torch.ops.kernels import (
        attention,
        attn_packed,
        dtw,
        fused_step,
        logits,
        matmul_residual,
        median,
        mlp,
    )

    attention.attention.launches = 0
    fused_step.fused_decoder_layers.launches = 0
    fused_step.fused_decoder_layers.launches_by_layout.clear()
    fused_step.int8_logits.launches = 0
    fused_step.cross_attention.launches = 0
    mlp.mlp_fused.launches = 0
    median.median_filter.launches = 0
    dtw.dtw_trace.launches = 0
    matmul_residual.matmul_residual.launches = 0
    logits.logits_streamed.launches = 0
    logits.logits_streamed.launches_by_layout.clear()
    attn_packed.attn_pairs_unpacked.launches = 0
    attn_packed.attn_pairs_packed.launches = 0


@contextlib.contextmanager
def k2_positions(record: list, keep: bool):
    """Records the positions the engine gives each decode step, per-step
    or in a write block, which passes them on as they are: the shared int,
    or for a (B,) tensor a copy of it (keep) or None."""
    from whisper_tpu_torch import engine

    real, real_pending = engine.decoder_step_fused, engine.decoder_step_fused_pending

    def note(t):
        record.append(t if isinstance(t, int) else (t.clone() if keep else None))

    def spy(params, dims, tokens, t, *rest):
        note(t)
        return real(params, dims, tokens, t, *rest)

    def spy_pending(params, dims, tokens, t, *rest):
        note(t)
        return real_pending(params, dims, tokens, t, *rest)

    engine.decoder_step_fused, engine.decoder_step_fused_pending = spy, spy_pending
    try:
        yield
    finally:
        engine.decoder_step_fused, engine.decoder_step_fused_pending = real, real_pending


def with_pending(tag: str = "") -> str:
    """launches_by_layout's tag of a form with the pending block."""
    return f"{tag}+pending" if tag else "pending"


def k2_count(layout: dict, multi: bool, groups: bool, tag: str = "") -> int:
    """K2's launches under the layouts of several audios (A > 1) of one row
    (groups False) or of groups of rows (groups True), with the tag."""
    return sum(n for key, n in layout.items()
               if (key[0] > 1) == multi and (key[1] > 1) == groups
               and key[2:] == ((tag,) if tag else ()))


@contextlib.contextmanager
def write_block(value):
    """Every DecodingTask in the block decodes with this write block (None:
    the policy's own)."""
    from whisper_tpu_torch.decoding import DecodingTask

    policy = DecodingTask.write_block
    if value is not None:
        DecodingTask.write_block = lambda self, n_audio: value
    try:
        yield
    finally:
        DecodingTask.write_block = policy


def end_to_end(device, name: str = "turbo"):
    import numpy as np
    import torch

    import whisper_tpu_torch
    from whisper_tpu_torch.models import KNOWN_MODELS
    from whisper_tpu_torch.models.whisper import init_params
    from whisper_tpu_torch.ops.kernels.attention import attention
    from whisper_tpu_torch.ops.kernels.fused_step import cross_attention, fused_decoder_layers
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

    reset_launches()
    t0 = time.perf_counter()
    result = model.transcribe(AUDIO, language=None, seed=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"encoder_attention": attention.launches,
                "fused_decoder_layers": fused_decoder_layers.launches_by_layout[(1, 1)],
                "decode_cross_attention": cross_attention.launches}
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
    walls = pinned_walls(model, audio, forced, runs=4)  # the first run is cold
    warm = sorted(walls[1:])[1]
    log(f"pinned window (mel, encoder, prefill, {len(forced)} steps, segmentation): "
        f"audio {audio_s:.3f} s, wall {walls[0]:.4f} s cold, {warm:.4f} s warm "
        f"(median of {len(walls) - 1}), tokens decoded {len(forced)}, "
        f"{1000 * warm / len(forced):.4f} ms per token (window wall / tokens)")
    log(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    return launches, model, audio, forced


def pinned_walls(model, audio, forced, runs: int, **options) -> list:
    """The walls of runs transcribe(waveform) calls that decode the pinned
    sequence (DecodingTask._forced_tokens), each checked."""
    import torch

    from whisper_tpu_torch.decoding import DecodingTask

    DecodingTask._forced_tokens = forced
    walls = []
    try:
        for _ in range(runs):
            t0 = time.perf_counter()
            pinned = model.transcribe(audio, language="en", temperature=0.0, **options)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            if [t for s in pinned["segments"] for t in s["tokens"]] != forced[:-1]:
                raise RuntimeError("the pinned window did not decode the pinned sequence once")
    finally:
        DecodingTask._forced_tokens = None
    return walls


# the CLI's defaults (whisper_tpu_torch.transcribe.cli) as transcribe
# arguments; --model has no turbo checkpoint in the repo, so the model is
# the random one, and --verbose is None here to keep the log short
CLI_DEFAULTS = dict(
    task="transcribe", language=None, best_of=5, beam_size=5, patience=None,
    length_penalty=None, suppress_tokens="-1", initial_prompt=None,
    carry_initial_prompt=False, condition_on_previous_text=True, fp16=True,
    compression_ratio_threshold=2.4, logprob_threshold=-1.0, no_speech_threshold=0.6,
    prepend_punctuations="\"'“¿([{-", append_punctuations="\"'.。,，!！?？:：”)]}、",
    clip_timestamps="0", hallucination_silence_threshold=None,
)


def _word_inside(segment, i: int) -> bool:
    """Whether word i of a segment lies inside it.  add_word_timestamps may
    move a segment's first word to start, and its last word to end, up to
    the median word duration (at most 0.7 s) past the segment's edge, when
    it prefers the segment's own timestamp to a word that looks too long."""
    words, edge = segment["words"], 0.7
    lo = max(0.0, segment["start"] - (edge if i == 0 else 0.0))
    hi = segment["end"] + (edge if i == len(words) - 1 else 0.0)
    return lo <= words[i]["start"] <= words[i]["end"] <= hi


def cli_default_path(model):
    """transcribe(jfk.flac) as ``python -m whisper_tpu_torch jfk.flac
    --word_timestamps True --highlight_words True`` runs it after
    load_model, then the writers of ``-f all``."""
    import numpy as np
    import torch

    from whisper_tpu_torch.ops.kernels import attention, dtw, fused_step, median, mlp
    from whisper_tpu_torch.utils.writers import get_writer

    temperature = tuple(np.arange(0.0, 1.0 + 1e-6, 0.2))  # --temperature_increment_on_fallback 0.2
    # the best-of rungs draw their sampling seed from numpy's global RNG, as
    # whisper_tpu's do: seeding it makes the phase repeat from run to run
    np.random.seed(0)
    reset_launches()
    t0 = time.perf_counter()
    result = model.transcribe(AUDIO, verbose=None, temperature=temperature, word_timestamps=True,
                              **CLI_DEFAULTS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    layout = dict(fused_step.fused_decoder_layers.launches_by_layout)
    launches = {"encoder_attention": attention.attention.launches,
                "fused_decoder_layers_b5": layout.get((1, 5), 0),
                "mlp_fused": mlp.mlp_fused.launches,  # K2's MLP stage: L per K2 launch
                "median_filter": median.median_filter.launches,
                "dtw_trace": dtw.dtw_trace.launches}
    with tempfile.TemporaryDirectory() as out_dir:
        get_writer("all", out_dir)(result, AUDIO, highlight_words=True, max_line_count=None,
                                   max_line_width=None, max_words_per_line=None)
        written = {f: os.path.getsize(os.path.join(out_dir, f)) for f in sorted(os.listdir(out_dir))}
    segments = result["segments"]
    words = [(s, w) for s in segments for w in s["words"]]
    log(f"CLI default path transcribe(jfk.flac, beam 5, best_of 5, ladder "
        f"{[round(float(t), 1) for t in temperature]}, word_timestamps): language {result['language']!r}, "
        f"{len(segments)} segments, {len(words)} words, rungs kept "
        f"{sorted({float(s['temperature']) for s in segments})}, wall {wall:.3f} s, launches {launches}, "
        f"K2 launches by (audios, rows per audio) {layout}, files {written}")
    if min(launches.values()) <= 0:
        raise RuntimeError(f"a kernel of the CLI default path never launched: {launches}")
    if set(written) != {f"jfk.{e}" for e in ("txt", "vtt", "srt", "tsv", "json")} or not written["jfk.json"]:
        raise RuntimeError(f"the writers did not write every format: {written}")
    outside = [(s["start"], s["end"], w["start"], w["end"]) for s in segments
               for i, w in enumerate(s["words"]) if not _word_inside(s, i)]
    if not words or outside:
        raise RuntimeError(f"no words, or words outside their segments: {outside[:5]}")
    return launches


def beam_window(model, audio, label: str = "", **options):
    """DecodingTask(beam_size=5).run on jfk's encoder features: the wall of
    one beam-5 window (median of 3 after a warm-up) and its ms per step.
    Returns (features, options, ms per step)."""
    import torch

    from whisper_tpu_torch import log_mel_spectrogram, pad_or_trim
    from whisper_tpu_torch.decoding import DecodingOptions, DecodingTask
    from whisper_tpu_torch.ops.kernels.fused_step import fused_decoder_layers

    mel = log_mel_spectrogram(pad_or_trim(audio), model.dims.n_mels, device=model.device)
    features = model.embed_audio(mel[None])
    options = DecodingOptions(language="en", beam_size=5, **options)
    walls = []
    for _ in range(4):  # the first is a warm-up
        before = fused_decoder_layers.launches
        t0 = time.perf_counter()
        DecodingTask(model, options).run(features)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        steps = fused_decoder_layers.launches - before
    wall = sorted(walls[1:])[1]
    log(f"beam-5 window{label} (DecodingTask.run from features: prefill + {steps} steps of 5 rows): "
        f"wall {wall:.4f} s (median of 3 after a warm-up), {1000 * wall / steps:.4f} ms per step")
    return features, options, 1000 * wall / steps


def sixteen_windows(model, audio):
    """16 windows of jfk tiled, 1 s apart, on the card, and prompts of 0, 7,
    64 and 223 tokens for them (four of each)."""
    import numpy as np
    import torch

    from whisper_tpu_torch import log_mel_spectrogram
    from whisper_tpu_torch.batch import _slice_windows

    wave = np.tile(audio, 4)
    store = log_mel_spectrogram(wave, model.dims.n_mels, padding=16000 * 30, device=model.device)[None]
    seeks = torch.arange(16, device=model.device) * 100  # 16 windows 1 s apart
    windows = _slice_windows(store, torch.zeros_like(seeks), seeks, torch.full_like(seeks, 3000))
    text = np.random.RandomState(1).randint(1000, 20000, size=223)
    lengths = [0, 7, 64, 223] * 4
    return windows, [list(map(int, text[:n])) for n in lengths], lengths


def prompts_window(model, audio, tag: str = "", **options):
    """DecodingTask.run_with_prompts on 16 windows of jfk whose prompts have
    four lengths, 0 and 223 tokens among them, greedy, in turns with the
    policy's 8-step write blocks and with per-step writes (block, step,
    step, block after a warm-up of each): every step must run K2 once for
    the 16 rows, under its layout (16, 1) with the tag of an int8 form and,
    in blocks, of the pending block.  In a last run (untimed, in blocks)
    each step's positions must be the rows' own, four different ones: the
    tensor the engine passed to K2's step, read back after the run.
    Returns (a function that runs it once, ms per step in blocks, a dict of
    the launches of both engines and their ms per step)."""
    import torch

    from whisper_tpu_torch.decoding import DecodingOptions, DecodingTask
    from whisper_tpu_torch.ops.kernels import fused_step

    windows, prompts, lengths = sixteen_windows(model, audio)
    task = DecodingTask(model, DecodingOptions(language="en", temperature=0.0, **options))
    if task.write_block(16) != 8:
        raise RuntimeError(f"a 16-window decode of a wide decoder takes write blocks of 8, not "
                           f"{task.write_block(16)}")
    layer = fused_step.fused_decoder_layers
    walls, launches = {8: [], 0: []}, {}
    for wb in (8, 0, 8, 0, 0, 8):  # the first two are warm-ups
        with write_block(wb):
            reset_launches()
            t0 = time.perf_counter()
            results = task.run_with_prompts(windows, prompts)
            torch.cuda.synchronize()
            walls[wb].append(time.perf_counter() - t0)
        key = (16, 1, with_pending(tag)) if wb else ((16, 1, tag) if tag else (16, 1))
        launches[wb] = layer.launches_by_layout[key]
        if not launches[wb] or launches[wb] != layer.launches or (wb and launches[wb] % wb):
            raise RuntimeError(f"the prompts window with write block {wb} did not run every step on "
                               f"K2 {key}: {dict(layer.launches_by_layout)}")
        if len(results) != 16 or any(not 0 <= t < model.dims.n_vocab for r in results for t in r.tokens):
            raise RuntimeError("run_with_prompts gave malformed results")
    ms = {wb: 1000 * min(w[1:]) / launches[wb] for wb, w in walls.items()}
    record = []
    with k2_positions(record, keep=True):
        task.run_with_prompts(windows, prompts)
    # row i's initial tokens: [sot_prev] + prompt + the SOT sequence
    begins = torch.tensor([task.sample_begin + (n + 1 if n else 0) for n in lengths])
    per_row = sum(
        1 for i, t in enumerate(record)
        if not isinstance(t, int) and torch.equal(t.cpu(), begins + i) and len(set(t.tolist())) == 4
    )
    log(f"run_with_prompts{' ' + tag if tag else ''}: 16 windows, prompt lengths {sorted(set(lengths))}, "
        f"greedy, in turns: write blocks of 8: {launches[8]} K2 pending launches of 16 audios x 1 row, "
        f"wall {min(walls[8][1:]):.4f} s (best of 2 after a warm-up), {ms[8]:.4f} ms per step; per-step "
        f"writes: {launches[0]} K2 launches, wall {min(walls[0][1:]):.4f} s, {ms[0]:.4f} ms per step "
        f"(blocks / per-step {ms[8] / ms[0]:.3f}); recorded run: {per_row} of {len(record)} steps at "
        f"the rows' own positions (first step {begins.tolist()})")
    if per_row != launches[8] or len(record) != launches[8]:
        raise RuntimeError(f"the prompts window did not run every step at per-row positions: "
                           f"{per_row} of {len(record)}, {launches[8]} steps")
    return (lambda: task.run_with_prompts(windows, prompts)), ms[8], dict(launches=launches, ms=ms)


def twenty_files(audio):
    """Phase 12's 20 inputs cut and tiled from jfk (4-70 s, each from its
    own offset), float32 at 16 kHz."""
    import numpy as np

    seconds = [4, 70, 12, 45, 8, 33, 25, 60, 6, 40, 18, 52, 10, 28, 65, 15, 36, 22, 48, 30]
    tiled = np.tile(audio, 8)
    return [tiled[int(0.37 * 16000 * i) :][: 16000 * n] for i, n in enumerate(seconds)]


def _well_formed(result, n_samples: int, n_vocab: int) -> bool:
    frames = n_samples // 160
    return isinstance(result["text"], str) and all(
        0 <= s["start"] <= s["end"] and 0 <= s["seek"] <= frames
        and all(0 <= t < n_vocab for t in s["tokens"])
        for s in result["segments"]
    )


def batch_path(model, audio, tag: str = "", **options):
    """transcribe_batch on 20 inputs cut and tiled from jfk (4-70 s, each
    from its own offset), batch_size 16, T = 0, condition_on_previous_text:
    files go in groups of 16, and each round of a group decodes the next
    window of its unfinished files in write blocks, each row after its own
    file's prompt, so the rows of a later round sit at their own positions
    (different ones when their files' prompts differ in length: random
    weights may give every file the same)."""
    import torch

    from whisper_tpu_torch.decoding import DecodingTask
    from whisper_tpu_torch.ops.kernels import attention, fused_step

    files = twenty_files(audio)
    calls = []  # the prompt lengths of each decode, as the engine saw them
    positions = []  # what each K2 call was given: an int, or None for per-row positions
    run = DecodingTask.run_with_prompts

    def spy(self, mel, prompts):
        calls.append([len(p) for p in prompts])
        return run(self, mel, prompts)

    DecodingTask.run_with_prompts = spy
    reset_launches()
    try:
        with k2_positions(positions, keep=False):
            t0 = time.perf_counter()
            results = model.transcribe_batch(files, batch_size=16, temperature=0.0, language="en",
                                             condition_on_previous_text=True, **options)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        DecodingTask.run_with_prompts = run
    layout = dict(fused_step.fused_decoder_layers.launches_by_layout)
    launches = {"encoder_attention": attention.attention.launches,
                "fused_decoder_layers_pending_multi": k2_count(layout, True, False, with_pending(tag))}
    per_row = sum(t is None for t in positions)
    seconds = sum(len(f) for f in files) // 16000
    log(f"transcribe_batch{' ' + tag if tag else ''}: {len(files)} files, {seconds} s of audio, batch_size 16, T=0: "
        f"wall {wall:.3f} s, {len(calls)} rounds of {[len(c) for c in calls]} rows, "
        f"prompt lengths per round {[sorted(set(c)) for c in calls]}, "
        f"{sum(len(r['segments']) for r in results)} segments, launches {launches}, "
        f"K2 launches by (audios, rows per audio) {layout}, "
        f"{per_row} of them at per-row positions")
    if len(results) != len(files) or not all(
        _well_formed(r, len(f), model.dims.n_vocab) for r, f in zip(results, files)
    ):
        raise RuntimeError("transcribe_batch gave a malformed result")
    if min(launches.values()) <= 0:
        raise RuntimeError(f"a kernel of the batch path never launched: {launches}")
    return launches, wall


def chunked_cli_path(model, audio, tag: str = "", **options):
    """``python -m whisper_tpu_torch jfk110.wav --chunked True
    --word_timestamps True --highlight_words True`` after load_model: jfk
    tiled to 110 s in five 30 s chunks, beam 5 at T = 0 and best-of 5 on the
    0.2-step ladder (25 rows of five audios, in write blocks), word
    timestamps, every writer.  K2's groups are counted under the tag of an
    int8 form."""
    import numpy as np
    import torch

    from whisper_tpu_torch.chunked import transcribe_chunked
    from whisper_tpu_torch.ops.kernels import dtw, fused_step, median
    from whisper_tpu_torch.utils.writers import get_writer

    wave = np.tile(audio, 11)[: 16000 * 110]
    temperature = tuple(np.arange(0.0, 1.0 + 1e-6, 0.2))
    args = {k: v for k, v in CLI_DEFAULTS.items() if k not in ("condition_on_previous_text", "clip_timestamps")}
    np.random.seed(0)
    reset_launches()
    t0 = time.perf_counter()
    result = transcribe_chunked(model, wave, chunk_overlap=5.0, verbose=None, temperature=temperature,
                                word_timestamps=True, **args, **options)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    layout = dict(fused_step.fused_decoder_layers.launches_by_layout)
    # beam 5 writes per step; the best-of rungs of the five chunks in blocks
    launches = {"fused_decoder_layers_groups": k2_count(layout, True, True, tag),
                "fused_decoder_layers_pending_groups": k2_count(layout, True, True, with_pending(tag)),
                "median_filter": median.median_filter.launches, "dtw_trace": dtw.dtw_trace.launches}
    with tempfile.TemporaryDirectory() as out_dir:
        get_writer("all", out_dir)(result, "jfk110.wav", highlight_words=True, max_line_count=None,
                                   max_line_width=None, max_words_per_line=None)
        written = {f: os.path.getsize(os.path.join(out_dir, f)) for f in sorted(os.listdir(out_dir))}
    segments = result["segments"]
    words = [w for s in segments for w in s["words"]]
    log(f"--chunked CLI path{' ' + tag if tag else ''} (110 s, 5 chunks, beam 5, best_of 5, ladder, word_timestamps): "
        f"language {result['language']!r}, {len(segments)} segments, {len(words)} words, "
        f"wall {wall:.3f} s, launches {launches}, K2 launches by (audios, rows per audio) {layout}, "
        f"files {written}")
    if min(launches.values()) <= 0:
        raise RuntimeError(f"a kernel of the chunked path never launched: {launches}")
    if set(written) != {f"jfk110.{e}" for e in ("txt", "vtt", "srt", "tsv", "json")} or not written["jfk110.json"]:
        raise RuntimeError(f"the writers did not write every format: {written}")
    outside = [(s["start"], s["end"], w["start"], w["end"]) for s in segments
               for i, w in enumerate(s["words"]) if not _word_inside(s, i)]
    if not words or outside or not _well_formed(result, len(wave), model.dims.n_vocab):
        raise RuntimeError(f"no words, words outside their segments, or a bad result: {outside[:5]}")
    return launches, wave, result


def align_path(model, wave, chunked):
    """align(segments=...) of the chunked result's text on the same file."""
    import torch

    from whisper_tpu_torch.ops.kernels import dtw, median

    # random weights may place a segment's timestamps past the audio's end
    # (inside the last chunk's 30 s window): align takes those inside it
    duration = len(wave) / 16000
    segments = [dict(start=s["start"], end=s["end"], text=s["text"]) for s in chunked["segments"]
                if s["text"].strip() and s["end"] - s["start"] <= 30.0 and s["end"] <= duration]
    reset_launches()
    t0 = time.perf_counter()
    aligned = model.align(wave, segments=segments, language=chunked["language"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"median_filter": median.median_filter.launches, "dtw_trace": dtw.dtw_trace.launches}
    words = [w for s in aligned["segments"] for w in s["words"]]
    log(f"align(segments=...): {len(segments)} segments, {len(words)} words, wall {wall:.3f} s, "
        f"launches {launches}")
    if min(launches.values()) <= 0 or not words or any(
        not s["start"] - 0.02 <= w["start"] <= w["end"] <= s["end"] + 0.02
        for s in aligned["segments"] for w in s["words"]
    ):
        raise RuntimeError(f"align missed a kernel or gave no words in place: {launches}")
    return launches


def tree_bytes(node) -> int:
    """The bytes of a parameter tree's leaves (int8 leaves with their scales)."""
    if isinstance(node, dict):
        return sum(tree_bytes(v) for v in node.values())
    return nbytes(node)


def int8_path(model, audio, forced, bf16: dict):
    """The int8 configuration end to end, at full depth: the random turbo
    weights quantized "int8+logits" (quantize_params, as load_model(...,
    quantize="int8+logits") does on the card) and decoded with
    kv_cache_dtype="int8".  The model's bytes; the greedy transcribe(jfk)
    with its kernels' launches (one row in write blocks: K2's int8 pending
    instance); the pinned window in turns with bf16's and with its own
    per-step writes; the beam-5 window, the 16-window run_with_prompts (in
    blocks and per step) and transcribe_batch, each beside the same run's
    bf16 number; int8_divergence_proxy on three windows; the --chunked CLI
    path (groups of rows of several audios).  Returns the int8 kernels'
    launch counts, and the int8 model with its beam-5 window and
    run_with_prompts (for --profile)."""
    import numpy as np
    import torch

    import whisper_tpu_torch
    from whisper_tpu_torch import log_mel_spectrogram, pad_or_trim
    from whisper_tpu_torch.evaluation import int8_divergence_proxy
    from whisper_tpu_torch.ops.kernels import attention, fused_step, mlp
    from whisper_tpu_torch.quantize import quantize_params
    from whisper_tpu_torch.tokenizer import LANGUAGES

    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    params = quantize_params(model.params, logits=True)
    torch.cuda.synchronize()
    added = torch.cuda.memory_allocated() - before
    qmodel = whisper_tpu_torch.Whisper(model.dims, params)
    sizes = {name: (tree_bytes(m.params), tree_bytes(m.params["decoder"]["blocks"]))
             for name, m in (("bf16", model), ("int8", qmodel))}
    log(f"model bytes on the card: bf16 {sizes['bf16'][0]} (decoder layers {sizes['bf16'][1]}), "
        f"int8+logits {sizes['int8'][0]} (decoder layers {sizes['int8'][1]}, logits copy "
        f"{nbytes(params['decoder']['logits_w'])}); memory_allocated grew {added} bytes across "
        f"quantize_params (the int8 leaves beside the bf16 ones they replace)")
    if not sizes["int8"][0] < sizes["bf16"][0] or not sizes["int8"][1] < sizes["bf16"][1]:
        raise RuntimeError(f"the int8 model is not smaller: {sizes}")

    opts, tag = dict(kv_cache_dtype="int8"), "int8+kv_int8"
    reset_launches()
    t0 = time.perf_counter()
    result = qmodel.transcribe(AUDIO, language=None, seed=0, **opts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    layout = fused_step.fused_decoder_layers.launches_by_layout
    launches = {"encoder_attention": attention.attention.launches,
                "fused_decoder_layers_pending_int8_transcribe": layout[(1, 1, with_pending(tag))],
                "mlp_fused": mlp.mlp_fused.launches,
                "int8_logits": fused_step.int8_logits.launches}
    log(f"int8 transcribe(jfk.flac, language=None, kv_cache_dtype='int8'): language "
        f"{result['language']!r}, {len(result['segments'])} segments, wall {wall:.3f} s, "
        f"launches {launches}, K2 launches by layout {dict(layout)}")
    if result["language"] not in LANGUAGES or not result["segments"] or any(
        not 0 <= t < qmodel.dims.n_vocab for s in result["segments"] for t in s["tokens"]
    ):
        raise RuntimeError("the int8 transcribe gave a malformed result")
    if min(launches.values()) <= 0 or set(layout) != {(1, 1, with_pending(tag))}:
        raise RuntimeError(f"the int8 path missed a kernel or ran another K2 form: {launches}, {dict(layout)}")

    # in turns: bf16 (per-step writes, the policy for one unquantized row),
    # int8 in blocks (the policy), int8 with per-step writes
    walls = {"bf16": [], "int8": [], "int8 per-step": []}
    reset_launches()
    for name in ("bf16", "int8", "int8 per-step", "int8 per-step", "int8", "bf16") * 2:
        with write_block(0 if name == "int8 per-step" else None):
            walls[name] += pinned_walls(model if name == "bf16" else qmodel, audio, forced, runs=1,
                                        **({} if name == "bf16" else opts))
    launches["fused_decoder_layers_int8"] = layout[(1, 1, tag)]
    pending = layout[(1, 1, with_pending(tag))]
    pinned = {name: 1000 * float(np.median(w)) / len(forced) for name, w in walls.items()}
    log(f"pinned window, in turns (bf16, int8, int8 per-step, int8 per-step, int8, bf16, twice): ms "
        f"per token int8 in blocks {pinned['int8']:.4f}, int8 per-step {pinned['int8 per-step']:.4f}, "
        f"bf16 {pinned['bf16']:.4f} (medians of 4); K2 int8 launches {pending} in blocks, "
        f"{launches['fused_decoder_layers_int8']} per step")
    if pending <= 0 or launches["fused_decoder_layers_int8"] <= 0:
        raise RuntimeError(f"the int8 pinned windows missed K2's int8 instances: {dict(layout)}")

    reset_launches()
    beam = beam_window(qmodel, audio, label=" int8", **opts)
    launches["fused_decoder_layers_b5_int8"] = layout[(1, 5, tag)]
    prompts_fn, prompts, turns = prompts_window(qmodel, audio, tag=tag, **opts)
    launches["fused_decoder_layers_multi_int8"] = turns["launches"][0]
    batch_launches, batch_wall = batch_path(qmodel, audio, tag=tag, **opts)
    launches["fused_decoder_layers_pending_multi_int8"] = batch_launches["fused_decoder_layers_pending_multi"]
    chunked = chunked_cli_path(qmodel, audio, tag=tag, **opts)[0]
    launches["fused_decoder_layers_groups_int8"] = chunked["fused_decoder_layers_groups"]
    launches["fused_decoder_layers_pending_groups_int8"] = chunked["fused_decoder_layers_pending_groups"]
    log(f"int8 against bf16: beam-5 window {beam[2]:.4f} / {bf16['beam']:.4f} ms per step; "
        f"run_with_prompts 16 windows {prompts:.4f} / {bf16['prompts']:.4f} ms per step; "
        f"transcribe_batch 20 files {batch_wall:.3f} / {bf16['batch']:.3f} s")

    waves = [audio, audio[3 * 16000:], np.tile(audio, 3)[5 * 16000:]]
    mels = torch.stack([log_mel_spectrogram(pad_or_trim(w), model.dims.n_mels) for w in waves]).numpy()
    proxy = int8_divergence_proxy(model, qmodel, mels, sample_len=32, batch_size=3,
                                  int8_decode_options=opts)
    log(f"int8_divergence_proxy (bf16 against int8+logits with kv_cache_dtype='int8', 3 windows, "
        f"32 tokens, random weights): {json.dumps(proxy)}")
    if launches["fused_decoder_layers_b5_int8"] <= 0:
        raise RuntimeError(f"the int8 beam window did not run K2's int8 instance: {launches}")
    return launches, (qmodel, beam, prompts_fn)


def column_write(device):
    """The per-row K/V column write at B=16 (turbo, T=448: the prompts
    window's cache) beside K2's step at the same shapes; and the write
    block's path per step: the engine's W = 8 pending-column writes and one
    flush_pending per block, at per-row and at one shared block start."""
    import torch

    from whisper_tpu_torch.models.whisper import KVCache, _write_kv_column, flush_pending
    from whisper_tpu_torch.ops.kernels.fused_step import WEIGHTS, fused_decoder_layers

    L, B, C, H, T, Ta = 4, 16, 1280, 20, 448, 1500
    gen = torch.Generator(device=device).manual_seed(2)

    def randn(*shape):
        return (torch.randn(shape, generator=gen, device=device) * 0.02).to(torch.bfloat16)

    cache = KVCache(randn(L, B, H, 64, T), randn(L, B, H, 64, T), randn(L, B, H, 64, Ta),
                    randn(L, B, H, 64, Ta))
    k_new, v_new = randn(L, B, C), randn(L, B, C)
    pos = torch.arange(B, device=device) * 25 + 30  # 30 .. 405

    def per_row():
        _write_kv_column(cache, k_new, v_new, pos)

    def uniform():
        _write_kv_column(cache, k_new, v_new, 200)

    eager = {name: time_ms(fn, CUDA, iters=50) for name, fn in (("per_row", per_row), ("uniform", uniform))}
    device_only = {name: graph_ms(fn) for name, fn in (("per_row", per_row), ("uniform", uniform))}
    shapes = {"fc1_w": (4 * C, C), "fc2_w": (C, 4 * C), "fc1_b": (4 * C,)}
    blocks = {n: randn(L, *shapes.get(n, (C, C) if n.endswith("_w") else (C,))) for n in WEIGHTS}
    step_ms = time_ms(lambda: fused_decoder_layers(blocks, H, randn(B, C), pos, *cache), CUDA, iters=50)
    log(f"K/V column write at B=16, T=448, bf16: per-row positions {device_only['per_row']:.4f} ms "
        f"of device time (graph replay; {eager['per_row']:.4f} ms eager, paced by the host's "
        f"launches), one shared position {device_only['uniform']:.4f} ms ({eager['uniform']:.4f} ms "
        f"eager), beside K2's step at the same shapes {step_ms:.4f} ms (per-row device time / "
        f"step {device_only['per_row'] / step_ms:.3f})")

    W = 8
    pend_k, pend_v = randn(L, B, H, 64, W), randn(L, B, H, 64, W)

    def block(start):
        def run():  # _step_pending's column writes, then the flush
            for w in range(W):
                pend_k[..., w] = k_new.view(L, B, H, 64)
                pend_v[..., w] = v_new.view(L, B, H, 64)
            flush_pending(cache, pend_k, pend_v, start)
        return run

    blocks_ms = {name: graph_ms(block(start)) / W for name, start in (("per_row", pos), ("uniform", 200))}
    log(f"write path per step at B=16, T=448, W={W}, bf16 (graph replay of one block / {W}): "
        f"pending-column writes + flush at per-row block starts {blocks_ms['per_row']:.4f} ms, at one "
        f"shared start {blocks_ms['uniform']:.4f} ms; per-step column writes {device_only['per_row']:.4f} "
        f"and {device_only['uniform']:.4f} ms")
    return dict(device_only, step_ms=step_ms, blocks=blocks_ms)


def f32_block_check(device, audio):
    """In f32 (random turbo weights, seed 3), the 16-window run_with_prompts
    without timestamps, with a pinned sequence of 109 text tokens that no
    filter masks, then EOT (random weights have near-tied logits, so
    free-running tokens may part for reasons that are no fault): the
    write-block engine's tokens must equal the per-step engine's and its
    avg_logprob lie within 1e-5 of it.  Then the same decode free-running,
    whose agreement is reported."""
    import numpy as np
    import torch

    import whisper_tpu_torch
    from whisper_tpu_torch.decoding import DecodingOptions, DecodingTask
    from whisper_tpu_torch.models import KNOWN_MODELS
    from whisper_tpu_torch.models.whisper import init_params

    dims = KNOWN_MODELS["turbo"]
    gen = torch.Generator(device=device).manual_seed(3)
    model = whisper_tpu_torch.Whisper(dims, init_params(dims, gen, torch.float32, device))
    windows, prompts, _ = sixteen_windows(model, audio)
    task = DecodingTask(model, DecodingOptions(language="en", temperature=0.0, without_timestamps=True))
    allowed = np.flatnonzero(~task._suppress_mask.cpu().numpy()[1000:20000]) + 1000
    forced = [int(t) for t in np.random.RandomState(0).choice(allowed, 109)] + [task.tokenizer.eot]
    results = {}
    for pinned in (True, False):
        task._forced_tokens = forced if pinned else None
        for wb in (8, 0):
            with write_block(wb):
                results[pinned, wb] = task.run_with_prompts(windows, prompts)
    torch.cuda.synchronize()
    same = {p: sum(a.tokens == b.tokens for a, b in zip(results[p, 8], results[p, 0])) for p in (True, False)}
    diff = max(abs(a.avg_logprob - b.avg_logprob) for a, b in zip(results[True, 8], results[True, 0]))
    finite = sum(math.isfinite(r.avg_logprob) for r in results[True, 8])
    log(f"f32 write blocks against per-step writes, 16 windows without timestamps: pinned {len(forced)}-token "
        f"sequence: {same[True]} of 16 rows with equal tokens, max |avg_logprob difference| {diff:.3e} "
        f"(bound 1e-5; {finite} of 16 finite); free-running: {same[False]} of 16 rows with equal tokens")
    del model
    torch.cuda.empty_cache()
    if same[True] != 16 or finite != 16 or not diff <= 1e-5:
        raise RuntimeError(f"the write-block engine departs from the per-step engine in f32: {same}, {diff}")


def _wav_bytes(wave) -> bytes:
    """16-bit mono WAV at 16 kHz of a float waveform (jfk's samples are
    16-bit values over 32768, so the round trip is exact)."""
    import io
    import wave as wave_mod

    import numpy as np

    pcm = np.clip(np.round(np.asarray(wave) * 32768.0), -32768, 32767).astype(np.int16)
    buf = io.BytesIO()
    with wave_mod.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(pcm.tobytes())
    return buf.getvalue()


def _post(port: int, query: str, body: bytes, first_line: bool = False):
    """POST /v1/audio/transcriptions?query; (status, body bytes, seconds to
    the first NDJSON line or None, seconds to the whole answer)."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    t0 = time.perf_counter()
    conn.request("POST", f"/v1/audio/transcriptions{query}", body=body)
    resp = conn.getresponse()
    data, t_first = b"", None
    if first_line:
        while chunk := resp.read(1):
            data += chunk
            if chunk == b"\n" and t_first is None:
                t_first = time.perf_counter() - t0
    else:
        data = resp.read()
    total = time.perf_counter() - t0
    conn.close()
    return resp.status, data, t_first, total


def server_path(model, audio, profile: bool = False):
    """The batching HTTP server end to end (make_server on an ephemeral
    port of 127.0.0.1, batch_size 16, max_wait_s 0.25, in a thread): after
    a warm-up of the batch and stream paths, phase 12's 20 files as WAV
    bodies from 20 client threads at once (language en, T = 0); then a
    stream=true and a chunked=true&stream=true request on jfk tiled to 70
    s.  With profile, the 20 requests once more under torch.profiler: the
    card's busy time and idle share.  Returns the launches of the 20
    requests."""
    import threading

    import numpy as np
    import torch

    from whisper_tpu_torch.ops.kernels import attention, fused_step
    from whisper_tpu_torch.serve import make_server

    files = twenty_files(audio)
    bodies = [_wav_bytes(f) for f in files]
    long_body = _wav_bytes(np.tile(audio, 7)[: 16000 * 70])
    query = "?language=en&temperature=0"
    server = make_server(model, port=0, batch_size=16, max_wait_s=0.25)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    port = server.server_port
    try:
        for q in (query, query + "&stream=true"):  # warm-up: the native decoder, both paths
            status, data, _, _ = _post(port, q, bodies[0])
            if status != 200:
                raise RuntimeError(f"the server's warm-up failed: {status} {data[:200]!r}")
        before = dict(server.batcher.stats)
        answers = [None] * len(files)

        def client(i):
            answers[i] = _post(port, query, bodies[i])

        def send_all() -> float:
            clients = [threading.Thread(target=client, args=(i,)) for i in range(len(files))]
            t0 = time.perf_counter()
            for c in clients:
                c.start()
            for c in clients:
                c.join()
            torch.cuda.synchronize()
            return time.perf_counter() - t0

        reset_launches()
        wall = send_all()
        layout = dict(fused_step.fused_decoder_layers.launches_by_layout)
        launches = {"encoder_attention": attention.attention.launches,
                    "fused_decoder_layers_pending_multi": k2_count(layout, True, False, "pending")}
        stats = {k: server.batcher.stats[k] - before[k] for k in before}
        bad = []
        for i, (status, data, _, _) in enumerate(answers):
            body = json.loads(data)
            if status != 200 or set(body) != {"text", "language", "segments"} or body["language"] != "en" \
                    or not isinstance(body["text"], str) or any(
                        not 0 <= seg["start"] <= seg["end"] or not isinstance(seg["text"], str)
                        for seg in body["segments"]):
                bad.append((i, status, data[:200]))
        conn_health = _health(port)
        latencies = sorted(a[3] for a in answers)
        audio_s = sum(len(f) for f in files) / 16000
        log(f"server: {len(files)} concurrent requests ({audio_s:.0f} s of audio, WAV bodies, "
            f"language en, T=0), batch_size 16, max_wait 0.25 s: wall {wall:.3f} s, "
            f"{len(files) / wall:.3f} requests/s, {audio_s / wall:.3f} audio s per wall s, latency "
            f"p50 {float(np.percentile(latencies, 50)):.3f} s p95 {float(np.percentile(latencies, 95)):.3f} s, "
            f"batcher stats {stats}, mean batch occupancy {stats['requests'] / max(stats['batches'], 1) / 16:.3f}, "
            f"launches {launches}, K2 launches by layout {layout}, /healthz {conn_health}")
        if bad or stats["errors"] or stats["batches"] < 2:
            raise RuntimeError(f"the server answered badly: {bad[:3]}, stats {stats}")
        if min(launches.values()) <= 0:
            raise RuntimeError(f"a kernel of the server path never launched: {launches}")
        if profile:
            from torch.profiler import ProfilerActivity
            from torch.profiler import profile as profiler

            with profiler(activities=[ProfilerActivity.CUDA]) as prof:
                again = send_all()
            busy = busy_ms(device_events(prof)) / 1e3
            log(f"profile server, 20 concurrent requests: wall {again:.3f} s, device busy {busy:.3f} s, "
                f"idle share {1 - busy / again:.3f}")

        for q, name in ((query + "&stream=true", "stream"),
                        (query + "&chunked=true&stream=true", "chunked stream")):
            reset_launches()
            status, data, t_first, total = _post(port, q, long_body, first_line=True)
            lines = [json.loads(line) for line in data.decode().splitlines() if line]
            segments = lines[:-1]
            log(f"server {name} (jfk tiled to 70 s): {status}, {len(segments)} segment lines, first line "
                f"after {t_first:.3f} s of {total:.3f} s, K2 launches by layout "
                f"{dict(fused_step.fused_decoder_layers.launches_by_layout)}")
            if (status != 200 or not lines or lines[-1].get("done") is not True or not segments
                    or any("error" in line for line in lines)
                    or [seg["id"] for seg in segments] != list(range(len(segments)))):
                raise RuntimeError(f"the {name} answer is malformed: {status} {data[-300:]!r}")
    finally:
        server.shutdown()
        server.batcher.close(drain=False)
        thread.join(timeout=60)
    return launches


def _health(port: int) -> dict:
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("GET", "/healthz")
    resp = conn.getresponse()
    body = json.loads(resp.read())
    conn.close()
    if resp.status != 200 or body.get("status") != "ok":
        raise RuntimeError(f"/healthz answered {resp.status} {body}")
    return body


def int8_streaming(qmodel, audio):
    """StreamingTranscriber on the int8 model with kv_cache_dtype="int8",
    fed jfk tiled to 44 s in 5 s pushes: one window decodes at a push, the
    rest at flush, each one row in write blocks (K2's one-row int8 pending
    instance).  Returns its launches."""
    import numpy as np
    import torch

    from whisper_tpu_torch import StreamingTranscriber
    from whisper_tpu_torch.ops.kernels import attention, fused_step

    wave = np.tile(audio, 4)
    reset_launches()
    t0 = time.perf_counter()
    st = StreamingTranscriber(qmodel, language="en", temperature=0.0, kv_cache_dtype="int8")
    emitted, at_push = [], 0
    for off in range(0, len(wave), 5 * 16000):
        emitted += st.push(wave[off : off + 5 * 16000])
    at_push = len(emitted)
    emitted += st.flush()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    layout = dict(fused_step.fused_decoder_layers.launches_by_layout)
    launches = {"encoder_attention": attention.attention.launches,
                "fused_decoder_layers_pending_int8": layout.get((1, 1, "int8+kv_int8+pending"), 0)}
    result = st.result
    log(f"StreamingTranscriber int8 (kv_cache_dtype='int8', jfk tiled to {len(wave) / 16000:.1f} s in 5 s "
        f"pushes): {len(emitted)} segments ({at_push} at pushes), seek {st.seek}, wall {wall:.3f} s, "
        f"launches {launches}, K2 launches by layout {layout}")
    if emitted != result["segments"] or not _well_formed(result, len(wave), qmodel.dims.n_vocab):
        raise RuntimeError("the int8 stream gave a malformed result")
    if min(launches.values()) <= 0 or set(layout) != {(1, 1, "int8+kv_int8+pending")}:
        raise RuntimeError(f"the int8 stream missed K2's one-row int8 pending instance: {layout}")
    return launches


def encoder_d128(model, audio):
    """The encoder at large-v3-turbo's widths with 10 audio heads (head dim
    128; the weights are the turbo model's, whose shapes do not depend on
    the head count) on jfk's mel: K1's D = 128 instance once per layer, the
    features finite; its wall beside the turbo encoder's (D = 64)."""
    import dataclasses

    import torch

    from whisper_tpu_torch import log_mel_spectrogram, pad_or_trim
    from whisper_tpu_torch.models.whisper import encoder_apply
    from whisper_tpu_torch.ops.kernels import attention

    dims = dataclasses.replace(model.dims, n_audio_head=10)
    mel = log_mel_spectrogram(pad_or_trim(audio), dims.n_mels, device=model.device)[None]
    walls = {}
    for name, d in (("D=128", dims), ("D=64", model.dims)) * 2:  # the first of each is a warm-up
        reset_launches()
        t0 = time.perf_counter()
        features = encoder_apply(model.params, d, mel)
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
        if name == "D=128":
            launches, finite = attention.attention.launches, bool(torch.isfinite(features).all())
    log(f"encoder at turbo's widths, 10 heads of 128 (jfk's mel, bf16): {launches} K1 launches, features "
        f"{tuple(features.shape)} finite {finite}, wall {1e3 * walls['D=128']:.3f} ms (20 heads of 64: "
        f"{1e3 * walls['D=64']:.3f} ms)")
    if launches != dims.n_audio_layer or not finite:
        raise RuntimeError(f"the D=128 encoder ran K1 {launches} times or gave non-finite features")
    return launches


def experiments_path():
    """The experiments' entry points as a user runs them (python -m
    whisper_tpu_torch.experiments.<name>), at their defaults on the card
    (encoder_ops at --d 128): E1, E2 in both layouts and E3 launched.
    Returns their launches."""
    from whisper_tpu_torch.experiments import attn_packed, encoder_ops, logits
    from whisper_tpu_torch.ops.kernels import attn_packed as e3
    from whisper_tpu_torch.ops.kernels import logits as e2
    from whisper_tpu_torch.ops.kernels import matmul_residual as e1

    reset_launches()
    for name, module, argv in (("encoder_ops", encoder_ops, ["--d", "128"]), ("logits", logits, []),
                               ("attn_packed", attn_packed, [])):
        log(f"python -m whisper_tpu_torch.experiments.{name} {' '.join(argv)}".rstrip() + ":")
        module.main(argv)
    launches = {"matmul_residual": e1.matmul_residual.launches,
                "logits_streamed_vc": e2.logits_streamed.launches_by_layout["vc"],
                "logits_streamed_cv": e2.logits_streamed.launches_by_layout["cv"],
                "attn_pairs_unpacked": e3.attn_pairs_unpacked.launches,
                "attn_pairs_packed": e3.attn_pairs_packed.launches}
    log(f"experiments' launches: {launches}")
    if min(launches.values()) <= 0:
        raise RuntimeError(f"an experiment did not launch its kernel: {launches}")
    return launches


def wide_group(model, audio) -> dict:
    """Best-of groups of 129 and 200 rows of jfk's window at T = 0.7 (a
    group wider than one K2 launch, cut into parts of one audio): the K2
    launches by layout, finite log-probs and tokens in the vocabulary."""
    import torch

    from whisper_tpu_torch import log_mel_spectrogram, pad_or_trim
    from whisper_tpu_torch.decoding import DecodingOptions
    from whisper_tpu_torch.ops.kernels import fused_step

    mel = log_mel_spectrogram(pad_or_trim(audio), model.dims.n_mels, device=model.device)
    out = {}
    for best_of in (129, 200):
        fused_step.fused_decoder_layers.launches_by_layout.clear()
        t0 = time.perf_counter()
        result = model.decode(mel, DecodingOptions(language="en", temperature=0.7, best_of=best_of,
                                                   sample_len=32))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        layout = dict(fused_step.fused_decoder_layers.launches_by_layout)
        parts = [(1, g) for g in ((65, 64) if best_of == 129 else (100,))]
        log(f"best-of-{best_of} decode (one audio's group of {best_of} rows): K2 launches by layout "
            f"{layout}, {len(result.tokens)} tokens, avg_logprob {result.avg_logprob:.4f}, wall {wall:.3f} s")
        if (set(layout) != set(parts) or not math.isfinite(result.avg_logprob)
                or not all(0 <= t < model.dims.n_vocab for t in result.tokens)):
            raise RuntimeError(f"best-of-{best_of}: layouts {layout}, tokens {result.tokens[:8]}")
        out[best_of] = layout
    return out


def narrow_decoder(device) -> None:
    """A decoder K2 does not take (head dim 32): greedy and beam-5 decodes
    in f32 on the card through the PyTorch step, chosen by shape before any
    launch; no K2 launch, and the CPU's tokens."""
    import numpy as np
    import torch

    import whisper_tpu_torch
    from whisper_tpu_torch.decoding import DecodingOptions
    from whisper_tpu_torch.models import ModelDimensions
    from whisper_tpu_torch.models.whisper import init_params
    from whisper_tpu_torch.ops.kernels import fused_step

    dims = ModelDimensions(n_mels=80, n_audio_ctx=1500, n_audio_state=64, n_audio_head=2, n_audio_layer=2,
                           n_vocab=51865, n_text_ctx=448, n_text_state=64, n_text_head=2, n_text_layer=2)
    params = init_params(dims, torch.Generator().manual_seed(0), torch.float32)
    mel = torch.from_numpy(np.random.RandomState(0).randn(80, 3000).astype(np.float32))

    def to(tree, where):
        return {k: to(v, where) for k, v in tree.items()} if isinstance(tree, dict) else tree.to(where)

    launches = fused_step.fused_decoder_layers.launches
    tokens = {}
    for where in ("cpu", device):
        model = whisper_tpu_torch.Whisper(dims, to(params, where))
        for beam in (None, 5):
            result = model.decode(mel.to(where), DecodingOptions(language="en", temperature=0.0,
                                                                 sample_len=24, beam_size=beam))
            tokens[torch.device(where).type, beam] = list(result.tokens)
    same = all(tokens["cuda", b] == tokens["cpu", b] for b in (None, 5))
    k2 = fused_step.fused_decoder_layers.launches - launches
    log(f"head dim 32 decoder on the card (PyTorch step by shape): K2 launches {k2} (bound 0), greedy "
        f"{len(tokens['cuda', None])} and beam-5 {len(tokens['cuda', 5])} tokens, equal to the CPU's: {same}")
    if k2 or not same:
        raise RuntimeError(f"head dim 32 decoder: {k2} K2 launches, tokens {tokens}")


def batch_beam_160(model, audio):
    """transcribe_batch on 32 files cut from jfk (4-26 s, phase 12's way)
    with batch_size 32 and beam 5 at T = 0: one round of 160 rows, which K2
    takes in launches of 25 and 7 audios of five rows."""
    import numpy as np
    import torch

    from whisper_tpu_torch.ops.kernels import fused_step

    tiled = np.tile(audio, 3)
    files = [tiled[int(0.37 * 16000 * i):][: 16000 * (4 + (i * 7) % 23)] for i in range(32)]
    reset_launches()
    t0 = time.perf_counter()
    results = model.transcribe_batch(files, batch_size=32, beam_size=5, temperature=0.0, language="en")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    layout = dict(fused_step.fused_decoder_layers.launches_by_layout)
    log(f"transcribe_batch(32 files, batch_size=32, beam_size=5, T=0): wall {wall:.3f} s, "
        f"{sum(len(r['segments']) for r in results)} segments, K2 launches by (audios, rows per "
        f"audio) {layout}")
    if len(results) != 32 or not all(_well_formed(r, len(f), model.dims.n_vocab) for r, f in zip(results, files)):
        raise RuntimeError("transcribe_batch at 160 rows gave a malformed result")
    # a later round of fewer files may slice as 25 + fewer: (7, 5) counts the 160-row steps
    if not 0 < layout.get((7, 5), 0) <= layout.get((25, 5), 0):
        raise RuntimeError(f"the 160-row steps did not run K2 in slices of 25 and 7 audios: {layout}")
    return layout[(25, 5)] + layout[(7, 5)]


def host_split(fn, steps: int, label: str) -> None:
    """cProfile's host time per token step of one decode (which it slows:
    its shares, not its sums, carry over)."""
    import cProfile
    import pstats

    import torch

    profiler = cProfile.Profile()
    profiler.enable()
    fn()
    torch.cuda.synchronize()
    profiler.disable()
    per_step = {}
    for (_, _, fn_name), (_, calls, own, cum, _) in pstats.Stats(profiler).stats.items():
        if fn_name in ("apply_logit_filters", "_greedy_update", "_beam_update", "decoder_step_fused",
                       "decoder_step_fused_pending", "flush_pending", "fused_decoder_layers",
                       "project_logits"):
            per_step[fn_name] = (calls, 1e3 * cum)
        elif fn_name in ("decode_engine", "_block_loop"):  # own time: completed's read-back
            per_step[f"{fn_name} (own time)"] = (calls, 1e3 * own)
    log(f"profile host per step of the {label} (cProfile, total ms / {steps} steps): " + ", ".join(
        f"{k} {ms / steps:.3f} ms ({calls} calls)" for k, (calls, ms) in sorted(per_step.items())))


def profile_window(model, audio, forced, beam, prompts, int8) -> None:
    """--profile: wall, device busy time and idle share of the pinned window,
    of its encoder and decode parts, of the beam-5 window and of the
    16-window run_with_prompts, the three decodes again on the int8
    configuration (int8 = (model, beam-5 window, run_with_prompts) from
    int8_path), then the host's time per token step of the bf16 decodes.
    Wall is the median of
    three runs without a profiler; busy is the time under torch.profiler in
    which a kernel or a copy ran (busy_ms: overlapping launches counted
    once); idle share is 1 - busy / wall."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from whisper_tpu_torch import log_mel_spectrogram, pad_or_trim
    from whisper_tpu_torch.decoding import DecodingOptions, DecodingTask

    mel = log_mel_spectrogram(pad_or_trim(audio), model.dims.n_mels, device=model.device)
    features = model.embed_audio(mel[None])
    options = DecodingOptions(language="en", temperature=0.0)
    beam_features, beam_options, _ = beam

    def greedy():
        return DecodingTask(model, options).run(features)

    def beam5():
        return DecodingTask(model, beam_options).run(beam_features)

    qmodel, (qfeatures, qbeam_options, _), qprompts = int8
    qoptions = DecodingOptions(language="en", temperature=0.0, sample_len=32, kv_cache_dtype="int8")

    # (label, fn, pinned): the pinned sequence is greedy-only
    parts = [
        ("window: transcribe(waveform)",
         lambda: model.transcribe(audio, language="en", temperature=0.0), True),
        ("encoder: embed_audio(mel)", lambda: model.embed_audio(mel[None]), True),
        (f"decode from features: prefill + {len(forced)} steps", greedy, True),
        ("beam-5 window from features: prefill + 224 steps of 5 rows", beam5, False),
        ("run_with_prompts: 16 windows, encoder + prefill + 224 steps of 16 rows", prompts, False),
        (f"int8 decode from features: prefill + {len(forced)} steps",
         lambda: DecodingTask(qmodel, qoptions).run(qfeatures), True),
        ("int8 beam-5 window from features: prefill + 224 steps of 5 rows",
         lambda: DecodingTask(qmodel, qbeam_options).run(qfeatures), False),
        ("int8 run_with_prompts: 16 windows, encoder + prefill + 224 steps of 16 rows", qprompts, False),
    ]
    try:
        for label, fn, pinned in parts:
            DecodingTask._forced_tokens = forced if pinned else None
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
            busy = busy_ms(device_events(prof))
            log(f"profile {label}: wall {wall:.3f} ms, device busy {busy:.3f} ms, "
                f"idle share {1 - busy / wall:.3f}")
            table = prof.key_averages().table(sort_by="self_device_time_total", row_limit=8,
                                              max_name_column_width=60)
            for line in table.splitlines():
                log(f"  {line}")
        DecodingTask._forced_tokens = forced
        host_split(greedy, len(forced), "pinned greedy decode")
        DecodingTask._forced_tokens = None
        host_split(beam5, 224, "beam-5 decode")
        host_split(prompts, 224, "16-window run_with_prompts")
    finally:
        DecodingTask._forced_tokens = None


def _cast(tree, dtype):
    """A parameter tree with its floating leaves in dtype (int8 leaves kept)."""
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    return tree.to(dtype) if tree.is_floating_point() else tree


@contextlib.contextmanager
def spec_timer(timer):
    """Every speculative decode in the block times its stages on timer."""
    from whisper_tpu_torch import decoding

    real = decoding.decode_engine_speculative

    def timed(*args, **kwargs):
        return real(*args, stage_timer=timer, **kwargs)

    decoding.decode_engine_speculative = timed
    try:
        yield
    finally:
        decoding.decode_engine_speculative = real


def spec_decode(target, draft, mel, options, force: bool = False):
    """One window through DecodingTask.run with a draft (None: the plain
    greedy decode), its stages on a StageTimer of the card: (result, wall
    s, rounds, timer)."""
    import torch

    from whisper_tpu_torch.decoding import DecodingTask
    from whisper_tpu_torch.profiling import StageTimer

    timer = StageTimer(mel.device)
    task = DecodingTask(target, options, draft_model=draft)
    task._force_accept = force  # whisper_tpu's benchmark-only all-accept ceiling
    with spec_timer(timer):
        t0 = time.perf_counter()
        result = task.run(mel)[0]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return result, wall, timer.counts["verify"], timer


def speculative_path(device, audio) -> dict:
    """Phase 35: speculative greedy decoding at full width, large-v3 (32 +
    32 layers) drafted for by large-v3-turbo's decoder (4 layers), the
    encoder shared, random weights from seeded generators on the card.

    f32 (TF32 off): the turbo-draft decode and the self-draft equal the
    target's plain greedy decode token for token on jfk's first window,
    and every draft step is a K2 launch ((S - 1) per round).  bf16, in
    turns, median of 3 after a 16-token warm-up: the plain window, the turbo draft,
    the self-draft and whisper_tpu's all-accept ceiling (_force_accept):
    ms per token, rounds, tokens per round, K1 and K2 launches; the turbo
    draft's tokens equal the plain ones, or at the first position where
    they differ the target's two candidates, re-scored teacher-forced by
    decoder_forward, lie within K2's bf16 bound (K2_REL_TOL relative to the
    largest logit).  The stages of the timed turbo window on a StageTimer
    (CUDA events), its device idle share under torch.profiler (64 tokens),
    the allocator's statistics, and a 32-token window of the int8 target
    with int8 cross K/V, well-formed."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from whisper_tpu_torch import Whisper, log_mel_spectrogram, pad_or_trim
    from whisper_tpu_torch.decoding import DecodingOptions, DecodingTask
    from whisper_tpu_torch.models import KNOWN_MODELS
    from whisper_tpu_torch.models.whisper import decoder_forward, init_params
    from whisper_tpu_torch.ops.kernels.attention import attention
    from whisper_tpu_torch.ops.kernels.fused_step import fused_decoder_layers
    from whisper_tpu_torch.profiling import device_memory_stats
    from whisper_tpu_torch.quantize import quantize_params

    t0 = time.perf_counter()
    tdims, ddims = KNOWN_MODELS["large-v3"], KNOWN_MODELS["turbo"]
    tparams = init_params(tdims, torch.Generator(device=device).manual_seed(35), torch.float32, device)
    dparams = init_params(ddims, torch.Generator(device=device).manual_seed(36), torch.float32, device)
    dparams["encoder"] = tparams["encoder"]  # turbo kept large-v3's encoder
    target, draft = Whisper(tdims, tparams), Whisper(ddims, dparams)
    mel = log_mel_spectrogram(pad_or_trim(audio), tdims.n_mels, device=device)[None]
    S = DecodingOptions.draft_len
    options = DecodingOptions(language="en", temperature=0.0)
    torch.cuda.synchronize()
    log(f"speculative: random large-v3 ({target.num_parameters()} parameters) and turbo's decoder, "
        f"f32, the encoder shared: {time.perf_counter() - t0:.3f} s")

    # f32, TF32 off: token-exact
    plain, _, _, _ = spec_decode(target, None, mel, options)
    for name, d in (("turbo draft", draft), ("self-draft", target)):
        reset_launches()
        spec, wall, rounds, _ = spec_decode(target, d, mel, options)
        k2 = fused_decoder_layers.launches
        log(f"speculative f32 {name}, S = {S}: {len(spec.tokens)} tokens in {rounds} rounds, "
            f"{len(spec.tokens) / rounds:.4f} tokens per round, K2 launches {k2} "
            f"((S - 1) x rounds = {(S - 1) * rounds}), equal to plain greedy "
            f"({len(plain.tokens)} tokens): {spec.tokens == plain.tokens}, avg_logprob "
            f"{spec.avg_logprob:.6f} / {plain.avg_logprob:.6f}, wall {wall:.4f} s")
        if spec.tokens != plain.tokens:
            raise RuntimeError(f"speculative f32 ({name}) differs from plain greedy")
        if k2 != (S - 1) * rounds or k2 <= 0:
            raise RuntimeError(f"speculative f32 ({name}): {k2} K2 launches for {rounds} rounds")

    # bf16: the four windows in turns
    target, draft = Whisper(tdims, _cast(tparams, torch.bfloat16)), Whisper(ddims, _cast(dparams, torch.bfloat16))
    del tparams, dparams
    torch.cuda.empty_cache()
    runs = {"plain": (None, False), "turbo draft": (draft, False), "self-draft": (target, False),
            "all-accept ceiling": (draft, True)}
    walls = {name: [] for name in runs}
    out = {}
    short = DecodingOptions(language="en", temperature=0.0, sample_len=16)
    for turn in range(4):  # the first is a short warm-up
        for name, (d, force) in runs.items():
            reset_launches()
            result, wall, rounds, timer = spec_decode(target, d, mel, options if turn else short, force)
            walls[name].append(wall)
            out[name] = dict(result=result, rounds=rounds, timer=timer, k1=attention.launches,
                             k2=fused_decoder_layers.launches)
    for name, o in out.items():
        wall = sorted(walls[name][1:])[1]
        n = len(o["result"].tokens)
        per_round = f"{o['rounds']} rounds, {n / o['rounds']:.4f} tokens per round, " if o["rounds"] else ""
        log(f"speculative bf16 {name}: {n} tokens, wall {wall:.4f} s (median of 3 after a short warm-up), "
            f"{1000 * wall / n:.4f} ms per token, {per_round}K1 launches {o['k1']}, K2 launches {o['k2']}")
    base, turbo = out["plain"]["result"], out["turbo draft"]["result"]
    if turbo.tokens != base.tokens:
        j = next((i for i, (a, b) in enumerate(zip(base.tokens, turbo.tokens)) if a != b),
                 min(len(base.tokens), len(turbo.tokens)))
        eot = DecodingTask(target, options).tokenizer.eot
        a, b = (r.tokens[j] if j < len(r.tokens) else eot for r in (base, turbo))
        prefix = list(DecodingTask(target, options).initial_tokens) + list(base.tokens[:j])
        logits = decoder_forward(target.params, tdims, torch.tensor([prefix], device=device),
                                 target.embed_audio(mel))[0, -1]
        rel = (logits[a] - logits[b]).abs().item() / logits.abs().max().item()
        log(f"speculative bf16 turbo draft: first differs from plain greedy at token {j} ({a} against "
            f"{b}); teacher-forced logits {logits[a].item():.6f} / {logits[b].item():.6f}, apart "
            f"{rel:.3e} of the largest (K2's bf16 bound {K2_REL_TOL['bfloat16']:.0e})")
        if not rel <= K2_REL_TOL["bfloat16"]:
            raise RuntimeError(f"speculative bf16: not a near-tie at token {j}: {rel}")
    else:
        log("speculative bf16 turbo draft: equal to plain greedy token for token")
    report = out["turbo draft"]["timer"].report(audio_seconds=len(audio) / 16000)
    rounds = out["turbo draft"]["rounds"]
    log(f"speculative bf16 turbo draft, stages on CUDA events (the last run): {report}; per round "
        + ", ".join(f"{k} {1000 * out['turbo draft']['timer'].totals[k] / rounds:.4f} ms"
                    for k in ("draft", "verify", "accept")))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        result, wall, rounds, _ = spec_decode(target, draft, mel, DecodingOptions(
            language="en", temperature=0.0, sample_len=64))
    busy = busy_ms(device_events(prof))
    log(f"speculative bf16 turbo draft, 64 tokens, under torch.profiler: {rounds} rounds, wall "
        f"{1000 * wall:.2f} ms, device busy {busy:.2f} ms, idle share {1 - busy / (1000 * wall):.4f}")
    stats = device_memory_stats(device)
    log("device_memory_stats: " + ", ".join(f"{k} {stats.get(k)}" for k in (
        "allocated_bytes.all.current", "allocated_bytes.all.peak", "reserved_bytes.all.peak",
        "num_alloc_retries", "num_ooms")))

    # int8 weights and int8 cross K/V in the target
    qtarget = Whisper(tdims, quantize_params(target.params))
    qoptions = DecodingOptions(language="en", temperature=0.0, sample_len=32, kv_cache_dtype="int8")
    reset_launches()
    result, wall, rounds, _ = spec_decode(qtarget, draft, mel, qoptions)
    ok = (0 < len(result.tokens) and all(0 <= t < tdims.n_vocab for t in result.tokens)
          and math.isfinite(result.avg_logprob) and isinstance(result.text, str))
    log(f"speculative int8 target (kv_cache_dtype int8), turbo draft bf16: {len(result.tokens)} "
        f"tokens in {rounds} rounds, avg_logprob {result.avg_logprob:.6f}, wall {wall:.4f} s, "
        f"K2 launches {fused_decoder_layers.launches}, well-formed: {ok}")
    if not ok:
        raise RuntimeError("speculative int8: malformed result")
    return dict(k1=out["turbo draft"]["k1"], k2=out["turbo draft"]["k2"])


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--profile", action="store_true",
                        help="profile the server's 20 requests and, after the phases, the pinned "
                        "window, the beam-5 window and the 16-window run_with_prompts (device idle "
                        "share, host time per step)")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)

    from whisper_tpu_torch.ops.kernels import build
    from whisper_tpu_torch.ops.kernels._lib import LIB_PATH

    log(card_line())  # name, power limit: nvidia-smi's own words
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    ptxas = build(verbose=True)
    log(f"kernel build: {time.perf_counter() - t0:.2f} s")
    for line in ptxas_summary(ptxas):
        log(f"  ptxas: {line}")
    for line in wgmma_check(ptxas, LIB_PATH):
        log(f"  wgmma: {line}")

    gen = torch.Generator(device=device).manual_seed(0)
    k1 = check_k1(gen, device)
    k2 = check_k2(gen, device)
    k2g = check_k2(gen, device, G=5)
    # several audios at per-row positions: sixteen positions for sixteen
    # audios; three and sixteen audios of five rows (80 rows: row tiles)
    spread = [int(p) for p in torch.randperm(256, generator=torch.Generator().manual_seed(0))[:16]]
    k2m = check_k2(gen, device, A=16, t=spread, label=" multi")
    check_k2(gen, device, A=3, G=5, t=[3, 40, 255, 256, 0] * 3, label=" groups")
    check_k2(gen, device, A=16, G=5, t=[(37 * i) % 257 for i in range(80)], label=" groups")
    # the --chunked path's layouts: five chunks of five rows at one position
    # (its chunks carry no prompt), four on a rung that re-decodes four
    k2ag = check_k2(gen, device, A=5, G=5, label=" groups")
    check_k2(gen, device, A=4, G=5, label=" groups")
    k2p = check_k2_pending(gen, device)
    k2_launch_split(gen, device)
    k5_launch_split(gen, device)
    xattn = check_cross_attention(gen, device)
    k3 = check_k3(gen, device)
    k4 = check_k4(gen, device)
    # this slice's kernels: K1 at head dim 128, E1-E3; K2 above 128 rows
    k1_128 = check_k1_d128(gen, device)
    e1 = check_e1(gen, device)
    e2 = check_e2(gen, device)
    e3 = check_e3(gen, device)
    k2_160 = check_k2(gen, device, A=32, G=5, t=[(37 * i) % 257 for i in range(160)], label=" slices")
    check_k2(gen, device, A=160, t=[(53 * i) % 257 for i in range(160)], label=" slices")
    # one audio's group wider than a launch, in parts of it (inputs from a
    # generator of their own, so that the phases after keep theirs)
    wide = torch.Generator(device=device).manual_seed(129)
    for G in (129, 200):
        check_k2(wide, device, G=G, t=[(37 * i) % 257 for i in range(G)], label=" wide group")
    # the speculative draft's one-token step: turbo's decoder, one row at a
    # per-row position in a 448-column cache (a generator of its own)
    k2d = check_k2(torch.Generator(device=device).manual_seed(448), device, t=[116], T=448,
                   label=" draft")
    launches, model, audio, forced = end_to_end(device)
    cli_launches = cli_default_path(model)
    beam = beam_window(model, audio)
    prompts, prompts_ms, turns = prompts_window(model, audio)
    batch_launches, batch_wall = batch_path(model, audio)
    chunked_launches, wave, chunked = chunked_cli_path(model, audio)
    align_path(model, wave, chunked)
    column_write(device)
    f32_block_check(device, audio)
    # int8: K2's int8 instances (int8 weights with the cross K/V in bf16, and
    # both int8) at the layouts of the int8 paths, both compute dtypes; K5;
    # the int8 logits; then the int8 configuration end to end
    k2q = {}
    for form in ("int8", "int8+kv_int8"):
        k2q[form, 1] = check_k2(gen, device, form=form)
        k2q[form, 5] = check_k2(gen, device, G=5, form=form)
        k2q[form, 16] = check_k2(gen, device, A=16, t=spread, label=" multi", form=form)
        k2q[form, 25] = check_k2(gen, device, A=5, G=5, label=" groups", form=form)
        check_k2(gen, device, A=16, G=5, t=[(37 * i) % 257 for i in range(80)], label=" groups",
                 form=form)
    k5 = check_k5(gen, device)
    logits = check_int8_logits(gen, device)
    int8_launches, int8 = int8_path(model, audio, forced,
                                    dict(beam=beam[2], prompts=prompts_ms, batch=batch_wall))
    server_launches = server_path(model, audio, profile=args.profile)
    stream_launches = int8_streaming(int8[0], audio)
    d128_launches = encoder_d128(model, audio)
    experiment_launches = experiments_path()
    k2_slice_launches = batch_beam_160(model, audio)
    wide_group(model, audio)
    narrow_decoder(device)
    spec_launches = speculative_path(device, audio)
    if args.profile:
        profile_window(model, audio, forced, beam, prompts, int8)

    fused = dict(route="cuda", source="whisper_tpu_torch/csrc/fused_step.cu",
                 replaces="whisper_tpu/ops/kernels/fused_step_pallas.py:301")
    pending = dict(fused, replaces="whisper_tpu/ops/kernels/fused_step_pallas.py:312")
    kernels = [
        # launches_speculative: the target's encoder in phase 35's bf16
        # turbo-draft window (large-v3, 32 layers)
        dict(name="encoder_attention", route="cuda",
             source="whisper_tpu_torch/csrc/attention.cu",
             replaces="whisper_tpu/ops/kernels/attention_pallas.py:62",
             launches=launches["encoder_attention"], launches_speculative=spec_launches["k1"],
             **k1[1, "bfloat16"]),
        # K1 at batch 16: timed at (16, 20, 1500, 64); launches: transcribe_batch's
        # encoder passes (groups of up to 16 files)
        dict(name="encoder_attention_b16", route="cuda", source="whisper_tpu_torch/csrc/attention.cu",
             replaces="whisper_tpu/ops/kernels/attention_pallas.py:62",
             launches=batch_launches["encoder_attention"], **k1[16, "bfloat16"]),
        # B=1: the greedy path's count; B=5 and K3, K4: the CLI default path's
        dict(name="fused_decoder_layers", **fused,
             launches=launches["fused_decoder_layers"], **k2["bfloat16"]),
        dict(name="fused_decoder_layers_b5", **fused,
             launches=cli_launches["fused_decoder_layers_b5"], **k2g["bfloat16"]),
        # K5 at five rows, bf16 weights: K2's MLP stage on the CLI default
        # path (L per K2 launch; the beam and best-of groups), timed alone
        dict(name="mlp_fused_b5", route="cuda", source="whisper_tpu_torch/csrc/fused_step.cu",
             replaces="whisper_tpu/ops/kernels/mlp_pallas.py:128",
             launches=cli_launches["mlp_fused"], **k5["B=5", "bfloat16"]),
        # K2's cross-attention launch alone, timed at one row beside SDPA;
        # launches: the greedy transcribe's, L per K2 step
        dict(name="decode_cross_attention", **fused,
             launches=launches["decode_cross_attention"], **xattn[1, 1]),
        # several audios: one row each (the 16-window decode's per-step turn,
        # timed at A=B=16; every other batch of a wide decoder writes in
        # blocks) and groups of rows (the chunked path's beam count, timed at
        # its 5 x 5)
        dict(name="fused_decoder_layers_multi", **fused,
             launches=turns["launches"][0], **k2m["bfloat16"]),
        dict(name="fused_decoder_layers_groups", **fused,
             launches=chunked_launches["fused_decoder_layers_groups"], **k2ag["bfloat16"]),
        dict(name="median_filter", route="cuda", source="whisper_tpu_torch/csrc/median.cu",
             replaces="whisper_tpu/ops/kernels/median_pallas.py:36",
             launches=cli_launches["median_filter"], **k3),
        dict(name="dtw_trace", route="cuda", source="whisper_tpu_torch/csrc/dtw.cu",
             replaces="whisper_tpu/ops/kernels/dtw_pallas.py:80",
             launches=cli_launches["dtw_trace"], **k4),
        # the int8 configuration (int8 weights and cross K/V): B=1 the int8
        # pinned window's per-step turns; the MLP stage (K5's code, timed
        # alone at B=1, int8) and the int8 logits, the greedy transcribe's
        # counts; B=5 the int8 beam window's; 16 x 1 the int8 16-window
        # decode's per-step turn; 5 x 5 the int8 --chunked path's beam
        dict(name="fused_decoder_layers_int8", **fused,
             launches=int8_launches["fused_decoder_layers_int8"], **k2q["int8+kv_int8", 1]["bfloat16"]),
        dict(name="fused_decoder_layers_b5_int8", **fused,
             launches=int8_launches["fused_decoder_layers_b5_int8"], **k2q["int8+kv_int8", 5]["bfloat16"]),
        dict(name="fused_decoder_layers_multi_int8", **fused,
             launches=int8_launches["fused_decoder_layers_multi_int8"],
             **k2q["int8+kv_int8", 16]["bfloat16"]),
        dict(name="fused_decoder_layers_groups_int8", **fused,
             launches=int8_launches["fused_decoder_layers_groups_int8"],
             **k2q["int8+kv_int8", 25]["bfloat16"]),
        dict(name="mlp_fused", route="cuda", source="whisper_tpu_torch/csrc/fused_step.cu",
             replaces="whisper_tpu/ops/kernels/mlp_pallas.py:128",
             launches=int8_launches["mlp_fused"], **k5["B=1", "int8"]),
        dict(name="int8_logits", route="cuda", source="whisper_tpu_torch/csrc/fused_step.cu",
             replaces="whisper_tpu/models/whisper.py:869",
             launches=int8_launches["int8_logits"], **logits[1]),
        # the pending block, timed at T=448 with 7 of 8 columns valid: 16 x
        # 1 the server's 20 requests' count; one int8+kv_int8 row the int8
        # stream's; 3 x 5 (timed) and 5 x 5 (counted) the chunked path's
        # best-of rungs
        dict(name="fused_decoder_layers_pending_multi", **pending,
             launches=server_launches["fused_decoder_layers_pending_multi"], **k2p["multi"]["bfloat16"]),
        dict(name="fused_decoder_layers_pending_int8", **pending,
             launches=stream_launches["fused_decoder_layers_pending_int8"], **k2p["int8"]["bfloat16"]),
        dict(name="fused_decoder_layers_pending_groups", **pending,
             launches=chunked_launches["fused_decoder_layers_pending_groups"], **k2p["groups"]["bfloat16"]),
        # more than 128 rows: 32 x 5 in launches of 25 and 7 audios, timed as
        # one step; launches: transcribe_batch's 160-row steps (each two)
        dict(name="fused_decoder_layers_160", **fused, launches=k2_slice_launches, **k2_160["bfloat16"]),
        # the speculative draft's one-token steps (turbo's decoder, one row,
        # per-row position, T = 448): phase 35's bf16 turbo-draft window
        dict(name="fused_decoder_layers_draft", **fused, launches=spec_launches["k2"],
             **k2d["bfloat16"]),
        # K1 at head dim 128: timed at the encoder pass's (1, 10, 1500, 128)
        dict(name="encoder_attention_d128", route="cuda", source="whisper_tpu_torch/csrc/attention.cu",
             replaces="whisper_tpu/ops/kernels/attention_pallas.py:62", launches=d128_launches,
             **k1_128[1, "bfloat16"]),
        # E1-E3, launched by the experiments' entry points at their defaults
        dict(name="matmul_residual", route="cuda", source="whisper_tpu_torch/csrc/matmul_residual.cu",
             replaces="scripts/_matmul_pallas_experiment.py:44",
             launches=experiment_launches["matmul_residual"], **e1),
        dict(name="logits_streamed_vc", route="cuda", source="whisper_tpu_torch/csrc/logits.cu",
             replaces="scripts/_logits_experiment.py:109",
             launches=experiment_launches["logits_streamed_vc"], **e2["vc", 16]),
        dict(name="logits_streamed_cv", route="cuda", source="whisper_tpu_torch/csrc/logits.cu",
             replaces="scripts/_logits_experiment.py:144",
             launches=experiment_launches["logits_streamed_cv"], **e2["cv", 16]),
        dict(name="attn_pairs_unpacked", route="cuda", source="whisper_tpu_torch/csrc/attn_packed.cu",
             replaces="scripts/_attn_packed_experiment.py:51",
             launches=experiment_launches["attn_pairs_unpacked"], **e3["unpacked"]),
        dict(name="attn_pairs_packed", route="cuda", source="whisper_tpu_torch/csrc/attn_packed.cu",
             replaces="scripts/_attn_packed_experiment.py:75",
             launches=experiment_launches["attn_pairs_packed"], **e3["packed"]),
    ]
    # no card beats its bound: a kernel timed below it skipped part of the
    # work, which a numeric comparison cannot always see (E3's reps)
    fast = [(k["name"], k["ms"], k["bound_ms"]) for k in kernels if k["ms"] < k["bound_ms"]]
    if fast:
        raise RuntimeError(f"kernels timed below their bound (name, ms, bound_ms): {fast}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
