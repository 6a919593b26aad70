#!/usr/bin/env python3
"""Trace E3 (csrc/attn_packed.cu) on one CUDA card: variants of the source
built alone and timed side by side, with the phases of a rep read by
clock64.

    python3 chip_trace_e3.py [--only NAME,...] [--reps 64] [--grid 320]

Each variant in VARIANTS is a list of text substitutions (file, old, new)
applied to a copy of whisper_tpu_torch/csrc in the git-ignored build/
directory; every variant also stamps clock64 in thread 0 of each
warpgroup of block 0 at four points of every rep: after qq is in (the
rep's start), after the products, after every block's partial is in,
and after the owners' qq is out.  The variants are built in parallel
(nvcc, one process each), loaded by ctypes, checked against the plain
version at a small shape (where they compute the same function) and
timed at g programs (CUDA events, the best of three calls after a
warm-up), unpacked and packed.  The lines give each variant's ms, its
error and the median cycles of each phase, and the clusters the card
holds at once.  The last line is one JSON object.
"""

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(REPO, "whisper_tpu_torch", "csrc")
OUT = os.path.join(REPO, "build", "e3_variants")
NVCC = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")

QQ_WAIT = "    hopper::mbar_wait<true>(qready + h, phase);\n"
PRODUCTS_DONE = "    hopper::wgmma_wait<0>();\n    hopper::fence_operands(oacc);\n"
SEND_LOOP = "#pragma unroll\n    for (int hh = 0; hh < 2; ++hh) {\n      const int row = 16 * w + g + 8 * hh, owner = row / R;"
SENDS = """        const float a = oacc[4 * j + 2 * hh], b = oacc[4 * j + 2 * hh + 1];
        const float pa = __shfl_xor_sync(0xffffffffu, a, 1), pb = __shfl_xor_sync(0xffffffffu, b, 1);
        if ((j & 1) == (t & 1)) {
          if (t & 1)
            hopper::st_async(dst + 32 * j, pa, pb, a, b, bar);
          else
            hopper::st_async(dst + 32 * j, a, b, pa, pb, bar);
        }
"""
V2_SEND = """__device__ __forceinline__ void st_async2(uint32_t addr, float a, float b, uint32_t bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f32 [%0], {%1, %2}, [%3];\\n" ::"r"(addr),
               "f"(a), "f"(b), "r"(bar) : "memory");
}

// -- TMA ---"""
STAGED_SENDS = """    if constexpr (HD == 64) {
      float* st = stage + h * 64 * L::PLD;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        *reinterpret_cast<float2*>(st + (16 * w + g) * L::PLD + 8 * j + 2 * t) = make_float2(oacc[4 * j], oacc[4 * j + 1]);
        *reinterpret_cast<float2*>(st + (16 * w + g + 8) * L::PLD + 8 * j + 2 * t) =
            make_float2(oacc[4 * j + 2], oacc[4 * j + 3]);
      }
      asm volatile("fence.proxy.async.shared::cta;\\n" ::: "memory");
      asm volatile("bar.sync %0, 128;\\n" ::"r"(2 + h) : "memory");
      if (tid < CL) {
        const uint32_t dst = hopper::cluster_addr(recv_half + rank * R * L::PLD, tid);
        const uint32_t bar = hopper::cluster_addr(pready + h, tid);
        asm volatile(
            "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\\n" ::"r"(dst),
            "r"(hopper::smem_u32(st + tid * R * L::PLD)), "r"((uint32_t)(R * L::PLD * 4)), "r"(bar)
            : "memory");
      }
    }
    if constexpr (HD != 64) {
""" + SEND_LOOP
# name: (substitutions, computes the same function, packed runs)
VARIANTS = {
    "as_is": ([], True, True),
    # half 1 starts its first products once half 0's are done
    "offset_start": ([
        ("attn_packed.cu", QQ_WAIT, QQ_WAIT + '    if (rep == 0 && h == 1) asm volatile("bar.sync 1, 256;\\n" ::: "memory");\n'),
        ("attn_packed.cu", PRODUCTS_DONE,
         PRODUCTS_DONE + '    if (rep == 0 && h == 0) asm volatile("bar.arrive 1, 256;\\n" ::: "memory");\n'),
    ], True, True),
    # 8-byte partial sends, each lane its own pairs
    "v2_sends": ([("hopper.cuh", "// -- TMA ---", V2_SEND),
                  ("attn_packed.cu", "L::PLD + 2 * (t & ~1), owner);", "L::PLD + 2 * t, owner);"),
                  ("attn_packed.cu", SENDS, "        hopper::st_async2(dst + 32 * j, oacc[4 * j + 2 * hh], "
                                            "oacc[4 * j + 2 * hh + 1], bar);\n")], True, True),
    # HD = 64: the partial staged in shared memory and sent by one bulk copy an owner
    "staged_partials": ([
        ("attn_packed.cu", "  static constexpr size_t QQ_BYTES = 2 * 64 * QLD * sizeof(bf16);\n",
         "  static constexpr size_t QQ_BYTES = 2 * 64 * QLD * sizeof(bf16);\n"
         "  static constexpr size_t STAGE_BYTES = HD == 64 ? 2 * 64 * PLD * sizeof(float) : 0;\n"),
        ("attn_packed.cu", "QQ_BYTES + 8 * N_BARRIERS;", "QQ_BYTES + STAGE_BYTES + 8 * N_BARRIERS;"),
        ("attn_packed.cu", "PARTIAL_BYTES = 64 * HD * sizeof(float)", "PARTIAL_BYTES = 64 * (HD == 64 ? PLD : HD) * sizeof(float)"),
        ("attn_packed.cu", "  uint64_t* kv_full = reinterpret_cast<uint64_t*>(qq + 2 * 64 * L::QLD);",
         "  float* stage = reinterpret_cast<float*>(qq + 2 * 64 * L::QLD);\n"
         "  uint64_t* kv_full = reinterpret_cast<uint64_t*>(reinterpret_cast<uint8_t*>(stage) + L::STAGE_BYTES);"),
        ("attn_packed.cu", SEND_LOOP, STAGED_SENDS),
        ("attn_packed.cu", "      }\n    }\n    hopper::mbar_wait<true>(pready + h, phase);",
         "      }\n    }\n    }\n    hopper::mbar_wait<true>(pready + h, phase);"),
    ], True, False),
    # no exchange: each block's products alone (the sends kept behind a
    # test that fails, so that the products stay live)
    "products_only": ([
        ("attn_packed.cu", QQ_WAIT, ""),
        ("attn_packed.cu", "        if ((j & 1) == (t & 1)) {", "        if ((j & 1) == (t & 1) && a == 1234.5f) {"),
        ("attn_packed.cu", "    hopper::mbar_wait<true>(pready + h, phase);\n", ""),
        ("attn_packed.cu", "    if (tid == 0 && more) hopper::mbar_arrive_expect_tx(qready + h, L::QQ_DATA_BYTES);", ""),
        ("attn_packed.cu", "    if (tid == 0 && more) hopper::mbar_arrive_expect_tx(pready + h, L::PARTIAL_BYTES);\n", ""),
        ("attn_packed.cu", "  if (reps > 0) publish();", ""),
        ("attn_packed.cu", "    if (more) publish();\n", ""),
    ], False, True),
    # unpacked: 192 keys a block in clusters of 8, two blocks an SM (four 64-row chains)
    "cl8_two_blocks": ([
        ("attn_packed.cu", "static constexpr int MAX_KEYS = HD == 64 ? 384 : 192;", "static constexpr int MAX_KEYS = 192;"),
        ("attn_packed.cu", "__launch_bounds__(THREADS, 1)", "__launch_bounds__(THREADS, HD == 64 ? 2 : 1)"),
        ("attn_packed.cu", "if (T <= 4 * Layout<64>::MAX_KEYS) return launch<64, 4>(",
         "if (T <= 8 * Layout<64>::MAX_KEYS) return launch<64, 8>("),
    ], True, False),
    # no products: the exchange alone
    "exchange_only": ([("attn_packed.cu", "  const int nck = (", "  const int nck = 0 * (")], False, True),
}

STAMPS = [  # (after the first of these lines, stamp index)
    ((QQ_WAIT, "    const bool more = rep + 1 < reps;\n"), 0),
    ((PRODUCTS_DONE,), 1),
    (("    phase ^= 1;\n",), 2),
    (("    if (more) publish();\n", "    phase ^= 1;\n"), 3),
]
TRACE_DECL = "__device__ long long e3_trace[2 * 64 * 4];  // [half][rep][stamp]\n"
TRACE_TAIL = r'''
extern "C" int e3_trace_read(long long* host) {
  return (int)cudaMemcpyFromSymbol(host, e3_trace, sizeof(e3_trace));
}

template <int HD, int CL>
int e3_clusters() {
  auto kernel = attn_pairs_cluster_kernel<HD, CL>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Layout<HD>::SMEM);
  if (CL > 8) cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = CL;
  attr.val.clusterDim.y = attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CL);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = Layout<HD>::SMEM;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  int n = 0;
  const cudaError_t e = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
  return e == cudaSuccess ? n : -(int)e;
}

extern "C" int e3_active_clusters(int packed, int cl) {
  return packed ? e3_clusters<128, 16>() : cl == 8 ? e3_clusters<64, 8>() : e3_clusters<64, 4>();
}
'''


def stamp(i: int) -> str:
    return f"    if (blockIdx.x == 0 && tid == 0 && rep < 64) e3_trace[(h * 64 + rep) * 4 + {i}] = clock64();\n"


def source_of(name: str, subs) -> str:
    """The variant's copy of csrc, substitutions and trace stamps applied."""
    d = os.path.join(OUT, name)
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(CSRC, d)
    for fname, old, new in subs:
        path = os.path.join(d, fname)
        text = open(path).read()
        if old not in text:
            raise RuntimeError(f"variant {name}: {old!r} not in {fname}")
        open(path, "w").write(text.replace(old, new))
    path = os.path.join(d, "attn_packed.cu")
    text = open(path).read()
    text = text.replace("namespace cg = cooperative_groups;\n", "namespace cg = cooperative_groups;\n" + TRACE_DECL)
    for lines, i in STAMPS:
        line = next(x for x in lines if x in text)
        at = text.index(line) + len(line)
        while text.startswith("    if (blockIdx.x == 0 && tid == 0", at):  # after the stamps already there
            at = text.index("\n", at) + 1
        text = text[:at] + stamp(i) + text[at:]
    open(path, "w").write(text + TRACE_TAIL)
    return path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", default=",".join(VARIANTS))
    ap.add_argument("--reps", type=int, default=64)
    ap.add_argument("--grid", type=int, default=320)
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    import torch

    if not torch.cuda.is_available():
        print("chip_trace_e3: no CUDA device", file=sys.stderr)
        return 1
    from whisper_tpu_torch.experiments.attn_packed import block_diagonal
    from whisper_tpu_torch.ops.kernels import attn_packed as e3
    from whisper_tpu_torch.ops.kernels._lib import SIGNATURES

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(card, flush=True)
    names = args.only.split(",")
    procs = {}
    for name in names:
        src = source_of(name, VARIANTS[name][0])
        lib = os.path.join(OUT, name, "libe3.so")
        procs[name] = (lib, subprocess.Popen(
            [NVCC, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
             "-Xptxas", "-v", "-shared", "-o", lib, src, "-lcuda"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    device = torch.device("cuda")
    eps = float(torch.tensor(1e-9, dtype=torch.bfloat16))

    def inputs(g, Q, T, seed):
        gen = torch.Generator(device=device).manual_seed(seed)
        q2 = (torch.randn((g, Q, 128), generator=gen, device=device) * 0.1).to(torch.bfloat16)
        ks = [(torch.randn((g, T, 64), generator=gen, device=device) * 0.1).to(torch.bfloat16) for _ in range(4)]
        return q2, ks, block_diagonal(ks[0], ks[2]), block_diagonal(ks[1], ks[3])

    def call(lib, packed, q2, kv, reps):
        out = torch.empty_like(q2)
        ptrs = [t.data_ptr() for t in kv] + [None] * (4 - len(kv))
        err = lib.attn_pairs(packed, q2.shape[0], q2.shape[1], kv[0].shape[1], reps, eps, q2.data_ptr(), *ptrs,
                             out.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"attn_pairs: cudaError_t {err}")
        return out

    def events_ms(fn, calls=3):
        fn()
        torch.cuda.synchronize()
        best = float("inf")
        for _ in range(calls):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            best = min(best, start.elapsed_time(end))
        return best

    small = inputs(3, 80, 400, 1)
    big = inputs(args.grid, 128, 1536, 0)
    refs = {0: e3.attn_pairs_unpacked_plain(small[0], *small[1], 2).float(),
            1: e3.attn_pairs_packed_plain(small[0], small[2], small[3], 2).float()}
    result = {"card": card}
    for name in names:
        lib_path, proc = procs[name]
        log = proc.communicate()[0]
        if proc.returncode != 0:
            print(f"{name}: build failed\n{log[-3000:]}", flush=True)
            result[name] = "build failed"
            continue
        regs = [line.split("Used")[1].strip() for line in log.splitlines() if "Used" in line and "registers" in line]
        lib = ctypes.CDLL(lib_path)
        lib.attn_pairs.argtypes = SIGNATURES["attn_pairs"]
        lib.e3_trace_read.argtypes = [ctypes.c_void_p]
        row = {"registers": regs}
        if name == names[0]:
            row["active_clusters"] = [lib.e3_active_clusters(0, 4), lib.e3_active_clusters(1, 16)]
        if name == "cl8_two_blocks":
            row["active_clusters"] = [lib.e3_active_clusters(0, 8)]
        same, packed_too = VARIANTS[name][1], VARIANTS[name][2]
        for packed in (0, 1) if packed_too else (0,):
            kv_small = small[1] if packed == 0 else small[2:]
            kv_big = big[1] if packed == 0 else big[2:]
            out = call(lib, packed, small[0], kv_small, 2).float()
            err = ((out - refs[packed]).abs().max() / refs[packed].abs().max()).item()
            ms = events_ms(lambda: call(lib, packed, big[0], kv_big, args.reps))
            trace = torch.zeros(2 * 64 * 4, dtype=torch.int64)
            lib.e3_trace_read(trace.data_ptr())
            t = trace.view(2, 64, 4).double()
            reps = min(args.reps, 64)
            phases = {}
            for h in range(2):
                d = t[h, :reps]
                parts = {"products": d[:, 1] - d[:, 0], "partials_in": d[:, 2] - d[:, 1],
                         "reduce_publish": d[:, 3] - d[:, 2]}
                if reps > 1:
                    parts["qq_wait"] = d[1:, 0] - d[:-1, 3]
                    parts["rep"] = d[1:, 0] - d[:-1, 0]
                phases[h] = {k: float(v.median()) for k, v in parts.items()}
            label = "packed" if packed else "unpacked"
            row[label] = {"ms": ms, "rel_err": err, "cycles": phases}
            print(f"{name} {label}: {ms:.4f} ms at g={args.grid} reps={args.reps}; relative error at (3, 80, 400) "
                  f"reps 2 {err:.3e}{'' if same else ' (not the same function)'}; median cycles, block 0 "
                  f"(half 0 / half 1): " + ", ".join(
                      f"{k} {phases[0][k]:.0f}/{phases[1][k]:.0f}" for k in phases[0]), flush=True)
        print(f"{name}: registers {regs}" + (f"; clusters at once (unpacked, packed): "
                                              f"{row['active_clusters']}" if "active_clusters" in row else ""),
              flush=True)
        result[name] = row
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
