"""Benchmark of whisper_tpu_torch on one NVIDIA H100.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of BENCHMARK.json and prints one JSON object as the last
line of standard output: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer metrics), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``, each number of the comparison with its limit (also the last
lines of standard error).  Without a CUDA card it exits 2 and prints no
result; where a per-layer metric of the cell reads nothing, it exits 4.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # the checkout's root, not this folder, whose data folders would shadow modules
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [ROOT] + [p for p in sys.path if os.path.abspath(p or ".") != here]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
        print("no CUDA card: this benchmark measures an H100 and has no CPU fallback", file=sys.stderr)
        return 2
    from benchmark.harness import cell, spec

    try:
        out = cell.run(spec.Cell(args.workload), args.seed, args.seconds, bool(args.trace),
                       torch.device("cuda", 0), T0)
    except cell.SilentMetric as e:
        print(e, file=sys.stderr)
        return 4
    bad = cell.forbidden_modules()
    if bad:
        print(f"modules of JAX or the JAX package were loaded: {bad}", file=sys.stderr)
        return 3
    for line in out.pop("_log"):
        print(line, file=sys.stderr)
    for c in out["checks"].values():  # JSON has no infinity: a gap with no bound reads 1e300
        c["value"] = c["value"] if math.isfinite(c["value"]) else 1e300
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
