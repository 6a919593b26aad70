"""The knee of a serving cell: its traffic at a list of rates, one model
and one server set up once, each rate an open-loop window of its own.

    python3 benchmark/sweep.py --workload turbo.serve.short --seed 7 --seconds 8 \\
        --rates 20 30 40 50 60 70

For each rate it prints one JSON line: requests, p50 and p95 latency,
rows a batch, the rate of answers over the window, and how long after the
last due time the last answer came (a backlog that grows through the
window shows there).  The knee is the highest rate whose answers keep up;
a serving cell runs at about four fifths of it, a number in its traffic
file.  Needs a CUDA card.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    args = ap.parse_args()
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [ROOT] + [p for p in sys.path if os.path.abspath(p or ".") != here]
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    from benchmark.harness import cell, spec, traffic

    c = spec.Cell(args.workload)
    run = cell.Run(c, args.seed, args.seconds, False, torch.device("cuda", 0), T0)
    run.setup()
    print("\n".join(run.log), file=sys.stderr)
    for k, rate in enumerate(args.rates):
        c.mix["rate_per_s"] = rate
        sched = traffic.open_schedule(args.seed, c.mix, args.seconds, stream=100 + k)
        clips = traffic.clips(args.seed, sched["lengths"], run.wave, stream=100 + k)
        stats0 = dict(run.batcher.stats)
        out = run.kind.send(run.batcher, sched, clips)
        lat = np.array(out["latencies"])
        batches = run.batcher.stats["batches"] - stats0["batches"]
        print(json.dumps({
            "workload": args.workload, "rate_per_s": rate, "requests": len(clips),
            "failed": out["failed"], "p50_s": float(np.percentile(lat, 50)),
            "p95_s": float(np.percentile(lat, 95)), "max_s": float(lat.max()),
            "rows_per_batch": len(clips) / max(batches, 1),
            "answers_per_s": len(clips) / out["wall_s"],
            "last_answer_after_last_due_s": out["wall_s"] - float(sched["due"][-1]),
            "sender_late_ms": 1e3 * out["late_s"],
        }), flush=True)
    run.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
