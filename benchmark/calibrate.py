"""The readings that a cell's correctness limits are set from, all in one
process at the cell's own traffic and sizes, each with a short window:
the port as the configuration states it (``--seeds``, a dozen or more),
the control (``--control-seeds``, three or more: the reference with
float8 products put in the port's place), and the port with each planted
fault of the cell's model family (``FAULTS`` of ``families/<family>.py``,
``--fault-seeds``).

    python3 benchmark/calibrate.py --workload large-v3.batch16 --seconds 1 \\
        --seeds 11 12 13 ... --control-seeds 21 22 23 --fault-seeds 31 32 33

One JSON line a seed and side (``program``, ``control``, or
``fault:<name>``): each number compared with the reference
(``judge`` of the family) and whether the cell's limits pass it.  A limit
lies above the largest reading of the port and below the smallest of the
control; ``PERF.md`` records both, and the faults' readings beside them.
Needs a CUDA card.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args()
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [ROOT] + [p for p in sys.path if os.path.abspath(p or ".") != here]
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    from benchmark.harness import cell, check, spec

    device = torch.device("cuda", 0)
    c = spec.Cell(args.workload)
    faults = c.family.FAULTS
    sides = [("program", s) for s in args.seeds] + [("control", s) for s in args.control_seeds] + \
            [(f"fault:{name}", s) for name in faults for s in args.fault_seeds]
    for side, seed in sides:
        t = time.perf_counter()
        fault = faults[side[6:]]() if side.startswith("fault:") else contextlib.nullcontext()
        run = cell.Run(c, seed, args.seconds, False, device, t)
        with fault:
            run.setup(warm=False)
            run.window()
        run.close()
        checks = run.judge("fp8" if side == "control" else None)
        print(json.dumps({"workload": args.workload, "side": side, "seed": seed,
                          "requests": len(run.files), "seconds": time.perf_counter() - t,
                          "correct": check.passed(checks), **run.readings, "log": run.log[-1]}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
