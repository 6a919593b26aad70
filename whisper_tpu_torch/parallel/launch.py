"""Start one process per rank of a mesh and collect what each returns.

``torchrun --nproc-per-node N`` is the launcher for a program (the server's
``--mesh``); :func:`run_ranks` is the one for a caller that wants each
rank's result back, as the tests and ``chip_smoke.py`` do.  A rank that
raises, dies or outlives the timeout brings the others down: the parent
terminates every rank and raises with the failing rank's traceback, so no
collective waits for a peer that will never come.
"""

import os
import queue as queue_mod
import time
import traceback
from typing import Any, Callable, Dict, List, Sequence

import torch.multiprocessing as mp

from .mesh import free_port


def _child(fn: Callable, rank: int, world: int, port: int, args: Sequence, results) -> None:
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(rank),
                      LOCAL_RANK=str(rank), WORLD_SIZE=str(world))
    try:
        results.put((rank, True, fn(rank, *args)))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn: Callable, nprocs: int, args: Sequence = (), *, timeout: float = 600.0) -> List[Any]:
    """Run ``fn(rank, *args)`` in ``nprocs`` spawned processes, with
    ``MASTER_ADDR``/``MASTER_PORT`` (a free localhost port), ``RANK``,
    ``LOCAL_RANK`` and ``WORLD_SIZE`` set, so that
    :func:`~.mesh.make_mesh` in ``fn`` joins them; returns the ranks' return
    values (picklable) in rank order.  ``fn`` must be importable by name
    (a module's top-level function)."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_child, args=(fn, r, nprocs, port, tuple(args), results), daemon=True)
             for r in range(nprocs)]
    for p in procs:
        p.start()
    out: Dict[int, Any] = {}
    failure = None
    deadline = time.monotonic() + timeout
    try:
        while len(out) < nprocs and failure is None:
            try:
                # a rank that ends puts its result first: a dead rank's result may
                # still be on its way, so wait a moment longer before calling it lost
                gone = [r for r, p in enumerate(procs) if r not in out and p.exitcode is not None]
                rank, ok, value = results.get(timeout=5.0 if gone else 0.5)
            except queue_mod.Empty:
                if gone:
                    failure = f"rank {gone[0]} exited with code {procs[gone[0]].exitcode}"
                elif time.monotonic() > deadline:
                    failure = f"ranks {sorted(set(range(nprocs)) - set(out))} still running after {timeout} s"
                continue
            if ok:
                out[rank] = value
            else:
                failure = f"rank {rank} raised:\n{value}"
    finally:
        for p in procs:
            if failure is not None and p.is_alive():
                p.terminate()
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
    if failure is not None:
        raise RuntimeError(f"run_ranks({getattr(fn, '__name__', fn)}, {nprocs}): {failure}")
    return [out[r] for r in range(nprocs)]
