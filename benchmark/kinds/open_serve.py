"""open_serve: a speech API.  A sender thread submits clips to
``serve.BatchingTranscriber`` at the due times of an open loop
(``traffic.open_schedule``); each request's latency runs from its due time
to its result.  End to end: ``latency_p50_s`` and ``latency_p95_s`` over
every request due in the window."""

import threading
import time
from concurrent.futures import wait as wait_futures
from typing import List, Optional

import numpy as np

from benchmark.harness import traffic


def setup(run, warm: bool) -> None:
    """The server; with ``warm``, every batch size it can form at the
    mix's clips, then its own loop at the mix's rate (set-up)."""
    from whisper_tpu_torch import transcribe_batch
    from whisper_tpu_torch.serve import BatchingTranscriber

    mix = run.cell.mix
    run.batcher = BatchingTranscriber(run.model, batch_size=mix["batch_size"],
                                      max_wait_s=mix["max_wait_s"], **run.options())
    if not warm:
        return
    sched = traffic.open_schedule(run.seed, mix, mix["warmup_s"], stream=1)
    clips = traffic.clips(run.seed, sched["lengths"], run.wave, stream=1)
    for k in range(1, mix["batch_size"] + 1):
        transcribe_batch(run.model, [clips[i % len(clips)] for i in range(k)],
                         batch_size=mix["batch_size"], **run.options())
    send(run.batcher, sched, clips)


def send(batcher, sched, clips) -> dict:
    """Open loop: a sender thread submits each clip at its due time; the
    latency of each runs from its due time to its result.  Waits for
    every answer, at most a minute past the last due time."""
    n = len(clips)
    done: List[Optional[float]] = [None] * n
    futures: list = [None] * n
    late = [0.0]
    start = time.perf_counter() + 0.02

    def sender():
        for i in range(n):
            due = start + sched["due"][i]
            delay = due - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
            late[0] = max(late[0], time.perf_counter() - due)
            fut = batcher.submit(clips[i])
            fut.add_done_callback(lambda _f, i=i: done.__setitem__(i, time.perf_counter()))
            futures[i] = fut

    th = threading.Thread(target=sender, name="bench-sender")
    th.start()
    th.join()
    wait_futures(futures, timeout=max(0.0, start + sched["due"][-1] + 60 - time.perf_counter()))
    results, latencies, failed = [], [], 0
    for i, fut in enumerate(futures):
        if fut.done() and fut.exception() is None and done[i] is not None:
            results.append(fut.result())
            latencies.append(done[i] - (start + sched["due"][i]))
        else:
            results.append(fut.exception() if fut.done() else None)
            failed += 1
    return dict(results=results, latencies=latencies, failed=failed, late_s=late[0],
                wall_s=time.perf_counter() - start)


def window(run) -> None:
    sched = traffic.open_schedule(run.seed, run.cell.mix, run.seconds, stream=0)
    run.files = traffic.clips(run.seed, sched["lengths"], run.wave, stream=0)
    out = send(run.batcher, sched, run.files)
    run.results, run.latencies, run.failed = out["results"], out["latencies"], out["failed"]
    run.wall_s = out["wall_s"]
    run.log.append(f"sender at most {out['late_s'] * 1e3:.3f} ms late; "
                   f"{len(run.files)} requests over {run.wall_s:.3f} s")


def values(run) -> dict:
    if not run.latencies:
        return {}
    return {"latency_p50_s": float(np.percentile(run.latencies, 50)),
            "latency_p95_s": float(np.percentile(run.latencies, 95))}


def close(run) -> None:
    run.batcher.close()
    del run.batcher
