"""The readers of the port's spans and queue counters (``engine.step_host_ms``,
``encoder.ms_per_window``, ``serve.queue_wait_ms``) on a made-up trace, the
probe that records the spans, and a tiny traced window on the CPU."""

import contextlib
import time
from types import SimpleNamespace

import pytest
import torch

from benchmark.harness import cell, spec, trace
from conftest import tiny
from test_portbench_arith import _Event

NEW = ("engine.step_host_ms", "encoder.ms_per_window", "serve.queue_wait_ms")


def reader(name):
    return spec.metric_reader(name)


def spans_probe():
    return next(p for p in spec.probes() if p.__name__.endswith("_spans"))


def test_span_readers_on_a_made_up_trace():
    t = trace.Trace([
        _Event(trace.WINDOW, 1.0, 10.0, False),
        _Event("whisper.step", 0.5, 1.0, False),  # opened before the window: not counted
        _Event("whisper.step", 2.0, 0.003, False),
        _Event("whisper.filters", 2.0, 0.001, False),
        _Event("whisper.step", 3.0, 0.001, False, thread=2),
        _Event("whisper.sync", 3.001, 0.5, False),
        _Event("whisper.step", 10.5, 1.0, False),  # closed after the window: not counted
    ])
    timer = SimpleNamespace(totals={"encoder": 0.03, "step": 1.0})
    run = SimpleNamespace(trace=t, timer=timer, rounds=SimpleNamespace(audios=[2, 1]),
                          stats={"taken": 4, "queue_wait_s": 0.8, "requests": 5, "batches": 2})
    assert reader("engine.step_host_ms")(run) == pytest.approx(2.0)
    assert reader("encoder.ms_per_window")(run) == pytest.approx(10.0)
    assert reader("serve.queue_wait_ms")(run) == pytest.approx(200.0)


@pytest.mark.parametrize("name", NEW)
def test_span_readers_read_nothing_where_there_is_nothing(name):
    t = trace.Trace([_Event(trace.WINDOW, 0.0, 1.0, False), _Event("aten::mm", 0.1, 0.1, False)])
    empty = SimpleNamespace(trace=t, timer=SimpleNamespace(totals={}),
                            rounds=SimpleNamespace(audios=[]), stats={"taken": 0, "queue_wait_s": 0.0})
    assert reader(name)(empty) is None
    assert reader(name)(SimpleNamespace(trace=None, stats={})) is None


def _bare_run():
    c = spec.Cell("turbo.serve.short")
    batcher = SimpleNamespace(stats={"requests": 0, "batches": 0, "errors": 0})
    return SimpleNamespace(cell=c, device=torch.device("cpu"), batcher=batcher, log=[])


def test_the_probe_records_the_ports_spans_for_its_window():
    from whisper_tpu_torch import profiling

    run = _bare_run()
    run.batcher.stats.update(taken=0, queue_wait_s=0.0)
    with spans_probe().install(run):
        with profiling.span("encoder"):
            pass
    with profiling.span("encoder"):  # after the window: not recorded
        pass
    assert run.timer.counts["encoder"] == 1
    assert {m["name"] for m in run.cell.per_layer} >= {"encoder.ms_per_window", "serve.queue_wait_ms"}


def test_a_port_without_spans_or_queue_counters_leaves_their_metrics_out(monkeypatch):
    """A port from before the spans and the counters (the metrics' parent)
    gives a line without them, not a silent metric."""
    from whisper_tpu_torch import profiling

    monkeypatch.delattr(profiling, "recording")
    run = _bare_run()
    with spans_probe().install(run):
        pass
    names = {m["name"] for m in run.cell.per_layer}
    assert not names & set(NEW) and "serve.rows_per_batch" in names
    assert not hasattr(run, "timer") and "left out of the line" in run.log[0]


def test_a_tiny_traced_serving_window_reads_the_spans_and_the_queue():
    r = cell.Run(tiny("serve"), 2**31 + 97, 0.5, True, torch.device("cpu"), time.perf_counter())
    r.setup(warm=False)
    with contextlib.ExitStack() as stack:
        stack.callback(r.close)
        r.window()
    values = {name: reader(name)(r) for name in NEW}
    assert all(v is not None and v > 0 for v in values.values()), values
    assert r.stats["taken"] == r.stats["requests"] == len(r.files)
    # the queue wait holds at least the part of the fill window a request waits
    assert values["serve.queue_wait_ms"] < 1e3 * (r.cell.mix["max_wait_s"] + r.wall_s)
    host = {name for name, _, _, _ in r.trace.host}
    assert {"whisper.fill", "whisper.round", "whisper.encoder", "whisper.step"} <= host
