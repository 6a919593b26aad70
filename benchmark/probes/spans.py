"""The port's own spans over a traced window: a ``profiling.StageTimer`` on
the run's device, as ``run.timer``, installed with ``profiling.recording``,
so that the spans of every thread of the port record into it and show in
the trace as ``whisper.<name>`` ranges on the profiler's clock.
``engine.step_host_ms`` reads the ``whisper.step`` ranges and
``encoder.ms_per_window`` the timer's ``encoder`` stage.  Only that stage
is timed by CUDA events; the others take the host's clock, a few
microseconds a span against about forty for the events, so that recording
changes the traced window's host work little.

A port from before these spans and the server's queue counters has no
source for the metrics that read them.  There they are left out of the
run's line, with a line in the log, rather than read as silent: a metric
that reads nothing where its source exists still stops the run."""

import contextlib

SPAN_METRICS = ("engine.step_host_ms", "encoder.ms_per_window")
# BatchingTranscriber.stats["taken"] and ["queue_wait_s"]
COUNTER_METRICS = ("serve.queue_wait_ms",)


def _leave_out(run, names) -> None:
    out = [m["name"] for m in run.cell.per_layer if m["name"] in names]
    if out:
        run.cell.per_layer = [m for m in run.cell.per_layer if m["name"] not in names]
        run.log.append(f"the port has no source for {out}: left out of the line")


@contextlib.contextmanager
def install(run):
    from whisper_tpu_torch import profiling

    batcher = getattr(run, "batcher", None)
    if batcher is not None and "queue_wait_s" not in batcher.stats:
        _leave_out(run, COUNTER_METRICS)
    recording = getattr(profiling, "recording", None)
    if recording is None:
        _leave_out(run, SPAN_METRICS)
        yield
        return
    run.timer = profiling.StageTimer(run.device, card_stages=("encoder",))
    with recording(run.timer):
        yield
