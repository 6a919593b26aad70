"""whisper_tpu_torch.profiling: the cases of tests/test_profiling.py on
the CPU (the host's clock), the trace file, the StageTimer on a
speculative decode's stages, and the spans: off without a recorder, on
under ``recording`` from every thread, nested without counting twice.  On
the card the timer reads CUDA events (tests/test_torch_cuda.py); the spans
of transcribe_batch and of the server are tests/test_torch_batch.py's and
tests/test_torch_serve.py's."""

import json
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from whisper_tpu_torch import profiling
from whisper_tpu_torch.profiling import StageTimer, device_memory_stats, recording, span, trace


def test_stage_timer():
    timer = StageTimer("cpu")
    with timer.stage("front_end"):
        time.sleep(0.01)
    with timer.stage("decode"):
        time.sleep(0.02)
    with timer.stage("decode"):
        time.sleep(0.02)
    report = timer.report(audio_seconds=30.0)
    assert report["decode_seconds"] >= 0.04
    assert timer.counts["decode"] == 2
    assert report["rtf"] > 0
    assert report["total_seconds"] >= report["front_end_seconds"]


def test_device_memory_stats_shape():
    stats = device_memory_stats()
    assert isinstance(stats, dict)
    assert device_memory_stats("cpu") == {}


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(str(tmp_path / "trace")) as log_dir:
        torch.ones(64, 64) @ torch.ones(64, 64)
    with open(os.path.join(log_dir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)


def test_stage_timer_takes_the_speculative_stages(monkeypatch):
    """decode_engine_speculative(stage_timer=) times its encoder, prefill,
    draft, verify and accept stages, the last three once per round."""
    from whisper_tpu_torch import decoding
    from whisper_tpu_torch.decoding import DecodingOptions, DecodingTask
    from whisper_tpu_torch.models.dims import ModelDimensions
    from whisper_tpu_torch.models.whisper import Whisper, init_params

    dims = ModelDimensions(n_mels=80, n_audio_ctx=1500, n_audio_state=64, n_audio_head=2,
                           n_audio_layer=1, n_vocab=51865, n_text_ctx=448, n_text_state=64,
                           n_text_head=2, n_text_layer=1)
    model = Whisper(dims, init_params(dims, torch.Generator().manual_seed(0)))
    timer = StageTimer("cpu")
    real = decoding.decode_engine_speculative
    monkeypatch.setattr(decoding, "decode_engine_speculative",
                        lambda *a, **k: real(*a, stage_timer=timer, **k))
    mel = torch.from_numpy(np.random.RandomState(0).randn(1, 80, 3000).astype(np.float32))
    options = DecodingOptions(language="en", temperature=0.0, sample_len=9)
    result = DecodingTask(model, options, draft_model=model).run(mel)[0]
    rounds = timer.counts["verify"]
    assert timer.counts["encoder"] == timer.counts["prefill"] == 1
    assert timer.counts["draft"] == timer.counts["accept"] == rounds >= len(result.tokens) / 5
    assert set(timer.report()) >= {f"{k}_seconds" for k in ("encoder", "prefill", "draft", "verify",
                                                            "accept", "total")}


def test_a_span_without_a_recorder_is_one_shared_null_context(monkeypatch):
    """With no recorder a span opens no record_function range: it is the
    module's one null context, whatever its name."""
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) opened with no recorder")

    monkeypatch.setattr(profiling, "_range", refuse)
    assert span("step") is span("encoder") is profiling._NULL
    with span("step"):
        pass
    with recording(StageTimer("cpu")), pytest.raises(AssertionError, match="whisper.step"):
        with span("step"):
            pass
    assert span("step") is profiling._NULL


def test_recording_restores_the_recorder_before_it():
    outer, inner = StageTimer("cpu"), StageTimer("cpu")
    with recording(outer):
        with recording(inner):
            with span("a"):
                pass
        with span("b"):
            pass
    assert dict(inner.counts) == {"a": 1} and dict(outer.counts) == {"b": 1}
    assert profiling._installs == ()


def test_installs_that_overlap_out_of_order_across_threads_all_go():
    """Thread 1 installs A, thread 2 installs B, thread 1 leaves, then
    thread 2: each exit takes its own install away, whatever the order, so
    none is left behind."""
    a, b = StageTimer("cpu"), StageTimer("cpu")
    entered_a, entered_b, left_a = threading.Event(), threading.Event(), threading.Event()

    def first():
        with recording(a):
            entered_a.set()
            entered_b.wait(10)
        left_a.set()

    def second():
        entered_a.wait(10)
        with recording(b):
            entered_b.set()
            left_a.wait(10)
            with span("after_a_left"):
                pass

    workers = [threading.Thread(target=first), threading.Thread(target=second)]
    for w in workers:
        w.start()
    for w in workers:
        w.join(timeout=30)
    assert not any(w.is_alive() for w in workers)
    assert profiling._installs == () and span("x") is profiling._NULL
    assert dict(b.counts) == {"after_a_left": 1} and not a.counts


def test_an_install_for_this_thread_records_no_other_thread():
    """The stage_timer= of one call records its own thread's spans; a
    server's worker thread keeps recording into the process's recorder."""
    process, call = StageTimer("cpu"), StageTimer("cpu")

    def worker():
        with span("fill"):
            pass

    with recording(process):
        with recording(call, this_thread=True):
            with span("engine"):
                pass
            w = threading.Thread(target=worker)
            w.start()
            w.join(timeout=30)
        with span("round"):
            pass
    assert dict(call.counts) == {"engine": 1}
    assert dict(process.counts) == {"fill": 1, "round": 1}
    with recording(None):
        assert span("x") is profiling._NULL


def test_a_card_timer_times_only_its_card_stages_by_events():
    """A timer of the card whose events are kept for the stages named takes
    the host's clock for the others: here, with no card, they still work."""
    timer = StageTimer("cuda", card_stages=("encoder",))
    with recording(timer):
        with span("step"):
            with span("filters"):
                time.sleep(0.002)
    report = timer.report()
    assert report["step_seconds"] >= report["filters_seconds"] >= 0.002
    assert report["total_seconds"] == report["step_seconds"]


@pytest.mark.parametrize("threads", [1, 4])
def test_nested_spans_count_once_in_the_total(threads):
    """total_seconds sums the spans opened with no parent on their thread:
    nesting never changes it, and each thread's top-level spans add up."""
    timer = StageTimer("cpu")

    def work():
        with span("outer"):
            with span("inner"):
                time.sleep(0.01)
                with span("innermost"):
                    time.sleep(0.005)
            with span("inner"):
                time.sleep(0.005)

    with recording(timer):
        workers = [threading.Thread(target=work) for _ in range(threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=30)
    assert not any(w.is_alive() for w in workers)
    report = timer.report(audio_seconds=1.0)
    assert dict(timer.counts) == {"outer": threads, "inner": 2 * threads, "innermost": threads}
    assert report["total_seconds"] == pytest.approx(report["outer_seconds"], abs=1e-4)
    totals = timer.totals  # unrounded: inner and outer differ by microseconds
    assert totals["innermost"] < totals["inner"] < totals["outer"]
    assert report["rtf"] == pytest.approx(1.0 / report["total_seconds"], rel=1e-2)


def test_a_timer_loses_no_stage_under_many_threads():
    """More threads than cores record at once, switching often: every
    stage is counted, and the total is the top-level stages' sum."""
    timer = StageTimer("cpu")
    n_threads, n_spans = 4 * (os.cpu_count() or 1), 200
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with recording(timer):
            def work():
                for _ in range(n_spans):
                    with span("top"):
                        with span("nested"):
                            pass
            workers = [threading.Thread(target=work) for _ in range(n_threads)]
            for w in workers:
                w.start()
            for w in workers:
                w.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(w.is_alive() for w in workers)
    assert timer.counts["top"] == timer.counts["nested"] == n_threads * n_spans
    totals = timer.totals
    assert timer.report()["total_seconds"] == pytest.approx(round(totals["top"], 4), abs=1e-4)


def test_spans_are_ranges_of_the_chrome_trace(tmp_path):
    with trace(str(tmp_path / "trace")) as log_dir, recording(StageTimer("cpu")):
        with span("step"):
            with span("filters"):
                torch.ones(8, 8) @ torch.ones(8, 8)
    with open(os.path.join(log_dir, "trace.json")) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"whisper.step", "whisper.filters"} <= names
