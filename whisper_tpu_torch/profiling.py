"""Tracing and performance reporting.

Counterpart of ``whisper_tpu/profiling.py``:

- :func:`span`: the one call by which each layer of the port marks a
  stretch of its work (the server's fill window and rounds, the batching
  stages, the engine's encoder, prefill and token steps); with no recorder
  installed it does nothing and costs one global read;
- :func:`recording`: installs a recorder (a :class:`StageTimer`) for the
  whole process, every thread included, or for the calling thread alone;
  each span is then a profiler range (``record_function``'s, opened from
  C++) named ``whisper.<name>``, on the clock of any running torch
  profiler, and a stage of the recorder;
- :class:`StageTimer`: time per named stage, from CUDA events on a CUDA
  device (for every stage, or the stages named) and from the host's clock
  otherwise, with the real-time factor in its report (also the
  ``stage_timer=`` of ``transcribe_batch`` and
  ``engine.decode_engine_speculative``, which record the calling thread's
  spans into it for the call);
- :func:`trace`: a ``torch.profiler`` trace of the host and the card,
  written as a Chrome trace (open it in Perfetto or chrome://tracing);
- :func:`device_memory_stats`: the card's allocator statistics.
"""

import contextlib
import os
import tempfile
import threading
import time
from collections import defaultdict
from typing import Collection, Dict, Iterator, Optional, Tuple, Union

import torch
from torch.autograd.profiler import record_function

try:  # the same range opened from C++: about a tenth of record_function's cost
    from torch._C._profiler import _RecordFunctionFast as _range
except ImportError:
    _range = record_function

SPAN_PREFIX = "whisper."

_lock = threading.Lock()
# the open installs of recording(), oldest first: (recorder, the thread it
# records or None for every thread); replaced whole under _lock, never
# changed in place, so that span() reads it without the lock
_installs: Tuple[Tuple[object, Optional[int]], ...] = ()
_NULL = contextlib.nullcontext()


def span(name: str):
    """A context manager around one stretch of the port's work.  With no
    recorder installed: one shared null context, which opens no
    profiler range and allocates nothing.  Under :func:`recording`: a
    profiler range ``whisper.<name>`` around the recorder's
    ``stage(name)``, the recorder being the newest install that covers the
    calling thread."""
    installs = _installs
    if not installs:
        return _NULL
    thread = threading.get_ident()
    for recorder, only in reversed(installs):
        if only is None or only == thread:
            return _Span(name, recorder)
    return _NULL


class _Span:
    __slots__ = ("_range", "_stage")

    def __init__(self, name: str, recorder):
        self._range = _range(SPAN_PREFIX + name)
        self._stage = recorder.stage(name)

    def __enter__(self):
        self._range.__enter__()
        self._stage.__enter__()

    def __exit__(self, *exc):
        try:
            self._stage.__exit__(*exc)
        finally:
            self._range.__exit__(*exc)


@contextlib.contextmanager
def recording(recorder, this_thread: bool = False) -> Iterator[None]:
    """Install ``recorder`` (any object whose ``.stage(name)`` is a context
    manager, such as a :class:`StageTimer`) for the whole process, so that
    the spans of every thread record into it; with ``this_thread``, for the
    calling thread alone (the ``stage_timer=`` of one call).  Installs may
    nest and may come and go from several threads in any order: a thread's
    spans go to the newest open install that covers it, and on exit this
    install alone is taken away.  ``recorder`` None installs nothing."""
    global _installs
    if recorder is None:
        yield
        return
    entry = (recorder, threading.get_ident() if this_thread else None)
    with _lock:
        _installs = _installs + (entry,)
    try:
        yield
    finally:
        with _lock:
            _installs = tuple(e for e in _installs if e is not entry)


class StageTimer:
    """Accumulates time per named stage.

    On a CUDA ``device`` (the default) each stage is timed by two CUDA
    events on the device's current stream: the time the card spent between
    the stage's entry and its exit, the stage's queued work included,
    without a host sync per stage; the events are read when ``totals`` or
    :meth:`report` is asked for.  ``card_stages`` names the stages so timed
    (default: every stage); the others, and every stage on the CPU, take
    the host's clock, which costs a few microseconds a stage against about
    forty for the events.

    Stages may nest and may come from several threads at once.  Each thread
    keeps its own stack of open stages, and the report's ``total_seconds``
    sums only the stages opened with none open on their thread, so that a
    stage inside another never counts twice.
    """

    def __init__(self, device: Union[str, torch.device] = "cuda",
                 card_stages: Optional[Collection[str]] = None):
        self.device = torch.device(device)
        self._events = self.device.type == "cuda"
        self._card_stages = None if card_stages is None else frozenset(card_stages)
        self._lock = threading.Lock()
        self._local = threading.local()  # .open: this thread's count of open stages
        self._totals: Dict[str, float] = defaultdict(float)
        self._top = 0.0  # seconds of the stages opened with no parent
        self.counts: Dict[str, int] = defaultdict(int)
        self._pending = []  # (name, top, start event, end event), not yet read

    def stage(self, name: str):
        if self._events and (self._card_stages is None or name in self._card_stages):
            return _CardStage(self, name)
        return _HostStage(self, name)

    def _enter(self) -> bool:
        """Counts a stage open on this thread; whether it has no parent."""
        local = self._local
        depth = getattr(local, "open", 0)
        local.open = depth + 1
        return depth == 0

    def _add(self, name: str, top: bool, seconds: float) -> None:
        """Under the lock."""
        self._totals[name] += seconds
        if top:
            self._top += seconds

    @property
    def totals(self) -> Dict[str, float]:
        """Seconds per stage (waits for the stages' events on the card)."""
        with self._lock:
            pending, self._pending = self._pending, []
        for _, _, _, end in pending:
            end.synchronize()
        with self._lock:
            for name, top, start, end in pending:
                self._add(name, top, start.elapsed_time(end) / 1e3)
            return dict(self._totals)

    def report(self, audio_seconds: Optional[float] = None) -> Dict[str, float]:
        """``<stage>_seconds`` for every stage; ``total_seconds``, the sum of
        the stages opened with no parent on their thread; with
        ``audio_seconds``, the real-time factor ``rtf`` against that
        total."""
        totals = self.totals
        out = {f"{k}_seconds": round(v, 4) for k, v in totals.items()}
        with self._lock:
            total = self._top
        out["total_seconds"] = round(total, 4)
        if audio_seconds is not None and total > 0:
            out["audio_seconds"] = round(audio_seconds, 3)
            out["rtf"] = round(audio_seconds / total, 2)
        return out


class _HostStage:
    """A stage on the host's clock."""

    __slots__ = ("timer", "name", "top", "t0")

    def __init__(self, timer: StageTimer, name: str):
        self.timer, self.name = timer, name

    def __enter__(self):
        self.top = self.timer._enter()
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        seconds = time.perf_counter() - self.t0
        timer = self.timer
        timer._local.open -= 1
        with timer._lock:
            timer._add(self.name, self.top, seconds)
            timer.counts[self.name] += 1


class _CardStage:
    """A stage between two CUDA events on the device's current stream."""

    __slots__ = ("timer", "name", "top", "stream", "start")

    def __init__(self, timer: StageTimer, name: str):
        self.timer, self.name = timer, name

    def __enter__(self):
        self.top = self.timer._enter()
        self.stream = torch.cuda.current_stream(self.timer.device)
        self.start = torch.cuda.Event(enable_timing=True)
        self.start.record(self.stream)

    def __exit__(self, *exc):
        timer = self.timer
        timer._local.open -= 1
        end = torch.cuda.Event(enable_timing=True)
        end.record(self.stream)
        with timer._lock:
            timer._pending.append((self.name, self.top, self.start, end))
            timer.counts[self.name] += 1


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None) -> Iterator[str]:
    """Profile the block with ``torch.profiler`` (the host, and the card
    when there is one) and write ``trace.json`` (Chrome trace format) into
    ``log_dir``, by default a directory under the temporary directory.
    Yields the directory.  Inside :func:`recording` the port's spans are in
    the trace as ``whisper.<name>`` ranges."""
    from torch.profiler import ProfilerActivity, profile

    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "whisper_tpu_torch_trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def device_memory_stats(device: Union[None, str, torch.device] = None) -> Dict[str, int]:
    """The CUDA caching allocator's statistics of ``device`` (the current
    card by default), ``torch.cuda.memory_stats``; empty without a card
    or for a CPU device."""
    if device is not None and torch.device(device).type != "cuda":
        return {}
    if not torch.cuda.is_available():
        return {}
    return dict(torch.cuda.memory_stats(device))
