"""Tracing and performance reporting.

Counterpart of ``whisper_tpu/profiling.py``:

- :class:`StageTimer`: time per named stage (any ``stage_timer=`` of
  ``transcribe_batch`` or ``engine.decode_engine_speculative``), from CUDA
  events on a CUDA device and from the host's clock on the CPU, with the
  real-time factor in its report;
- :func:`trace`: a ``torch.profiler`` trace of the host and the card,
  written as a Chrome trace (open it in Perfetto or chrome://tracing);
- :func:`device_memory_stats`: the card's allocator statistics.
"""

import contextlib
import os
import tempfile
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional, Union

import torch


class StageTimer:
    """Accumulates time per named stage.

    On a CUDA ``device`` (the default) each stage is timed by two CUDA
    events on the device's current stream: the time the card spent between
    the stage's entry and its exit, the stage's queued work included,
    without a host sync per stage; the events are read when ``totals`` or
    :meth:`report` is asked for.  On the CPU, the host's clock.
    """

    def __init__(self, device: Union[str, torch.device] = "cuda"):
        self.device = torch.device(device)
        self._totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self._pending = []  # (name, start event, end event), not yet read

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        if self.device.type == "cuda":
            stream = torch.cuda.current_stream(self.device)
            start = torch.cuda.Event(enable_timing=True)
            start.record(stream)
            try:
                yield
            finally:
                end = torch.cuda.Event(enable_timing=True)
                end.record(stream)
                self._pending.append((name, start, end))
                self.counts[name] += 1
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    @property
    def totals(self) -> Dict[str, float]:
        """Seconds per stage (waits for the stages' events on the card)."""
        for name, start, end in self._pending:
            end.synchronize()
            self._totals[name] += start.elapsed_time(end) / 1e3
        self._pending.clear()
        return self._totals

    def report(self, audio_seconds: Optional[float] = None) -> Dict[str, float]:
        totals = self.totals
        out = {f"{k}_seconds": round(v, 4) for k, v in totals.items()}
        total = sum(totals.values())
        out["total_seconds"] = round(total, 4)
        if audio_seconds is not None and total > 0:
            out["audio_seconds"] = round(audio_seconds, 3)
            out["rtf"] = round(audio_seconds / total, 2)
        return out


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None) -> Iterator[str]:
    """Profile the block with ``torch.profiler`` (the host, and the card
    when there is one) and write ``trace.json`` (Chrome trace format) into
    ``log_dir``, by default a directory under the temporary directory.
    Yields the directory."""
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
