"""The traced window: ``torch.profiler`` over the card and the host, read
in memory (no trace file is written), reduced to what the per-layer
metrics read.

Spans are ``record_function`` ranges that the benchmark's own code opens
around its calls into the program (``bench.window`` around the whole
window, ``bench.round`` around each batch round of a server), so they
share the profiler's clock with the device's kernels.
"""

import bisect
import contextlib
from collections import defaultdict
from typing import Dict, List, Tuple

import torch
from torch.profiler import record_function

WINDOW = "bench.window"
ROUND = "bench.round"


@contextlib.contextmanager
def span(name: str, on: bool):
    """A span the trace keeps, or nothing in an untraced run."""
    if not on:
        yield
        return
    with record_function(name):
        yield


def union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Sorted, merged, non-overlapping intervals."""
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def covered(intervals: List[Tuple[float, float]], within: List[Tuple[float, float]]) -> float:
    """The length of the union of ``intervals`` inside the union of
    ``within``: overlapping intervals count once (a launch under
    programmatic dependent launch starts while the one before drains)."""
    busy, spans = union(intervals), union(within)
    total, j = 0.0, 0
    for a, b in spans:
        while j < len(busy) and busy[j][1] <= a:
            j += 1
        k = j
        while k < len(busy) and busy[k][0] < b:
            total += max(0.0, min(b, busy[k][1]) - max(a, busy[k][0]))
            k += 1
    return total


class Trace:
    """Device activity and host spans of one profiled window, in seconds on
    the profiler's clock.  Each device operation keeps the host operation
    that launched it (the profiler links a kernel to the innermost
    operator or span open around its launch)."""

    def __init__(self, events):
        self.device: List[Tuple[str, float, float]] = []  # (name, start, end)
        self.host: List[Tuple[str, float, float, int]] = []  # (name, start, end, thread)
        self.spans: Dict[str, List[Tuple[float, float]]] = defaultdict(list)
        links: List[int] = []  # the launching host operation's id, beside self.device
        ops: Dict[int, str] = {}
        cuda = torch.autograd.DeviceType.CUDA
        for e in events:
            name, start = e.name(), e.start_ns() * 1e-9
            end = start + e.duration_ns() * 1e-9
            if name in (WINDOW, ROUND):
                # a span shows twice: on the host, and as an annotation on the
                # card's timeline, which is no device work
                if e.device_type() != cuda:
                    self.spans[name].append((start, end))
            elif e.device_type() == cuda:
                if not e.is_user_annotation():
                    self.device.append((name, start, end))
                    links.append(e.linked_correlation_id())
            else:
                self.host.append((name, start, end, e.start_thread_id()))
                # an operator or span links to nothing; a runtime call such as
                # cudaLaunchKernel links to its operator, as a kernel does
                if e.linked_correlation_id() == 0 and e.correlation_id():
                    ops[e.correlation_id()] = name
        order = sorted(range(len(self.device)), key=lambda i: self.device[i][1])
        self.device = [self.device[i] for i in order]
        self.launched_by: List[str] = [ops.get(links[i], "") for i in order]
        (self.start, self.end), = self.spans[WINDOW]

    @property
    def window_s(self) -> float:
        return self.end - self.start

    def busy_s(self, within=None) -> float:
        return covered([(a, b) for _, a, b in self.device], within or [(self.start, self.end)])

    def kernel_s(self, names) -> float:
        """Device time of the kernels named in ``names`` (by
        :func:`short_name`), overlaps counted once."""
        names = set(names)
        return covered([(a, b) for n, a, b in self.device if short_name(n) in names],
                       [(self.start, self.end)])

    def breakdown(self, top: int = 10, short_gap_s: float = 20e-6) -> Dict[str, list]:
        """The device operations that took most time, each as "kernel <-
        the host operation that launched it", and the device's idle time by
        what the host was doing: each gap of the device's timeline goes to
        the innermost host operation (of any thread) open at its middle,
        gaps under ``short_gap_s`` together under one name."""
        by_op = defaultdict(float)
        for (n, a, b), op in zip(self.device, self.launched_by):
            by_op[short_name(n) + (" <- " + op if op else "")] += b - a
        gaps, end = [], self.start
        for a, b in union([(a, b) for _, a, b in self.device]):
            if a > end:
                gaps.append((end, min(a, self.end)))
            end = max(end, b)
        if self.end > end:
            gaps.append((end, self.end))
        host = sorted(self.host, key=lambda h: h[1])
        starts = [h[1] for h in host]
        by_host = defaultdict(float)
        for a, b in gaps:
            if b - a < short_gap_s:
                by_host["gaps under 20 us"] += b - a
                continue
            mid, label = 0.5 * (a + b), "host between operations"
            i = bisect.bisect_right(starts, mid) - 1
            for name, _, hb, _ in host[max(i - 64, 0) : i + 1][::-1]:
                if hb >= mid:  # the latest start that still covers the middle
                    label = name
                    break
            by_host[label] += b - a
        rank = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
        return {"device_ops": rank(by_op), "idle_gaps": rank(by_host)}


def short_name(name: str) -> str:
    """A kernel's name without its namespaces, template arguments and
    parameters: "void (anonymous namespace)::gemv_kernel<...>(...)" is
    "gemv_kernel"."""
    head = name.replace("(anonymous namespace)::", "")
    head = head[5:] if head.startswith("void ") else head
    for stop in "<(":
        head = head.split(stop)[0]
    return head.split("::")[-1].strip()[:120] or name[:120]


@contextlib.contextmanager
def profiled():
    """Profile the block on the host (every thread: a server's worker starts
    before the window) and on the card; yields a holder whose ``trace`` is
    set when the block ends.  The profiler's results are read as they come
    from its C++ side: torch.profiler's Python events, one object each,
    would take minutes to build for a window of millions of kernels."""
    from torch._C._autograd import _disable_profiler, _enable_profiler, _prepare_profiler
    from torch._C._profiler import (ProfilerActivity, ProfilerConfig, ProfilerState,
                                    _ExperimentalConfig)

    experimental = _ExperimentalConfig(profile_all_threads=True)
    flags = (ProfilerState.KINETO, False, False, False, False, False, experimental)
    try:
        config = ProfilerConfig(*flags, "")  # newer versions take a trace id
    except TypeError:
        config = ProfilerConfig(*flags)
    activities = {ProfilerActivity.CPU}
    if torch.cuda.is_available():
        activities.add(ProfilerActivity.CUDA)
    holder = type("Holder", (), {"trace": None})()
    _prepare_profiler(config, activities)
    _enable_profiler(config, activities)
    try:
        yield holder
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        result = _disable_profiler()
    holder.trace = Trace(result.events())
