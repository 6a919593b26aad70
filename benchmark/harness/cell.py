"""One run of one cell: set-up, the measured window, the metrics, the
comparison with the reference, and the result line.

What depends on the model comes from the configuration's family
(``families/<family>.py``): the seeded inputs it pins in the port, the
port's model, the work of each window and the comparison with its
reference.  The port (``whisper_tpu_torch``) is driven through its public
entry points by the driver of the mix's kind (``kinds/<kind>.py``).  A
traced window installs every probe of ``probes/``.
"""

import contextlib
import gc
import sys
import time
from typing import Dict, List

import torch

from . import check, spec, traffic
from .trace import WINDOW, profiled, span

FORBIDDEN = ("jax", "jaxlib", "flax", "whisper_tpu")


class SilentMetric(RuntimeError):
    """A per-layer metric of the cell found nothing to read."""


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


class Run:
    """Drives one cell; its attributes are what the metric readers read."""

    def __init__(self, cell: spec.Cell, seed: int, seconds: float, traced: bool, device, t0: float):
        self.cell, self.seed, self.seconds, self.traced = cell, seed, seconds, traced
        self.device, self.t0 = device, t0
        self.kind = spec.kind(cell.mix)
        self.family = cell.family
        self.dims = cell.dims
        self.trace = None
        self.stats: Dict[str, int] = {}
        self.log: List[str] = []

    def options(self) -> dict:
        """The transcription options: the mix's, and the configuration's
        own (``transcribe_options``, such as an int8 cache) over them."""
        return {**self.cell.mix["options"], **self.cell.config.get("transcribe_options", {})}

    # -- set-up ---------------------------------------------------------------

    def setup(self, warm: bool = True) -> None:
        """The kernel library, the inputs (pinned in the port by the
        family), the model, and the kind's set-up (with ``warm``, one round
        of the cell's own traffic); each step's time goes to the log."""
        steps, t = [f"imports {time.perf_counter() - self.t0:.3f} s"], time.perf_counter()

        def done(what: str) -> None:
            nonlocal t
            self._sync()
            steps.append(f"{what} {time.perf_counter() - t:.3f} s")
            t = time.perf_counter()

        if self.device.type == "cuda":
            from whisper_tpu_torch.ops.kernels import _lib

            built = _lib.ensure_built()
            _lib.lib()
            done("kernel library (built)" if built else "kernel library")
        mix = self.cell.mix
        self.wave = traffic.waveform(self.seed, mix["audio_s"])
        self.family.pin(self)
        done("inputs")
        self.model = self.family.build_model(self.cell, self.seed, self.device)
        done("weights")
        self.kind.setup(self, warm)
        done("warm-up")
        self.log.append("set-up: " + ", ".join(steps))

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- the window -----------------------------------------------------------

    def window(self) -> None:
        self.setup_s = time.perf_counter() - self.t0
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        batcher = getattr(self, "batcher", None)
        stats0 = dict(batcher.stats) if batcher is not None else {}
        with contextlib.ExitStack() as stack:
            if self.traced:
                for probe in spec.probes():
                    stack.enter_context(probe.install(self))
                holder = stack.enter_context(profiled())
            with span(WINDOW, self.traced):
                self.kind.window(self)
        self.trace = holder.trace if self.traced else None
        if batcher is not None:
            self.stats = {k: v - stats0.get(k, 0) for k, v in batcher.stats.items()}
        self.peak_bytes = torch.cuda.max_memory_allocated(self.device) if self.device.type == "cuda" else 0

    # -- after the window -----------------------------------------------------

    def close(self) -> None:
        """Free the port's state (the reference runs after it)."""
        self.kind.close(self)
        self.family.unpin()
        del self.model
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def end_to_end(self) -> Dict[str, Dict]:
        values = {"setup_s": self.setup_s, "peak_mem_gib": self.peak_bytes / 2**30, **self.kind.values(self)}
        return {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                for m in self.cell.end_to_end if m["name"] in values}

    def per_layer(self) -> Dict[str, Dict]:
        """Every per-layer metric of the cell; one that reads nothing
        raises :class:`SilentMetric`, since the cell lists it."""
        self.windows = self.family.window_work(self.results)
        out, silent = {}, []
        for m in self.cell.per_layer:
            value = spec.metric_reader(m["name"])(self)
            if value is None:
                silent.append(m["name"])
            else:
                out[m["name"]] = {"value": value, "unit": m["unit"]}
        if silent:
            raise SilentMetric(f"per-layer metrics of {self.cell.name} read nothing: {silent}")
        return out

    def judge(self, products=None) -> Dict[str, Dict[str, float]]:
        """The comparison with the reference; ``products="fp8"`` judges the
        reference with float8 products in the port's place (the control)."""
        lengths = [len(f) for f in self.files]
        picked = check.sample(lengths, self.cell.mix["check"]["requests"], self.seed)
        self.readings, log = self.family.judge(self, picked, products)
        self.log.append(log)
        return {k: {"value": self.readings[k], "limit": v} for k, v in self.cell.limits.items()}


def run(cell: spec.Cell, seed: int, seconds: float, traced: bool, device, t0: float) -> dict:
    """One run; returns the result line's object (``correct`` decided) and
    under "_log" the lines for standard error."""
    r = Run(cell, seed, seconds, traced, device, t0)
    r.setup()
    r.window()
    r.close()
    metrics = r.per_layer() if traced else r.end_to_end()
    checks = r.judge()
    out = {"correct": check.passed(checks), "attempted": len(r.files), "failed": r.failed,
           "metrics": metrics}
    if device.type == "cuda":
        out["device"] = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
                         "memory_peak_bytes": r.peak_bytes}
    else:
        out["device"] = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    if traced:
        out["device"]["busy_s"] = r.trace.busy_s()
        out["device"]["window_s"] = r.trace.window_s
        out["breakdown"] = r.trace.breakdown()
    out["_log"] = r.log
    out["checks"] = checks
    return out
