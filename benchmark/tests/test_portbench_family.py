"""The seam between the harness and a model family: a configuration of a
family the harness has never seen runs end to end with new files and new
entries alone.

In a copy of the benchmark, a stand-in family (a two-layer tanh network
over frames of the waveform) brings its family file, its reference, a
configuration, a traffic mix and the kind that drives it, its limits, a
per-layer metric and a cell's entry; ``cell.run`` on the CPU gives a
result line that is correct, and not correct with the family's planted
fault; and no file that was there before is edited.
"""

import hashlib
import json
import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

STUB = {
    "families/stub.py": '''
"""A stand-in family: y = tanh(x W1) W2 over frames of ``width`` samples."""

import contextlib

import torch

from benchmark.harness import check
from benchmark.reference import stub_ref as reference


class Model:
    def __init__(self, w):
        self.w = w

    def __call__(self, x):
        return torch.tanh(x @ self.w[0]) @ self.w[1]


def pin(run):
    pass


def unpin():
    pass


def build_model(cell, seed, device):
    n = cell.dims["width"]
    gen = torch.Generator(device=device).manual_seed(seed % 2**63)
    w = torch.randn(2, n, n, generator=gen, dtype=getattr(torch, cell.config["dtype"]), device=device)
    return Model(w / n ** 0.5)


def judge(run, picked, products=None):
    gaps = [float((run.results[i].double() - reference.forward(run.files[i], run.seed, run.dims["width"])).abs().max())
            for i in picked]
    return {"failed": run.failed, "gap_max": check.max_abs(gaps)}, f"stub: {len(picked)} clips judged"


def window_work(results):
    return [(int(r.shape[0]),) for r in results if isinstance(r, torch.Tensor)]


def window_ops(dims, frames):
    return 4.0 * frames * dims["width"] ** 2


@contextlib.contextmanager
def output_altered():
    call = Model.__call__

    def altered(self, x):
        y = call(self, x)
        y[0, 0] += 1.0
        return y

    Model.__call__ = altered
    try:
        yield
    finally:
        Model.__call__ = call


FAULTS = {"output_altered": output_altered}
''',
    "reference/stub_ref.py": '''
"""The stand-in family's plain reference, in float64."""

import numpy as np
import torch


def forward(clip, seed, width):
    gen = torch.Generator().manual_seed(seed % 2**63)
    w = torch.randn(2, width, width, generator=gen).double() / width ** 0.5
    x = torch.from_numpy(np.asarray(clip[: len(clip) // width * width], np.float64).reshape(-1, width))
    return torch.tanh(x @ w[0]) @ w[1]
''',
    "kinds/stub_loop.py": '''
"""stub_loop: the stand-in model over each clip of the mix, back to back."""

import time

import torch

from benchmark.harness import traffic


def _clips(run):
    mix = run.cell.mix
    return traffic.clips(run.seed, traffic.quantiles(mix["length_s"], mix["clips"]), run.wave, stream=0)


def _call(run, clip):
    n = run.dims["width"]
    return run.model(torch.from_numpy(clip[: len(clip) // n * n].reshape(-1, n)).to(run.device))


def setup(run, warm):
    if warm:
        _call(run, _clips(run)[0])


def window(run):
    run.files, run.results = [], []
    start = time.perf_counter()
    while time.perf_counter() - start < run.seconds:
        for clip in _clips(run):
            run.results.append(_call(run, clip))
            run.files.append(clip)
    run.wall_s, run.failed = time.perf_counter() - start, 0


def values(run):
    return {"frames_per_s": sum(int(r.shape[0]) for r in run.results) / run.wall_s}


def close(run):
    pass
''',
    "metrics/stub.frames_per_call.py": '''
"""stub.frames_per_call: frames a call of the stand-in model."""


def read(run):
    return sum(w[0] for w in run.windows) / len(run.windows) if run.windows else None
''',
    "configs/stub-tiny.json": {"name": "stub-tiny", "source": "https://example.org/stub", "family": "stub",
                               "dims": {"width": 16}, "dtype": "float32",
                               "reference": "benchmark/reference/stub_ref.py"},
    "traffic/stub.clips.json": {"kind": "stub_loop", "audio_s": 4,
                                "length_s": {"dist": "log_uniform", "low": 0.1, "high": 1.0}, "clips": 4,
                                "options": {}, "check": {"requests": 3}},
    "limits/stub.clips.json": {"failed": 0, "gap_max": 1e-4},
}
ENTRIES = {
    "configs": {"name": "stub-tiny", "source": "https://example.org/stub",
                "file": "benchmark/configs/stub-tiny.json", "reduced": [], "why": "the seam test"},
    "workloads": {"name": "stub.clips", "config": "stub-tiny", "traffic": "stub.clips", "chips": 1,
                  "why": "the seam test"},
    "end_to_end": {"name": "frames_per_s", "unit": "frames/s", "better": "higher", "bound": 0.25,
                   "source": "host_clock", "workloads": ["stub.clips"]},
    "per_layer": {"name": "stub.frames_per_call", "unit": "frames", "better": "higher",
                  "source": "program_counter", "layer": "stub", "moves": "frames_per_s",
                  "workloads": ["stub.clips"]},
}
RUN = '''
import json, time, torch
from benchmark.harness import arith, cell, spec
c = spec.Cell("stub.clips")
cpu, seed = torch.device("cpu"), 2**33 + 5
out = {"plain": cell.run(c, seed, 0.3, False, cpu, time.perf_counter())}
with c.family.FAULTS["output_altered"]():
    out["fault"] = cell.run(c, seed, 0.3, False, cpu, time.perf_counter())
out["traced"] = cell.run(c, seed, 0.3, True, cpu, time.perf_counter())
r = cell.Run(c, seed, 0.3, True, cpu, time.perf_counter())
r.setup()
r.window()
r.close()
r.per_layer()
ops = sum(4.0 * w[0] * 16 ** 2 for w in r.windows)
out["mfu"] = [spec.metric_reader("mfu_pct.batch")(r), 100.0 * ops / arith.PEAK_OPS_PER_S / r.trace.window_s]
print(json.dumps(out))
'''


def _digests(folder: str) -> dict:
    out = {}
    for d, dirs, files in os.walk(folder):
        dirs[:] = [x for x in dirs if x != "__pycache__"]
        for f in files:
            with open(os.path.join(d, f), "rb") as fh:
                out[os.path.relpath(os.path.join(d, f), folder)] = hashlib.sha256(fh.read()).hexdigest()
    return out


@pytest.fixture(scope="module")
def stub_copy(tmp_path_factory):
    """A copy of the benchmark with the stand-in family's files and entries
    added, and the result of its runs."""
    top = str(tmp_path_factory.mktemp("seam"))
    bench = os.path.join(top, "benchmark")
    shutil.copytree(os.path.join(ROOT, "benchmark"), bench, ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(bench)
    for path, content in STUB.items():
        assert not os.path.exists(os.path.join(bench, path)), path  # new files only
        with open(os.path.join(bench, path), "w") as f:
            f.write(content.lstrip() if isinstance(content, str) else json.dumps(content, indent=2))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    parent = json.loads(json.dumps(spec))
    for key, entry in ENTRIES.items():
        spec[key].append(entry)
    with open(os.path.join(top, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f, indent=2)
    out = subprocess.run([sys.executable, "-c", RUN], cwd=top, capture_output=True, text=True, timeout=600,
                         env={**os.environ, "PYTHONPATH": os.pathsep.join([top, ROOT])})
    assert out.returncode == 0, out.stderr[-3000:]
    return dict(before=before, after=_digests(bench), parent=parent, spec=spec,
                result=json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_new_family_runs_correct_from_new_files_alone(stub_copy):
    line = stub_copy["result"]["plain"]
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    assert set(line["metrics"]) == {"frames_per_s", "setup_s", "peak_mem_gib"}
    assert list(line)[-1] == "checks" and set(line["checks"]) == {"failed", "gap_max"}
    assert line["checks"]["gap_max"]["value"] < 1e-5


def test_the_new_familys_planted_fault_is_not_correct(stub_copy):
    line = stub_copy["result"]["fault"]
    assert line["correct"] is False and line["checks"]["gap_max"]["value"] >= 0.5


def test_a_traced_run_of_the_new_family_reads_its_metrics_through_the_family(stub_copy):
    line = stub_copy["result"]["traced"]
    assert line["correct"] is True and set(line["metrics"]) == {"stub.frames_per_call"}
    assert line["metrics"]["stub.frames_per_call"]["value"] > 0
    got, want = stub_copy["result"]["mfu"]
    assert got == pytest.approx(want) and got > 0


def test_no_file_that_was_there_is_edited(stub_copy):
    before, after = stub_copy["before"], stub_copy["after"]
    assert {k: after[k] for k in before} == before
    assert set(after) - set(before) == set(STUB)
    spec, parent = stub_copy["spec"], stub_copy["parent"]
    for key, entries in parent.items():  # BENCHMARK.json: entries added, none changed
        assert spec[key][: len(entries)] == entries if isinstance(entries, list) else spec[key] == entries
