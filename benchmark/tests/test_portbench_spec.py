"""BENCHMARK.json and the files it names: every cell finds its pieces by
name, its model family among them, and the file keeps to the benchmark's
contract."""

import json
import os
import re
from types import SimpleNamespace

import pytest

from benchmark.harness import spec

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
# what the harness calls of a model family (families/<family>.py)
FAMILY = ("pin", "unpin", "build_model", "judge", "window_work", "window_ops")


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_a_cell_finds_its_files_by_name(name):
    cell = spec.Cell(name)
    assert cell.config["name"] == cell.workload["config"]
    kind = spec.kind(cell.mix)
    assert all(callable(getattr(kind, f)) for f in ("setup", "window", "values", "close"))
    family = cell.family
    assert all(callable(getattr(family, f)) for f in FAMILY)
    assert family.FAULTS and all(callable(f) for f in family.FAULTS.values())
    assert cell.limits["failed"] == 0
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s", "peak_mem_gib"}
    assert len(cell.end_to_end) >= 3 and cell.per_layer
    for m in cell.per_layer:
        assert callable(spec.metric_reader(m["name"]))
        assert m["moves"] in {e["name"] for e in cell.end_to_end}


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]
                                  if spec.Cell(w["name"]).config["family"] == "whisper"])
def test_a_whisper_cell_reads_its_vocabulary_and_compares_its_segments(name):
    cell = spec.Cell(name)
    assert cell.family.vocabulary(cell.config)["n_vocab"] == cell.dims["n_vocab"]
    assert cell.limits["segments_wrong"] == 0


PROBES = sorted(f[:-3] for f in os.listdir(os.path.join(spec.BENCH_DIR, "probes"))
                if f.endswith(".py") and not f.startswith("_"))


def test_every_probe_is_found():
    assert [p.__name__.rsplit("_probes_", 1)[-1] for p in spec.probes()] == PROBES


@pytest.mark.parametrize("name", PROBES)
def test_every_probe_installs(name):
    """Installed over a window in which the port runs nothing (a model that
    never calls what the probe wraps), a probe does no harm: it opens and
    closes, and leaves the port's functions as they were."""
    import torch

    from whisper_tpu_torch import engine

    probe = spec.module("probes", name)
    assert callable(probe.install)
    cell = spec.Cell(BENCH["workloads"][0]["name"])
    before = {k: getattr(engine, k) for k in dir(engine) if callable(getattr(engine, k))}
    for batcher in (None, SimpleNamespace(stats={"requests": 0, "batches": 0, "taken": 0, "queue_wait_s": 0.0},
                                          _transcribe_batch=lambda model, audios, **kw: [])):
        run = SimpleNamespace(cell=cell, device=torch.device("cpu"), log=[], batcher=batcher)
        inner = getattr(batcher, "_transcribe_batch", None)
        with probe.install(run):
            pass
        assert getattr(batcher, "_transcribe_batch", None) is inner
    assert {k: getattr(engine, k) for k in before} == before


def test_benchmark_json_keeps_to_its_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"] and BENCH["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and not c["reduced"]
        assert c["file"].startswith("benchmark/") and os.path.isfile(os.path.join(spec.ROOT, c["file"]))
        names.append(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in names and w["chips"] == 1 and len(w["why"]) <= 200
        names.append(w["name"])
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
        names.append(m["name"])
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert all(UNIT.match(m["unit"]) for m in BENCH["per_layer"] + BENCH["end_to_end"])
        names.append(m["name"])
    assert all(NAME.match(n) for n in names) and len(names) == len(set(names))
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_a_configuration_states_its_quantization():
    import torch

    from benchmark.harness import cell
    from conftest import tiny
    from whisper_tpu_torch.quantize import Int8Weight

    c = tiny("batch")
    plain = c.family.build_model(c, 3, torch.device("cpu"))
    c.config["quantize"] = "int8"
    c.config["transcribe_options"] = {"kv_cache_dtype": "int8"}
    quantized = c.family.build_model(c, 3, torch.device("cpu"))
    q_w = lambda m: m.params["decoder"]["blocks"]["q_w"]
    assert not isinstance(q_w(plain), Int8Weight) and isinstance(q_w(quantized), Int8Weight)
    run = cell.Run(c, 3, 1.0, False, torch.device("cpu"), 0.0)
    assert run.options()["kv_cache_dtype"] == "int8" and run.options()["language"] == "en"
