"""BENCHMARK.json and the files it names: every cell finds its pieces by
name, and the file keeps to the benchmark's contract."""

import json
import os
import re

import pytest

from benchmark.harness import spec

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_a_cell_finds_its_files_by_name(name):
    cell = spec.Cell(name)
    assert cell.config["name"] == cell.workload["config"]
    kind = spec.kind(cell.mix)
    assert all(callable(getattr(kind, f)) for f in ("setup", "window", "values", "close"))
    assert {"segments_wrong", "failed"} <= set(cell.limits)
    assert cell.vocab["n_vocab"] == cell.dims["n_vocab"]
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s", "peak_mem_gib"}
    assert len(cell.end_to_end) >= 3 and cell.per_layer
    for m in cell.per_layer:
        assert callable(spec.metric_reader(m["name"]))
        assert m["moves"] in {e["name"] for e in cell.end_to_end}


def test_every_probe_installs():
    probes = {p.__name__.rsplit("_probes_", 1)[-1] for p in spec.probes()}
    assert probes == {"k2_steps", "rounds"}
    assert all(callable(p.install) for p in spec.probes())


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
    plain = cell.build_model(c, 3, torch.device("cpu"))
    c.config["quantize"] = "int8"
    c.config["transcribe_options"] = {"kv_cache_dtype": "int8"}
    quantized = cell.build_model(c, 3, torch.device("cpu"))
    q_w = lambda m: m.params["decoder"]["blocks"]["q_w"]
    assert not isinstance(q_w(plain), Int8Weight) and isinstance(q_w(quantized), Int8Weight)
    run = cell.Run(c, 3, 1.0, False, torch.device("cpu"), 0.0)
    assert run.options()["kv_cache_dtype"] == "int8" and run.options()["language"] == "en"
