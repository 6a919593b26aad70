"""Finds a cell's pieces by the names in ``BENCHMARK.json``: its
configuration (``configs/<config>.json``) and the module of the model
family that the configuration names (``families/<family>.py``), its
traffic mix (``traffic/<traffic>.json``), the driver of the mix's kind
(``kinds/<kind>.py``), its correctness limits (``limits/<cell>.json``) and
the reader of each per-layer metric (``metrics/<metric>.py``); and every
probe of a traced window (``probes/*.py``)."""

import importlib.util
import json
import os
import sys
from typing import Dict, List, Optional

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def _json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> Dict:
    return _json(os.path.join(root, "BENCHMARK.json"))


class Cell:
    """One workload of BENCHMARK.json with everything it names."""

    def __init__(self, name: str, bench: Optional[Dict] = None):
        bench = bench or benchmark()
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
        self.name = name
        self.workload = cells[name]
        config = next(c for c in bench["configs"] if c["name"] == self.workload["config"])
        self.config = _json(os.path.join(ROOT, config["file"]))
        self.mix = _json(os.path.join(BENCH_DIR, "traffic", self.workload["traffic"] + ".json"))
        self.limits = _json(os.path.join(BENCH_DIR, "limits", name + ".json"))
        self.end_to_end: List[Dict] = [m for m in bench["end_to_end"]
                                       if name in m.get("workloads", [name])]
        moved = {m["name"] for m in self.end_to_end}
        # a per-layer metric without a list goes with the metric it moves
        self.per_layer: List[Dict] = [m for m in bench["per_layer"]
                                      if name in m.get("workloads", [name] if m["moves"] in moved else [])]

    @classmethod
    def of(cls, name: str, config: Dict, mix: Dict, limits: Dict,
           end_to_end: List[Dict], per_layer: List[Dict]) -> "Cell":
        """A cell from its pieces, not from files (the benchmark's tests)."""
        cell = cls.__new__(cls)
        cell.name, cell.workload = name, {"name": name}
        cell.config, cell.mix, cell.limits = config, mix, limits
        cell.end_to_end, cell.per_layer = end_to_end, per_layer
        return cell

    @property
    def dims(self) -> Dict[str, int]:
        return self.config["dims"]

    @property
    def family(self):
        """The module of the configuration's model family,
        ``families/<family>.py``."""
        return module("families", self.config["family"])


def module(folder: str, name: str):
    """The module ``<folder>/<name>.py`` of the benchmark's folder, loaded
    once."""
    key = f"bench_{folder}_" + name.replace(".", "_").replace("-", "_")
    if key not in sys.modules:
        path = os.path.join(BENCH_DIR, folder, name + ".py")
        if not os.path.isfile(path):
            raise KeyError(f"no {folder}/{name}.py in {BENCH_DIR}")
        spec = importlib.util.spec_from_file_location(key, path)
        loaded = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(loaded)
        sys.modules[key] = loaded
    return sys.modules[key]


def metric_reader(name: str):
    """The ``read(run)`` function of ``metrics/<name>.py``."""
    return module("metrics", name).read


def kind(mix: Dict):
    """The driver of a traffic mix's ``kind``: ``kinds/<kind>.py``."""
    return module("kinds", mix["kind"])


def probes() -> list:
    """Every probe of a traced window: the modules of ``probes/``, each
    with ``install(run)``, a context manager."""
    folder = os.path.join(BENCH_DIR, "probes")
    return [module("probes", f[:-3]) for f in sorted(os.listdir(folder))
            if f.endswith(".py") and not f.startswith("_")]
