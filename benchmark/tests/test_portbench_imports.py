"""What a run imports: neither JAX nor the JAX package (by whole top-level
name; whisper_tpu_torch is the port), and each reference nothing of the
port; what the harness names: nothing of one model family, which lives
behind ``families/<family>.py``."""

import ast
import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BENCH_DIR = os.path.join(ROOT, "benchmark")
REFERENCES = sorted(f[:-3] for f in os.listdir(os.path.join(BENCH_DIR, "reference"))
                    if f.endswith(".py") and not f.startswith("_"))
# a Whisper model, its sizes, its decoding hook and its reference
FAMILY_NAMES = {"DecodingTask", "ModelDimensions", "Whisper", "whisper_ref"}
GENERIC = ("harness", "kinds", "metrics")


def _modules_after(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\nprint(sorted({m.split('.')[0] for m in sys.modules}))"],
                         cwd=ROOT, capture_output=True, text=True, timeout=600,
                         env={**os.environ, "PYTHONPATH": ROOT})
    assert out.returncode == 0, out.stderr[-3000:]
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_a_run_imports_neither_jax_nor_the_jax_package():
    code = ("import sys, time, torch; sys.path.insert(0, 'benchmark/tests')\n"
            "from conftest import tiny\n"
            "from benchmark.harness import cell\n"
            "c = tiny('serve')\n"
            "c.per_layer = [m for m in c.per_layer if not m['name'].endswith('.roofline_pct')]  # no kernel on a CPU\n"
            "out = cell.run(c, 5, 0.5, True, torch.device('cpu'), time.perf_counter())\n"
            "assert out['correct'], out\n"
            "import runpy; runpy.run_path('benchmark/run.py', run_name='not_main')")
    loaded = _modules_after(code)
    assert "whisper_tpu_torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "whisper_tpu"}


@pytest.mark.parametrize("name", REFERENCES)
def test_the_reference_imports_nothing_of_the_port(name):
    loaded = _modules_after(f"import benchmark.reference.{name}")
    assert not loaded & {"whisper_tpu_torch", "whisper_tpu", "jax", "jaxlib", "flax"}


def _configs():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return [c["file"] for c in json.load(f)["configs"]]


@pytest.mark.parametrize("file", _configs())
def test_a_configuration_names_the_reference_its_family_loads(file):
    from benchmark.harness import spec

    with open(os.path.join(ROOT, file)) as f:
        config = json.load(f)
    family = spec.module("families", config["family"])
    assert os.path.samefile(family.reference.__file__, os.path.join(ROOT, config["reference"]))


def _names(path: str) -> set:
    """Every name the code of a module uses: identifiers, attributes and
    imported modules (not its docstrings or comments)."""
    with open(path) as f:
        tree = ast.parse(f.read())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Name):
            out.add(node.id)
        elif isinstance(node, ast.Attribute):
            out.add(node.attr)
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            out.update(part for a in node.names for part in (a.name.split(".") + [a.asname or ""]))
            out.update((getattr(node, "module", None) or "").split("."))
    return out


@pytest.mark.parametrize("folder", GENERIC)
def test_the_harness_names_nothing_of_one_model_family(folder):
    assert _names(os.path.join(BENCH_DIR, "families", "whisper.py")) >= FAMILY_NAMES  # the family does
    found = {}
    for f in sorted(os.listdir(os.path.join(BENCH_DIR, folder))):
        if f.endswith(".py"):
            named = _names(os.path.join(BENCH_DIR, folder, f)) & FAMILY_NAMES
            if named:
                found[f] = sorted(named)
    assert not found


def test_run_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is there: this checks the refusal without one")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "turbo.serve.short",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.cuda
def test_a_short_run_on_the_card_is_correct():
    import json

    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "turbo.serve.short",
                          "--seed", str(2**31 + 5), "--seconds", "3", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert list(line)[-1] == "checks"
