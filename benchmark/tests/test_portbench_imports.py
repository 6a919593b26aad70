"""What a run imports: neither JAX nor the JAX package (by whole top-level
name; whisper_tpu_torch is the port), and the reference nothing of the
port."""

import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


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


def test_the_reference_imports_nothing_of_the_port():
    loaded = _modules_after("import benchmark.reference.whisper_ref")
    assert not loaded & {"whisper_tpu_torch", "whisper_tpu", "jax", "jaxlib", "flax"}


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
