"""The benchmark's CPU tests: a cell cut to a tiny width, run end to end on
the CPU (the kernels' plain versions), beside the harness's pieces.

    python -m pytest benchmark/tests -q
"""

import copy
import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark.harness import spec  # noqa: E402

# what the CPU reads at this width, with room: the bf16 port 0.006-0.016
# (log-probability) and 0.03-0.08 (no speech), the fp8 reference 0.08-0.21
# and 0.5-0.55
TINY_LIMITS = {"segments_wrong": 0, "failed": 0, "logprob_gap": 0.045, "no_speech_gap": 0.2}


def tiny(kind: str, dtype: str = "bfloat16") -> spec.Cell:
    """A cell of BENCHMARK.json at width 128 (2 heads of 64), one layer a
    side, with a few short files or clips."""
    if kind == "batch":
        name, config, traffic = "large-v3.batch16", "whisper-large-v3", "offline.files"
    else:
        name, config, traffic = "turbo.serve.short", "whisper-large-v3-turbo", "serve.short.turbo"
    cell = spec.Cell(name)
    with open(os.path.join(spec.BENCH_DIR, "configs", config + ".json")) as f:
        cfg = json.load(f)
    cfg["dims"].update(n_audio_state=128, n_audio_head=2, n_audio_layer=1, n_text_state=128,
                       n_text_head=2, n_text_layer=1)
    cfg["dtype"] = dtype
    mix = copy.deepcopy(cell.mix)
    if kind == "batch":
        mix.update(batch_size=4, files_per_call=4, audio_s=80,
                   length_s={"dist": "log_uniform", "low": 20, "high": 70})
        mix["check"]["requests"] = 4
    else:
        mix.update(rate_per_s=20.0, warmup_s=0.5, batch_size=4)
        mix["check"]["requests"] = 10  # every request of a 0.5 s window
    return spec.Cell.of(name, cfg, mix, dict(TINY_LIMITS), cell.end_to_end, cell.per_layer)


@pytest.fixture(autouse=True)
def _no_forced_tokens():
    """A failed run leaves no pinned sequence behind for the next test."""
    yield
    spec.module("families", "whisper").unpin()
