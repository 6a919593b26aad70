"""whisper_tpu_torch.profiling: the cases of tests/test_profiling.py on
the CPU (the host's clock), the trace file, and the StageTimer on a
speculative decode's stages.  On the card the timer reads CUDA events
(tests/test_torch_cuda.py)."""

import json
import os
import time

import numpy as np
import torch

from whisper_tpu_torch.profiling import StageTimer, device_memory_stats, trace


def test_stage_timer():
    timer = StageTimer("cpu")
    with timer.stage("front_end"):
        time.sleep(0.01)
    with timer.stage("decode"):
        time.sleep(0.02)
    with timer.stage("decode"):
        time.sleep(0.02)
    report = timer.report(audio_seconds=30.0)
    assert report["decode_seconds"] >= 0.04
    assert timer.counts["decode"] == 2
    assert report["rtf"] > 0
    assert report["total_seconds"] >= report["front_end_seconds"]


def test_device_memory_stats_shape():
    stats = device_memory_stats()
    assert isinstance(stats, dict)
    assert device_memory_stats("cpu") == {}


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(str(tmp_path / "trace")) as log_dir:
        torch.ones(64, 64) @ torch.ones(64, 64)
    with open(os.path.join(log_dir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)


def test_stage_timer_takes_the_speculative_stages(monkeypatch):
    """decode_engine_speculative(stage_timer=) times its encoder, prefill,
    draft, verify and accept stages, the last three once per round."""
    from whisper_tpu_torch import decoding
    from whisper_tpu_torch.decoding import DecodingOptions, DecodingTask
    from whisper_tpu_torch.models.dims import ModelDimensions
    from whisper_tpu_torch.models.whisper import Whisper, init_params

    dims = ModelDimensions(n_mels=80, n_audio_ctx=1500, n_audio_state=64, n_audio_head=2,
                           n_audio_layer=1, n_vocab=51865, n_text_ctx=448, n_text_state=64,
                           n_text_head=2, n_text_layer=1)
    model = Whisper(dims, init_params(dims, torch.Generator().manual_seed(0)))
    timer = StageTimer("cpu")
    real = decoding.decode_engine_speculative
    monkeypatch.setattr(decoding, "decode_engine_speculative",
                        lambda *a, **k: real(*a, stage_timer=timer, **k))
    mel = torch.from_numpy(np.random.RandomState(0).randn(1, 80, 3000).astype(np.float32))
    options = DecodingOptions(language="en", temperature=0.0, sample_len=9)
    result = DecodingTask(model, options, draft_model=model).run(mel)[0]
    rounds = timer.counts["verify"]
    assert timer.counts["encoder"] == timer.counts["prefill"] == 1
    assert timer.counts["draft"] == timer.counts["accept"] == rounds >= len(result.tokens) / 5
    assert set(timer.report()) >= {f"{k}_seconds" for k in ("encoder", "prefill", "draft", "verify",
                                                            "accept", "total")}
