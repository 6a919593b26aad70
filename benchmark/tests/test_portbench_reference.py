"""The plain reference against the port on the CPU at a tiny width, and
the comparison's control and planted faults, which must come out as not
correct."""

import json
import os
import time

import numpy as np
import pytest
import torch

from benchmark.harness import cell, check, spec
from benchmark.reference import whisper_ref
from conftest import tiny

FAULTS = spec.module("families", "whisper").FAULTS


def run_tiny(kind, products=None):
    """One run of a tiny cell on the CPU: (correct, readings)."""
    r = cell.Run(tiny(kind), 2**31 + 99, 0.5, False, torch.device("cpu"), time.perf_counter())
    r.setup(warm=False)
    r.window()
    r.close()
    checks = r.judge(products)
    return check.passed(checks), r.readings


def test_mel_filters_are_librosas():
    from whisper_tpu_torch.audio import mel_filters

    for n in (80, 128):
        np.testing.assert_allclose(whisper_ref.mel_filters(n), mel_filters(n), rtol=1e-5, atol=1e-7)


def test_frozen_vocabulary_facts_are_the_tokenizers():
    from whisper_tpu_torch.tokenizer import get_tokenizer

    with open(os.path.join(os.path.dirname(whisper_ref.__file__), "vocab_51866.json")) as f:
        vocab = json.load(f)
    t = get_tokenizer(True, num_languages=100, language="en", task="transcribe")
    assert (vocab["eot"], vocab["sot"], vocab["sot_prev"], vocab["no_speech"], vocab["no_timestamps"],
            vocab["timestamp_begin"], vocab["transcribe"], vocab["language"]) == (
        t.eot, t.sot, t.sot_prev, t.no_speech, t.no_timestamps, t.timestamp_begin, t.transcribe,
        t.language_token)
    assert vocab["blank"] == t.encode(" ")
    assert set(vocab["suppress"]) == set(t.non_speech_tokens) | {
        t.transcribe, t.translate, t.sot, t.sot_prev, t.sot_lm, t.no_speech}


@pytest.mark.parametrize("kind", ["batch", "serve"])
def test_reference_agrees_with_the_port_under_forced_sequences(kind):
    ok, readings = run_tiny(kind)
    assert ok, readings
    assert readings["segments_wrong"] == 0 and readings["failed"] == 0
    assert 0 < readings["logprob_gap"] < 0.045 and 0 < readings["no_speech_gap"] < 0.2


@pytest.mark.parametrize("kind", ["batch", "serve"])
def test_the_fp8_control_is_not_correct(kind):
    ok, readings = run_tiny(kind, products="fp8")
    assert not ok, readings
    assert readings["segments_wrong"] == 0


def test_a_metric_that_reads_nothing_stops_the_run():
    # on the CPU no kernel runs, so K1's roofline has nothing to read
    with pytest.raises(cell.SilentMetric, match="k1.roofline_pct"):
        cell.run(tiny("serve"), 2**31 + 98, 0.5, True, torch.device("cpu"), time.perf_counter())


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("kind", ["batch", "serve"])
def test_a_broken_timed_path_is_not_correct(kind, fault):
    with FAULTS[fault]():
        ok, readings = run_tiny(kind)
    assert not ok, readings
