"""The traffic generator and the Whisper family's forced sequence: a seed
gives the same inputs every time, and every seed the same amount of
work."""

import numpy as np

from benchmark.harness import spec, traffic

BIG = 2**31 + 12345
whisper = spec.module("families", "whisper")


def test_waveform_and_forced_sequence_repeat_for_a_seed():
    a, b = traffic.waveform(BIG, 3.0), traffic.waveform(BIG, 3.0)
    assert a.dtype == np.float32 and a.shape == (48000,) and np.array_equal(a, b)
    assert not np.array_equal(a, traffic.waveform(BIG + 1, 3.0))
    cell = spec.Cell("large-v3.batch16")
    vocab, mix = whisper.vocabulary(cell.config), cell.mix
    f = whisper.forced_sequence(BIG, mix["forced"], vocab)
    assert f == whisper.forced_sequence(BIG, mix["forced"], vocab)
    tsb = vocab["timestamp_begin"]
    assert len(f) == mix["forced"]["text_tokens"] + 3
    assert f[0] == tsb and f[-2] == tsb + 1500 and f[-1] == vocab["eot"]
    text = f[1:-2]
    assert all(t < vocab["eot"] for t in text)
    assert not set(text) & (set(vocab["suppress"]) | set(vocab["blank"]))


def test_batch_calls_repeat_and_share_their_lengths_across_seeds():
    mix = spec.Cell("large-v3.batch16").mix
    wave = traffic.waveform(7, 320.0)
    a = traffic.batch_calls(BIG, mix, wave, 2)
    b = traffic.batch_calls(BIG, mix, wave, 2)
    assert all(np.array_equal(x, y) for ca, cb in zip(a, b) for x, y in zip(ca, cb))
    lengths = lambda calls: [sorted(len(f) for f in call) for call in calls]
    other = traffic.batch_calls(5, mix, wave, 2)
    assert lengths(a) == lengths(other) == [lengths(a)[0]] * 2  # the same set, another order
    assert [len(f) for f in a[0]] != [len(f) for f in other[0]]
    seconds = np.array(lengths(a)[0]) / traffic.SAMPLE_RATE
    assert len(seconds) == 16 and 30 < seconds.min() < 33 and 279 < seconds.max() < 281


def test_open_schedule_is_the_same_for_every_seed():
    mix = spec.Cell("turbo.serve.short").mix
    a = traffic.open_schedule(BIG, mix, 10.0, stream=0)
    b = traffic.open_schedule(3, mix, 10.0, stream=0)
    assert np.array_equal(a["due"], b["due"]) and np.array_equal(a["lengths"], b["lengths"])
    n = round(mix["rate_per_s"] * 10)
    assert len(a["due"]) == n and a["due"][0] == 0.0
    assert np.all(np.diff(a["due"]) > 0) and a["due"][-1] < 10.0
    assert 1.0 < a["lengths"].min() and a["lengths"].max() < 10.0
    warm = traffic.open_schedule(BIG, mix, 10.0, stream=1)
    assert not np.array_equal(a["lengths"], warm["lengths"])


def test_quantiles_of_the_length_distributions():
    q = traffic.quantiles({"dist": "log_uniform", "low": 1, "high": 100}, 2)
    assert np.allclose(q, [10 ** 0.5, 10 ** 1.5])
    e = traffic.quantiles({"dist": "exponential", "mean": 2.0}, 1)
    assert np.allclose(e, [2.0 * np.log(2.0)])
