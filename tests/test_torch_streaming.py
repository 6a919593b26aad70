"""Streaming transcription in whisper_tpu_torch against whisper_tpu.

Float32 on the CPU at tests/_reference.py's TINY_DIMS, the same weights in
both packages (whisper_tpu's init_params through save_npz -> load_npz).
``log_mel_frames`` must agree with whisper_tpu's within 1e-4.  A
StreamingTranscriber fed jfk.flac in chunks of any size must give the
port's one-shot ``transcribe`` of the same audio (tokens and seeks equal,
times within 1e-9: each window here holds speech, so the per-window mel
floor is the file's) and whisper_tpu's streamer (tokens, seeks and times
equal, words within 0.02 s), and the same with 8-step write blocks forced
on as without.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import whisper_tpu
import whisper_tpu.audio as ja
import whisper_tpu.models.whisper as jw
from whisper_tpu.models.load import load_npz as jload
from whisper_tpu.models.load import save_npz
from whisper_tpu.streaming import StreamingTranscriber as JStreamer

import whisper_tpu_torch
import whisper_tpu_torch.audio as ta
from whisper_tpu_torch import StreamingTranscriber
from whisper_tpu_torch.decoding import DecodingTask

from _reference import TINY_DIMS
from conftest import JFK

torch.set_num_threads(2)

# greedy and short: the streamer's window logic, not long decodes
KW = dict(language="en", temperature=0.0, sample_len=24, compression_ratio_threshold=None,
          logprob_threshold=None, condition_on_previous_text=True)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    dims = whisper_tpu.ModelDimensions(**TINY_DIMS)
    path = str(tmp_path_factory.mktemp("ckpt") / "tiny.npz")
    save_npz(path, jw.init_params(dims, jax.random.PRNGKey(0), jnp.float32), dims)
    return jw.Whisper(*reversed(jload(path))), whisper_tpu_torch.load_model(path, device="cpu")


@pytest.fixture(scope="module")
def jfk():
    return whisper_tpu_torch.load_audio(JFK)


def _stream(model, audio, chunk_seconds, streamer=StreamingTranscriber, **kw):
    st = streamer(model, **kw)
    emitted = []
    step = int(chunk_seconds * 16000)
    for off in range(0, len(audio), step):
        emitted.extend(st.push(audio[off : off + step]))
    emitted.extend(st.flush())
    assert emitted == st.result["segments"]
    return st


def _assert_same(got: dict, ref: dict, tol: float = 1e-9, word_tol: float = 0.0):
    assert got["text"] == ref["text"] and got["language"] == ref["language"]
    assert len(got["segments"]) == len(ref["segments"]) > 0
    for g, r in zip(got["segments"], ref["segments"]):
        assert g["tokens"] == [int(t) for t in r["tokens"]] and g["seek"] == r["seek"]
        assert abs(g["start"] - r["start"]) <= tol and abs(g["end"] - r["end"]) <= tol
        gw, rw = g.get("words", []), r.get("words", [])
        assert [w["word"] for w in gw] == [w["word"] for w in rw]
        for a, b in zip(gw, rw):
            assert abs(a["start"] - b["start"]) <= word_tol and abs(a["end"] - b["end"]) <= word_tol


@pytest.mark.parametrize("n_mels", [80, 128])
def test_log_mel_frames_matches_jax(n_mels):
    rng = np.random.RandomState(n_mels)
    for x in ((rng.randn(16000 * 3 + 400) * 0.1).astype(np.float32),
              (rng.randn(20000) * 3000).astype(np.int16)):
        ref = np.asarray(ja.log_mel_frames(x, n_mels))
        got = ta.log_mel_frames(x, n_mels)
        assert got.shape == ref.shape and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-4, rtol=0)


@pytest.mark.parametrize("chunk_seconds", [0.37, 2.0, 31.0])
def test_streaming_matches_transcribe_and_jax(models, jfk, chunk_seconds):
    """jfk tiled to 44 s: windows cross the chunk boundaries."""
    jmodel, tmodel = models
    audio = np.tile(jfk, 4)
    st = _stream(tmodel, audio, chunk_seconds, **KW)
    _assert_same(st.result, tmodel.transcribe(audio, verbose=None, **KW))
    if chunk_seconds == 2.0:
        _assert_same(st.result, _stream(jmodel, audio, chunk_seconds, JStreamer, **KW).result)


def test_streaming_single_short_window(models, jfk):
    """11 s: nothing before flush, then the flush path's one window."""
    _, tmodel = models
    st = StreamingTranscriber(tmodel, **KW)
    assert st.push(jfk) == []
    st.flush()
    _assert_same(st.result, tmodel.transcribe(jfk, verbose=None, **KW))


def test_streaming_word_timestamps(models, jfk):
    jmodel, tmodel = models
    audio = np.tile(jfk, 3)
    kw = dict(KW, word_timestamps=True)
    st = _stream(tmodel, audio, 5.0, **kw)
    _assert_same(st.result, tmodel.transcribe(audio, verbose=None, **kw))
    _assert_same(st.result, _stream(jmodel, audio, 5.0, JStreamer, **kw).result, word_tol=0.02)


def test_streaming_initial_prompt_and_flush_semantics(models, jfk):
    _, tmodel = models
    audio = np.tile(jfk, 3)
    kw = dict(KW, initial_prompt="JFK inaugural address")
    st = StreamingTranscriber(tmodel, **kw)
    st.push(audio)
    st.flush()
    _assert_same(st.result, tmodel.transcribe(audio, verbose=None, **kw))
    with pytest.raises(RuntimeError):
        st.push(np.zeros(160, np.float32))
    assert st.flush() == []  # idempotent


def test_streaming_with_write_blocks_equals_per_step(models, jfk, monkeypatch):
    """The single-row pending case (an int8 configuration on a wide
    decoder decodes its windows in write blocks): forced on here, the same
    segments as per-step writes."""
    _, tmodel = models
    audio = np.tile(jfk, 3)
    per_step = _stream(tmodel, audio, 5.0, **KW).result
    monkeypatch.setattr(DecodingTask, "write_block", lambda self, n_audio: 8)
    _assert_same(_stream(tmodel, audio, 5.0, **KW).result, per_step)


def test_streaming_mel_window_matches_full_mel(models, jfk):
    """The incremental window mel equals a slice of the whole-file mel
    where neither is floored."""
    _, tmodel = models
    audio = np.tile(jfk, 3)
    full = ta.log_mel_spectrogram(audio, 80, padding=16000 * 30).numpy()
    st = StreamingTranscriber(tmodel, **KW)
    # install PCM without processing windows (push would advance the seek)
    st._pcm = np.asarray(audio, np.float32)
    st._total_samples = len(audio)
    content = st._content_frames()
    for seek in (0, 1, 700, 3000, content - 100):
        size = min(3000, content - seek)
        got = st._window_mel(seek, size)
        assert got.shape == (80, 3000) and not got[:, size:].any()
        g, w = got[:, :size].numpy(), full[:, seek : seek + size]
        mask = (g > g.min() + 1e-6) & (w > w.min() + 1e-6)
        assert mask.mean() > 0.5
        np.testing.assert_allclose(g[mask], w[mask], atol=2e-4)
