"""Chunked long-form transcription in whisper_tpu_torch against whisper_tpu.

``chunk_offsets``, ``owned_segments`` and ``merge_chunk_segments`` are pure
functions: equal outputs on the same inputs.  ``transcribe_chunked`` on jfk
tiled to 70 s (three chunks, decoded as one batch) must give whisper_tpu's
segments token for token, in float32 at tests/_reference.py's TINY_DIMS on
the same weights, and raise where whisper_tpu's raises.  ``python -m
whisper_tpu_torch --chunked True`` must write what whisper_tpu's CLI writes
with the same flags.
"""

import importlib
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import whisper_tpu
import whisper_tpu.chunked as jc
import whisper_tpu.models.whisper as jw
from whisper_tpu.models.dims import ModelDimensions as JDims
from whisper_tpu.models.load import load_npz as jload
from whisper_tpu.models.load import save_npz

import whisper_tpu_torch
import whisper_tpu_torch.chunked as tc

from _reference import TINY_DIMS
from conftest import JFK

torch.set_num_threads(2)


@pytest.fixture(autouse=True, scope="module")
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@pytest.fixture(scope="module")
def npz_path(tmp_path_factory):
    dims = JDims(**TINY_DIMS)
    path = str(tmp_path_factory.mktemp("ckpt") / "tiny.npz")
    save_npz(path, jw.init_params(dims, jax.random.PRNGKey(0), jnp.float32), dims)
    return path


@pytest.fixture(scope="module")
def models(npz_path):
    return jw.Whisper(*reversed(jload(npz_path))), whisper_tpu_torch.load_model(npz_path, device="cpu")


# -- the pure functions ------------------------------------------------------


@pytest.mark.parametrize("n_seconds", [1, 30, 31, 55, 56.5, 405])
@pytest.mark.parametrize("overlap", [0.0, 5.0, 12.5])
def test_chunk_offsets_equal_jax(n_seconds, overlap):
    n = int(n_seconds * 16000)
    assert tc.chunk_offsets(n, overlap) == jc.chunk_offsets(n, overlap)


def test_chunk_offsets_refuse_what_jax_refuses():
    for overlap in (-1.0, 30.0, 31.0):
        with pytest.raises(ValueError, match="overlap"):
            jc.chunk_offsets(16000 * 60, overlap)
        with pytest.raises(ValueError, match="overlap"):
            tc.chunk_offsets(16000 * 60, overlap)


def _chunk_segments(seed: int, n_chunks: int):
    rng = np.random.RandomState(seed)
    chunks = []
    for c in range(n_chunks):
        segs = []
        for k in range(rng.randint(1, 6)):
            start = float(rng.uniform(0, 28))
            end = start + float(rng.uniform(0, 2))
            words = [dict(word=f" w{k}", start=start, end=end, probability=0.5)] if k % 2 else []
            segs.append(dict(id=k, seek=int(rng.randint(0, 3000)), start=start, end=end,
                             text=f" c{c}s{k}", tokens=[k], words=words))
        chunks.append(segs)
    return chunks


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_owned_and_merged_segments_equal_jax(seed):
    chunks = _chunk_segments(seed, 4)
    offsets = [0.0, 25.0, 50.0, 72.5]
    copy = json.loads(json.dumps(chunks))
    for i in range(4):
        assert tc.owned_segments(chunks[i], i, offsets) == jc.owned_segments(chunks[i], i, offsets)
    assert tc.merge_chunk_segments(chunks, offsets) == jc.merge_chunk_segments(chunks, offsets)
    assert chunks == copy  # inputs are not mutated
    with pytest.raises(ValueError, match="one offset per chunk"):
        tc.merge_chunk_segments(chunks, offsets[:3])


# -- transcribe_chunked ------------------------------------------------------

KW = dict(language="en", temperature=0.0, compression_ratio_threshold=None,
          logprob_threshold=None, no_speech_threshold=None, sample_len=48)


def test_transcribe_chunked_matches_jax(models):
    jmodel, tmodel = models
    audio = np.tile(whisper_tpu.load_audio(JFK), 7)[: 16000 * 70]
    jr = jc.transcribe_chunked(jmodel, audio, batch_size=4, **KW)
    tr = whisper_tpu_torch.transcribe_chunked(tmodel, audio, batch_size=4, **KW)
    assert tr["language"] == jr["language"] and tr["text"] == jr["text"]
    assert len(tr["segments"]) == len(jr["segments"]) > 0
    for js, ts in zip(jr["segments"], tr["segments"]):
        assert ts["id"] == js["id"] and ts["seek"] == js["seek"]
        assert ts["tokens"] == js["tokens"]
        assert abs(ts["start"] - js["start"]) <= 1e-6 and abs(ts["end"] - js["end"]) <= 1e-6
    assert max(s["end"] for s in tr["segments"]) > 30.0  # later chunks, rebased


@pytest.mark.parametrize(
    "bad",
    [dict(condition_on_previous_text=True), dict(clip_timestamps="0,5"),
     dict(word_timestamps=True, hallucination_silence_threshold=1.0),
     dict(word_seek_refinement=True)],
    ids=["conditioning", "clips", "hallucination", "refinement"],
)
def test_transcribe_chunked_raises_as_jax(models, bad):
    jmodel, tmodel = models
    audio = np.zeros(16000 * 2, np.float32)
    with pytest.raises(ValueError) as jerr:
        jc.transcribe_chunked(jmodel, audio, **KW, **bad)
    with pytest.raises(ValueError) as terr:
        whisper_tpu_torch.transcribe_chunked(tmodel, audio, **KW, **bad)
    assert str(terr.value) == str(jerr.value)


def test_cli_chunked_writes_the_files_of_whisper_tpu(npz_path, tmp_path, monkeypatch, capsys):
    """``--chunked True`` with beam 2 at one temperature on jfk.flac (one
    chunk)."""
    common = [JFK, "--model", npz_path, "--device", "cpu", "--language", "en", "-f", "json",
              "--temperature_increment_on_fallback", "None", "--verbose", "False",
              "--beam_size", "2", "--chunked", "True", "--chunk_overlap", "4"]
    out = {}
    for module, sub in (("whisper_tpu_torch.transcribe", "port"), ("whisper_tpu.transcribe", "ref")):
        monkeypatch.setattr(sys, "argv", ["whisper", *common, "-o", str(tmp_path / sub)])
        importlib.import_module(module).cli()
        out[sub] = json.loads((tmp_path / sub / "jfk.json").read_text())
    assert "Skipping" not in capsys.readouterr().out
    port, ref = out["port"], out["ref"]
    assert port["text"] == ref["text"] and len(port["segments"]) == len(ref["segments"])
    for ps, rs in zip(port["segments"], ref["segments"]):
        assert ps["tokens"] == rs["tokens"] and ps["seek"] == rs["seek"]
        assert abs(ps["avg_logprob"] - rs["avg_logprob"]) <= 1e-5
