"""Forced alignment in whisper_tpu_torch against whisper_tpu.

Float32 at tests/_reference.py's TINY_DIMS on the same weights:
``align(text=...)`` on jfk.flac and ``align(segments=...)`` on jfk tiled to
40 s (three segments sliced out of one mel store and aligned in one pass)
must give whisper_tpu's words, word for word, with start and end times
within 0.02 s (one DTW frame) and probabilities within 1e-5; the argument
errors are whisper_tpu's.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import whisper_tpu
import whisper_tpu.models.whisper as jw
from whisper_tpu.models.dims import ModelDimensions as JDims
from whisper_tpu.models.load import load_npz as jload
from whisper_tpu.models.load import save_npz

import whisper_tpu_torch

from _reference import TINY_DIMS
from conftest import JFK

ja = importlib.import_module("whisper_tpu.align")  # the package rebinds the name to the function
torch.set_num_threads(2)
TEXT = ("And so my fellow Americans, ask not what your country can do for you, "
        "ask what you can do for your country.")


@pytest.fixture(autouse=True, scope="module")
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    dims = JDims(**TINY_DIMS)
    path = str(tmp_path_factory.mktemp("ckpt") / "tiny.npz")
    save_npz(path, jw.init_params(dims, jax.random.PRNGKey(0), jnp.float32), dims)
    return jw.Whisper(*reversed(jload(path))), whisper_tpu_torch.load_model(path, device="cpu")


@pytest.fixture(scope="module")
def audio():
    return whisper_tpu.load_audio(JFK)


def _compare(jr, tr):
    assert tr["language"] == jr["language"]
    assert len(tr["segments"]) == len(jr["segments"])
    for js, ts in zip(jr["segments"], tr["segments"]):
        assert (ts["start"], ts["end"], ts["text"]) == (js["start"], js["end"], js["text"])
        assert [w["word"] for w in ts["words"]] == [w["word"] for w in js["words"]]
        assert ts["words"]
        for jword, tword in zip(js["words"], ts["words"]):
            assert abs(tword["start"] - jword["start"]) <= 0.02
            assert abs(tword["end"] - jword["end"]) <= 0.02
            assert abs(tword["probability"] - jword["probability"]) <= 1e-5


def test_align_text_matches_jax(models, audio):
    jmodel, tmodel = models
    _compare(ja.align(jmodel, audio, TEXT), whisper_tpu_torch.align(tmodel, audio, TEXT))


def test_align_segments_matches_jax(models, audio):
    jmodel, tmodel = models
    long = np.tile(audio, 4)[: 16000 * 40]
    segments = [
        dict(start=0.0, end=11.0, text=TEXT),
        dict(start=11.2, end=17.5, text="ask not what your country can do"),
        dict(start=25.0, end=40.0, text="for you, ask what you can do for your country."),
    ]
    jr = ja.align(jmodel, long, segments=segments)
    tr = tmodel.align(long, segments=segments)
    _compare(jr, tr)
    assert tr["segments"][2]["words"][0]["start"] >= 25.0  # absolute times


@pytest.mark.parametrize(
    "args,kw",
    [
        ((), {}),
        ((TEXT,), dict(segments=[dict(start=0.0, end=1.0, text="x")])),
        ((), dict(segments=[dict(start=0.0, end=12.0, text="x")])),  # past the end
        ((), dict(segments=[dict(start=1.0, end=0.5, text="x")])),
    ],
    ids=["neither", "both", "beyond_eof", "reversed"],
)
def test_align_argument_errors_as_jax(models, audio, args, kw):
    jmodel, tmodel = models
    with pytest.raises(ValueError) as jerr:
        ja.align(jmodel, audio, *args, **kw)
    with pytest.raises(ValueError) as terr:
        whisper_tpu_torch.align(tmodel, audio, *args, **kw)
    assert str(terr.value) == str(jerr.value)


def test_align_refuses_a_long_clip_and_a_long_segment(models):
    _, tmodel = models
    long = np.zeros(16000 * 40, np.float32)
    with pytest.raises(ValueError, match="one <=30 s clip"):
        whisper_tpu_torch.align(tmodel, long, TEXT)
    with pytest.raises(ValueError, match="exceeds the 30 s window"):
        whisper_tpu_torch.align(tmodel, long, segments=[dict(start=0.0, end=31.0, text="x")])
