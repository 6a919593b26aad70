"""The greedy slice of whisper_tpu_torch end to end against whisper_tpu.

Float32 at tests/_reference.py's TINY_DIMS, the same weights in both
packages (whisper_tpu's init_params written with save_npz and read with the
port's load_npz), temperature 0: DecodingTask.run and transcribe must give
the same tokens, segments and language.  Plus the port's own contracts: no
JAX in its import graph, no silent move to the CPU, and NotImplementedError
for what later slices bring.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import whisper_tpu
from whisper_tpu.decoding import DecodingOptions as JOptions
from whisper_tpu.decoding import DecodingTask as JTask
from whisper_tpu.models.dims import ModelDimensions as JDims
from whisper_tpu.models.load import save_npz
from whisper_tpu.models.whisper import Whisper as JWhisper
from whisper_tpu.models.whisper import init_params

import whisper_tpu_torch
from whisper_tpu_torch.decoding import DecodingOptions, DecodingTask

from _reference import TINY_DIMS
from conftest import JFK

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@pytest.fixture(scope="module")
def npz_path(tmp_path_factory):
    dims = JDims(**TINY_DIMS)
    path = str(tmp_path_factory.mktemp("ckpt") / "tiny.npz")
    save_npz(path, init_params(dims, jax.random.PRNGKey(0), jnp.float32), dims)
    return path


@pytest.fixture(scope="module")
def models(npz_path):
    from whisper_tpu.models.load import load_npz as jload

    jmodel = JWhisper(*reversed(jload(npz_path)))
    tmodel = whisper_tpu_torch.load_model(npz_path, device="cpu")
    assert tmodel.dtype == torch.float32
    return jmodel, tmodel


@pytest.fixture(scope="module")
def mel():
    audio = whisper_tpu.load_audio(JFK)
    m = whisper_tpu.log_mel_spectrogram(whisper_tpu.pad_or_trim(audio), 80)
    return np.array(m)[None]  # (1, 80, 3000)


def _run_both(models, mel, **kw):
    jmodel, tmodel = models
    jres = JTask(jmodel, JOptions(**kw)).run(jnp.asarray(mel))[0]
    tres = DecodingTask(tmodel, DecodingOptions(**kw)).run(torch.from_numpy(mel))[0]
    return jres, tres


@pytest.mark.parametrize(
    "kw",
    [
        dict(language="en"),
        dict(language="en", without_timestamps=True),
        dict(language="en", prompt="the inaugural address", prefix="And so"),
        dict(language="en", sample_len=12, suppress_blank=False, suppress_tokens=""),
        dict(language=None),
    ],
    ids=["timestamps", "no_timestamps", "prompt_prefix", "short_unsuppressed", "lang_id"],
)
def test_decoding_task_run_matches_jax(models, mel, kw):
    jres, tres = _run_both(models, mel, temperature=0.0, **kw)
    assert tres.tokens == [int(t) for t in jres.tokens]
    assert tres.text == jres.text
    assert tres.language == jres.language
    assert abs(tres.no_speech_prob - jres.no_speech_prob) <= 1e-5
    assert abs(tres.avg_logprob - jres.avg_logprob) <= 1e-4
    assert abs(tres.compression_ratio - jres.compression_ratio) <= 1e-9


def test_detect_language_matches_jax(models, mel):
    jmodel, tmodel = models
    jtok, jprobs = whisper_tpu.detect_language(jmodel, jnp.asarray(mel[0]))
    ttok, tprobs = whisper_tpu_torch.detect_language(tmodel, torch.from_numpy(mel[0]))
    assert int(ttok) == int(jtok)
    assert max(tprobs, key=tprobs.get) == max(jprobs, key=jprobs.get)
    assert tprobs.keys() == jprobs.keys()
    assert max(abs(tprobs[c] - jprobs[c]) for c in jprobs) <= 1e-5


def test_forced_tokens_pin_the_same_sequence(models, mel):
    jmodel, tmodel = models
    tok = whisper_tpu_torch.tokenizer.get_tokenizer(
        True, num_languages=tmodel.num_languages, language="en", task="transcribe"
    )
    text = np.random.RandomState(0).randint(1000, 20000, size=20)
    forced = [tok.timestamp_begin, *map(int, text), tok.timestamp_begin + 1500, tok.eot]
    JTask._forced_tokens = np.asarray(forced, np.int32)
    DecodingTask._forced_tokens = forced
    try:
        jres, tres = _run_both(models, mel, language="en", temperature=0.0)
    finally:
        JTask._forced_tokens = None
        DecodingTask._forced_tokens = None
    assert tres.tokens == [int(t) for t in jres.tokens] == forced[:-1]
    # a pinned token the filters had masked scores -inf in both packages
    np.testing.assert_allclose(tres.avg_logprob, jres.avg_logprob, atol=1e-4)


def _compare(jr, tr):
    """The pattern of tests/test_transcribe.py's _compare."""
    assert tr["language"] == jr["language"]
    assert tr["text"] == jr["text"]
    assert len(tr["segments"]) == len(jr["segments"]) > 0
    for js, ts in zip(jr["segments"], tr["segments"]):
        assert ts["tokens"] == js["tokens"]
        assert ts["seek"] == js["seek"]
        assert abs(ts["start"] - js["start"]) < 1e-6
        assert abs(ts["end"] - js["end"]) < 1e-6


@pytest.mark.parametrize(
    "extra",
    [
        dict(),
        dict(initial_prompt="JFK speech", carry_initial_prompt=True),
        dict(clip_timestamps="2,8", condition_on_previous_text=False),
    ],
    ids=["plain", "carry_prompt", "clips_no_condition"],
)
def test_transcribe_matches_jax(models, extra):
    jmodel, tmodel = models
    kw = dict(
        language="en", temperature=0.0, verbose=None,
        compression_ratio_threshold=None, logprob_threshold=None,
        no_speech_threshold=None, **extra,
    )
    audio = whisper_tpu.load_audio(JFK)
    _compare(jmodel.transcribe(audio, **kw), tmodel.transcribe(audio, **kw))


def test_temperature_ladder_runs_every_rung_when_the_gates_fail(models):
    """An unreachable logprob threshold sends each window down the whole
    ladder; the kept result is the last rung's (sampled, seeded)."""
    _, tmodel = models
    temps = []
    decode = type(tmodel).decode

    def counting(self, mel, options, **kw):
        temps.append(options.temperature)
        return decode(self, mel, options, **kw)

    tmodel.decode = counting.__get__(tmodel)
    try:
        result = tmodel.transcribe(
            np.zeros(16000 * 3, np.float32), language="en", logprob_threshold=10.0,
            compression_ratio_threshold=None, no_speech_threshold=None,
            sample_len=6, seed=1,
        )
    finally:
        del tmodel.decode
    ladder = [0.0, 0.2, 0.4, 0.6, 0.8, 1.0]
    assert temps[:6] == ladder and len(temps) % 6 == 0
    assert all(s["temperature"] == 1.0 for s in result["segments"])


def test_sampling_is_reproducible_from_its_seed(models, mel):
    _, tmodel = models
    opts = DecodingOptions(language="en", temperature=0.8, seed=3, sample_len=16)
    a = DecodingTask(tmodel, opts).run(torch.from_numpy(mel))[0]
    b = DecodingTask(tmodel, opts).run(torch.from_numpy(mel))[0]
    assert a.tokens == b.tokens and a.temperature == 0.8


@pytest.mark.parametrize(
    "kw",
    [dict(beam_size=5), dict(temperature=0.5, best_of=5), dict(kv_cache_dtype="int8")],
    ids=["beam", "best_of", "int8_kv"],
)
def test_later_slices_raise_not_implemented(models, kw):
    _, tmodel = models
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        DecodingTask(tmodel, DecodingOptions(language="en", **kw))


def test_draft_model_and_word_timestamps_raise(models, mel):
    _, tmodel = models
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tmodel.decode(torch.from_numpy(mel[0]), DecodingOptions(language="en"), draft_model=tmodel)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tmodel.transcribe(np.zeros(16000, np.float32), language="en", word_timestamps=True)


def test_import_pulls_in_no_jax():
    code = (
        "import sys, whisper_tpu_torch, whisper_tpu_torch.ops.kernels.fused_step, chip_smoke; "
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'whisper_tpu')]; "
        "print(bad); sys.exit(1 if bad else 0)"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_load_model_never_falls_back_to_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the behaviour without one")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        whisper_tpu_torch.load_model("tiny")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        whisper_tpu_torch.load_model("turbo", device="cuda")


def test_load_model_random_weights_on_cpu(npz_path):
    """A checkpoint of random weights loads on the CPU in f32; random
    weights at a published size come from init_params and a seed."""
    from whisper_tpu_torch.models import KNOWN_MODELS
    from whisper_tpu_torch.models.whisper import init_params as tinit

    model = whisper_tpu_torch.load_model(npz_path, device="cpu")
    assert model.dims == whisper_tpu_torch.ModelDimensions(**TINY_DIMS)
    assert model.dtype == torch.float32 and model.device.type == "cpu"
    assert model.alignment_heads.shape[1] == 2

    dims = KNOWN_MODELS["tiny.en"]
    model = whisper_tpu_torch.Whisper(dims, tinit(dims, torch.Generator().manual_seed(0)))
    assert not model.is_multilingual and model.dtype == torch.float32
    again = tinit(dims, torch.Generator().manual_seed(0))
    torch.testing.assert_close(
        again["decoder"]["tok_emb"], model.params["decoder"]["tok_emb"], rtol=0, atol=0
    )
    assert "turbo" in whisper_tpu_torch.available_models()
