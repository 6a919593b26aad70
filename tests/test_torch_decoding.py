"""The greedy slice of whisper_tpu_torch end to end against whisper_tpu.

Float32 at tests/_reference.py's TINY_DIMS, the same weights in both
packages (whisper_tpu's init_params written with save_npz and read with the
port's load_npz), temperature 0: DecodingTask.run and transcribe must give
the same tokens, segments and language.  Plus the port's own contracts: no
JAX in its import graph and nothing read from whisper_tpu's tree, no
silent move to the CPU, and NotImplementedError for what later slices bring
(beam search, best-of and word timestamps have their own tests:
tests/test_torch_beam.py, tests/test_torch_timing.py; int8 has
tests/test_torch_quantize.py).
"""

import ast
import os
import shutil
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


def test_draft_model_and_word_timestamps_raise(models, mel):
    """Neither raises any more: word timestamps run, and a draft model
    (here the model drafting for itself) decodes, from decode and from
    transcribe (which passes it on as whisper_tpu's does), to what the
    plain decode gives (its cases: tests/test_torch_speculative.py)."""
    _, tmodel = models
    opts = DecodingOptions(language="en", sample_len=24)
    plain = tmodel.decode(torch.from_numpy(mel[0]), opts)
    spec = tmodel.decode(torch.from_numpy(mel[0]), opts, draft_model=tmodel)
    assert spec.tokens == plain.tokens and abs(spec.avg_logprob - plain.avg_logprob) < 1e-4
    kw = dict(language="en", temperature=0.0, sample_len=8)
    audio = np.zeros(16000, np.float32)
    assert (tmodel.transcribe(audio, draft_model=tmodel, **kw)["text"]
            == tmodel.transcribe(audio, **kw)["text"])


def test_import_pulls_in_no_jax():
    code = (
        "import sys, whisper_tpu_torch, whisper_tpu_torch.ops.kernels.fused_step, chip_smoke, "
        "chip_compare, chip_trace_e3, whisper_tpu_torch.quantize, whisper_tpu_torch.evaluation, "
        "whisper_tpu_torch.ops.kernels.mlp, "
        "whisper_tpu_torch.timing, whisper_tpu_torch.__main__, whisper_tpu_torch.ops.kernels.median, "
        "whisper_tpu_torch.ops.kernels.dtw, whisper_tpu_torch.batch, whisper_tpu_torch.chunked, "
        "whisper_tpu_torch.align, whisper_tpu_torch.serve, whisper_tpu_torch.streaming, "
        "whisper_tpu_torch.experiments.encoder_ops, whisper_tpu_torch.experiments.logits, "
        "whisper_tpu_torch.experiments.attn_packed, whisper_tpu_torch.ops.kernels.matmul_residual, "
        "whisper_tpu_torch.ops.kernels.logits, whisper_tpu_torch.ops.kernels.attn_packed, "
        "whisper_tpu_torch.profiling, whisper_tpu_torch.normalizers; "
        "from whisper_tpu_torch.transcribe import cli; "
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'whisper_tpu', 'scripts') "
        f"or m in {_SCRIPT_MODULES!r}]; "
        "print(bad); sys.exit(1 if bad else 0)"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


# the modules under scripts/, importable by name once scripts/ is on sys.path
_SCRIPT_MODULES = sorted(f[:-3] for f in os.listdir(os.path.join(REPO, "scripts")) if f.endswith(".py"))


def _port_sources():
    pkg = os.path.join(REPO, "whisper_tpu_torch")
    paths = [os.path.join(REPO, f) for f in ("chip_smoke.py", "chip_compare.py", "chip_trace_e3.py")]
    for root, _, files in os.walk(pkg):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return paths


def test_port_reads_no_path_under_whisper_tpu():
    """No module of the port, nor chip_smoke.py, chip_compare.py or
    chip_trace_e3.py, imports
    whisper_tpu or a module of scripts/, or builds a path into either tree:
    no "whisper_tpu" path component, no "whisper_tpu/..." or "scripts/..."
    string in code.  Docstrings that cite a
    counterpart, and chip_smoke's ``replaces=`` (which names the TPU kernel
    a CUDA kernel replaces and is never opened), are not paths."""
    bad = []
    for path in _port_sources():
        tree = ast.parse(open(path).read())
        cited = {
            id(node.body[0].value) for node in ast.walk(tree)
            if isinstance(node, (ast.Module, ast.FunctionDef, ast.ClassDef))
            and node.body and isinstance(node.body[0], ast.Expr)
            and isinstance(node.body[0].value, ast.Constant)
        }
        cited |= {id(k.value) for k in ast.walk(tree) if isinstance(k, ast.keyword) and k.arg == "replaces"}
        for node in ast.walk(tree):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                names = [a.name for a in node.names] if isinstance(node, ast.Import) else [node.module or ""]
                bad += [(path, n) for n in names
                        if n.split(".")[0] in ("whisper_tpu", "scripts") or n in _SCRIPT_MODULES]
            elif isinstance(node, ast.Constant) and isinstance(node.value, str) and id(node) not in cited:
                if (node.value == "whisper_tpu" or node.value.startswith(("whisper_tpu/", "scripts/"))
                        or "/whisper_tpu/" in node.value or "/scripts/" in node.value):
                    bad.append((os.path.relpath(path, REPO), node.value[:60]))
    assert bad == []


def test_port_runs_from_a_tree_without_whisper_tpu(tmp_path):
    """The port's package alone, copied beside tests/jfk.flac, builds its
    native library, decodes audio, makes a mel, tokenizes and normalizes
    text (its own copy of the UK -> US spelling map)."""
    shutil.copytree(os.path.join(REPO, "whisper_tpu_torch"), tmp_path / "whisper_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = (
        "import sys, whisper_tpu_torch as w; from whisper_tpu_torch.tokenizer import get_tokenizer; "
        "from whisper_tpu_torch.normalizers import EnglishTextNormalizer; "
        "a = w.load_audio(sys.argv[1]); m = w.log_mel_spectrogram(a[:16000], 128); "
        "print(len(a), tuple(m.shape), get_tokenizer(True).encode(' hello world'), "
        "EnglishTextNormalizer()('Colour'), 'whisper_tpu' in sys.modules)"
    )
    proc = subprocess.run([sys.executable, "-c", code, JFK], cwd=tmp_path, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["176000", "(128,", "100)", "[7751,", "1002]", "color", "False"]


def test_pyproject_lists_every_port_package():
    """Every directory of whisper_tpu_torch/ with an __init__.py is among
    pyproject.toml's packages, so that an installed copy has it (the
    experiments' entry points, which chip_smoke.py imports, among them)."""
    import tomllib

    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        packages = set(tomllib.load(f)["tool"]["setuptools"]["packages"])
    found = {
        os.path.relpath(root, REPO).replace(os.sep, ".")
        for root, _, files in os.walk(os.path.join(REPO, "whisper_tpu_torch"))
        if "__init__.py" in files
    }
    assert "whisper_tpu_torch.experiments" in found and found <= packages, found - packages


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
