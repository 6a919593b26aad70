"""Word timing in whisper_tpu_torch against whisper_tpu, and the port's CLI.

The plain versions of K3 (median filter) and K4 (DTW trace) must equal
whisper_tpu's off-TPU forms bit for bit: ``_median_filter_xla`` and
``_dtw_trace_device`` (a median selects; the trace's ties decide codes).
``decoder_forward``'s alignment-head QK capture must match the JAX one to
5e-4.  End to end, in f32 at tests/_reference.py's TINY_DIMS on the same
weights, ``transcribe(word_timestamps=True)`` on jfk.flac must give the same
segments, words and word probabilities (1e-5), with word times within
0.02 s, one DTW frame.  The two CLIs must write the same files: the .srt
byte for byte, the .json equal up to float32 summation order in its float
fields (1e-5 relative).
"""

import importlib
import json
import os
import subprocess
import sys

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
from whisper_tpu.ops.dtw import _dtw_trace_device, dtw_numpy
from whisper_tpu.ops.median import _median_filter_xla
from whisper_tpu.ops.median import median_filter as j_median_filter

import whisper_tpu_torch
import whisper_tpu_torch.models.whisper as tw
from whisper_tpu_torch.ops import dtw as tdtw
from whisper_tpu_torch.ops.kernels import dtw as k4
from whisper_tpu_torch.ops.kernels import median as k3
from whisper_tpu_torch.ops.median import median_filter

from _reference import TINY_DIMS
from conftest import JFK

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# -- K3 and K4, plain -------------------------------------------------------


@pytest.mark.parametrize("shape", [(10,), (1, 15), (4, 5, 345), (6, 12, 240), (2, 3), (3, 7)])
@pytest.mark.parametrize("width", [3, 5, 7, 13])
def test_median_filter_equals_jax(shape, width):
    """The tests/test_timing.py shapes plus a T <= width // 2 and an odd T:
    the dispatcher returns short rows unchanged, as whisper_tpu's does; on
    longer rows K3's plain version equals _median_filter_xla bit for bit."""
    x = np.random.RandomState(width).randn(*shape).astype(np.float32)
    x[..., ::4] = np.round(x[..., ::4])  # ties
    launches = k3.median_filter.launches
    got = median_filter(torch.from_numpy(x), width).numpy()
    assert k3.median_filter.launches == launches  # a CPU tensor launches nothing
    if shape[-1] <= width // 2:
        ref = np.asarray(j_median_filter(x, width))
    else:
        ref = np.asarray(_median_filter_xla(jnp.asarray(x), width))
        assert np.array_equal(k3.median_filter_plain(torch.from_numpy(x), width).numpy().view(np.int32),
                              ref.view(np.int32))
    assert np.array_equal(got.view(np.int32), ref.view(np.int32))


def _batcher(n):
    """csrc/median.cu's sort_net<n> comparators: Batcher's merge-exchange
    (Knuth, TAOCP 5.2.2, Algorithm M)."""
    top = 1 << ((n - 1).bit_length() - 1) if n > 1 else 0
    pairs, p = [], top
    while p > 0:
        q = top
        while q >= p:
            d, r = (p, 0) if q == top else (2 * q - p, p)
            pairs += [(i, i + d) for i in range(n - d) if i & p == r]
            q >>= 1
        p >>= 1
    return pairs


def _k3_selection(x: torch.Tensor, width: int) -> torch.Tensor:
    """csrc/median.cu's selection restated in PyTorch: 32-bit keys; for the
    pair (t, t + 1), t even, the 2P shared values sorted by the network and
    each median the output's own value clamped between ranks P - 1 and P
    (output t's first window value, output t + 1's last); a median key of
    0 or NaN resolved by window position among the equal keys."""
    P, T = width // 2, x.shape[-1]
    pos = torch.arange(T)[:, None] + torch.arange(width) - P
    pos = torch.where(pos < 0, -pos, torch.where(pos >= T, 2 * (T - 1) - pos, pos))
    win, vals = (k3._sort_keys(x) // 16)[..., pos], x[..., pos]  # (..., T, width)
    if width == 1:
        med = win[..., 0]
    else:
        even = (torch.arange(T) % 2 == 0)[:, None]
        core = torch.where(even, win[..., 1:], win[..., :-1])
        extra = torch.where(even[:, 0], win[..., 0], win[..., -1])
        s = list(core.unbind(-1))
        for i, j in _batcher(2 * P):
            s[i], s[j] = torch.minimum(s[i], s[j]), torch.maximum(s[i], s[j])
        med = torch.maximum(s[P - 1], torch.minimum(extra, s[P]))
    bits = (med ^ ((med >> 31) & 0x7FFFFFFF)).to(torch.int32).view(torch.float32)
    eq = win == med[..., None]
    q = P - (win < med[..., None]).sum(-1)
    chosen = eq & (eq.cumsum(-1) - 1 == q[..., None])
    tied = vals.gather(-1, chosen.int().argmax(-1, keepdim=True))[..., 0]
    return torch.where((med == 0) | (med == 0x7FC00000), tied, bits)


@pytest.mark.parametrize("shape", [(3, 7), (2, 5, 345), (4, 1030), (1, 513)])
@pytest.mark.parametrize("width", [1, 3, 5, 7, 9, 11, 13])
def test_k3_selection_keeps_the_stable_sort(shape, width):
    """The kernel's pair selection (a sorted shared core, each output's own
    value clamped into it, ties resolved by window position) equals the
    plain version and whisper_tpu's _median_filter_xla bit for bit, on
    values with ties, signed zeros, infinities and NaNs of distinct
    payloads and signs side by side."""
    if shape[-1] <= width // 2:
        pytest.skip("the dispatcher returns such rows unchanged")
    rng = np.random.RandomState(width)
    x = rng.randn(*shape).astype(np.float32)
    x[..., ::4] = np.round(x[..., ::4])
    bits = x.view(np.int32)
    bits[..., 1::9] = 0  # +0 beside -0
    bits[..., 2::9] = np.int32(-(2**31))
    bits[..., 5::13] = np.int32(0x7FC00001)  # NaNs of distinct payloads, both signs
    bits[..., 6::17] = np.int32(0x7F800123)
    bits[..., 7::19] = np.int32(-0x00400001)  # 0xFFBFFFFF: a negative NaN
    x[..., 8::23] = np.inf
    x[..., 3::29] = -np.inf
    got = _k3_selection(torch.from_numpy(x), width).numpy().view(np.int32)
    assert np.array_equal(got, k3.median_filter_plain(torch.from_numpy(x), width).numpy().view(np.int32))
    ref = np.asarray(_median_filter_xla(jnp.asarray(x), width)).view(np.int32)
    assert np.array_equal(got, ref)


@pytest.mark.parametrize("N, M", [(10, 20), (32, 16), (60, 200)])
@pytest.mark.parametrize("ties", [False, True])
def test_dtw_trace_equals_jax(N, M, ties):
    rng = np.random.RandomState(N)
    x = rng.randint(0, 3, (N, M)).astype(np.float32) if ties else rng.randn(N, M).astype(np.float32)
    ref = np.asarray(_dtw_trace_device(jnp.asarray(x), N, M)).astype(np.int32)
    got = tdtw.dtw_trace(torch.from_numpy(x), N, M)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(tdtw.dtw(x), dtw_numpy(x))


def test_dtw_trace_batched_equals_unbatched():
    x = np.random.RandomState(0).randn(3, 17, 40).astype(np.float32)
    x[1] = np.round(x[1])
    launches = k4.dtw_trace.launches
    got = k4.dtw_trace(torch.from_numpy(x), 17, 40)
    assert k4.dtw_trace.launches == launches
    for b in range(3):
        ref = np.asarray(_dtw_trace_device(jnp.asarray(x[b]), 17, 40)).astype(np.int32)
        assert np.array_equal(got[b].numpy(), ref)


# -- QK capture -------------------------------------------------------------


@pytest.fixture(scope="module")
def npz_path(tmp_path_factory):
    dims = JDims(**TINY_DIMS)
    path = str(tmp_path_factory.mktemp("ckpt") / "tiny.npz")
    save_npz(path, jw.init_params(dims, jax.random.PRNGKey(0), jnp.float32), dims)
    return path


@pytest.fixture(scope="module")
def models(npz_path):
    return jw.Whisper(*reversed(jload(npz_path))), whisper_tpu_torch.load_model(npz_path, device="cpu")


def test_decoder_forward_qk_capture_matches_jax(models):
    jmodel, tmodel = models
    np.testing.assert_array_equal(tmodel.alignment_heads, jmodel.alignment_heads)
    rng = np.random.RandomState(0)
    feats = (rng.randn(1, 1500, TINY_DIMS["n_text_state"]) * 0.3).astype(np.float32)
    tokens = rng.randint(0, 50000, (1, 19))
    heads = np.array([[1, 1], [0, 0], [1, 0]])  # any order is kept
    jl, jqk = jw.decoder_forward(jmodel.params, jmodel.dims, jnp.asarray(tokens), jnp.asarray(feats),
                                 alignment_heads=heads)
    tl, tqk = tw.decoder_forward(tmodel.params, tmodel.dims, torch.from_numpy(tokens),
                                 torch.from_numpy(feats), alignment_heads=heads)
    assert tqk.shape == (3, 1, 19, 1500) and tqk.dtype == torch.float32
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=5e-4)
    np.testing.assert_allclose(tqk.numpy(), np.asarray(jqk), atol=5e-4)
    plain = tw.decoder_forward(tmodel.params, tmodel.dims, torch.from_numpy(tokens), torch.from_numpy(feats))
    torch.testing.assert_close(plain, tl, rtol=0, atol=0)


def test_alignment_heads_match_for_published_dims():
    from whisper_tpu_torch.models import KNOWN_MODELS

    for name in ("tiny", "turbo"):
        dims = KNOWN_MODELS[name]
        port = whisper_tpu_torch.Whisper(dims, {})
        ref = jw.Whisper(JDims(**dims.__dict__), params={})
        np.testing.assert_array_equal(port.alignment_heads, ref.alignment_heads)
    assert len(whisper_tpu_torch.Whisper(KNOWN_MODELS["turbo"], {}).alignment_heads) == 40


# -- transcribe(word_timestamps=True) ----------------------------------------


def _compare_words(jr, tr):
    assert tr["text"] == jr["text"] and tr["language"] == jr["language"]
    assert len(tr["segments"]) == len(jr["segments"])
    for js, ts in zip(jr["segments"], tr["segments"]):
        assert ts["tokens"] == js["tokens"] and ts["seek"] == js["seek"]
        assert abs(ts["start"] - js["start"]) <= 0.02 and abs(ts["end"] - js["end"]) <= 0.02
        assert [w["word"] for w in ts["words"]] == [w["word"] for w in js["words"]]
        for jword, tword in zip(js["words"], ts["words"]):
            assert abs(tword["start"] - jword["start"]) <= 0.02
            assert abs(tword["end"] - jword["end"]) <= 0.02
            assert abs(tword["probability"] - jword["probability"]) <= 1e-5


@pytest.mark.parametrize(
    "extra",
    [dict(), dict(beam_size=5, sample_len=32),
     dict(hallucination_silence_threshold=2.0, sample_len=32)],
    ids=["greedy", "beam5", "hallucination_silence"],
)
def test_transcribe_word_timestamps_match_jax(models, extra):
    jmodel, tmodel = models
    kw = dict(
        language="en", temperature=0.0, verbose=None, word_timestamps=True,
        compression_ratio_threshold=None, logprob_threshold=None, no_speech_threshold=None,
        **extra,
    )
    audio = whisper_tpu.load_audio(JFK)
    jr, tr = jmodel.transcribe(audio, **kw), tmodel.transcribe(audio, **kw)
    _compare_words(jr, tr)
    if "hallucination_silence_threshold" not in extra:
        assert sum(len(s["words"]) for s in tr["segments"]) > 0


def test_word_timestamps_on_translate_warn(models):
    _, tmodel = models
    with pytest.warns(UserWarning, match="translations"):
        tmodel.transcribe(np.zeros(16000, np.float32), language="en", task="translate",
                          word_timestamps=True, temperature=0.0, sample_len=4)


# -- the CLI -----------------------------------------------------------------


def _close(a, b):
    """Equal structure; floats within float32 summation order."""
    if isinstance(a, float) or isinstance(b, float):
        return abs(a - b) <= 1e-5 * max(1.0, abs(a), abs(b))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_close(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(_close(x, y) for x, y in zip(a, b))
    return a == b


def _cli(module, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["whisper", *argv])
    importlib.import_module(module).cli()


@pytest.mark.parametrize("words", [False, True], ids=["segments", "word_timestamps"])
def test_cli_writes_the_files_of_whisper_tpu(npz_path, tmp_path, monkeypatch, capsys, words):
    """CLI defaults (beam 5, best_of 5) with one temperature, so no sampled
    rung runs (the two packages' random streams differ), on the first
    second of jfk.flac."""
    common = [JFK, "--model", npz_path, "--device", "cpu", "--language", "en", "-f", "all",
              "--temperature_increment_on_fallback", "None", "--clip_timestamps", "0,1",
              "--verbose", "False"]
    if words:
        common += ["--word_timestamps", "True", "--highlight_words", "True"]
    port_dir, ref_dir = tmp_path / "port", tmp_path / "ref"
    _cli("whisper_tpu_torch.transcribe", [*common, "-o", str(port_dir)], monkeypatch)
    _cli("whisper_tpu.transcribe", [*common, "-o", str(ref_dir)], monkeypatch)
    assert "Skipping" not in capsys.readouterr().out

    for ext in ("txt", "vtt", "srt", "tsv", "json"):
        assert (port_dir / f"jfk.{ext}").is_file()
    assert (port_dir / "jfk.srt").read_text() == (ref_dir / "jfk.srt").read_text()
    port, ref = (json.loads((d / "jfk.json").read_text()) for d in (port_dir, ref_dir))
    assert _close(port, ref)
    assert all(("words" in s) == words for s in port["segments"])
    if words:
        assert "<u>" in (port_dir / "jfk.srt").read_text()


def test_cli_refuses_what_the_port_lacks(npz_path, tmp_path, monkeypatch):
    """As ``python -m whisper_tpu_torch``; the flag whisper_tpu has and the
    port does not yet raises, naming its ROADMAP item (``--chunked`` runs:
    tests/test_torch_chunked.py)."""
    proc = subprocess.run(
        [sys.executable, "-m", "whisper_tpu_torch", JFK, "--model", npz_path, "--device", "cpu",
         "-o", str(tmp_path), "--draft_model", "tiny"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode != 0 and "NotImplementedError" in proc.stderr
    assert "Speculative decoding" in proc.stderr
    with pytest.raises(NotImplementedError, match="Speculative decoding"):
        _cli("whisper_tpu_torch.transcribe",
             [JFK, "--model", npz_path, "--device", "cpu", "-o", str(tmp_path),
              "--draft_model", "tiny"], monkeypatch)
