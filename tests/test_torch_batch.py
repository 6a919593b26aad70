"""Batched decoding in whisper_tpu_torch against whisper_tpu.

Float32 at tests/_reference.py's TINY_DIMS, the same weights in both
packages (whisper_tpu's init_params through save_npz -> the port's
load_npz), the same numpy-made inputs.  Kernel K2's plain version at
per-row positions with A audios of G rows must give what
``decoder_step(..., n_group=G)`` gives (5e-4, one row past the cache among
them).  ``DecodingTask.run`` on three mels and ``run_with_prompts`` with
prompts of three lengths, greedy and beam 2, must be token-exact with
sum_logprobs within 1e-5 (relative above 1).  ``_slice_windows`` must equal
``_slice_windows_dev``, and the batch mel store each file's own
log-mel (1e-4).  ``transcribe_batch`` must give whisper_tpu's segments,
tokens and seeks, word times within 0.02 s, the port's own ``transcribe``
per file, and the same results in one group as in several.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import whisper_tpu
import whisper_tpu.models.whisper as jw
from whisper_tpu.batch import _slice_windows_dev
from whisper_tpu.decoding import DecodingOptions as JOptions
from whisper_tpu.decoding import DecodingTask as JTask
from whisper_tpu.models.dims import ModelDimensions as JDims
from whisper_tpu.models.load import load_npz as jload
from whisper_tpu.models.load import save_npz

import whisper_tpu_torch
import whisper_tpu_torch.models.whisper as tw
from whisper_tpu_torch.batch import _prepare_mels, _slice_windows
from whisper_tpu_torch.decoding import DecodingOptions, DecodingTask
from whisper_tpu_torch.models.dims import ModelDimensions
from whisper_tpu_torch.models.load import params_from_numpy
from whisper_tpu_torch.ops.kernels import fused_step as k2

from _reference import TINY_DIMS
from conftest import JFK

torch.set_num_threads(2)


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


@pytest.fixture(scope="module")
def mels(audio):
    """Three windows: jfk, noise, jfk from 3 s on."""
    noise = np.random.RandomState(0).randn(16000 * 8).astype(np.float32) * 0.05
    waves = [audio, noise, audio[3 * 16000 :]]
    return np.stack(
        [np.array(whisper_tpu.log_mel_spectrogram(whisper_tpu.pad_or_trim(w), 80)) for w in waves]
    )


# -- K2 plain at per-row positions -------------------------------------------

# head_dim 64, as the CUDA kernel takes
STEP_KW = dict(TINY_DIMS, n_text_state=128, n_audio_state=128)


@pytest.mark.parametrize("A,G", [(3, 1), (2, 3), (1, 4)], ids=["multi", "groups", "one_audio"])
def test_k2_plain_at_per_row_positions_matches_jax(A, G):
    """Rows at positions 0..T, the last past the cache: hidden and the
    cache 5e-4; the past row attends the whole cache, and its write is
    dropped."""
    jdims, dims = JDims(**STEP_KW), ModelDimensions(**STEP_KW)
    jparams = jw.init_params(jdims, jax.random.PRNGKey(1), jnp.float32)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), dims)
    B, T, L, H = A * G, 32, dims.n_text_layer, dims.n_text_head
    rng = np.random.RandomState(A * 10 + G)
    feats = jnp.asarray(rng.randn(A, 1500, 128) * 0.3, jnp.float32)
    xk, xv = (np.array(a) for a in jw.compute_cross_kv(jparams, jdims, feats))
    sk = (rng.randn(L, B, H, 64, T) * 0.1).astype(np.float32)
    sv = (rng.randn(L, B, H, 64, T) * 0.1).astype(np.float32)
    t = np.array([0, 5, 17, 31, T, 9][:B] if B > 1 else [T])
    t[-1] = T  # one row past the cache
    tokens = rng.randint(0, 50000, B)

    ref_h, ref_cache = jw.decoder_step(
        jparams, jdims, jnp.asarray(tokens, jnp.int32), jnp.asarray(t, jnp.int32),
        jw.KVCache(*(jnp.asarray(a) for a in (sk, sv, xk, xv))), n_group=G,
    )
    cache = tw.KVCache(*(torch.from_numpy(a.copy()) for a in (sk, sv, xk, xv)))
    launches = k2.fused_decoder_layers.launches
    h, cache = tw.decoder_step_fused(tparams, dims, torch.from_numpy(tokens), torch.from_numpy(t), cache)
    assert k2.fused_decoder_layers.launches == launches  # a CPU tensor launches nothing
    np.testing.assert_allclose(h.numpy(), np.asarray(ref_h), atol=5e-4)
    np.testing.assert_allclose(cache.self_k.numpy(), np.asarray(ref_cache.self_k), atol=5e-4)
    np.testing.assert_allclose(cache.self_v.numpy(), np.asarray(ref_cache.self_v), atol=5e-4)
    np.testing.assert_array_equal(cache.self_k[:, -1].numpy(), sk[:, -1])  # dropped


def test_k2_plain_refuses_audios_that_do_not_divide_the_rows():
    dims = ModelDimensions(**STEP_KW)
    params = tw.init_params(dims, torch.Generator().manual_seed(0))
    L, H = dims.n_text_layer, dims.n_text_head
    x = torch.zeros(4, 128)
    caches = [torch.zeros(L, 4, H, 64, 8)] * 2 + [torch.zeros(L, 3, H, 64, 16)] * 2
    with pytest.raises(ValueError, match="divide"):
        k2.fused_decoder_layers(params["decoder"]["blocks"], H, x, 3, *caches)


# -- DecodingTask.run and run_with_prompts -----------------------------------


def _close_sums(jr, tr):
    js = jr.avg_logprob * (len(jr.tokens) + 1)
    ts = tr.avg_logprob * (len(tr.tokens) + 1)
    return abs(js - ts) <= 1e-5 * max(1.0, abs(js))


def _same(jres, tres):
    assert len(jres) == len(tres)
    for jr, tr in zip(jres, tres):
        assert tr.tokens == [int(x) for x in jr.tokens]
        assert tr.text == jr.text and tr.language == jr.language
        assert _close_sums(jr, tr)
        assert abs(tr.no_speech_prob - jr.no_speech_prob) <= 1e-5


RUN_CASES = [
    dict(language="en", sample_len=24),
    dict(language=None, sample_len=16),
    dict(language="en", beam_size=2, sample_len=24),
]


@pytest.mark.parametrize("kw", RUN_CASES, ids=["greedy", "lang_id", "beam2"])
def test_decoding_task_run_on_three_mels_matches_jax(models, mels, kw):
    jmodel, tmodel = models
    jres = JTask(jmodel, JOptions(temperature=0.0, **kw)).run(jnp.asarray(mels))
    tres = DecodingTask(tmodel, DecodingOptions(temperature=0.0, **kw)).run(torch.from_numpy(mels))
    _same(jres, tres)
    if kw["language"] is None:
        for jr, tr in zip(jres, tres):
            assert max(abs(tr.language_probs[c] - jr.language_probs[c]) for c in jr.language_probs) <= 1e-5


@pytest.mark.parametrize("beam", [None, 2], ids=["greedy", "beam2"])
def test_run_with_prompts_matches_jax(models, mels, beam):
    """Prompts of 0, 5 and 40 tokens: three prompt lengths in one decode."""
    jmodel, tmodel = models
    rng = np.random.RandomState(5)
    prompts = [[], list(map(int, rng.randint(1000, 20000, 5))), list(map(int, rng.randint(1000, 20000, 40)))]
    kw = dict(language="en", temperature=0.0, beam_size=beam, sample_len=24)
    jres = JTask(jmodel, JOptions(**kw)).run_with_prompts(jnp.asarray(mels), prompts)
    ttask = DecodingTask(tmodel, DecodingOptions(**kw))
    tres = ttask.run_with_prompts(torch.from_numpy(mels), prompts)
    _same(jres, tres)
    # each row is the single-row decode with that prompt
    for i, prompt in enumerate(prompts):
        alone = DecodingTask(tmodel, DecodingOptions(prompt=prompt or None, **kw)).run(
            torch.from_numpy(mels[i : i + 1])
        )[0]
        assert alone.tokens == tres[i].tokens


def test_engine_steps_at_one_shared_or_per_row_positions(models, mels, monkeypatch):
    """Prompts of one length step every row at one host int (no per-row
    gather or scatter); prompts of different lengths step row b at the
    device position len(row b's initial tokens) + step - 1."""
    import whisper_tpu_torch.engine as te

    _, tmodel = models
    seen = []

    def spying(step):
        def spy(params, dims, tokens, t, cache):
            seen.append(t if isinstance(t, int) else t.tolist())
            return step(params, dims, tokens, t, cache)
        return spy

    # the engine takes K2's step or the PyTorch one by the decoder's shape
    # (engine.decoder_steps); watch both
    for name in ("decoder_step_fused", "decoder_step"):
        monkeypatch.setattr(te, name, spying(getattr(te, name)))
    task = DecodingTask(tmodel, DecodingOptions(language="en", temperature=0.0, beam_size=2, sample_len=6))
    task.run(torch.from_numpy(mels))
    begin = task.sample_begin
    assert seen == list(range(begin, begin + len(seen))) and seen
    seen.clear()
    prompts = [[], [1000] * 5, [2000] * 40]
    task.run_with_prompts(torch.from_numpy(mels), prompts)
    begins = [begin + (len(p) + 1 if p else 0) for p in prompts]
    assert seen and seen == [[b + s for b in begins for _ in range(2)] for s in range(len(seen))]


def test_run_with_prompts_row_past_the_buffer_matches_jax(models, mels):
    """A 223-token prompt fills the 448-column buffer before sample_len: its
    row caps and freezes while the unprompted rows decode on (the capped
    row's filters then read past the buffer, which must not fail)."""
    jmodel, tmodel = models
    text = list(map(int, np.random.RandomState(6).randint(1000, 20000, 223)))
    prompts = [[], text, []]
    kw = dict(language="en", temperature=0.0)
    jres = JTask(jmodel, JOptions(**kw)).run_with_prompts(jnp.asarray(mels), prompts)
    tres = DecodingTask(tmodel, DecodingOptions(**kw)).run_with_prompts(torch.from_numpy(mels), prompts)
    _same(jres, tres)
    assert len(tres[1].tokens) <= 449 - 227 < 224  # a 448-column cache, 449 tokens


def test_run_with_prompts_argument_errors(models, mels):
    _, tmodel = models
    with pytest.raises(ValueError, match="pinned language"):
        DecodingTask(tmodel, DecodingOptions(language=None)).run_with_prompts(mels, [[]] * 3)
    with pytest.raises(ValueError, match="conflict"):
        DecodingTask(tmodel, DecodingOptions(language="en", prompt="x")).run_with_prompts(mels, [[]] * 3)


# -- the mel store and the window slices -------------------------------------


def test_slice_windows_equals_jax():
    rng = np.random.RandomState(0)
    store = rng.randn(3, 4, 7000).astype(np.float32)
    rows = np.array([0, 2, 1, 2, 0], np.int32)
    seeks = np.array([0, 123, 6000, 3999, 4000], np.int32)  # 6000: past the store's end
    sizes = np.array([3000, 2000, 3000, 0, 2999], np.int32)
    ref = np.asarray(_slice_windows_dev(*(jnp.asarray(a) for a in (store, rows, seeks, sizes))))
    got = _slice_windows(torch.from_numpy(store), *(torch.from_numpy(a).long() for a in (rows, seeks, sizes)))
    assert got.shape == ref.shape == (5, 4, 3000)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_batch_mel_store_equals_each_files_log_mel(models, audio):
    """Files of 11 s, 4 s and 40 s share one store padded to the longest;
    each row equals the file's own log-mel over every frame a window can
    read, within 1e-4."""
    _, tmodel = models
    noise = np.random.RandomState(1).randn(16000 * 4).astype(np.float32) * 0.05
    files = [audio, noise, np.tile(audio, 4)[: 16000 * 40]]
    store, lens = _prepare_mels(tmodel, files, lambda x: x)
    assert lens == [len(f) for f in files]
    for i, f in enumerate(files):
        own = whisper_tpu_torch.log_mel_spectrogram(f, 80, padding=16000 * 30)
        ref = np.array(whisper_tpu.log_mel_spectrogram(f, 80, padding=16000 * 30))
        n = own.shape[-1]
        np.testing.assert_allclose(store[i, :, :n].numpy(), own.numpy(), atol=1e-4)
        np.testing.assert_allclose(store[i, :, :n].numpy(), ref, atol=1e-4)


# -- transcribe_batch --------------------------------------------------------


def _files(audio):
    noise = np.random.RandomState(2).randn(16000 * 6).astype(np.float32) * 0.05
    return [audio, noise, audio[: 16000 * 4], np.tile(audio, 4)[: 16000 * 40]]


def _compare(jr, tr, words=False):
    assert tr["language"] == jr["language"] and tr["text"] == jr["text"]
    assert len(tr["segments"]) == len(jr["segments"])
    for js, ts in zip(jr["segments"], tr["segments"]):
        assert ts["tokens"] == js["tokens"] and ts["seek"] == js["seek"]
        assert abs(ts["start"] - js["start"]) <= (0.02 if words else 1e-6)
        assert abs(ts["end"] - js["end"]) <= (0.02 if words else 1e-6)
        if words:
            assert [w["word"] for w in ts["words"]] == [w["word"] for w in js["words"]]
            for jw_, tw_ in zip(js["words"], ts["words"]):
                assert abs(tw_["start"] - jw_["start"]) <= 0.02
                assert abs(tw_["end"] - jw_["end"]) <= 0.02


BATCH_KW = dict(language="en", temperature=0.0, compression_ratio_threshold=None,
                logprob_threshold=None, no_speech_threshold=None, sample_len=48,
                condition_on_previous_text=True)


@pytest.mark.parametrize("words", [False, True], ids=["segments", "word_timestamps"])
def test_transcribe_batch_matches_jax(models, audio, words):
    jmodel, tmodel = models
    files = _files(audio)
    kw = dict(BATCH_KW, word_timestamps=words)
    jres = whisper_tpu.transcribe_batch(jmodel, files, batch_size=4, **kw)
    tres = whisper_tpu_torch.transcribe_batch(tmodel, files, batch_size=4, **kw)
    assert len(tres) == len(files)
    for jr, tr in zip(jres, tres):
        _compare(jr, tr, words)
    assert len(tres[3]["segments"]) > 1  # the 40 s file decoded a second window


def test_transcribe_batch_equals_transcribe_and_regroups(models, audio):
    """Per file the port's own transcribe; four files in groups of two (the
    refill and prefetch path) as in one group of four."""
    _, tmodel = models
    files = _files(audio)
    one = tmodel.transcribe_batch(files, batch_size=4, **BATCH_KW)
    piped = tmodel.transcribe_batch(files, batch_size=2, **BATCH_KW)
    for f, a, b in zip(files, one, piped):
        _compare(tmodel.transcribe(f, verbose=None, **BATCH_KW), a)
        _compare(a, b)


def test_transcribe_batch_reports_its_stages(models, audio):
    """Any object whose .stage(name) is a context manager times the stages;
    with one, the groups are prepared serially and the results stay the
    same."""
    _, tmodel = models

    class Recorder:
        def __init__(self):
            self.names = []

        def stage(self, name):
            self.names.append(name)
            return contextlib.nullcontext()

    files = _files(audio)[:2]
    recorder = Recorder()
    timed = tmodel.transcribe_batch(files, batch_size=1, stage_timer=recorder, word_timestamps=True,
                                    **BATCH_KW)
    for a, b in zip(tmodel.transcribe_batch(files, batch_size=1, word_timestamps=True, **BATCH_KW), timed):
        _compare(a, b, words=True)
    assert {"audio_host", "mel", "window_slice", "engine", "segment", "alignment"} <= set(recorder.names)


SPANS = {"audio_host", "mel", "window_slice", "engine", "segment", "alignment", "assemble",
         "encoder", "prefill", "step", "filters", "update", "decode_step", "logits", "sync"}


@pytest.mark.parametrize("write_block", [0, 4], ids=["per_step", "blocks_of_4"])
def test_transcribe_batch_records_every_span(models, audio, monkeypatch, write_block):
    """Under profiling.recording every span of the batching stages and the
    engine records, a step span per token step and a sync span per block of
    steps, and the results stay those of an unrecorded call."""
    from whisper_tpu_torch import engine
    from whisper_tpu_torch.profiling import StageTimer, recording

    _, tmodel = models
    monkeypatch.setattr(DecodingTask, "write_block", lambda self, n_audio: write_block)
    calls = [0]
    real_steps = engine.decoder_steps

    def counting(fn):
        def step(*args):
            calls[0] += 1
            return fn(*args)
        return step

    monkeypatch.setattr(engine, "decoder_steps",
                        lambda params, dims: tuple(map(counting, real_steps(params, dims))))
    files = _files(audio)[:2]
    kw = dict(BATCH_KW, word_timestamps=True)
    plain = whisper_tpu_torch.transcribe_batch(tmodel, files, batch_size=2, **kw)
    steps, calls[0] = calls[0], 0
    timer = StageTimer("cpu")
    with recording(timer):
        recorded = whisper_tpu_torch.transcribe_batch(tmodel, files, batch_size=2, **kw)
    for a, b in zip(plain, recorded):
        _compare(a, b, words=True)
    assert set(timer.counts) == SPANS
    assert calls[0] == steps > 0
    for name in ("step", "filters", "update", "decode_step", "logits"):
        assert timer.counts[name] == steps, name
    assert timer.counts["sync"] == steps // max(write_block, 1)
    assert timer.counts["encoder"] == timer.counts["prefill"] == timer.counts["engine"]


@pytest.mark.parametrize("recorded", [False, True], ids=["no_recorder", "recording"])
def test_a_profiler_sees_the_spans_only_under_recording(models, audio, recorded):
    from torch.profiler import ProfilerActivity, profile

    from whisper_tpu_torch.profiling import StageTimer, recording

    _, tmodel = models
    with contextlib.ExitStack() as stack:
        if recorded:
            stack.enter_context(recording(StageTimer("cpu")))
        prof = stack.enter_context(profile(activities=[ProfilerActivity.CPU]))
        whisper_tpu_torch.transcribe_batch(tmodel, [audio[: 16000 * 4]], batch_size=1,
                                           **dict(BATCH_KW, sample_len=4))
    names = {e.name for e in prof.events() if e.name.startswith("whisper.")}
    assert names == ({"whisper." + n for n in SPANS - {"alignment"}} if recorded else set())


def test_transcribe_batch_rejects_a_fixed_prompt(models, audio):
    _, tmodel = models
    with pytest.raises(NotImplementedError, match="per file"):
        whisper_tpu_torch.transcribe_batch(tmodel, [audio], prompt="hello", **BATCH_KW)
    with pytest.raises(ValueError, match="word_seek_refinement"):
        whisper_tpu_torch.transcribe_batch(
            tmodel, [audio], word_timestamps=True, word_seek_refinement=False,
            hallucination_silence_threshold=1.0, **BATCH_KW,
        )
