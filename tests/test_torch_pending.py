"""The write block in whisper_tpu_torch against whisper_tpu.

Float32 on the CPU, the same weights in both packages (whisper_tpu's
init_params, through params_from_numpy or save_npz -> load_npz) and the same
numpy-seeded inputs.  Tolerances:

- the pending decode step (``decoder_step_pending`` and the engine's
  ``decoder_step_fused_pending``, K2's plain version with a pending block)
  against whisper_tpu's ``decoder_step_pending``, and where its Pallas
  kernel takes the layout, against ``decoder_step_fused_pending`` in
  interpret mode: hidden atol 3e-5 / rtol 1e-4, the pending K/V 1e-5 (the
  bounds of tests/test_fused_step.py), unquantized and int8 weights with
  int8 cross K/V;
- ``flush_pending``: equal to whisper_tpu's, bit for bit (a copy);
- the write-block engine: token-exact with whisper_tpu's block engine and
  with the port's per-step engine, log-prob sums within 1e-5 (relative
  above 1: the pending keys enter the softmax sums in another order);
- ``DecodingTask.write_block``: whisper_tpu's policy on its kernel path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from dataclasses import replace

import whisper_tpu
import whisper_tpu.models.whisper as jw
import whisper_tpu.quantize as jq
from whisper_tpu.decoding import DecodingOptions as JOptions
from whisper_tpu.decoding import DecodingTask as JTask
from whisper_tpu.models.dims import ModelDimensions as JDims
from whisper_tpu.models.load import load_npz as jload
from whisper_tpu.models.load import save_npz
from whisper_tpu.ops.kernels.fused_step_pallas import pack_fused_weights, pad_cross_kv

import whisper_tpu_torch
import whisper_tpu_torch.models.whisper as tw
import whisper_tpu_torch.quantize as tq
from whisper_tpu_torch.decoding import DecodingOptions, DecodingTask
from whisper_tpu_torch.models.dims import ModelDimensions
from whisper_tpu_torch.models.load import params_from_numpy
from whisper_tpu_torch.ops.kernels import fused_step as k2

from _reference import TINY_DIMS
from conftest import JFK

torch.set_num_threads(2)
# head_dim 64, as the CUDA kernel takes
STEP_KW = dict(TINY_DIMS, n_text_state=128, n_audio_state=128)
W = 8


@pytest.fixture(autouse=True, scope="module")
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _port_kv(leaf) -> tq.Int8Weight:
    return tq.Int8Weight(*(torch.from_numpy(np.array(leaf[k])) for k in ("q", "s")))


# -- the pending decode step ---------------------------------------------------


@pytest.fixture(scope="module")
def step_params():
    jparams = jw.init_params(JDims(**STEP_KW), jax.random.PRNGKey(1), jnp.float32)
    return {False: jparams, True: jq.quantize_params(jparams, scopes=("decoder",))}


# (A, G, per-row block starts): one row; three audios at their own starts;
# two audios of three rows (whisper_tpu's XLA pending step with n_group=3)
LAYOUTS = [(1, 1, False), (3, 1, True), (2, 3, True)]


@pytest.mark.parametrize("int8", [False, True], ids=["dense", "int8+kv_int8"])
@pytest.mark.parametrize("w", [0, W - 1])
@pytest.mark.parametrize("A,G,per_row", LAYOUTS, ids=["1x1", "3x1_per_row", "2x3_per_row"])
def test_pending_step_matches_jax(step_params, A, G, per_row, w, int8):
    jdims, dims = JDims(**STEP_KW), ModelDimensions(**STEP_KW)
    jparams = step_params[int8]
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), dims)
    B, T, L, H = A * G, 64, dims.n_text_layer, dims.n_text_head
    rng = np.random.RandomState(A * 100 + G * 10 + w)
    feats = jnp.asarray(rng.randn(A, 1500, 128) * 0.3, jnp.float32)
    xk, xv = jw.compute_cross_kv(jparams, jdims, feats)
    if int8:
        xk, xv = jq.quantize_kv(xk), jq.quantize_kv(xv)
    starts = np.array([9, 30, 2, 17, 41, 5][:B]) if per_row else np.full(B, 12)
    sk = (rng.randn(L, B, H, 64, T) * 0.1).astype(np.float32)
    sv = (rng.randn(L, B, H, 64, T) * 0.1).astype(np.float32)
    for b, s in enumerate(starts):  # the committed cache ends at the block's start
        sk[:, b, ..., s:] = 0
        sv[:, b, ..., s:] = 0
    # every pending column filled: those at and past w must be masked
    pk = (rng.randn(L, B, H, 64, W) * 0.1).astype(np.float32)
    pv = (rng.randn(L, B, H, 64, W) * 0.1).astype(np.float32)
    tokens = rng.randint(0, 50000, B)
    t = starts + w

    jcache = jw.KVCache(jnp.asarray(sk), jnp.asarray(sv), xk, xv)
    jtok = jnp.asarray(tokens, jnp.int32)
    jt, jbs = (jnp.asarray(a, jnp.int32) for a in (t, starts)) if per_row else (
        jnp.int32(int(t[0])), jnp.int32(int(starts[0])))
    refs = [jw.decoder_step_pending(jparams, jdims, jtok, jt, jbs, jnp.int32(w), jnp.asarray(pk),
                                    jnp.asarray(pv), jcache, n_group=G)]
    if G == 1 and w == W - 1:  # the TPU kernel itself, run by the Pallas interpreter
        refs.append(jw.decoder_step_fused_pending(
            jparams, pack_fused_weights(jparams, jdims), jdims, jtok, jt, jbs, jnp.int32(w),
            jnp.asarray(pk), jnp.asarray(pv), jcache, *pad_cross_kv(xk, xv)))

    cross = [_port_kv(a) if int8 else torch.from_numpy(np.array(a)) for a in (xk, xv)]
    tt, tbs = (torch.from_numpy(t), torch.from_numpy(starts)) if per_row else (int(t[0]), int(starts[0]))
    outs = []
    for step in (tw.decoder_step_pending, tw.decoder_step_fused_pending):
        tcache = tw.KVCache(torch.from_numpy(sk.copy()), torch.from_numpy(sv.copy()), *cross)
        launches = k2.fused_decoder_layers.launches
        h, tpk, tpv = step(tparams, dims, torch.from_numpy(tokens), tt, tbs, w,
                           torch.from_numpy(pk.copy()), torch.from_numpy(pv.copy()), tcache)
        assert k2.fused_decoder_layers.launches == launches  # a CPU tensor launches nothing
        np.testing.assert_array_equal(tcache.self_k.numpy(), sk)  # the cache is not touched
        outs.append((h, tpk, tpv))
    for (h, tpk, tpv) in outs:
        for ref_h, ref_pk, ref_pv in refs:
            np.testing.assert_allclose(h.numpy(), np.asarray(ref_h), atol=3e-5, rtol=1e-4)
            np.testing.assert_allclose(tpk.numpy(), np.asarray(ref_pk), atol=1e-5)
            np.testing.assert_allclose(tpv.numpy(), np.asarray(ref_pv), atol=1e-5)


def test_pending_step_refuses_a_half_block():
    """The wrapper takes a pending block's K and V together, (L, B, H, D, W)
    with 1 <= W <= 64 and 0 <= pend_w <= W (checked before any launch: the
    check runs on CPU tensors too through _check_args)."""
    L, B, H, T, C = 2, 3, 2, 16, 128
    blocks = tw.init_params(ModelDimensions(**STEP_KW), torch.Generator().manual_seed(0))["decoder"]["blocks"]
    x = torch.zeros(B, C)
    sk = torch.zeros(L, B, H, 64, T)
    xk = torch.zeros(L, B, H, 64, 32)
    pk = torch.zeros(L, B, H, 64, W)
    for pend in ((pk, None, 0), (pk, pk, W + 1), (pk[..., :0], pk[..., :0], 0),
                 (torch.zeros(L, B, H, 64, 65), torch.zeros(L, B, H, 64, 65), 0)):
        with pytest.raises(ValueError, match="pending block"):
            k2._check_args(blocks, H, x, None, sk, sk, xk, xk, *pend)


# -- the flush -----------------------------------------------------------------


@pytest.mark.parametrize("starts", [[12], [60], [70], [0, 30, 57, 64, 70]],
                         ids=["shared", "shared_crossing", "shared_past", "per_row_crossing"])
def test_flush_pending_equals_jax(starts):
    """Rows whose block crosses the cache's capacity (57 + 8 > 64) or starts
    at or past it keep the columns inside it and drop the rest."""
    L, H, D, T = 2, 2, 64, 64
    B = len(starts) if len(starts) > 1 else 3
    rng = np.random.RandomState(len(starts) + starts[0])
    sk, sv = ((rng.randn(L, B, H, D, T) * 0.1).astype(np.float32) for _ in range(2))
    pk, pv = ((rng.randn(L, B, H, D, W) * 0.1).astype(np.float32) for _ in range(2))
    xk = np.zeros((L, 1, H, D, 4), np.float32)
    per_row = len(starts) > 1
    ref = jw.flush_pending(jw.KVCache(jnp.asarray(sk), jnp.asarray(sv), xk, xk), jnp.asarray(pk),
                           jnp.asarray(pv), jnp.asarray(starts, jnp.int32) if per_row else jnp.int32(starts[0]))
    cache = tw.KVCache(torch.from_numpy(sk.copy()), torch.from_numpy(sv.copy()), None, None)
    got = tw.flush_pending(cache, torch.from_numpy(pk), torch.from_numpy(pv),
                           torch.tensor(starts) if per_row else starts[0])
    assert got.self_k is cache.self_k  # in place
    np.testing.assert_array_equal(got.self_k.numpy(), np.asarray(ref.self_k))
    np.testing.assert_array_equal(got.self_v.numpy(), np.asarray(ref.self_v))


# -- the write-block engine ----------------------------------------------------


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    dims = JDims(**TINY_DIMS)
    path = str(tmp_path_factory.mktemp("ckpt") / "tiny.npz")
    save_npz(path, jw.init_params(dims, jax.random.PRNGKey(0), jnp.float32), dims)
    return jw.Whisper(*reversed(jload(path))), whisper_tpu_torch.load_model(path, device="cpu")


@pytest.fixture(scope="module")
def mels():
    audio = whisper_tpu.load_audio(JFK)
    return np.stack([np.array(whisper_tpu.log_mel_spectrogram(whisper_tpu.pad_or_trim(w), 80))
                     for w in (audio, audio * 0.7)])


def _same(ref, got):
    assert len(ref) == len(got)
    for r, g in zip(ref, got):
        assert g.tokens == [int(x) for x in r.tokens]
        rs, gs = (x.avg_logprob * (len(x.tokens) + 1) for x in (r, g))
        assert abs(rs - gs) <= 1e-5 * max(1.0, abs(rs))
        assert abs(g.no_speech_prob - r.no_speech_prob) <= 1e-5


def _decode(task, mels, prompts):
    if prompts is None:
        return task.run(mels)
    return task.run_with_prompts(mels, prompts)


# sample_len 37 is not a multiple of the block: its last block runs overrun
# steps; the 223-token prompt caps its row at the buffer's end mid-decode
ENGINE_CASES = [
    (1, None, 37),
    (2, [[], [290, 291, 292]], 21),
    (2, [list(map(int, np.random.RandomState(6).randint(1000, 20000, 223))), []], None),
]


@pytest.mark.parametrize("n,prompts,sample_len", ENGINE_CASES, ids=["run", "prompts", "capped_row"])
def test_block_engine_matches_jax_and_per_step(models, mels, n, prompts, sample_len):
    jmodel, tmodel = models
    kw = dict(language="en", temperature=0.0, sample_len=sample_len)
    jtask = JTask(jmodel, JOptions(**kw))
    # the tiny test dims fall under the width gate: force the block on
    jtask.spec = replace(jtask.spec, write_block=W)
    jres = _decode(jtask, jnp.asarray(mels[:n]), prompts)

    task = DecodingTask(tmodel, DecodingOptions(**kw))
    assert task.write_block(n) == 0
    task.write_block = lambda n_audio: W
    block = _decode(task, torch.from_numpy(mels[:n]), prompts)
    task.write_block = lambda n_audio: 0
    per_step = _decode(task, torch.from_numpy(mels[:n]), prompts)
    _same(jres, block)
    _same(per_step, block)


def test_block_engine_sampling_equals_per_step(models, mels, monkeypatch):
    """Best-of 3 at T = 0.6 on two audios (two groups of three rows): the
    block engine's overrun steps still draw from the generator but keep
    nothing, so it gives the per-step engine's samples.  (Against
    whisper_tpu only in distribution: its sampler draws from another RNG.)"""
    _, tmodel = models
    kw = dict(language="en", temperature=0.6, best_of=3, sample_len=19, seed=4)
    got = {}
    for wb in (W, 0):
        monkeypatch.setattr(DecodingTask, "write_block", lambda self, n_audio, wb=wb: wb)
        got[wb] = DecodingTask(tmodel, DecodingOptions(**kw)).run(torch.from_numpy(mels))
    _same(got[0], got[W])


def test_engine_runs_blocks_at_the_block_starts(models, mels, monkeypatch):
    """Prompts of one length: every step of a block starts at one host int,
    len(initial tokens) + 8 k; of different lengths: at each row's t, a
    device tensor; one flush per block, and per-step writes never."""
    import whisper_tpu_torch.engine as te

    _, tmodel = models
    seen, flushed = [], []
    flush = te.flush_pending

    def spying(step):
        def spy(params, dims, tokens, t, block_start, w, pk, pv, cache):
            seen.append((block_start if isinstance(block_start, int) else block_start.tolist(), w))
            return step(params, dims, tokens, t, block_start, w, pk, pv, cache)
        return spy

    # the engine takes K2's pending step or the PyTorch one by the decoder's
    # shape (engine.decoder_steps); watch both
    for name in ("decoder_step_fused_pending", "decoder_step_pending"):
        monkeypatch.setattr(te, name, spying(getattr(te, name)))
    monkeypatch.setattr(te, "flush_pending", lambda *a: flushed.append(1) or flush(*a))
    for name in ("decoder_step_fused", "decoder_step"):
        monkeypatch.setattr(te, name, None)  # a per-step write would fail
    task = DecodingTask(tmodel, DecodingOptions(language="en", temperature=0.0, sample_len=11))
    task.write_block = lambda n_audio: W
    task.run(torch.from_numpy(mels))
    begin = task.sample_begin
    assert seen == [(begin + W * (i // W), i % W) for i in range(2 * W)] and len(flushed) == 2
    seen.clear()
    task.run_with_prompts(torch.from_numpy(mels), [[], [1000] * 5])
    begins = [begin, begin + 6]
    assert seen == [([b + W * (i // W) for b in begins], i % W) for i in range(2 * W)]


# -- the policy ----------------------------------------------------------------


def _stub_model(width: int, int8: bool):
    """A model with just what DecodingTask's policy reads: its dims and its
    first projection (int8 or not)."""
    dims = ModelDimensions(**dict(TINY_DIMS, n_text_state=width))
    q_w = tq.Int8Weight(torch.zeros(1, 1, 1, dtype=torch.int8), torch.ones(1, 1, 1)) if int8 else torch.zeros(1)
    return tw.Whisper(dims, {"decoder": {"tok_emb": torch.zeros(1), "blocks": {"q_w": q_w}}})


# (width, int8 weights, options, audios) -> write block
POLICY = [
    (1280, False, dict(beam_size=5), 16, 0),  # beam search writes per step
    (768, True, dict(kv_cache_dtype="int8"), 1, 0),  # a decoder narrower than 1024
    (1280, False, dict(), 1, 0),  # one audio, unquantized weights and K/V
    (1280, False, dict(temperature=0.4, best_of=5), 1, 0),  # one audio's group
    (1280, True, dict(temperature=0.4, best_of=5), 1, 0),
    (1280, True, dict(), 1, W),  # int8 weights, one row
    (1280, False, dict(kv_cache_dtype="int8"), 1, W),  # int8 K/V, one row
    (1280, False, dict(), 16, W),  # several audios
    (1280, False, dict(temperature=0.4, best_of=5), 5, W),  # best-of groups of several audios
]


@pytest.mark.parametrize("width,int8,options,n_audio,expected", POLICY)
def test_write_block_policy(width, int8, options, n_audio, expected):
    task = DecodingTask(_stub_model(width, int8), DecodingOptions(language="en", **options))
    assert task.write_block(n_audio) == expected
