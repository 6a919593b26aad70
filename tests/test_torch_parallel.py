"""whisper_tpu_torch.parallel: the (data, model) mesh on torch.distributed,
against whisper_tpu's mesh paths, on the CPU.

Four spawned gloo ranks form a (2, 2) mesh (``parallel.launch.run_ranks``;
their side is ``tests/_torch_parallel_ranks.py``) and run, in one spawn,
every path whisper_tpu runs under a mesh: the encoder, greedy and beam
decode, the alignment, ``transcribe_batch``, the server's batcher, the
server's stream and its chunked request without a language (each run as
worker jobs on every rank), DP+TP training and distillation, and the
sharded save.  A second spawn of two
ranks reloads the checkpoint at (1, 2) and (2, 1).  The dims are
tests/test_parallel.py's (64 wide, 4 heads, 2 + 2 layers), f32; the
weights are whisper_tpu's ``init_params`` through ``params_from_numpy``.

Tolerances: the encoder within atol 2e-5 of whisper_tpu's on its 8-device
virtual mesh (tests/test_parallel.py's); decode tokens, alignment words
(times rounded to 3 places, as ``dryrun_multichip``), batch and server
results equal (the stream's and the chunked request's: text, language,
segment tokens and words equal to one device's, and the NDJSON lines); the DP+TP train step's loss and grad_norm within 1e-5
relative of the port's single-device step on the same global batch, and
its parameters within tests/test_torch_training.py's rule for one AdamW
step; the reloaded checkpoint equal.
"""

import io
import json
import os
import threading
import time
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parallel_ranks as ranks

import whisper_tpu
from whisper_tpu.models.dims import ModelDimensions as JDims
from whisper_tpu.models.whisper import Whisper as JWhisper
from whisper_tpu.models.whisper import encoder_apply as j_encoder_apply
from whisper_tpu.models.whisper import init_params as j_init_params
from whisper_tpu.parallel import make_mesh as j_make_mesh
from whisper_tpu.parallel import param_sharding_rules as j_rules
from whisper_tpu.parallel import shard_params as j_shard_params
from whisper_tpu.quantize import quantize_params as j_quantize_params
from whisper_tpu.timing import find_alignment as j_find_alignment
from whisper_tpu.tokenizer import get_tokenizer as j_get_tokenizer

import whisper_tpu_torch as w
from whisper_tpu_torch.batch import transcribe_batch
from whisper_tpu_torch.models.dims import ModelDimensions
from whisper_tpu_torch.models.load import load_sharded, params_from_numpy
from whisper_tpu_torch.models.whisper import Whisper, encoder_apply
from whisper_tpu_torch.parallel import Mesh, make_mesh, param_sharding_rules, shard_params
from whisper_tpu_torch.parallel.launch import run_ranks
from whisper_tpu_torch.quantize import Int8Weight
from whisper_tpu_torch.serve import BatchingTranscriber, make_server, parse_mesh
from whisper_tpu_torch.streaming import StreamingTranscriber
from whisper_tpu_torch.training import init_train_state, make_optimizer, train_step

KW = dict(n_mels=80, n_audio_ctx=1500, n_audio_state=64, n_audio_head=4, n_audio_layer=2,
          n_vocab=51865, n_text_ctx=448, n_text_state=64, n_text_head=4, n_text_layer=2)
JD, TD = JDims(**KW), ModelDimensions(**KW)
GREEDY = dict(language="en", temperature=0.0, sample_len=16)
BEAM = dict(language="en", temperature=0.0, sample_len=8, beam_size=2)
# the server's and the batch's options (tests/test_serve.py's)
OPTS = dict(language="en", temperature=0.0, sample_len=12, condition_on_previous_text=False,
            no_speech_threshold=None, logprob_threshold=None, compression_ratio_threshold=None)
TEXT = " and so my fellow Americans ask not"
TOKENS = [50258, 50259, 50359, 50363, 440, 7177, 300, 50257]


# the server's options for the stream and the chunked request: no language
LANGLESS = {k: v for k, v in OPTS.items() if k != "language"}


def _tone(seconds=2.0, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(int(16000 * seconds)) * 0.1).astype(np.float32)


def _wav(pcm) -> bytes:
    buf = io.BytesIO()
    with wave.open(buf, "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(16000)
        f.writeframes((np.clip(pcm, -1, 1) * 32767).astype(np.int16).tobytes())
    return buf.getvalue()


def _fake_mesh(shape, rank):
    """A rank's view of a mesh with no process group: enough for
    shard_params and the checks that raise before any collective."""
    return Mesh(shape, ("data", "model"), rank, divmod(rank, shape[1]), torch.device("cpu"),
                "gloo", {"data": None, "model": None}, {"data": None, "model": None, "world": None})


@pytest.fixture(scope="module")
def jparams():
    return jax.tree.map(np.asarray, j_init_params(JD, jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def run(jparams, tmp_path_factory):
    """The ranks' results of the (2, 2) spawn and of the reload, and what
    they are held against."""
    rng = np.random.RandomState(0)
    mel = (rng.randn(2, 80, 3000) * 0.4).astype(np.float32)
    jfk = w.load_audio(os.path.join(os.path.dirname(__file__), "jfk.flac"))
    tok = j_get_tokenizer(True, language="en", task="transcribe")
    train = dict(mel=(rng.randn(4, 80, 3000) * 0.5).astype(np.float32),
                 tokens=np.tile(np.asarray(TOKENS, np.int64), (4, 1)),
                 loss_mask=np.ones((4, len(TOKENS)), np.float32))
    train["loss_mask"][:, :4] = 0.0
    train["loss_mask"][2:, -2:] = 0.0
    ckpt = str(tmp_path_factory.mktemp("ckpt") / "sharded")
    long = np.concatenate([jfk, _tone(8.0, 5), jfk, jfk[: 16000 * 8]])  # 38 s: two windows, two chunks
    # over HTTP: a stream whose push raises on rank 1 alone, then a stream and
    # a chunked request without a language
    http = [("?stream=true&initial_prompt=planted%20fault", _wav(_tone(3.0, 9))),
            ("?stream=true", _wav(long)), ("?chunked=true", _wav(long))]
    inp = dict(dims=KW, params=jparams, mel=mel, greedy=GREEDY, beam=BEAM,
               text_tokens=tok.encode(TEXT), files=[jfk[:16000 * 4], jfk[16000 * 3:], _tone(3.0, 7)],
               tones=[_tone(seed=i) for i in range(3)], opts=OPTS, train=train, ckpt=ckpt,
               long=long, http=http)
    with ranks.spawn_lock():
        results = run_ranks(ranks.mesh_paths, 4, (inp,), timeout=300)
        reloaded = run_ranks(ranks.reload, 2, ({"ckpt": ckpt},), timeout=120)
    return dict(inp=inp, ranks=results, reloaded=reloaded)


def _whole(shards, key_path, spec):
    """A leaf put back together from the model ranks' shards."""
    parts = list(shards)
    for k in key_path:
        parts = [p[k] for p in parts]
    if "model" not in spec:
        return parts[0]
    return np.concatenate(parts, axis=spec.index("model"))


def _leaves(tree, path=()):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k], path + (k,))
        else:
            yield path + (k,), tree[k]


# ---------------------------------------------------------------------------
# rules and shards (no process group)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("quantized", [False, True])
def test_rules_match_whisper_tpu(jparams, quantized):
    """Every leaf of whisper_tpu's tree: the port's rule splits the same
    axis, in the (L, out, in) layout; a quantized leaf and its bias stay
    whole, as whisper_tpu's {"q", "s"} leaves do."""
    jtree = j_quantize_params(jparams) if quantized else jparams
    ttree = params_from_numpy(jax.tree.map(np.asarray, jtree), TD)
    local = shard_params(ttree, _fake_mesh((1, 2), 1))
    checked = 0
    for path, leaf in _leaves(jax.tree.map(np.asarray, jtree)):
        name = path[-1]
        if name in ("q", "s"):
            assert isinstance(_at(local, path[:-1]), Int8Weight)
            continue
        jspec = tuple(j_rules(name, leaf.ndim))
        if name in ("q_w", "k_w", "v_w", "o_w", "fc1_w", "fc2_w", "xq_w", "xk_w", "xv_w", "xo_w"):
            jspec = jspec[:-2] + (jspec[-1], jspec[-2])  # (L, in, out) -> (L, out, in)
        assert param_sharding_rules(name, leaf.ndim) == jspec, name
        got = _at(local, path)
        whole = _at(ttree, path)
        int8_bias = name in ("q_b", "v_b", "fc1_b", "xq_b", "xv_b") and isinstance(
            _at(ttree, path[:-1] + (name[:-1] + "w",)), Int8Weight)
        if "model" in jspec and not int8_bias:
            d = jspec.index("model")
            assert got.shape[d] * 2 == whole.shape[d], name
        else:
            assert got.shape == whole.shape, name
        checked += 1
    assert checked > 20


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def test_local_shards_concatenate_to_the_whole(jparams):
    ttree = params_from_numpy(jparams, TD)
    shards = [jax.tree.map(lambda t: t.numpy(), shard_params(ttree, _fake_mesh((2, 2), r)))
              for r in range(4)]
    for path, leaf in _leaves(jax.tree.map(lambda t: t.numpy(), ttree)):
        spec = param_sharding_rules(path[-1], leaf.ndim)
        np.testing.assert_array_equal(_whole(shards[:2], path, spec), leaf)
        np.testing.assert_array_equal(_whole(shards[2:], path, spec), leaf)  # data 1 holds the same
    assert ttree["decoder"]["blocks"]["q_w"].shape == (2, 64, 64)  # the input is not changed


def test_indivisible_heads_raise(jparams):
    """Three heads of 16 over a model axis of 2: 24 rows per rank are no
    whole heads (GSPMD would pad the split)."""
    dims = ModelDimensions(**dict(KW, n_audio_state=48, n_audio_head=3, n_text_state=48,
                                  n_text_head=3))
    params = w.models.whisper.init_params(dims, torch.Generator().manual_seed(0))
    mesh = _fake_mesh((1, 2), 0)
    local = shard_params(params, mesh)
    with mesh, pytest.raises(ValueError, match="whole heads of 16"):
        encoder_apply(local, dims, torch.zeros(1, 80, 3000))
    with pytest.raises(ValueError, match="does not divide dim 1"):
        shard_params({"blocks": {"q_w": torch.zeros(1, 7, 4)}}, mesh)


def test_make_mesh_larger_than_the_world_raises():
    with pytest.raises(ValueError, match=r"needs 4 devices, have 1"):
        make_mesh((2, 2), devices="cpu")
    assert not torch.distributed.is_initialized()


def test_cuda_mesh_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the behaviour without one")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()
    with pytest.raises(RuntimeError, match="without a CUDA device"):
        make_mesh((1, 1), devices="cuda", backend="gloo")
    assert not torch.distributed.is_initialized()


def test_parse_mesh_specs(monkeypatch):
    from whisper_tpu.serve import parse_mesh as j_parse_mesh

    import whisper_tpu_torch.serve as tserve

    seen = []
    monkeypatch.setattr("whisper_tpu_torch.parallel.make_mesh", lambda shape: seen.append(shape))
    for spec, shape in (("data=8", (8, 1)), ("data=4,model=2", (4, 2)), ("model=2", (1, 2)),
                        (" data = 2 , model=2", (2, 2))):
        tserve.parse_mesh(spec)
        assert seen[-1] == shape
    for bad in ("data=x", "pipe=2", "data", "data=2;model=2", ""):
        with pytest.raises(ValueError) as port:
            parse_mesh(bad)
        with pytest.raises(ValueError) as ref:
            j_parse_mesh(bad)
        assert str(port.value) == str(ref.value)


def test_data_rows_split_contiguously():
    for D, n in ((2, 2), (2, 3), (3, 2), (4, 9)):
        rows = [_fake_mesh((D, 1), d).rows(n) for d in range(D)]
        assert [i for r in rows for i in r] == list(range(n))
        assert [len(r) for r in rows] == [len(a) for a in np.array_split(np.arange(n), D)]


def test_a_rank_that_raises_brings_the_others_down():
    """Rank 1 raises while rank 0 waits for it in a collective: run_ranks
    ends both and raises with rank 1's traceback, well inside the
    collective's timeout."""
    with ranks.spawn_lock(), pytest.raises(RuntimeError, match=r"(?s)rank 1 raised.*planted"):
        t0 = time.perf_counter()
        run_ranks(ranks.one_raises, 2, timeout=60)
    assert time.perf_counter() - t0 < 45


def test_build_lock_builds_once(tmp_path):
    """Two processes that ask for the kernel library at the same moment:
    one compiles (the stub), the other waits on the lock and loads it."""
    with ranks.spawn_lock():
        built = run_ranks(ranks.race_build, 2, (str(tmp_path), time.time() + 8.0), timeout=60)
    assert sorted(built) == [False, True]
    assert len(open(tmp_path / "compiles.log").read().split()) == 1


# ---------------------------------------------------------------------------
# the (2, 2) spawn
# ---------------------------------------------------------------------------


def test_ranks_hold_their_coordinates(run):
    assert [r["coords"] for r in run["ranks"]] == [
        {"data": d, "model": m} for d in range(2) for m in range(2)]


def test_decode_splits_the_rows_over_data(run):
    """Each data group decodes one of the two rows, in greedy, beam,
    speculative and best-of decodes."""
    assert [r["rows"] for r in run["ranks"]] == [[1, 1, 1, 1]] * 4


def test_decoder_steps_take_k2_only_for_a_whole_decoder():
    """A model shard takes the PyTorch step (K2 has no place for the
    all-reduces); a whole decoder of a shape K2 takes, K2 (on the CPU its
    wrapper runs the plain version)."""
    from whisper_tpu_torch import engine

    dims = ModelDimensions(**dict(KW, n_text_state=128, n_text_head=2))
    params = w.models.whisper.init_params(dims, torch.Generator().manual_seed(0))
    assert engine.decoder_steps(params, dims)[0] is engine.decoder_step_fused
    local = shard_params(params, _fake_mesh((1, 2), 0))
    assert engine.decoder_steps(local, dims)[0] is engine.decoder_step
    assert engine.decoder_steps(shard_params(params, _fake_mesh((2, 1), 1)), dims)[0] is (
        engine.decoder_step_fused)


def test_encoder_matches_whisper_tpu_on_its_mesh(run, jparams):
    mel = jnp.asarray(run["inp"]["mel"])
    mesh = j_make_mesh((4, 2))
    with mesh:
        want = np.asarray(jax.jit(lambda p, m: j_encoder_apply(p, JD, m))(
            j_shard_params(jparams, mesh), mel))
    for r in run["ranks"]:
        np.testing.assert_allclose(r["encoder"], want, atol=2e-5)


@pytest.mark.parametrize("what, opts", [("greedy", GREEDY), ("beam", BEAM)])
def test_decode_matches_whisper_tpu(run, jparams, what, opts):
    want = [r.tokens for r in JWhisper(JD, jparams).decode(
        jnp.asarray(run["inp"]["mel"]), whisper_tpu.DecodingOptions(**opts))]
    assert all(len(t) for t in want)
    for r in run["ranks"]:
        assert r[what] == want


def test_speculative_decode_under_the_mesh_is_plain_greedy(run):
    """A sharded model drafting for itself decodes its plain greedy
    tokens."""
    for r in run["ranks"]:
        assert r["speculative"] == r["greedy"]


def test_sampling_under_the_mesh_agrees_within_a_model_group(run):
    """Best-of sampling from a numpy-drawn seed: the ranks of a model group
    share rank 0's seed, so every rank returns the same gathered rows."""
    sampled = [r["sampled"] for r in run["ranks"]]
    assert all(len(t) for t in sampled[0]) and sampled[1:] == [sampled[0]] * 3


def test_alignment_matches_whisper_tpu(run, jparams):
    tok = j_get_tokenizer(True, language="en", task="transcribe")
    want = j_find_alignment(JWhisper(JD, jparams), tok, tok.encode(TEXT),
                            run["inp"]["mel"][:1], num_frames=1000)
    want = [(x.word, round(x.start, 3), round(x.end, 3)) for x in want]
    assert len(want) == 7
    for r in run["ranks"]:
        assert r["words"] == want


def test_transcribe_batch_matches_one_device(run, jparams):
    model = Whisper(TD, params_from_numpy(jparams, TD))
    want = transcribe_batch(model, run["inp"]["files"], batch_size=2, **OPTS)
    for r in run["ranks"]:
        assert [x["text"] for x in r["batch"]] == [x["text"] for x in want]
        assert [[s["tokens"] for s in x["segments"]] for x in r["batch"]] == [
            [s["tokens"] for s in x["segments"]] for x in want]


def test_batching_transcriber_matches_one_device(run, jparams):
    """tests/test_serve.py's mesh test: texts and segment tokens equal; the
    other ranks refuse requests."""
    model = Whisper(TD, params_from_numpy(jparams, TD))
    with BatchingTranscriber(model, batch_size=4, max_wait_s=0.4, **OPTS) as bt:
        want = [f.result(timeout=300) for f in [bt.submit(a) for a in run["inp"]["tones"]]]
    got = run["ranks"][0]["served"]
    assert [r["text"] for r in got] == [r["text"] for r in want]
    assert [[s["tokens"] for s in r["segments"]] for r in got] == [
        [s["tokens"] for s in r["segments"]] for r in want]
    assert all("takes no requests" in r["submit_refused"] for r in run["ranks"][1:])


def _segments(result):
    return [(s["text"], s["tokens"], [(x["word"], x["start"], x["end"]) for x in s.get("words", [])])
            for s in result["segments"]]


def test_mesh_stream_matches_one_device(run, jparams):
    """A stream under the mesh (its detection, decodes and word timestamps
    as worker jobs on every rank): the segments, text and language of a
    StreamingTranscriber on one device, fed the same PCM."""
    model = Whisper(TD, params_from_numpy(jparams, TD))
    st, long = StreamingTranscriber(model, **dict(LANGLESS, word_timestamps=True)), run["inp"]["long"]
    want = [s for i in range(0, len(long), 5 * 16000) for s in st.push(long[i:i + 5 * 16000])]
    want += st.flush()
    segments, result = run["ranks"][0]["stream"]
    assert len(want) >= 2 and any(s["words"] for s in want)
    assert _segments({"segments": segments}) == _segments({"segments": want})
    assert (result["text"], result["language"]) == (st.result["text"], st.result["language"])


def test_mesh_chunked_request_detects_its_language(run, jparams):
    """A chunked request without a language under the mesh (the detection
    a worker job on every rank): one device's batcher's result."""
    model = Whisper(TD, params_from_numpy(jparams, TD))
    with BatchingTranscriber(model, batch_size=4, max_wait_s=0.2, **LANGLESS) as bt:
        want = bt.submit_chunked(run["inp"]["long"]).result(timeout=300)
    got = run["ranks"][0]["chunked"]
    assert (got["text"], got["language"]) == (want["text"], want["language"])
    assert _segments(got) == _segments(want)


def test_mesh_server_answers_both_forms_over_http(run, jparams):
    """Over HTTP under the mesh: the stream whose push raised on rank 1
    alone answers its NDJSON error line naming rank 1; the stream and the
    chunked request after it answer 200 with one device's server's
    bodies."""
    model = Whisper(TD, params_from_numpy(jparams, TD))
    srv = make_server(model, port=0, batch_size=4, max_wait_s=0.2, **LANGLESS)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        want = [ranks._post(srv.server_port, q, body) for q, body in run["inp"]["http"][1:]]
    finally:
        srv.shutdown()
        srv.batcher.close(drain=False)
    planted, *got = run["ranks"][0]["http"]
    error = json.loads(planted[1].splitlines()[-1])
    assert planted[0] == 200 and "rank 1: RuntimeError: planted on rank 1" in error["error"], planted
    assert [status for status, _ in got] == [200, 200]
    stream, chunked = [body for _, body in got]
    lines = [json.loads(x) for x in stream.splitlines()]
    assert lines[-1]["done"] and len(lines) >= 3 and lines[-1]["language"]
    assert [status for status, _ in want] == [200, 200]
    for body, ref in zip((lines, json.loads(chunked)), (
            [json.loads(x) for x in want[0][1].splitlines()], json.loads(want[1][1]))):
        assert _close(body, ref), (body, ref)


def _close(a, b) -> bool:
    """JSON values equal, floats within 1e-5 relative (the scores of a
    segment sum in another order under the mesh)."""
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(_close(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return isinstance(b, list) and len(a) == len(b) and all(map(_close, a, b))
    if isinstance(a, float) and isinstance(b, float):
        return abs(a - b) <= 1e-5 * max(abs(a), abs(b))
    return a == b


def _one_device_step(jparams, batch):
    opt = make_optimizer(learning_rate=1e-3)
    state = init_train_state(params_from_numpy(jparams, TD), opt)
    return train_step(state, TD, opt, {k: torch.from_numpy(v) for k, v in batch.items()})


def test_train_step_matches_one_device(run, jparams):
    """Loss and grad_norm within 1e-5 relative; every parameter after the
    step, put back together from the shards, within 1e-3 x lr of the
    single-device step's, or 2 x lr where the gradient is near zero
    (tests/test_torch_training.py's rule for one AdamW step)."""
    state, m = _one_device_step(jparams, run["inp"]["train"])
    loss, g_norm = m["loss"].item(), m["grad_norm"].item()
    for r in run["ranks"]:
        assert abs(r["step1"][0] - loss) <= 1e-5 * abs(loss), (r["step1"], loss)
        assert abs(r["step1"][1] - g_norm) <= 1e-5 * abs(g_norm), (r["step1"], g_norm)
    lr, bad = 1e-3, []
    want = jax.tree.map(lambda t: t.detach().numpy(), state.params)
    grads = {path: p.grad.numpy() for path, p in _leaves(state.params)}
    for d in range(2):
        shards = run["ranks"][2 * d: 2 * d + 2]
        for path, leaf in _leaves(want):
            spec = param_sharding_rules(path[-1], leaf.ndim)
            got = _whole([s["params1"] for s in shards], path, spec)
            g = grads[path]
            near_zero = (np.abs(g) < 1e-6 * np.abs(g).max()) | (np.abs(g) < 1e-6)
            err = np.abs(got - leaf)
            if not (err <= np.where(near_zero, 2 * lr, 1e-3 * lr)).all():
                bad.append((d, path, float(err.max())))
    assert bad == []


def test_three_train_steps_lower_the_loss(run):
    for r in run["ranks"]:
        losses = r["losses"]
        assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
    assert len({tuple(r["losses"]) for r in run["ranks"]}) == 1


def test_distill_step_lowers_the_loss(run):
    for r in run["ranks"]:
        assert np.isfinite(r["distill"]).all() and r["distill"][-1] < r["distill"][0], r["distill"]


def _tree_np(tree):
    return jax.tree.map(lambda t: t.detach().numpy(), tree)


def test_checkpoint_reloads_on_one_device(run, jparams):
    params, dims = load_sharded(run["inp"]["ckpt"], device="cpu")
    assert dims == TD
    for (path, got), (_, want) in zip(_leaves(_tree_np(params)),
                                      _leaves(_tree_np(params_from_numpy(jparams, TD)))):
        np.testing.assert_array_equal(got, want, err_msg=str(path))


@pytest.mark.parametrize("shape", [(1, 2), (2, 1)])
def test_checkpoint_reloads_on_another_mesh(run, jparams, shape):
    whole = _tree_np(params_from_numpy(jparams, TD))
    for r in run["reloaded"]:
        coords, local, dims = r[shape]
        assert dims == TD.__dict__
        want = _tree_np(shard_params(params_from_numpy(jparams, TD),
                                     _fake_mesh(shape, coords["data"] * shape[1] + coords["model"])))
        for (path, got), (_, ref) in zip(_leaves(local), _leaves(want)):
            np.testing.assert_array_equal(got, ref, err_msg=str(path))
    # the model ranks' shards put together give the whole
    if shape == (1, 2):
        q = np.concatenate([r[shape][1]["decoder"]["blocks"]["q_w"] for r in run["reloaded"]], 1)
        np.testing.assert_array_equal(q, whole["decoder"]["blocks"]["q_w"])
