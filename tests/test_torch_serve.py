"""The batching server of whisper_tpu_torch: request coalescing and the HTTP
front-end, on the CPU, against whisper_tpu's.

Float32 at tests/_reference.py's TINY_DIMS, the same weights in both
packages (whisper_tpu's init_params through save_npz -> load_npz).  The
batcher's results must equal a direct ``transcribe_batch`` of the same
audios and whisper_tpu's batcher (text and tokens equal), though the port
does not pad a partial batch with empty files; the HTTP answers must carry
whisper_tpu's JSON fields.  Multi-device serving (``mesh``) is
tests/test_torch_parallel.py's, but for a mesh of one rank here.

The streaming test times its first NDJSON line against the whole answer
(0.3-0.7 s on the CPU): it pins torch to two threads, as the other
test_torch_* files, and takes the lock that tests/test_torch_parallel.py's
spawns hold, so that it does not run beside their ranks.
"""

import http.client
import io
import json
import threading
import time
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import whisper_tpu.models.whisper as jw
from whisper_tpu.models.load import load_npz as jload
from whisper_tpu.models.load import save_npz
from whisper_tpu.serve import BatchingTranscriber as JBatcher

import whisper_tpu_torch
import whisper_tpu_torch.serve as serve_mod
from whisper_tpu_torch.batch import transcribe_batch
from whisper_tpu_torch.chunked import transcribe_chunked
from whisper_tpu_torch.serve import BatchingTranscriber, make_server

import _torch_parallel_ranks as ranks
from _reference import TINY_DIMS
from conftest import JFK

torch.set_num_threads(2)

OPTS = dict(
    language="en", temperature=0.0, sample_len=12,
    condition_on_previous_text=False, no_speech_threshold=None,
    logprob_threshold=None, compression_ratio_threshold=None,
)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    dims = whisper_tpu_torch.ModelDimensions(**TINY_DIMS)
    path = str(tmp_path_factory.mktemp("ckpt") / "tiny.npz")
    save_npz(path, jw.init_params(dims, jax.random.PRNGKey(0), jnp.float32), dims)
    return jw.Whisper(*reversed(jload(path))), whisper_tpu_torch.load_model(path, device="cpu")


@pytest.fixture(scope="module")
def model(models):
    return models[1]


def _tone(seconds=2.0, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(int(16000 * seconds)) * 0.1).astype(np.float32)


def _wav(seconds: float, seed: int) -> bytes:
    pcm = (_tone(seconds, seed) * 32767 * 0.05).astype(np.int16)
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(pcm.tobytes())
    return buf.getvalue()


@pytest.fixture
def server(model):
    """A server on an ephemeral port of 127.0.0.1, in a thread."""
    srv = make_server(model, port=0, batch_size=4, max_wait_s=0.1, **OPTS)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield srv
    srv.shutdown()
    srv.batcher.close(drain=False)


def _post(srv, query: str, body: bytes):
    conn = http.client.HTTPConnection("127.0.0.1", srv.server_port, timeout=600)
    conn.request("POST", f"/v1/audio/transcriptions{query}", body=body)
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return resp, data


# -- the batcher ---------------------------------------------------------------


def test_batcher_coalesces_and_matches_direct_and_jax(models):
    """Five requests in fewer than five batches; a partial batch of five
    (batch_size 8) gives what whisper_tpu's batcher, which pads it with
    three empty files, gives."""
    jmodel, model = models
    audios = [_tone(seed=i) for i in range(5)]
    with BatchingTranscriber(model, batch_size=8, max_wait_s=0.5, **OPTS) as bt:
        results = [f.result(timeout=300) for f in [bt.submit(a) for a in audios]]
        stats = dict(bt.stats)
    with JBatcher(jmodel, batch_size=8, max_wait_s=0.5, **OPTS) as jbt:
        jresults = [f.result(timeout=300) for f in [jbt.submit(a) for a in audios]]
    direct = transcribe_batch(model, audios, batch_size=8, **OPTS)
    for ref in (direct, jresults):
        assert [r["text"] for r in results] == [r["text"] for r in ref]
        assert [[s["tokens"] for s in r["segments"]] for r in results] == [
            [[int(t) for t in s["tokens"]] for s in r["segments"]] for r in ref]
    assert stats["requests"] == 5 and stats["batches"] < 5


def test_batcher_records_its_rounds_and_counts_the_queue_wait(model):
    """Under profiling.recording the worker thread records each batch's
    fill window and round; stats["taken"] counts the requests taken off the
    queue, and stats["queue_wait_s"] their waits from submit: a lone
    request on an idle server waits out the fill window, and no wait
    outlasts its request."""
    import contextlib

    from whisper_tpu_torch.profiling import recording

    class Recorder:
        def __init__(self):
            self.spans = []

        def stage(self, name):
            self.spans.append((name, threading.current_thread().name))
            return contextlib.nullcontext()

    recorder = Recorder()
    with recording(recorder), BatchingTranscriber(model, batch_size=4, max_wait_s=0.2, **OPTS) as bt:
        t0 = time.monotonic()
        bt.submit(_tone(seed=0)).result(timeout=300)
        lone = time.monotonic() - t0
        lone_wait = bt.stats["queue_wait_s"]
        sent = []
        futures = []
        for i in range(5):
            sent.append(time.monotonic())
            futures.append(bt.submit(_tone(seed=i + 1)))
        answered = []
        for f in futures:
            f.result(timeout=300)
            answered.append(time.monotonic())
        stats = dict(bt.stats)
    assert stats["requests"] == stats["taken"] == 6 and 3 <= stats["batches"] <= 4
    assert 0.2 - 0.01 <= lone_wait <= lone
    assert lone_wait < stats["queue_wait_s"] <= lone + sum(b - a for a, b in zip(sent, answered))
    worker = {thread for name, thread in recorder.spans if name in ("fill", "round")}
    assert worker == {"whisper-tpu-torch-batcher"}
    names = [name for name, _ in recorder.spans]
    assert names.count("round") == stats["batches"] and names.count("fill") >= stats["batches"]
    assert {"engine", "encoder", "step", "sync"} <= set(names)


def test_fill_window_reopens_when_engine_frees(model):
    """Requests that queued during a decode still get max_wait_s to
    coalesce with a client's re-send that arrives just after it.  Batch 1
    starts at 0.5 s and decodes until 1.7 s; fut2 and fut3 come at 0.8 s
    (0.3 s into the decode) and their fill window ends at 1.3 s (0.4 s
    before the decode does); the re-send has 0.5 s."""
    sizes = []
    with BatchingTranscriber(model, batch_size=4, max_wait_s=0.5, **OPTS) as bt:
        def slow(model_, audios, **kw):
            sizes.append(len(audios))
            time.sleep(1.2)
            return [{"text": "", "segments": [], "language": "en"} for _ in audios]

        bt._transcribe_batch = slow
        fut1 = bt.submit(_tone(seed=0))
        threading.Event().wait(0.8)  # batch 1 ([fut1]) is now decoding
        fut2 = bt.submit(_tone(seed=1))  # queued during the decode: their
        fut3 = bt.submit(_tone(seed=2))  # arrival deadline expires in it
        fut1.result(timeout=60)
        fut4 = bt.submit(_tone(seed=3))  # the client's re-send
        for f in (fut2, fut3, fut4):
            f.result(timeout=60)
    assert sizes == [1, 3]  # not [1, 2, 1]: the re-send joined the batch


@pytest.mark.parametrize("override", [dict(temperature=0.0), dict(temperature=[0.0, 0.2])],
                         ids=["equal_to_default", "list_valued"])
def test_batcher_groups_by_options(model, override):
    """An override equal to the server's default joins the default group;
    a list-valued one (a temperature ladder) makes a group key of its own."""
    with BatchingTranscriber(model, batch_size=4, max_wait_s=0.3, **OPTS) as bt:
        futures = [bt.submit(_tone(seed=1)), bt.submit(_tone(seed=2), **override)]
        results = [f.result(timeout=300) for f in futures]
        stats = dict(bt.stats)
    assert all(isinstance(r["text"], str) for r in results)
    assert stats["batches"] == (1 if override == dict(temperature=0.0) else 2), stats


@pytest.mark.parametrize("neighbour", [False, True], ids=["alone", "with_a_good_neighbour"])
def test_batcher_errors(model, neighbour):
    """A bad item fails its own future (counted in stats), and a good item
    batched with it still succeeds: the batch is retried item by item."""
    with BatchingTranscriber(model, batch_size=4, max_wait_s=0.3, **OPTS) as bt:
        good = bt.submit(_tone(seed=3)) if neighbour else None
        bad = bt.submit("/nonexistent/audio.wav")
        with pytest.raises(Exception):
            bad.result(timeout=300)
        assert bt.stats["errors"] >= 1
        if good is not None:
            assert isinstance(good.result(timeout=300)["text"], str)


def test_cancelled_future_does_not_kill_the_worker(model):
    with BatchingTranscriber(model, batch_size=2, max_wait_s=0.2, **OPTS) as bt:
        doomed = bt.submit(_tone(seed=4))
        doomed.cancel()
        later = bt.submit(_tone(seed=5))
        assert isinstance(later.result(timeout=300)["text"], str)


def test_priority_lane_jumps_queue(model):
    order = []
    with BatchingTranscriber(model, batch_size=1, max_wait_s=0.05, **OPTS) as bt:
        real = bt._transcribe_batch

        def slow(*a, **kw):
            time.sleep(0.4)
            return real(*a, **kw)

        bt._transcribe_batch = slow
        futs = {"n1": bt.submit(_tone(seed=10))}
        time.sleep(0.1)  # n1 is now being dispatched
        futs["n2"] = bt.submit(_tone(seed=11))
        futs["n3"] = bt.submit(_tone(seed=12))
        futs["prio"] = bt.submit(_tone(seed=13), priority=True)
        for name, fut in futs.items():
            fut.add_done_callback(lambda _, n=name: order.append(n))
        for fut in futs.values():
            fut.result(timeout=600)
    assert order.index("prio") < order.index("n2") and order.index("prio") < order.index("n3"), order


def test_batcher_chunked_matches_transcribe_chunked(model):
    audio = _tone(seconds=40.0, seed=7)  # > 30 s: two chunks
    with BatchingTranscriber(model, batch_size=4, max_wait_s=0.3, **OPTS) as bt:
        served = bt.submit_chunked(audio).result(timeout=600)
        stats = dict(bt.stats)
    assert stats["requests"] == 2  # one request per chunk
    direct = transcribe_chunked(model, audio, verbose=None, **OPTS)
    assert served["text"] == direct["text"] and served["language"] == direct["language"]
    assert [(s["id"], s["start"], s["end"], s["seek"], s["tokens"]) for s in served["segments"]] == [
        (s["id"], s["start"], s["end"], s["seek"], s["tokens"]) for s in direct["segments"]]


def test_batcher_chunked_rejects_conditioning_and_propagates_failure(model):
    with BatchingTranscriber(model, batch_size=2, max_wait_s=0.1, **OPTS) as bt:
        with pytest.raises(ValueError):
            bt.submit_chunked(_tone(), condition_on_previous_text=True)
        real = bt._transcribe_batch

        def flaky(model_, audios, **kw):
            # the 15 s tail chunk of a 40 s file fails, also when retried alone
            if any(np.asarray(a).shape[0] < 20 * 16000 for a in audios):
                raise RuntimeError("injected chunk failure")
            return real(model_, audios, **kw)

        bt._transcribe_batch = flaky
        with pytest.raises(RuntimeError):
            bt.submit_chunked(_tone(seconds=40.0, seed=8)).result(timeout=600)


def test_launch_counts_survive_concurrent_threads():
    """The server's worker and its streaming handlers launch kernels from
    several threads: a kernel wrapper's counts, under _lib's lock, lose no
    update (16 threads, a switch interval of 1 us)."""
    import collections
    import sys

    from whisper_tpu_torch.ops.kernels import _lib

    def wrapper():
        pass

    wrapper.launches, wrapper.launches_by_layout = 0, collections.Counter()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [_lib.count_launch(wrapper, layout=(1, 1))
                                                    for _ in range(5000)]) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert wrapper.launches == wrapper.launches_by_layout[(1, 1)] == 16 * 5000


def test_mesh_is_a_later_slice(model):
    """The mesh is in the port: a batcher under a mesh of
    one rank (no process group needed) answers as the plain one, and
    ``--mesh`` builds the mesh, refusing one larger than the world (the
    many-rank paths are tests/test_torch_parallel.py's)."""
    one = _one_rank_mesh()
    audio = _tone(seed=3)
    with BatchingTranscriber(model, batch_size=2, max_wait_s=0.05, **OPTS) as bt:
        want = bt.transcribe(audio, timeout=300)
    with BatchingTranscriber(model, batch_size=2, max_wait_s=0.05, mesh=one, **OPTS) as bt:
        assert bt.model is not model and bt.mesh is one
        got = bt.transcribe(audio, timeout=300)
    assert got["text"] == want["text"]
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        serve_mod.main(["--mesh", "data=2", "--device", "cpu"])


def _one_rank_mesh():
    """A mesh of one rank without a process group: its collectives are
    no-ops, so a batcher under it runs its mesh paths in this process."""
    from whisper_tpu_torch.parallel import Mesh

    return Mesh((1, 1), ("data", "model"), 0, (0, 0), torch.device("cpu"), "gloo",
                {"data": None, "model": None}, {"data": None, "model": None, "world": None})


def test_mesh_forms_run_as_worker_jobs(model):
    """Under a mesh a stream and a chunked request's language detection run
    on the batcher's worker thread, with the results of the request's own
    thread without a mesh."""
    from whisper_tpu_torch.streaming import StreamingTranscriber

    langless = {k: v for k, v in OPTS.items() if k != "language"}
    audio = _tone(seconds=36.0, seed=21)
    threads = []
    real_push = StreamingTranscriber.push

    def push(self, pcm):
        threads.append(threading.current_thread().name)
        return real_push(self, pcm)

    def stream(bt):
        st = bt._open_stream(dict(langless))
        segments = [s for i in range(0, len(audio), 80000) for s in st.push(audio[i:i + 80000])]
        return segments + st.flush(), st.result

    with BatchingTranscriber(model, batch_size=4, max_wait_s=0.05, **langless) as bt:
        want = stream(bt), bt.submit_chunked(audio).result(timeout=300)
    StreamingTranscriber.push = push
    try:
        with BatchingTranscriber(model, batch_size=4, max_wait_s=0.05, mesh=_one_rank_mesh(),
                                 **langless) as bt:
            got = stream(bt), bt.submit_chunked(audio).result(timeout=300)
            assert not bt._streams  # the flush closed it
    finally:
        StreamingTranscriber.push = real_push
    assert threads and set(threads) == {"whisper-tpu-torch-batcher"}
    (segments, result), chunked = got
    (want_segments, want_result), want_chunked = want
    assert [s["tokens"] for s in segments] == [s["tokens"] for s in want_segments]
    assert (result["text"], result["language"]) == (want_result["text"], want_result["language"])
    assert [s["tokens"] for s in chunked["segments"]] == [s["tokens"] for s in want_chunked["segments"]]
    assert chunked["language"] == want_chunked["language"] == result["language"]


def test_mesh_jobs_alternate_with_batch_rounds(model):
    """While batches are queued the worker runs one job between two batch
    rounds; a failed job fails its future and counts as an error."""
    order, gate = [], threading.Event()
    with BatchingTranscriber(model, batch_size=1, max_wait_s=0.01, mesh=_one_rank_mesh(),
                             **OPTS) as bt:
        def batch(model_, audios, **kw):
            order.append(f"batch {kw['sample_len']}")
            gate.wait(60)
            return [{"text": "", "segments": [], "language": "en"} for _ in audios]

        def job(kind, payload):
            order.append(f"job {payload}")
            if payload == "bad":
                raise ValueError("planted")
            return payload

        bt._transcribe_batch, bt._job = batch, job
        futures = [bt.submit(_tone(seed=0), sample_len=1)]
        while not order:  # the first batch is decoding
            time.sleep(0.01)
        jobs = [bt._submit_job("detect", p) for p in ("a", "bad", "c")]
        futures += [bt.submit(_tone(seed=0), sample_len=n) for n in (2, 3)]
        gate.set()
        assert [f.result(timeout=60)["language"] for f in futures] == ["en"] * 3
        assert jobs[0].result(timeout=60) == "a" and jobs[2].result(timeout=60) == "c"
        with pytest.raises(RuntimeError, match="rank 0: ValueError: planted"):
            jobs[1].result(timeout=60)
        assert bt.stats["errors"] == 1
    assert order == ["batch 1", "job a", "batch 2", "job bad", "batch 3", "job c"]


# -- the HTTP front-end --------------------------------------------------------


def test_http_server_end_to_end(server):
    conn = http.client.HTTPConnection("127.0.0.1", server.server_port, timeout=600)
    conn.request("GET", "/healthz")
    health = conn.getresponse()
    assert health.status == 200 and json.loads(health.read())["status"] == "ok"
    with open(JFK, "rb") as f:
        payload = f.read()
    conn.request("POST", "/v1/audio/transcriptions?language=en", body=payload)
    resp = conn.getresponse()
    body = json.loads(resp.read())
    assert resp.status == 200, body
    assert set(body) == {"text", "language", "segments"} and body["language"] == "en"
    assert body["segments"] and {"id", "start", "end", "text"} <= set(body["segments"][0])
    # an unknown option: 400; an unknown path: 404; an empty body: 400
    for path, data, status in (("/v1/audio/transcriptions?bogus=1", payload, 400),
                               ("/nope", b"x", 404), ("/transcribe", b"", 400)):
        conn.request("POST", path, body=data)
        r = conn.getresponse()
        r.read()
        assert r.status == status, path
    conn.close()


def test_http_timeout_returns_503(model, monkeypatch):
    """A wedged device surfaces as 503, not as an eternally blocked thread."""
    srv = make_server(model, port=0, batch_size=2, max_wait_s=0.05, **OPTS)
    monkeypatch.setattr(serve_mod, "REQUEST_TIMEOUT_S", 0.2)
    real = srv.batcher._transcribe_batch

    def slow(*args, **kwargs):
        time.sleep(2.0)
        return real(*args, **kwargs)

    srv.batcher._transcribe_batch = slow
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        with open(JFK, "rb") as f:
            resp, data = _post(srv, "", f.read())
        body = json.loads(data)
        assert resp.status == 503 and "timed out" in body["error"], body
    finally:
        srv.shutdown()
        srv.batcher.close(drain=False)


def test_http_chunked_end_to_end(server):
    """?chunked=true on a sub-30 s file: the plain response's text; with
    condition_on_previous_text: 400."""
    with open(JFK, "rb") as f:
        payload = f.read()
    plain = json.loads(_post(server, "", payload)[1])
    resp, data = _post(server, "?chunked=true&chunk_overlap=5.0", payload)
    chunked = json.loads(data)
    assert resp.status == 200, chunked
    assert chunked["text"] == plain["text"] and len(chunked["segments"]) == len(plain["segments"])
    resp, data = _post(server, "?chunked=true&condition_on_previous_text=true", payload)
    assert resp.status == 400, data


@pytest.mark.parametrize("query", ["?stream=true", "?chunked=true&stream=true"],
                         ids=["stream", "chunked_stream"])
def test_http_ndjson_streaming(server, query):
    """NDJSON: one line per segment (ids 0, 1, ..., start times rising),
    then a done line whose text is theirs; a plain stream sends its first
    line well before the last."""
    payload = _wav(70.0, 20)  # three windows
    if query == "?stream=true":  # warm-up
        _post(server, query, payload)
    conn = http.client.HTTPConnection("127.0.0.1", server.server_port, timeout=600)
    with ranks.spawn_lock():  # not beside tests/test_torch_parallel.py's ranks
        t0 = time.monotonic()
        conn.request("POST", f"/v1/audio/transcriptions{query}", body=payload)
        resp = conn.getresponse()
        assert resp.status == 200 and resp.getheader("Content-Type") == "application/x-ndjson"
        body, t_first = b"", None
        while chunk := resp.read(1):
            body += chunk
            if chunk == b"\n" and t_first is None:
                t_first = time.monotonic() - t0
        t_total = time.monotonic() - t0
    conn.close()
    lines = [json.loads(line) for line in body.decode().splitlines() if line]
    assert lines[-1].get("done") is True and "error" not in lines[-1], lines[-1]
    segments = lines[:-1]
    assert [s["id"] for s in segments] == list(range(len(segments)))
    assert [s["start"] for s in segments] == sorted(s["start"] for s in segments)
    assert lines[-1]["text"] == "".join(s["text"] for s in segments)
    if query == "?stream=true":
        assert len(segments) >= 2 and t_first < 0.7 * t_total, (t_first, t_total)
