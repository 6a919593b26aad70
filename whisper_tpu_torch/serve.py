"""Dynamic-batching transcription server.

Counterpart of ``whisper_tpu/serve.py``: the serving layer.  The decode
step reads every weight once for all of a batch's rows, so the cost per
audio second falls with the batch, and a server coalesces concurrent
requests into ``transcribe_batch`` calls rather than decoding them one by
one.

Two layers:

- :class:`BatchingTranscriber`: in-process request coalescing.  ``submit``
  returns a Future; a worker thread groups compatible requests (same decode
  options) into batches of up to ``batch_size``, waiting at most
  ``max_wait_s`` after the first request of a group (or after the engine
  became free) before dispatching a partial batch.  A partial batch decodes
  just its own files: nothing here compiles per shape, so whisper_tpu's
  padding of a dispatch with empty files is not needed, and the results are
  those the padded batch gives.
- :func:`serve` / ``python -m whisper_tpu_torch.serve``: a stdlib
  ThreadingHTTPServer front-end.  ``POST /v1/audio/transcriptions`` (or
  ``/transcribe``) with the audio file as the request body (WAV/FLAC
  natively; anything ffmpeg reads where it is installed), options as query
  parameters; ``stream=true`` answers NDJSON, one line per finalized
  segment, from :class:`~whisper_tpu_torch.streaming.StreamingTranscriber`
  (or, with ``chunked=true``, from the chunks as their batches land);
  ``GET /healthz`` for liveness.

The batcher's worker and each streaming request's handler thread run the
model at the same time, each on the device's current stream;
``torch.inference_mode`` is per thread and set by the engine's entry points.

Multi-device serving (``mesh=``, ``--mesh``; whisper_tpu/serve.py:56-86,
327): whisper_tpu's one controller shards the parameters and runs each
batch under the mesh, and GSPMD spreads the decode.  Here every rank of a
``torchrun`` (or ``parallel.launch.run_ranks``) job builds the same
:class:`BatchingTranscriber` over its own shards (``shard_params``).  Rank
0 holds the queue and the HTTP front end and broadcasts each batch's audios
and options on a CPU gloo group before it decodes them under the mesh; the
other ranks' batcher threads receive the batch and run the same
``transcribe_batch`` under the mesh, so every collective has all its ranks
(``transcribe_batch`` splits the files over the data groups).  An idle rank
0 broadcasts a heartbeat, so that no rank waits in a broadcast past the
process group's timeout; ``close()`` broadcasts a stop.  ``submit`` on
another rank raises.

The two request forms that run the model outside a batch, ``stream=true``
without ``chunked`` (a ``StreamingTranscriber``) and a chunked request
without a ``language`` (its language detection on the first 30 s), run in
the request's own thread on one device, as whisper_tpu's.  Under a mesh
only rank 0's worker thread may start collectives, so they become jobs of
the worker, which rank 0 broadcasts as it does a batch: a detection, and a
stream's open, each push of PCM, its flush and its close.  Every rank runs
each job under the mesh on its own shards (each keeps its own
``StreamingTranscriber`` of every open stream, fed the same PCM, so all
make the same model calls in the same order), and then all ranks gather
whether any of them failed: a failure on any rank fails the job on rank 0,
whose handler answers it (a stream's NDJSON ``error`` line), and every rank
drops the stream.  A fault that strikes one rank between two collectives
leaves the others waiting in the next until the process group's timeout
(``make_mesh``) raises there.  The worker takes jobs in their order, one job between two batch rounds while
batches are queued, so that a long stream and a burst of batch requests
advance in turns.
"""

import argparse
import contextlib
import itertools
import json
import os
import tempfile
import threading
import time
import traceback
from collections import OrderedDict, deque
from concurrent.futures import Future
from concurrent.futures import TimeoutError as FutureTimeoutError
from typing import Any, Dict, List, Optional, Union

import numpy as np

from .profiling import span

__all__ = ["BatchingTranscriber", "make_server", "serve"]

# an idle rank 0 broadcasts this often, well inside the process group's timeout
_HEARTBEAT_S = 30.0

# the fields of a segment that a response carries
_SEGMENT_KEYS = ("id", "start", "end", "text", "words", "avg_logprob", "no_speech_prob")


def _freeze(v):
    """Hashable stand-in for an option value (lists/tuples -> tuples);
    transcribe takes a tuple wherever it takes a list."""
    if isinstance(v, (list, tuple)):
        return tuple(_freeze(x) for x in v)
    return v


class BatchingTranscriber:
    """Coalesces concurrent transcription requests into device batches.

    ``submit(..., priority=True)`` puts a request in the priority lane: it
    is batched ahead of every queued normal request of its options group,
    and groups with priority work are dispatched first.

    ``stats`` counts as it goes (no device read): ``requests`` submitted,
    ``taken`` off the queue, ``batches`` and ``errors``, and
    ``queue_wait_s``, the taken requests' summed time from ``submit`` to
    leaving the queue.  The worker's spans (``profiling.span``): ``fill``,
    a batch's fill window, and ``round``, its call into
    ``transcribe_batch``.
    """

    def __init__(
        self,
        model,
        batch_size: int = 16,
        max_wait_s: float = 0.25,
        mesh=None,
        **transcribe_options,
    ):
        from .batch import transcribe_batch  # local import: avoid cycles

        self.mesh = mesh
        if mesh is not None:
            # each rank holds its shards (whisper_tpu/serve.py:80-86); the
            # caller's model is not changed
            from .models.whisper import Whisper
            from .parallel import shard_params

            sharded = Whisper(model.dims, shard_params(model.params, mesh))
            sharded.alignment_heads = model.alignment_heads
            model = sharded
        self._transcribe_batch = transcribe_batch
        self.model = model
        self.batch_size = int(batch_size)
        self.max_wait_s = float(max_wait_s)
        self.defaults = transcribe_options
        # option-key -> {"p": priority deque, "n": normal deque} of
        # (audio, future, enqueue_time); key insertion order approximates
        # request order across groups
        self._groups: "OrderedDict[tuple, Dict[str, deque]]" = OrderedDict()
        self._cv = threading.Condition()
        self._closed = False
        # when the engine last finished a batch round: a batch's fill window
        # runs from max(its oldest request, engine free), so requests that
        # queued during a decode still get max_wait_s to coalesce with the
        # re-sends of the clients that decode just answered.  The worker
        # thread is its one writer and its one reader (in _take), so it takes
        # no lock; a mesh job leaves it as it is, since it answers no batch
        # client, and its time counts towards the window
        self._engine_free_t = 0.0
        # under a mesh: rank 0's queue of (kind, payload, future) jobs, whether
        # the last round was a batch (a job goes next), and every rank's open
        # streams by id
        self._jobs: deque = deque()
        self._after_batch = False
        self._streams: Dict[int, Any] = {}
        self._stream_ids = itertools.count()
        self.stats: Dict[str, Union[int, float]] = {"requests": 0, "taken": 0, "batches": 0,
                                                    "errors": 0, "queue_wait_s": 0.0}
        follower = mesh is not None and mesh.rank != 0
        self._worker = threading.Thread(target=self._follow if follower else self._run,
                                        name="whisper-tpu-torch-batcher", daemon=True)
        self._worker.start()

    # -- client API ---------------------------------------------------------

    def submit(self, audio, priority: bool = False, **overrides) -> Future:
        """Queue one audio (float32 PCM @16 kHz, or a file path) for
        transcription; returns a Future resolving to the transcribe() dict.
        Under a mesh only rank 0 takes requests."""
        if self.mesh is not None and self.mesh.rank != 0:
            raise RuntimeError(f"BatchingTranscriber: rank {self.mesh.rank} of a mesh takes no "
                               "requests; rank 0 holds the queue and broadcasts each batch")
        fut: Future = Future()
        # overrides equal to the server defaults don't fragment batching
        overrides = {
            k: v for k, v in overrides.items() if not (k in self.defaults and self.defaults[k] == v)
        }
        key = tuple(sorted((k, _freeze(v)) for k, v in overrides.items()))
        with self._cv:
            if self._closed:
                raise RuntimeError("BatchingTranscriber is closed")
            lanes = self._groups.setdefault(key, {"p": deque(), "n": deque()})
            lanes["p" if priority else "n"].append((audio, fut, time.monotonic()))
            self.stats["requests"] += 1
            self._cv.notify()
        return fut

    def transcribe(self, audio, timeout: Optional[float] = None, **overrides):
        """Synchronous convenience wrapper over submit()."""
        return self.submit(audio, **overrides).result(timeout)

    def submit_chunk_futures(self, audio, chunk_overlap: float = 5.0, priority: bool = False,
                             **overrides):
        """Split ONE long audio into fixed overlapping 30 s chunks and queue
        each as its own request; returns ``(offsets_sec, futures)``.

        The chunks share one options group, so they coalesce into the same
        device batches as each other (and as concurrent requests with the
        same options).  Ownership boundaries are fixed by the offsets
        (chunked.owned_segments), so chunk i's stitched segments can go out
        as soon as futures[i] resolves.
        """
        from .audio import SAMPLE_RATE, load_audio
        from .chunked import chunk_offsets, detect_file_language

        if overrides.pop("condition_on_previous_text", False):
            raise ValueError(
                "chunked requests decode chunks independently; "
                "condition_on_previous_text=True requires a non-chunked request"
            )
        wave = load_audio(audio) if isinstance(audio, str) else np.asarray(audio)
        if wave.ndim != 1:
            wave = wave.reshape(-1)
        language = overrides.get("language", self.defaults.get("language"))
        if language is None:
            if self.mesh is None:
                language = detect_file_language(self.model, wave)
            else:  # on every rank, as a job of the worker
                language = self._submit_job("detect", wave[: 30 * SAMPLE_RATE]).result(
                    timeout=REQUEST_TIMEOUT_S)
        offsets = chunk_offsets(wave.shape[0], chunk_overlap)
        chunk_samples = 30 * SAMPLE_RATE
        futures = [
            self.submit(
                wave[o : o + chunk_samples],
                priority=priority,
                condition_on_previous_text=False,
                language=language,
                **{k: v for k, v in overrides.items() if k != "language"},
            )
            for o in offsets
        ]
        return [o / SAMPLE_RATE for o in offsets], futures

    def submit_chunked(self, audio, chunk_overlap: float = 5.0, priority: bool = False,
                       **overrides) -> Future:
        """Queue one long audio as parallel chunks; returns a Future of the
        stitched ``{"text", "segments", "language"}`` dict (the
        ``transcribe_chunked`` result shape)."""
        from .chunked import merge_chunk_segments

        offsets_sec, futures = self.submit_chunk_futures(
            audio, chunk_overlap=chunk_overlap, priority=priority, **overrides
        )
        out: Future = Future()
        lock = threading.Lock()
        remaining = [len(futures)]

        def _done(_):
            with lock:
                remaining[0] -= 1
                if remaining[0] > 0:
                    return
            try:
                results = [f.result() for f in futures]
                if len(results) == 1:
                    merged = results[0]["segments"]
                else:
                    merged = merge_chunk_segments([r["segments"] for r in results], offsets_sec)
                out.set_result(dict(text="".join(s["text"] for s in merged), segments=merged,
                                    language=results[0]["language"]))
            except BaseException as exc:  # the first chunk's failure
                out.set_exception(exc)

        for f in futures:
            f.add_done_callback(_done)
        return out

    def _open_stream(self, options: Dict[str, Any]):
        """A streaming transcriber of the model: a StreamingTranscriber, or
        under a mesh one that runs on every rank through the worker
        (module docstring)."""
        if self.mesh is None:
            from .streaming import StreamingTranscriber

            return StreamingTranscriber(self.model, **options)
        return _MeshStream(self, options)

    def _submit_job(self, kind: str, payload) -> Future:
        """Queue a job for the worker (under a mesh, on rank 0)."""
        fut: Future = Future()
        with self._cv:
            if self._closed:
                raise RuntimeError("BatchingTranscriber is closed")
            self._jobs.append((kind, payload, fut))
            self._cv.notify()
        return fut

    def close(self, drain: bool = True):
        """Stop the worker; with drain=True, first finish queued requests.
        Under a mesh rank 0's worker broadcasts a stop as it ends, and the
        other ranks wait here until it has."""
        if self.mesh is not None and self.mesh.rank != 0:
            self._worker.join()
            return
        if drain:
            while self._worker.is_alive():
                with self._cv:
                    if not self._jobs and not any(lanes["p"] or lanes["n"]
                                                  for lanes in self._groups.values()):
                        break
                time.sleep(0.01)
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        self._worker.join(timeout=30)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- worker -------------------------------------------------------------

    def _pick_group(self):
        """Group to serve next: the oldest priority head wins over any normal."""
        best_key, best_t = None, None
        for key, lanes in self._groups.items():
            if lanes["p"] and (best_t is None or lanes["p"][0][2] < best_t):
                best_key, best_t = key, lanes["p"][0][2]
        if best_key is not None:
            return best_key
        for key, lanes in self._groups.items():
            if lanes["n"] and (best_t is None or lanes["n"][0][2] < best_t):
                best_key, best_t = key, lanes["n"][0][2]
        return best_key

    def _run(self):
        try:
            self._serve_queue()
        finally:
            if self.mesh is not None:
                self.mesh.broadcast_object(("stop",))

    def _next_work(self):
        """The worker's next round (called under the lock): ("job", kind,
        payload, future) when a job is queued and the last round was a batch
        or no batch is queued, else ("batch", key, items), or None."""
        key = self._pick_group()
        if self._jobs and (self._after_batch or key is None):
            self._after_batch = False
            return ("job",) + self._jobs.popleft()
        if key is None:
            return None
        self._after_batch = True
        return "batch", key, self._take(key)

    def _serve_queue(self):
        idle_s = _HEARTBEAT_S if self.mesh is not None else None
        while True:
            with self._cv:
                work = self._next_work()
                while work is None and not self._closed:
                    if not self._cv.wait(timeout=idle_s):
                        break  # idle under a mesh: the heartbeat below
                    work = self._next_work()
                if work is None and self._closed:
                    return
            if work is None:
                self.mesh.broadcast_object(("idle",))
                continue
            if work[0] == "job":
                self._lead_job(*work[1:])
                continue
            _, key, items = work
            if not items:
                continue
            options = dict(self.defaults)
            options.update(dict(key))
            self._dispatch(items, options)
            self._engine_free_t = time.monotonic()

    def _follow(self):
        """A mesh rank other than 0: run each batch and job rank 0
        broadcasts, under the mesh, until its stop.  A batch's failure here
        is rank 0's too (the same inputs), which answers it; a job's reaches
        rank 0 through the job's gather."""
        while True:
            message = self.mesh.broadcast_object()
            if message[0] == "stop":
                return
            if message[0] == "batch":
                _, audios, options = message
                try:
                    with self.mesh:
                        self._transcribe_batch(self.model, audios, batch_size=self.batch_size,
                                               **options)
                except Exception:  # the batcher keeps serving; rank 0 answers the request
                    traceback.print_exc()
            elif message[0] == "job":
                self._run_job(*message[1:])

    def _lead_job(self, kind: str, payload, fut: Future):
        """Rank 0: broadcast a job, run it, and answer its future."""
        self.mesh.broadcast_object(("job", kind, payload))
        value, error = self._run_job(kind, payload)
        if error is not None:
            with self._cv:
                self.stats["errors"] += 1
        with contextlib.suppress(Exception):  # cancelled by the client
            if error is None:
                fut.set_result(value)
            else:
                fut.set_exception(RuntimeError(error))

    def _run_job(self, kind: str, payload):
        """Every rank: one job under the mesh, then the gather of every
        rank's failure; returns (this rank's value, the failures or None).
        A failed job drops its stream on every rank."""
        error = None
        try:
            with self.mesh:
                value = self._job(kind, payload)
        except Exception as exc:  # the worker keeps serving; rank 0 answers the job
            traceback.print_exc()
            value, error = None, f"{type(exc).__name__}: {exc}"
        failures = [f"rank {rank}: {e}" for rank, e in
                    enumerate(self.mesh.gather_objects(error, "world")) if e is not None]
        if failures and kind == "stream":
            self._streams.pop(payload[0], None)
        return value, "; ".join(failures) or None

    def _job(self, kind: str, payload):
        if kind == "detect":
            from .chunked import detect_file_language

            return detect_file_language(self.model, payload)
        sid, op, arg = payload
        if op == "open":
            from .streaming import StreamingTranscriber

            self._streams[sid] = StreamingTranscriber(self.model, **arg)
            return None
        if op == "close":
            self._streams.pop(sid, None)
            return None
        st = self._streams[sid]
        if op == "push":
            return st.push(arg)
        segments = st.flush()  # op == "flush": the stream ends
        del self._streams[sid]
        return segments, st.result

    def _take(self, key) -> list:
        """Up to batch_size requests of an options group, after its fill
        window (called under the lock)."""
        lanes = self._groups[key]

        def count():
            return len(lanes["p"]) + len(lanes["n"])

        def oldest():
            return min(dq[0][2] for dq in lanes.values() if dq)

        # wait for the batch to fill, up to max_wait after the group's
        # oldest request arrived or the engine became free, whichever
        # is later; an idle engine with a lone request pays max_wait_s
        deadline = max(oldest(), self._engine_free_t) + self.max_wait_s
        with span("fill"):
            while count() < self.batch_size and not self._closed and time.monotonic() < deadline:
                self._cv.wait(timeout=max(deadline - time.monotonic(), 0.001))
        items = []
        for dq in (lanes["p"], lanes["n"]):  # priority lane first
            while dq and len(items) < self.batch_size:
                items.append(dq.popleft())
        now = time.monotonic()
        self.stats["taken"] += len(items)
        self.stats["queue_wait_s"] += sum(now - t for _, _, t in items)
        if not (lanes["p"] or lanes["n"]):
            del self._groups[key]  # drained groups don't accumulate
        return items

    def _dispatch(self, items, options):
        audios = [a for a, _, _ in items]
        futures = [f for _, f, _ in items]
        try:
            if self.mesh is None:
                with span("round"):
                    results = self._transcribe_batch(self.model, audios,
                                                     batch_size=self.batch_size, **options)
            else:
                self.mesh.broadcast_object(("batch", audios, options))
                with self.mesh, span("round"):
                    results = self._transcribe_batch(self.model, audios,
                                                     batch_size=self.batch_size, **options)
            with self._cv:
                self.stats["batches"] += 1
            for fut, res in zip(futures, results):
                try:
                    fut.set_result(res)
                except Exception:  # cancelled by the client: drop the result
                    pass
        except Exception as exc:
            with self._cv:
                self.stats["errors"] += 1
            if len(items) > 1:
                # one bad item (unreadable path, undecodable audio) must not
                # fail its co-batched neighbours: retry each alone
                for item in items:
                    self._dispatch([item], options)
            else:
                try:
                    futures[0].set_exception(exc)
                except Exception:  # cancelled by the client
                    pass


class _MeshStream:
    """A stream under a mesh, with StreamingTranscriber's ``push``,
    ``flush`` and ``result``: each call is a job of the batcher's worker on
    every rank (module docstring), waited for here.  ``close`` drops it on
    every rank if it did not end."""

    def __init__(self, batcher: BatchingTranscriber, options: Dict[str, Any]):
        self._batcher = batcher
        self._id = next(batcher._stream_ids)
        self.result = None
        self._call("open", options)

    def _call(self, op: str, arg=None):
        fut = self._batcher._submit_job("stream", (self._id, op, arg))
        return fut.result(timeout=REQUEST_TIMEOUT_S)

    def push(self, pcm) -> List[dict]:
        return self._call("push", np.asarray(pcm, np.float32).reshape(-1))

    def flush(self) -> List[dict]:
        segments, self.result = self._call("flush")
        return segments

    def close(self):
        if self.result is None:  # not flushed: a no-op where it is gone already
            with contextlib.suppress(RuntimeError):  # the batcher closed first
                self._batcher._submit_job("stream", (self._id, "close", None))


# ---------------------------------------------------------------------------
# HTTP front-end
# ---------------------------------------------------------------------------

# per-request ceiling of the HTTP layer: a wedged device answers 503
REQUEST_TIMEOUT_S = float(os.environ.get("WHISPER_TPU_REQUEST_TIMEOUT", "1200"))

_BOOL = {"true": True, "1": True, "false": False, "0": False}
_OPTION_TYPES = {
    "language": str,
    "task": str,
    "temperature": float,
    "beam_size": int,
    "best_of": int,
    "patience": float,
    "length_penalty": float,
    "initial_prompt": str,
    "condition_on_previous_text": bool,
    "word_timestamps": bool,
    "no_speech_threshold": float,
    "logprob_threshold": float,
    "compression_ratio_threshold": float,
    "hallucination_silence_threshold": float,
}


def _parse_options(query: str) -> Dict[str, Any]:
    from urllib.parse import parse_qsl

    out: Dict[str, Any] = {}
    for k, v in parse_qsl(query):
        # request-routing flags, not transcribe options
        if k in ("priority", "stream", "chunked"):
            out[k] = _BOOL[v.lower()]
            continue
        if k == "chunk_overlap":
            out[k] = float(v)
            continue
        typ = _OPTION_TYPES.get(k)
        if typ is None:
            raise ValueError(f"unknown option {k!r}")
        out[k] = _BOOL[v.lower()] if typ is bool else typ(v)
    return out


def _segment_json(seg: dict) -> dict:
    return {k: v for k, v in seg.items() if k in _SEGMENT_KEYS}


def _make_handler(batcher: BatchingTranscriber):
    from http.server import BaseHTTPRequestHandler

    from .audio import load_audio

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def _send_json(self, code: int, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _start_ndjson(self):
            self.send_response(200)
            self.send_header("Content-Type", "application/x-ndjson")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()

        def _write_chunk(self, obj):
            body = (json.dumps(obj) + "\n").encode()
            self.wfile.write(f"{len(body):x}\r\n".encode() + body + b"\r\n")
            self.wfile.flush()

        def do_GET(self):
            if self.path.split("?")[0] in ("/healthz", "/health"):
                self._send_json(200, {"status": "ok", **batcher.stats})
            else:
                self._send_json(404, {"error": "not found"})

        def do_POST(self):
            # drain the body before any response, or the keep-alive
            # connection breaks mid-pipeline on error paths
            length = int(self.headers.get("Content-Length", 0))
            data = self.rfile.read(length) if length > 0 else b""
            path, _, query = self.path.partition("?")
            if path not in ("/v1/audio/transcriptions", "/transcribe"):
                self._send_json(404, {"error": "not found"})
                return
            try:
                options = _parse_options(query)
            except (ValueError, KeyError) as exc:
                self._send_json(400, {"error": str(exc)})
                return
            if not data:
                self._send_json(400, {"error": "empty request body"})
                return
            priority = bool(options.pop("priority", False))
            stream = bool(options.pop("stream", False))
            chunked = bool(options.pop("chunked", False))
            chunk_overlap = float(options.pop("chunk_overlap", 5.0))
            try:
                # the decoders read files (native WAV/FLAC, or ffmpeg):
                # spool the body to a temporary file
                with tempfile.NamedTemporaryFile(suffix=".audio", delete=False) as f:
                    f.write(data)
                    tmp = f.name
                try:
                    audio = load_audio(tmp)
                finally:
                    os.unlink(tmp)
                if stream:
                    if chunked:
                        self._stream_chunked_response(audio, options, chunk_overlap, priority)
                    else:
                        self._stream_response(audio, options)
                    return
                if chunked:
                    try:
                        fut = batcher.submit_chunked(audio, chunk_overlap=chunk_overlap,
                                                     priority=priority, **options)
                    except ValueError as exc:  # contradictory chunked options
                        self._send_json(400, {"error": str(exc)})
                        return
                else:
                    fut = batcher.submit(audio, priority=priority, **options)
                # a bounded wait: a wedged device surfaces as an error, not as
                # blocked HTTP threads piling up
                try:
                    result = fut.result(timeout=REQUEST_TIMEOUT_S)
                except (TimeoutError, FutureTimeoutError):
                    fut.cancel()
                    self._send_json(503, {"error": "transcription timed out; server busy"})
                    return
            except Exception as exc:
                self._send_json(500, {"error": f"{type(exc).__name__}: {exc}"})
                return
            self._send_json(200, {"text": result["text"], "language": result["language"],
                                  "segments": [_segment_json(s) for s in result["segments"]]})

        def _stream_response(self, audio, options):
            """NDJSON, one line per finalized segment, from a
            StreamingTranscriber in this handler's thread (under a mesh, on
            every rank through the worker): the first window's segments go
            out while later windows still decode."""
            merged = dict(batcher.defaults)
            merged.update(options)
            merged.pop("batch_size", None)
            st = batcher._open_stream(merged)
            self._start_ndjson()
            try:
                # ~5 s slices, so that segments stream out per window
                step = 5 * 16000
                for off in range(0, len(audio), step):
                    for seg in st.push(audio[off : off + step]):
                        self._write_chunk(_segment_json(seg))
                for seg in st.flush():
                    self._write_chunk(_segment_json(seg))
                final = st.result
                self._write_chunk({"done": True, "text": final["text"],
                                   "language": final["language"]})
            except Exception as exc:
                self._write_chunk({"error": f"{type(exc).__name__}: {exc}"})
            finally:
                if isinstance(st, _MeshStream):
                    st.close()
            self.wfile.write(b"0\r\n\r\n")

        def _stream_chunked_response(self, audio, options, chunk_overlap, priority):
            """NDJSON for a chunked request: the chunks decode through the
            batcher, and chunk i's owned segments go out as soon as its
            future resolves (in order)."""
            from .chunked import owned_segments

            self._start_ndjson()
            try:
                offsets_sec, futures = batcher.submit_chunk_futures(
                    audio, chunk_overlap=chunk_overlap, priority=priority, **options
                )
                texts, language, next_id = [], None, 0
                for i, fut in enumerate(futures):
                    result = fut.result(timeout=REQUEST_TIMEOUT_S)
                    language = result["language"]
                    for seg in owned_segments(result["segments"], i, offsets_sec):
                        seg = dict(seg, id=next_id)
                        next_id += 1
                        texts.append(seg["text"])
                        self._write_chunk(_segment_json(seg))
                self._write_chunk({"done": True, "text": "".join(texts), "language": language})
            except Exception as exc:
                self._write_chunk({"error": f"{type(exc).__name__}: {exc}"})
            self.wfile.write(b"0\r\n\r\n")

        def log_message(self, fmt, *args):  # quiet by default
            pass

    return Handler


def serve(
    model,
    host: str = "127.0.0.1",
    port: int = 9000,
    batch_size: int = 16,
    max_wait_s: float = 0.25,
    mesh=None,
    **transcribe_options,
):
    """Start the HTTP server (blocking).  Returns never; raises on bind error.
    Under a mesh every rank calls it: rank 0 serves HTTP, the others run
    its batches until it stops."""
    server = make_server(model, host, port, batch_size, max_wait_s, mesh=mesh, **transcribe_options)
    if mesh is not None and mesh.rank != 0:
        server.serve_forever()
        return
    print(f"whisper_tpu_torch serving on http://{host}:{server.server_port} "
          f"(batch_size={batch_size}, max_wait={max_wait_s}s, device={model.device})")
    try:
        server.serve_forever()
    finally:
        server.batcher.close(drain=False)


def make_server(
    model,
    host: str = "127.0.0.1",
    port: int = 0,
    batch_size: int = 16,
    max_wait_s: float = 0.25,
    mesh=None,
    **transcribe_options,
):
    """Build (without starting) the ThreadingHTTPServer; port 0 = ephemeral.

    The server carries its ``batcher``; a caller that embeds the server runs
    ``serve_forever`` in a thread, and on teardown calls ``shutdown`` and
    ``batcher.close()``.

    Under a mesh every rank calls it with the same arguments.  Rank 0 binds
    the port; another rank gets a :class:`_FollowerServer`, whose
    ``serve_forever`` runs rank 0's batches until rank 0's batcher stops.
    """
    from http.server import ThreadingHTTPServer

    batcher = BatchingTranscriber(model, batch_size=batch_size, max_wait_s=max_wait_s, mesh=mesh,
                                  **transcribe_options)
    if mesh is not None and mesh.rank != 0:
        return _FollowerServer(batcher)
    server = ThreadingHTTPServer((host, port), _make_handler(batcher))
    server.batcher = batcher
    return server


class _FollowerServer:
    """A mesh rank's stand-in for the HTTP server: it binds nothing, and
    serves by running the batches rank 0 broadcasts."""

    server_port = None

    def __init__(self, batcher: BatchingTranscriber):
        self.batcher = batcher

    def serve_forever(self):
        self.batcher.close()

    def shutdown(self):
        pass

    def server_close(self):
        pass


def parse_mesh(spec: str):
    """Build a mesh from a CLI spec like "data=8" or "data=4,model=2"
    (whisper_tpu/serve.py:611-624), over the process group that
    ``torchrun`` describes (``parallel.make_mesh``)."""
    from .parallel import make_mesh

    return make_mesh(_mesh_shape(spec))


def _mesh_shape(spec: str):
    sizes = {"data": 1, "model": 1}
    for part in spec.split(","):
        name, _, num = part.partition("=")
        name = name.strip()
        if name not in sizes or not num.strip().isdigit():
            raise ValueError(
                f"bad mesh spec {spec!r}; expected e.g. 'data=8' or 'data=4,model=2'"
            )
        sizes[name] = int(num)
    return sizes["data"], sizes["model"]


def main(argv: Optional[List[str]] = None):
    parser = argparse.ArgumentParser(
        prog="python -m whisper_tpu_torch.serve",
        description="Batching transcription HTTP server",
    )
    parser.add_argument("--model", default="turbo",
                        help="model name or checkpoint path (.pt, or whisper_tpu's .npz)")
    parser.add_argument("--device", default="cuda", help="torch device to run on, e.g. 'cuda' or 'cpu'")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=9000)
    parser.add_argument("--batch-size", type=int, default=16)
    parser.add_argument("--max-wait", type=float, default=0.25)
    parser.add_argument("--language", default=None)
    parser.add_argument("--task", default="transcribe")
    parser.add_argument("--quantize", default=None, choices=[None, "int8", "int8+logits"])
    parser.add_argument("--mesh", default=None, metavar="SPEC",
                        help="multi-device mesh, e.g. 'data=8' (pure data parallel) or "
                        "'data=4,model=2' (4-way DP x 2-way TP); run one process per device "
                        "under torchrun (--nproc-per-node data*model): rank 0 binds the port")
    args = parser.parse_args(argv)

    from . import load_model

    mesh = None
    if args.mesh:  # every rank on its own card (cuda:LOCAL_RANK), or the device named
        from .parallel import make_mesh

        mesh = make_mesh(_mesh_shape(args.mesh), devices=None if args.device == "cuda" else args.device)
    device = mesh.device if mesh is not None else args.device
    model = load_model(args.model, device=device, quantize=args.quantize)
    options = {"task": args.task}
    if args.language:
        options["language"] = args.language
    serve(model, host=args.host, port=args.port, batch_size=args.batch_size,
          max_wait_s=args.max_wait, mesh=mesh, **options)


if __name__ == "__main__":
    main()
