"""The ranks' side of tests/test_torch_parallel.py: functions that
``parallel.launch.run_ranks`` runs in spawned processes, one per rank of a
gloo mesh on the CPU.  They import the port only (no JAX), and return host
objects: numpy arrays, lists, dicts."""

import contextlib
import fcntl
import os
import tempfile
import time

import torch


@contextlib.contextmanager
def spawn_lock():
    """A lock of the host (a file in the temporary directory): the tests
    that spawn ranks hold it while their ranks run, and a test that times
    a wall ratio takes it, so that the two do not run at the same moment
    under pytest-xdist."""
    with open(os.path.join(tempfile.gettempdir(), "whisper_tpu_torch_spawn.lock"), "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def _setup(inp):
    torch.set_num_threads(1)
    from whisper_tpu_torch.models.dims import ModelDimensions
    from whisper_tpu_torch.models.load import params_from_numpy

    dims = ModelDimensions(**inp["dims"])
    return dims, params_from_numpy(inp["params"], dims)


def _np_tree(tree):
    return {k: _np_tree(v) if isinstance(v, dict) else v.detach().numpy().copy()
            for k, v in tree.items()}


def mesh_paths(rank, inp):
    """The (2, 2) mesh: every path of whisper_tpu's under a mesh."""
    import whisper_tpu_torch as w
    from whisper_tpu_torch import decoding
    from whisper_tpu_torch.batch import transcribe_batch
    from whisper_tpu_torch.distill import DistillState, distill_loss, distill_step, init_draft_from_teacher
    from whisper_tpu_torch.models.load import save_sharded
    from whisper_tpu_torch.models.whisper import Whisper, encoder_apply
    from whisper_tpu_torch.parallel import make_mesh, shard_params
    from whisper_tpu_torch.serve import BatchingTranscriber
    from whisper_tpu_torch.timing import find_alignment
    from whisper_tpu_torch.tokenizer import get_tokenizer
    from whisper_tpu_torch.training import init_train_state, loss_fn, make_optimizer, train_step

    dims, params = _setup(inp)
    out = {"rows": []}
    real_run = decoding.DecodingTask._run  # the rows each decode runs here

    def run_rows(task, mel):
        out["rows"].append(mel.shape[0])
        return real_run(task, mel)

    decoding.DecodingTask._run = run_rows
    mesh = make_mesh((2, 2), devices="cpu", timeout=120)
    out["coords"] = dict(mesh.coords)
    mel = torch.from_numpy(inp["mel"])
    with mesh:
        model = Whisper(dims, shard_params(params, mesh))
        with torch.inference_mode():
            out["encoder"] = encoder_apply(model.params, dims, mel).numpy()
        out["greedy"] = [r.tokens for r in model.decode(mel, w.DecodingOptions(**inp["greedy"]))]
        out["beam"] = [r.tokens for r in model.decode(mel, w.DecodingOptions(**inp["beam"]))]
        # the model as its own draft: both sharded, the resync and verify
        # passes with their reductions
        out["speculative"] = [r.tokens for r in model.decode(
            mel, w.DecodingOptions(**inp["greedy"]), draft_model=model)]
        # best-of sampling with a seed drawn from numpy, which differs between
        # the spawned processes: a model group must sample alike
        out["sampled"] = [r.tokens for r in model.decode(
            mel, w.DecodingOptions(language="en", temperature=0.7, best_of=2, sample_len=8))]
        tok = get_tokenizer(True, language="en", task="transcribe")
        words = find_alignment(model, tok, inp["text_tokens"], mel[:1], num_frames=1000)
        out["words"] = [(x.word, round(x.start, 3), round(x.end, 3)) for x in words]
        decoding.DecodingTask._run = real_run
        out["batch"] = transcribe_batch(model, inp["files"], batch_size=2, **inp["opts"])

    # the server's batcher: built on every rank, rank 0 takes the requests
    with BatchingTranscriber(Whisper(dims, params), batch_size=4, max_wait_s=0.4, mesh=mesh,
                             **inp["opts"]) as bt:
        if rank == 0:
            out["served"] = [f.result(timeout=300) for f in [bt.submit(a) for a in inp["tones"]]]
        else:
            try:
                bt.submit(inp["tones"][0])
            except RuntimeError as exc:
                out["submit_refused"] = str(exc)

    out.update(_mesh_forms(rank, mesh, dims, params, inp))

    # one DP+TP train step, then two more; distillation
    batch = {k: torch.from_numpy(v) for k, v in inp["train"].items()}
    with mesh:
        opt = make_optimizer(learning_rate=1e-3)
        state = init_train_state(shard_params(params, mesh), opt)
        state, m = train_step(state, dims, opt, batch)
        out["step1"] = (m["loss"].item(), m["grad_norm"].item())
        out["params1"] = _np_tree(state.params)
        out["grads1"] = _np_tree(_grads(state))
        losses = [m["loss"].item()]
        for _ in range(2):
            state, m = train_step(state, dims, opt, batch)
            losses.append(m["loss"].item())
        with torch.no_grad():
            losses.append(loss_fn(state.params, dims, batch).item())
        out["losses"] = losses

        teacher = shard_params(params, mesh)
        draft, draft_dims = init_draft_from_teacher(teacher, dims, 1)
        dopt = make_optimizer(learning_rate=1e-3)
        dstate = DistillState(draft["decoder"], dopt.init(draft["decoder"]), 0)
        with torch.no_grad():
            feats = encoder_apply(teacher, dims, batch["mel"])
        dbatch = {"features": feats, "tokens": batch["tokens"], "loss_mask": batch["loss_mask"]}
        with torch.no_grad():
            dlosses = [distill_loss(dstate.decoder, teacher, draft_dims, dims, dbatch).item()]
        for _ in range(3):
            dstate, dm = distill_step(dstate, teacher, draft_dims, dims, dopt, dbatch)
            dlosses.append(dm["loss"].item())
        out["distill"] = dlosses

        save_sharded(inp["ckpt"], shard_params(params, mesh), dims)
    return out


def _post(port, query, body):
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    conn.request("POST", f"/v1/audio/transcriptions{query}", body=body)
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return resp.status, data.decode()


def _mesh_forms(rank, mesh, dims, params, inp):
    """make_server(mesh=) without a default language: a stream (push and
    flush as worker jobs, with word timestamps) and a chunked request
    through the batcher, then over HTTP a stream whose first push raises on
    rank 1 alone, a stream and a chunked request; rank 0's results."""
    import threading

    from whisper_tpu_torch.models.whisper import Whisper
    from whisper_tpu_torch.serve import make_server
    from whisper_tpu_torch.streaming import StreamingTranscriber

    if rank == 1:  # a fault on one follower: the planted stream's push raises here only
        real_push = StreamingTranscriber.push

        def push(self, pcm):
            if self._initial_prompt == "planted fault":
                raise RuntimeError("planted on rank 1")
            return real_push(self, pcm)

        StreamingTranscriber.push = push
    opts = {k: v for k, v in inp["opts"].items() if k != "language"}
    server = make_server(Whisper(dims, params), port=0, batch_size=4, max_wait_s=0.2, mesh=mesh,
                         **opts)
    if rank != 0:
        server.serve_forever()
        return {}
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    out = {}
    try:
        bt, long = server.batcher, inp["long"]
        st = bt._open_stream(dict(opts, word_timestamps=True))
        segments = [s for i in range(0, len(long), 5 * 16000) for s in st.push(long[i:i + 5 * 16000])]
        segments += st.flush()
        out["stream"] = (segments, st.result)
        out["chunked"] = bt.submit_chunked(long).result(timeout=300)
        out["http"] = [_post(server.server_port, q, body) for q, body in inp["http"]]
    finally:
        server.shutdown()
        server.server_close()
        server.batcher.close()
        thread.join(timeout=60)
    return out


def _grads(state):
    """The parameters' gradients (clipped, as Adam saw them) in the params'
    tree."""
    def walk(tree):
        return {k: walk(v) if isinstance(v, dict) else v.grad for k, v in tree.items()}

    return walk(state.params)


def reload(rank, inp):
    """Load the (2, 2) checkpoint at (1, 2) and at (2, 1) in one world of two."""
    from whisper_tpu_torch.models.load import load_sharded
    from whisper_tpu_torch.parallel import make_mesh

    torch.set_num_threads(1)
    out = {}
    for shape in ((1, 2), (2, 1)):
        mesh = make_mesh(shape, devices="cpu", timeout=120)
        with mesh:
            params, dims = load_sharded(inp["ckpt"])
        out[shape] = (dict(mesh.coords), _np_tree(params), dims.__dict__)
    return out


def one_raises(rank):
    import torch.distributed as dist

    from whisper_tpu_torch.parallel import make_mesh

    make_mesh((2, 1), devices="cpu", timeout=120)
    if rank == 1:
        raise ValueError("planted")
    dist.barrier()


def race_build(rank, build_dir, start_at):
    """Two processes asking for the kernel library at the same moment
    (``start_at``, a wall-clock time), the compile stubbed by a slow write:
    one builds it."""
    from whisper_tpu_torch.ops.kernels import _lib

    _lib.BUILD_DIR = build_dir
    _lib.LIB_PATH = os.path.join(build_dir, "libwhisper_kernels.so")

    def fake_compile(verbose=False):
        with open(os.path.join(build_dir, "compiles.log"), "a") as f:
            f.write(f"{rank}\n")
        time.sleep(1.0)
        with open(_lib.LIB_PATH, "w") as f:
            f.write("built")
        return ""

    _lib._compile = fake_compile
    time.sleep(max(start_at - time.time(), 0.0))
    return _lib.ensure_built()
