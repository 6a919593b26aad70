"""Build and load the port's CUDA kernel library.

The kernels are CUDA C++ for Hopper (``sm_90a``) under
``whisper_tpu_torch/csrc/``.  They are compiled at first use with ``nvcc``
(one process per source, all started together, then one link) into one
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds), placed in the git-ignored ``whisper_tpu_torch/_build/`` and
loaded with ``ctypes``.  Nothing here runs at import time: the CPU tests
import every module on machines without ``nvcc``.  The ranks of a mesh
start at once, each with this module: a file lock in ``_build/`` makes the
first build while the others wait, and then load its library.
"""

import contextlib
import ctypes
import fcntl
import os
import shutil
import subprocess
import threading
from typing import Optional

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
LIB_PATH = os.path.join(BUILD_DIR, "libwhisper_kernels.so")
SOURCES = ("attention.cu", "fused_step.cu", "median.cu", "dtw.cu", "matmul_residual.cu",
           "logits.cu", "attn_packed.cu", "encoder_block.cu")
HEADERS = ("common.cuh", "mma.cuh", "hopper.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-lineinfo",
)
# K1's, E1's and the encoder GEMM's bf16 kernels build TMA tensor maps on the host with
# cuTensorMapEncodeTiled, which libcuda exports, so the library links
# libcuda (the toolkit's stub at link time, the installed one at run time)
LINK_FLAGS = ("-lcuda",)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signatures (csrc/*.cu extern "C" functions); every one returns the
# cudaError_t of cudaGetLastError() after its launches
SIGNATURES = {
    # dtype, q, k, v, out, batch*heads, T, head_dim, stream
    "encoder_attention": [_I, _P, _P, _P, _P, _I, _I, _I, _P],
    # dtype, int8 weights, int8 cross K/V, L, B, A (this launch's rows and
    # audios), its first row, the tensors' rows, its first audio, the
    # tensors' audios, C, H, T_cap, t (shared),
    # Ta, pending columns W (0: none), valid pending columns, positions (B,)
    # int32 or null (every row at t), x, out, k_new, v_new, self_k, self_v,
    # cross_k, cross_v, cross K/V scales (or null), weight pointer table
    # (host), scale pointer table (host, or null), pending K and V (or
    # null), scratch, stream
    "fused_decoder_layers": [_I] * 17 + [_P] * 17,
    # dtype, int8 K/V, A, G, C, H, Ta, q, k, v, k_scale, v_scale (or
    # null), out, stream
    "decode_cross_attention": [_I] * 7 + [_P] * 7,
    # dtype, int8 weights, B, C, F, x, out, ln_g, ln_b, w1, s1, b1, w2, s2,
    # b2, scratch, stream
    "mlp_fused": [_I] * 5 + [_P] * 12,
    # dtype, rows, C, V, x, q, s, out, stream
    "int8_logits": [_I] * 4 + [_P] * 5,
    # x, out, rows, T, width, stream
    "median_filter": [_P, _P, ctypes.c_longlong, _I, _I, _P],
    # x, trace, batch, n, m, stream
    "dtw_trace": [_P, _P, _I, _I, _I, _P],
    # seed (4 f32), out (1 f32), codes (1 int32), iters, stream
    "dtw_chain": [_P, _P, _P, _I, _P],
    # dtype, x, w, bias, res, out, M, K, N, stream
    "matmul_residual": [_I, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    # epilogue (0 bias, 1 GELU, 2 residual), column tile, x in K1's layout,
    # outputs in K1's layout, segments; x, three weights, three biases (or
    # null), res (or null), three outputs; G, T, K, N, D, stream
    "encoder_linear": [_I] * 5 + [_P] * 11 + [_I] * 5 + [_P],
    # x, g, b, out, rows, C, stream
    "layer_norm_rows": [_P] * 4 + [ctypes.c_longlong, _I, _P],
    # layout (0: (V, C), 1: (C, V)), B, C, V, x, emb, out, stream
    "logits_streamed": [_I] * 4 + [_P] * 4,
    # packed, g, Q, T, reps, eps (float), q, k0, v0, k1, v1, out, stream
    "attn_pairs": [_I] * 5 + [ctypes.c_float] + [_P] * 7,
}


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the port's CUDA kernels are "
        "built from whisper_tpu_torch/csrc at first use"
    )


def _stale() -> bool:
    if not os.path.exists(LIB_PATH):
        return True
    built = os.path.getmtime(LIB_PATH)
    return any(
        os.path.getmtime(os.path.join(CSRC_DIR, f)) > built for f in SOURCES + HEADERS
    )


@contextlib.contextmanager
def _build_lock():
    """An exclusive lock on ``_build/.lock`` across processes (flock: the
    kernel drops it when its holder exits, however it exits)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, ".lock"), "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def build(verbose: bool = False) -> str:
    """Compile the kernel library (always; :func:`lib` builds only when it
    is missing or older than its sources), under the build lock.

    Returns nvcc's combined output (with ``-Xptxas -v`` when ``verbose``:
    registers, shared memory and spills per kernel).  Raises on failure.
    """
    with _build_lock():
        return _compile(verbose)


def ensure_built() -> bool:
    """Build the library if it is missing or stale, under the build lock:
    of processes that ask at once, one builds and the others find it
    fresh.  Returns whether this call built it."""
    with _build_lock():
        if not _stale():
            return False
        _compile()
        return True


def _compile(verbose: bool = False) -> str:
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc, tag = _nvcc(), f"{os.getpid()}.tmp"
    objects = [os.path.join(BUILD_DIR, f"{s}.{tag}.o") for s in SOURCES]
    compiles = [
        subprocess.Popen(
            [nvcc, *NVCC_FLAGS, *(("-Xptxas", "-v") if verbose else ()), "-c",
             os.path.join(CSRC_DIR, s), "-o", obj],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for s, obj in zip(SOURCES, objects)
    ]
    logs = [proc.communicate()[0] for proc in compiles]  # waits for every one
    tmp = f"{LIB_PATH}.{tag}"
    try:
        for source, proc, log in zip(SOURCES, compiles, logs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {source} ({proc.returncode}):\n{log}")
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objects, *LINK_FLAGS],
            capture_output=True, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{link.stdout}\n{link.stderr}")
        os.replace(tmp, LIB_PATH)
    finally:
        for path in objects + [tmp]:
            if os.path.exists(path):
                os.remove(path)
    return "".join(logs)


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built first when needed."""
    global _lib
    with _lock:
        if _lib is None:
            ensure_built()
            handle = ctypes.CDLL(LIB_PATH)
            for name, argtypes in SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            handle.kernel_error_string.argtypes = [_I]
            handle.kernel_error_string.restype = ctypes.c_char_p
            _lib = handle
        return _lib


def check(err: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        text = lib().kernel_error_string(err).decode(errors="replace")
        raise RuntimeError(f"CUDA kernel {name} failed: cudaError_t {err} ({text})")


_count_lock = threading.Lock()


def count_launch(wrapper, n: int = 1, layout=None) -> None:
    """Add n to a kernel wrapper's ``launches`` (and to
    ``launches_by_layout[layout]``), under a lock: a server's batching
    worker and its streaming handlers launch kernels from several threads,
    and ``+=`` on an attribute is not atomic."""
    with _count_lock:
        wrapper.launches += n
        if layout is not None:
            wrapper.launches_by_layout[layout] += n


def _tensors(node):
    """The tensors in a wrapper's argument: a tensor, or a dict, list or
    tuple (an Int8Weight among them) of them, at any depth."""
    if isinstance(node, torch.Tensor):
        yield node
    elif isinstance(node, dict):
        for v in node.values():
            yield from _tensors(v)
    elif isinstance(node, (list, tuple)):
        for v in node:
            yield from _tensors(v)


def refuse_grad(name: str, *inputs) -> None:
    """Raise before a kernel launch whose output autograd would not track.

    No kernel here has a backward (whisper_tpu's Pallas kernels have none
    either), and a wrapper writes its kernel's output into a fresh tensor:
    under grad mode an input that requires grad would get no gradient
    through the kernel, silently.  Inference runs under
    ``torch.inference_mode()``, where grad mode is off; a training pass
    runs the differentiable torch ops instead (``training.loss_fn`` passes
    the encoder's attention explicitly)."""
    if torch.is_grad_enabled() and any(t.requires_grad for x in inputs for t in _tensors(x)):
        raise RuntimeError(
            f"CUDA kernel {name} has no backward: an input requires grad under grad mode, "
            "and the kernel's output would carry no gradient.  Run inference under "
            "torch.inference_mode() or torch.no_grad(); a training pass runs the "
            "differentiable torch ops (whisper_tpu_torch.training.loss_fn)"
        )


def stream_ptr(device) -> int:
    """The current CUDA stream of ``device``, as the kernels' launch stream."""
    return torch.cuda.current_stream(device).cuda_stream
