"""Build and load the port's CUDA kernel library.

The kernels are CUDA C++ for Hopper (``sm_90a``) under
``whisper_tpu_torch/csrc/``.  They are compiled at first use with ``nvcc``
into one shared library with a plain C interface (no PyTorch headers, so a
build takes seconds), placed in the git-ignored ``whisper_tpu_torch/_build/``
and loaded with ``ctypes``.  Nothing here runs at import time: the CPU tests
import every module on machines without ``nvcc``.
"""

import ctypes
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
SOURCES = ("attention.cu", "fused_step.cu")
HEADERS = ("common.cuh",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signatures (csrc/*.cu extern "C" functions); every one returns the
# cudaError_t of cudaGetLastError() after its launches
SIGNATURES = {
    # dtype, q, k, v, out, batch*heads, T, head_dim, stream
    "encoder_attention": [_I, _P, _P, _P, _P, _I, _I, _I, _P],
    # dtype, L, C, H, T_cap, t, Ta, x, out, k_new, v_new, self_k, self_v,
    # cross_k, cross_v, weight pointer table (host), scratch, stream
    "fused_decoder_layers": [
        _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
    ],
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


def build(verbose: bool = False) -> str:
    """Compile the kernel library if it is missing or older than its sources.

    Returns nvcc's combined output (with ``-Xptxas -v`` when ``verbose``:
    registers, shared memory and spills per kernel).  Raises on failure.
    """
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{LIB_PATH}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, *(("-Xptxas", "-v") if verbose else ()), "-o", tmp]
    cmd += [os.path.join(CSRC_DIR, s) for s in SOURCES]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, LIB_PATH)
    return proc.stdout + proc.stderr


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built first when needed."""
    global _lib
    with _lock:
        if _lib is None:
            if _stale():
                build()
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


def stream_ptr(device) -> int:
    """The current CUDA stream of ``device``, as the kernels' launch stream."""
    return torch.cuda.current_stream(device).cuda_stream
