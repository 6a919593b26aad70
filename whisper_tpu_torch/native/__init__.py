"""ctypes bindings for the port's native C++ runtime (BPE core, audio IO,
DTW backtrace), and the directory of its assets.

Counterpart of ``whisper_tpu/native/__init__.py``.  Importing that package
would import JAX (``whisper_tpu/__init__.py`` loads every module eagerly), so
the port keeps its own copies and compiles them with ``g++`` into its own
git-ignored build directory: ``bpe.cpp``, ``audioio.cpp`` and ``dtw.cpp``
here are whisper_tpu's ``native/*.cpp`` (each names its source in its
header), and ``whisper_tpu_torch/assets/`` holds copies of whisper_tpu's
``assets/mel_filters.npz``, ``gpt2.tiktoken`` and ``multilingual.tiktoken``.
As in the JAX package, every binding has a pure-Python/NumPy counterpart at
its call site (tokenizer BPE, ffmpeg audio decode), so a missing host
toolchain degrades host-side speed, not the device path.
"""

import ctypes
import os
import subprocess
import threading
import warnings
from typing import Optional

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE_DIR = os.path.dirname(os.path.abspath(__file__))
ASSETS_DIR = os.path.join(_PKG, "assets")
BUILD_DIR = os.path.join(_PKG, "_build")
_LIB_PATH = os.path.join(BUILD_DIR, "libwhisper_native.so")
_SOURCES = ["bpe.cpp", "audioio.cpp", "dtw.cpp"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def _needs_build() -> bool:
    if not os.path.exists(_LIB_PATH):
        return True
    lib_mtime = os.path.getmtime(_LIB_PATH)
    return any(
        os.path.getmtime(os.path.join(SOURCE_DIR, s)) > lib_mtime for s in _SOURCES
    )


def _build() -> bool:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
    try:
        subprocess.run(
            ["g++", "-O3", "-fPIC", "-std=c++17", "-shared", "-o", tmp]
            + [os.path.join(SOURCE_DIR, s) for s in _SOURCES],
            check=True,
            capture_output=True,
        )
        os.replace(tmp, _LIB_PATH)
        return True
    except (subprocess.CalledProcessError, FileNotFoundError) as e:
        detail = getattr(e, "stderr", b"") or b""
        warnings.warn(
            "Failed to build the native host library; using the pure Python "
            f"tokenizer and ffmpeg audio decode. {detail.decode(errors='replace')[:500]}"
        )
        return False


def load_native() -> Optional[ctypes.CDLL]:
    """Return the native library handle, building it if necessary; None on failure."""
    global _lib, _build_failed
    with _lock:
        if _lib is not None:
            return _lib
        if _build_failed:
            return None
        if _needs_build() and not _build():
            _build_failed = True
            return None
        try:
            lib = ctypes.CDLL(_LIB_PATH)
        except OSError as e:
            warnings.warn(f"Failed to load the native host library: {e}")
            _build_failed = True
            return None

        # ---- BPE core (bpe.cpp) ----
        lib.bpe_new.restype = ctypes.c_void_p
        lib.bpe_free.argtypes = [ctypes.c_void_p]
        lib.bpe_load.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int32,
        ]
        lib.bpe_encode_piece.restype = ctypes.c_int32
        lib.bpe_encode_piece.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int32,
        ]

        # ---- Audio IO (audioio.cpp) ----
        lib.audio_decode_file.restype = ctypes.POINTER(ctypes.c_float)
        lib.audio_decode_file.argtypes = [
            ctypes.c_char_p,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.audio_free.argtypes = [ctypes.POINTER(ctypes.c_float)]

        # ---- DTW backtrace (dtw.cpp) ----
        lib.dtw_backtrace.restype = ctypes.c_int32
        lib.dtw_backtrace.argtypes = [
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int32,
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
        ]

        _lib = lib
        return _lib
