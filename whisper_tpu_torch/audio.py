"""Audio front-end: decode -> 16 kHz mono PCM -> log-Mel spectrogram.

Counterpart of ``whisper_tpu/audio.py:27-310``.  Decoding uses the JAX
package's native C++ WAV/FLAC decoder (built by path, see
:mod:`whisper_tpu_torch.native`) with the ffmpeg CLI for other containers.
The spectrogram is ``torch.stft`` on the tensor's own device; its numerics
follow ``_log_mel_jax`` (periodic Hann window, reflect-padded centred
frames, last frame dropped, power spectrum, clamp at 1e-10, floor at
max - 8, (x + 4) / 4).
"""

import ctypes
import os
import shutil
from functools import lru_cache
from subprocess import CalledProcessError, run
from typing import Optional, Union

import numpy as np
import torch
import torch.nn.functional as F

from .native import ASSETS_DIR, load_native
from .utils import exact_div

# hard-coded audio hyperparameters (reference whisper/audio.py:13-22)
SAMPLE_RATE = 16000
N_FFT = 400
HOP_LENGTH = 160
CHUNK_LENGTH = 30
N_SAMPLES = CHUNK_LENGTH * SAMPLE_RATE  # 480000 samples in a 30-second chunk
N_FRAMES = exact_div(N_SAMPLES, HOP_LENGTH)  # 3000 frames in a mel spectrogram

N_SAMPLES_PER_TOKEN = HOP_LENGTH * 2  # the initial convolutions have stride 2
FRAMES_PER_SECOND = exact_div(SAMPLE_RATE, HOP_LENGTH)  # 10ms per audio frame
TOKENS_PER_SECOND = exact_div(SAMPLE_RATE, N_SAMPLES_PER_TOKEN)  # 20ms per token


def _load_audio_native(file: str, sr: int) -> Optional[np.ndarray]:
    lib = load_native()
    if lib is None:
        return None
    out_len = ctypes.c_int64(0)
    ptr = lib.audio_decode_file(file.encode(), sr, ctypes.byref(out_len))
    if not ptr:
        return None
    try:
        return np.ctypeslib.as_array(ptr, shape=(out_len.value,)).astype(np.float32)
    finally:
        lib.audio_free(ptr)


def _load_audio_ffmpeg(file: str, sr: int) -> np.ndarray:
    cmd = [
        "ffmpeg", "-nostdin", "-threads", "0", "-i", file,
        "-f", "s16le", "-ac", "1", "-acodec", "pcm_s16le", "-ar", str(sr), "-",
    ]
    try:
        out = run(cmd, capture_output=True, check=True).stdout
    except CalledProcessError as e:
        raise RuntimeError(f"Failed to load audio: {e.stderr.decode()}") from e
    return np.frombuffer(out, np.int16).flatten().astype(np.float32) / 32768.0


def load_audio(file: str, sr: int = SAMPLE_RATE) -> np.ndarray:
    """Read an audio file as mono float32 PCM at `sr`, resampling as needed.

    WAV and FLAC decode natively (C++); other containers go through the
    ffmpeg CLI when it is installed.
    """
    audio = _load_audio_native(file, sr)
    if audio is not None:
        return audio
    if shutil.which("ffmpeg"):
        return _load_audio_ffmpeg(file, sr)
    raise RuntimeError(
        f"Failed to load audio from {file!r}: the native decoder supports "
        "WAV/FLAC, and no ffmpeg CLI was found for other formats."
    )


def pad_or_trim(array, length: int = N_SAMPLES, *, axis: int = -1):
    """Pad (zeros) or trim the audio/mel array to `length` along `axis`."""
    if isinstance(array, np.ndarray):
        if array.shape[axis] > length:
            array = array.take(indices=range(length), axis=axis)
        if array.shape[axis] < length:
            pad_widths = [(0, 0)] * array.ndim
            pad_widths[axis] = (0, length - array.shape[axis])
            array = np.pad(array, pad_widths)
        return array

    if array.shape[axis] > length:
        array = array.narrow(axis, 0, length)
    if array.shape[axis] < length:
        axis = axis % array.dim()
        pad = [0, 0] * (array.dim() - 1 - axis) + [0, length - array.shape[axis]]
        array = F.pad(array, pad)
    return array


@lru_cache(maxsize=None)
def mel_filters(n_mels: int) -> np.ndarray:
    """The mel filterbank matrix (n_mels, N_FFT//2 + 1), read from the JAX
    package's asset file by path."""
    assert n_mels in {80, 128}, f"Unsupported n_mels: {n_mels}"
    with np.load(os.path.join(ASSETS_DIR, "mel_filters.npz"), allow_pickle=False) as f:
        return f[f"mel_{n_mels}"]


def log_mel_spectrogram(
    audio: Union[str, np.ndarray, torch.Tensor],
    n_mels: int = 80,
    padding: int = 0,
    device: Union[str, torch.device, None] = None,
) -> torch.Tensor:
    """Log-Mel spectrogram (..., n_mels, n_frames) of 16 kHz audio.

    ``audio`` is a path, a 1-D waveform, or a batch of waveforms; int16
    arrays are 16-bit PCM and scale by 1/32768.  ``padding`` zero samples are
    appended (transcribe pads a full 30 s window).  The result lies on
    ``device`` (default: the tensor's own device, or the CPU for host data).
    """
    if isinstance(audio, str):
        audio = load_audio(audio)
    if isinstance(audio, np.ndarray):
        audio = torch.from_numpy(np.ascontiguousarray(audio))
    if device is not None:
        audio = audio.to(device)
    if audio.dtype == torch.int16:
        audio = audio.float() * (1.0 / 32768.0)
    else:
        audio = audio.float()
    if padding > 0:
        audio = F.pad(audio, (0, padding))

    window = torch.hann_window(N_FFT, device=audio.device)
    stft = torch.stft(
        audio, N_FFT, HOP_LENGTH, window=window, center=True,
        pad_mode="reflect", return_complex=True,
    )
    magnitudes = stft[..., :-1].abs() ** 2  # drop the trailing frame

    filters = torch.from_numpy(mel_filters(n_mels)).to(audio.device)
    mel_spec = torch.matmul(filters, magnitudes)
    log_spec = torch.clamp(mel_spec, min=1e-10).log10()
    peak = log_spec.amax(dim=(-2, -1), keepdim=True)
    log_spec = torch.maximum(log_spec, peak - 8.0)
    return (log_spec + 4.0) / 4.0
