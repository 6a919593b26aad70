"""whisper_tpu_torch: the port of whisper_tpu to PyTorch and CUDA on an
NVIDIA H100.

Public API parity target: ``whisper_tpu/__init__.py`` (reference
``whisper/__init__.py``): load_model / available_models / load_audio /
log_mel_spectrogram / pad_or_trim / transcribe / decode / detect_language /
DecodingOptions / DecodingResult / ModelDimensions / Whisper.  This slice
runs the greedy ``load_model`` -> ``transcribe`` path, with the encoder's
self-attention (K1) and the decode step (K2) as hand-written CUDA kernels.
"""

import hashlib
import os
import urllib.request
import warnings
from typing import List, Optional, Union

import torch

from .audio import load_audio, log_mel_spectrogram, pad_or_trim
from .decoding import DecodingOptions, DecodingResult, decode, detect_language
from .models import ModelDimensions, Whisper
from .transcribe import transcribe

# attach the high-level entry points as methods (reference model.py:343-345)
Whisper.decode = decode
Whisper.detect_language = detect_language
Whisper.transcribe = transcribe

# official checkpoint registry (reference whisper/__init__.py:17-32); the
# SHA256 is embedded in the URL path and verified after download
_MODELS = {
    "tiny.en": "https://openaipublic.azureedge.net/main/whisper/models/d3dd57d32accea0b295c96e26691aa14d8822fac7d9d27d5dc00b4ca2826dd03/tiny.en.pt",
    "tiny": "https://openaipublic.azureedge.net/main/whisper/models/65147644a518d12f04e32d6f3b26facc3f8dd46e5390956a9424a650c0ce22b9/tiny.pt",
    "base.en": "https://openaipublic.azureedge.net/main/whisper/models/25a8566e1d0c1e2231d1c762132cd20e0f96a85d16145c3a00adf5d1ac670ead/base.en.pt",
    "base": "https://openaipublic.azureedge.net/main/whisper/models/ed3a0b6b1c0edf879ad9b11b1af5a0e6ab5db9205f891f668f8b0e6c6326e34e/base.pt",
    "small.en": "https://openaipublic.azureedge.net/main/whisper/models/f953ad0fd29cacd07d5a9eda5624af0f6bcf2258be67c92b79389873d91e0872/small.en.pt",
    "small": "https://openaipublic.azureedge.net/main/whisper/models/9ecf779972d90ba49c06d968637d720dd632c55bbf19d441fb42bf17a411e794/small.pt",
    "medium.en": "https://openaipublic.azureedge.net/main/whisper/models/d7440d1dc186f76616474e0ff0b3b6b879abc9d1a4926b7adfa41db2d497ab4f/medium.en.pt",
    "medium": "https://openaipublic.azureedge.net/main/whisper/models/345ae4da62f9b3d59415adc60127b97c714f32e89e936602e85993674d08dcb1/medium.pt",
    "large-v1": "https://openaipublic.azureedge.net/main/whisper/models/e4b87e7e0bf463eb8e6956e646f1e277e901512310def2c24bf0e11bd3c28e9a/large-v1.pt",
    "large-v2": "https://openaipublic.azureedge.net/main/whisper/models/81f7c96c852ee8fc832187b0132e569d6c3065a3252ed18e56effd0b6a73e524/large-v2.pt",
    "large-v3": "https://openaipublic.azureedge.net/main/whisper/models/e5b1a55b89c1367dacf97e3e19bfd829a01529dbfdeefa8caeb59b3f1b81dadb/large-v3.pt",
    "large": "https://openaipublic.azureedge.net/main/whisper/models/e5b1a55b89c1367dacf97e3e19bfd829a01529dbfdeefa8caeb59b3f1b81dadb/large-v3.pt",
    "large-v3-turbo": "https://openaipublic.azureedge.net/main/whisper/models/aff26ae408abcba5fbf8813c21e62b0941638c5f6eebfb145be0c9839262a19a/large-v3-turbo.pt",
    "turbo": "https://openaipublic.azureedge.net/main/whisper/models/aff26ae408abcba5fbf8813c21e62b0941638c5f6eebfb145be0c9839262a19a/large-v3-turbo.pt",
}

# base85+gzip-packed (n_text_layer, n_text_head) boolean masks of the
# cross-attention heads most correlated with word-level timing
# (reference whisper/__init__.py:36-51)
_ALIGNMENT_HEADS = {
    "tiny.en": b"ABzY8J1N>@0{>%R00Bk>$p{7v037`oCl~+#00",
    "tiny": b"ABzY8bu8Lr0{>%RKn9Fp%m@SkK7Kt=7ytkO",
    "base.en": b"ABzY8;40c<0{>%RzzG;p*o+Vo09|#PsxSZm00",
    "base": b"ABzY8KQ!870{>%RzyTQH3`Q^yNP!>##QT-<FaQ7m",
    "small.en": b"ABzY8>?_)10{>%RpeA61k&I|OI3I$65C{;;pbCHh0B{qLQ;+}v00",
    "small": b"ABzY8DmU6=0{>%Rpa?J`kvJ6qF(V^F86#Xh7JUGMK}P<N0000",
    "medium.en": b"ABzY8usPae0{>%R7<zz_OvQ{)4kMa0BMw6u5rT}kRKX;$NfYBv00*Hl@qhsU00",
    "medium": b"ABzY8B0Jh+0{>%R7}kK1fFL7w6%<-Pf*t^=N)Qr&0RR9",
    "large-v1": b"ABzY8r9j$a0{>%R7#4sLmoOs{s)o3~84-RPdcFk!JR<kSfC2yj",
    "large-v2": b"ABzY8zd+h!0{>%R7=D0pU<_bnWW*tkYAhobTNnu$jnkEkXqp)j;w1Tzk)UH3X%SZd&fFZ2fC2yj",
    "large-v3": b"ABzY8gWO1E0{>%R7(9S+Kn!D~%ngiGaR?*L!iJG9p-nab0JQ=-{D1-g00",
    "large": b"ABzY8gWO1E0{>%R7(9S+Kn!D~%ngiGaR?*L!iJG9p-nab0JQ=-{D1-g00",
    "large-v3-turbo": b"ABzY8j^C+e0{>%RARaKHP%t(lGR*)0g!tONPyhe`",
    "turbo": b"ABzY8j^C+e0{>%RARaKHP%t(lGR*)0g!tONPyhe`",
}


def _download(url: str, root: str, in_memory: bool) -> Union[bytes, str]:
    """Fetch a checkpoint URL into ``root`` (SHA256-verified, cached).

    Same contract as the reference's downloader (whisper/__init__.py:54-95):
    the expected digest is the second-to-last URL path component, an existing
    file with a matching digest is reused, and a post-download mismatch is an
    error.  Returns the raw bytes when ``in_memory`` else the file path.
    """
    os.makedirs(root, exist_ok=True)
    sha256 = url.split("/")[-2]
    target = os.path.join(root, os.path.basename(url))

    if os.path.exists(target) and not os.path.isfile(target):
        raise RuntimeError(f"{target} exists and is not a regular file")
    if os.path.isfile(target):
        with open(target, "rb") as f:
            data = f.read()
        if hashlib.sha256(data).hexdigest() == sha256:
            return data if in_memory else target
        warnings.warn(
            f"{target} exists, but the SHA256 checksum does not match; re-downloading the file"
        )

    from tqdm import tqdm

    with urllib.request.urlopen(url) as source, open(target, "wb") as output:
        size = int(source.info().get("Content-Length"))
        with tqdm(total=size, ncols=80, unit="iB", unit_scale=True, unit_divisor=1024) as bar:
            for chunk in iter(lambda: source.read(8192), b""):
                output.write(chunk)
                bar.update(len(chunk))

    with open(target, "rb") as f:
        data = f.read()
    if hashlib.sha256(data).hexdigest() != sha256:
        raise RuntimeError(
            "Model has been downloaded but the SHA256 checksum does not match. "
            "Please retry loading the model."
        )
    return data if in_memory else target


def available_models() -> List[str]:
    """Returns the names of available models"""
    return list(_MODELS.keys())


def load_model(
    name: str,
    device: Union[str, torch.device] = "cuda",
    download_root: Optional[str] = None,
    in_memory: bool = False,
    dtype: Optional[torch.dtype] = None,
) -> Whisper:
    """Load a Whisper ASR model onto a torch device.

    Parameters
    ----------
    name : one of ``available_models()``, or a path to a checkpoint — an
        official torch ``.pt`` file or the JAX package's converted ``.npz``
    device : where the model runs, "cuda" by default.  A CUDA device that is
        not there is an error: the model never moves to the CPU by itself.
    download_root : checkpoint cache dir (default ``$XDG_CACHE_HOME/whisper``)
    in_memory : preload checkpoint bytes into host memory
    dtype : parameter dtype; bfloat16 on CUDA and float32 on the CPU by default

    Random weights at a model's published dimensions, without a checkpoint:
    ``Whisper(dims, init_params(dims, generator, dtype, device))`` with
    ``dims = models.KNOWN_MODELS[name]`` and ``models.whisper.init_params``.
    """
    from .models.load import load_npz, load_torch_checkpoint

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"load_model(device={str(device)!r}): no CUDA device is available; "
            "pass device='cpu' to run on the CPU"
        )
    if dtype is None:
        dtype = torch.bfloat16 if device.type == "cuda" else torch.float32

    if download_root is None:
        default = os.path.join(os.path.expanduser("~"), ".cache")
        download_root = os.path.join(os.getenv("XDG_CACHE_HOME", default), "whisper")
    if name in _MODELS:
        checkpoint = _download(_MODELS[name], download_root, in_memory)
    elif os.path.isfile(name):
        checkpoint = name
        if in_memory:
            with open(name, "rb") as f:
                checkpoint = f.read()
    else:
        raise RuntimeError(f"Model {name} not found; available models = {available_models()}")
    if isinstance(checkpoint, str) and checkpoint.endswith(".npz"):
        params, dims = load_npz(checkpoint, dtype, device)
    else:
        params, dims = load_torch_checkpoint(checkpoint, dtype, device)
    model = Whisper(dims, params)
    if name in _ALIGNMENT_HEADS:
        model.set_alignment_heads(_ALIGNMENT_HEADS[name])
    return model


__all__ = [
    "DecodingOptions",
    "DecodingResult",
    "ModelDimensions",
    "Whisper",
    "available_models",
    "decode",
    "detect_language",
    "load_audio",
    "load_model",
    "log_mel_spectrogram",
    "pad_or_trim",
    "transcribe",
]
