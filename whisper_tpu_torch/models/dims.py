# Copied from whisper_tpu/models/dims.py (jax-free); keep in step with it.
"""Model hyperparameter schema (reference whisper/model.py:25-36).

The field names and meanings are part of the checkpoint contract: every
official ``.pt`` checkpoint carries exactly this dict under ``"dims"``.
"""

from dataclasses import dataclass


@dataclass(frozen=True)
class ModelDimensions:
    n_mels: int
    n_audio_ctx: int
    n_audio_state: int
    n_audio_head: int
    n_audio_layer: int
    n_vocab: int
    n_text_ctx: int
    n_text_state: int
    n_text_head: int
    n_text_layer: int


# dims of the official model family (README.md table; turbo has 4 decoder
# layers per the large-v3-turbo release).  Used for random init and tests;
# real weights come from checkpoint conversion.
KNOWN_MODELS = {
    "tiny.en": ModelDimensions(80, 1500, 384, 6, 4, 51864, 448, 384, 6, 4),
    "tiny": ModelDimensions(80, 1500, 384, 6, 4, 51865, 448, 384, 6, 4),
    "base.en": ModelDimensions(80, 1500, 512, 8, 6, 51864, 448, 512, 8, 6),
    "base": ModelDimensions(80, 1500, 512, 8, 6, 51865, 448, 512, 8, 6),
    "small.en": ModelDimensions(80, 1500, 768, 12, 12, 51864, 448, 768, 12, 12),
    "small": ModelDimensions(80, 1500, 768, 12, 12, 51865, 448, 768, 12, 12),
    "medium.en": ModelDimensions(80, 1500, 1024, 16, 24, 51864, 448, 1024, 16, 24),
    "medium": ModelDimensions(80, 1500, 1024, 16, 24, 51865, 448, 1024, 16, 24),
    "large-v1": ModelDimensions(80, 1500, 1280, 20, 32, 51865, 448, 1280, 20, 32),
    "large-v2": ModelDimensions(80, 1500, 1280, 20, 32, 51865, 448, 1280, 20, 32),
    "large-v3": ModelDimensions(128, 1500, 1280, 20, 32, 51866, 448, 1280, 20, 32),
    "large": ModelDimensions(128, 1500, 1280, 20, 32, 51866, 448, 1280, 20, 32),
    "large-v3-turbo": ModelDimensions(128, 1500, 1280, 20, 32, 51866, 448, 1280, 20, 4),
    "turbo": ModelDimensions(128, 1500, 1280, 20, 32, 51866, 448, 1280, 20, 4),
}
