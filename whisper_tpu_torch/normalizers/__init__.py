# Copied from whisper_tpu/normalizers/__init__.py (jax-free); keep in step with it.
"""Text normalizers for WER evaluation (basic + English).

english.json, the UK -> US spelling map, is a copy of
whisper_tpu/normalizers/english.json."""

from .basic import BasicTextNormalizer
from .english import EnglishTextNormalizer

__all__ = ["BasicTextNormalizer", "EnglishTextNormalizer"]
