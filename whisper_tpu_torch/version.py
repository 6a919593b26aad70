"""Package version: the port's copy of ``whisper_tpu/version.py``, so that
both packages report the same release."""

__version__ = "0.1.0"
