"""Entry point for ``python -m whisper_tpu_torch``."""

from .transcribe import cli

if __name__ == "__main__":
    cli()
