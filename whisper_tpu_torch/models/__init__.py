from .dims import KNOWN_MODELS, ModelDimensions
from .whisper import Whisper

__all__ = ["KNOWN_MODELS", "ModelDimensions", "Whisper"]
