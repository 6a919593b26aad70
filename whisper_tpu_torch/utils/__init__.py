# Copied from whisper_tpu/utils/__init__.py (jax-free); keep in step with it.
"""Small host-side helpers shared across the package.

Functional parity target: reference ``whisper/utils.py:1-82`` (make_safe,
exact_div, CLI coercers, compression_ratio, format_timestamp, get_start/get_end).
Writers live in :mod:`whisper_tpu.utils.writers`.
"""

import sys
import zlib
from typing import List, Optional

_SYSTEM_ENCODING = sys.getdefaultencoding()


def make_safe(string: str) -> str:
    """Replace characters unrepresentable in the system encoding with '?'.

    Mirrors reference ``whisper/utils.py:8-21``; a no-op on UTF-8 systems.
    """
    if _SYSTEM_ENCODING == "utf-8":
        return string
    return string.encode(_SYSTEM_ENCODING, errors="replace").decode(_SYSTEM_ENCODING)


def exact_div(x: int, y: int) -> int:
    assert x % y == 0
    return x // y


def str2bool(string: str) -> bool:
    table = {"True": True, "False": False}
    if string not in table:
        raise ValueError(f"Expected one of {set(table)}, got {string}")
    return table[string]


def optional_int(string: str) -> Optional[int]:
    return None if string == "None" else int(string)


def optional_float(string: str) -> Optional[float]:
    return None if string == "None" else float(string)


def compression_ratio(text: str) -> float:
    """zlib compression ratio of the UTF-8 text; high values flag repetition.

    Used by the temperature-fallback ladder (reference ``whisper/utils.py:45-47``).
    """
    text_bytes = text.encode("utf-8")
    return len(text_bytes) / len(zlib.compress(text_bytes))


def format_timestamp(
    seconds: float, always_include_hours: bool = False, decimal_marker: str = "."
) -> str:
    """Render seconds as ``[HH:]MM:SS<marker>mmm`` (reference ``utils.py:50-68``)."""
    assert seconds >= 0, "non-negative timestamp expected"
    ms = round(seconds * 1000.0)
    hours, ms = divmod(ms, 3_600_000)
    minutes, ms = divmod(ms, 60_000)
    secs, ms = divmod(ms, 1_000)
    hours_marker = f"{hours:02d}:" if always_include_hours or hours > 0 else ""
    return f"{hours_marker}{minutes:02d}:{secs:02d}{decimal_marker}{ms:03d}"


def get_start(segments: List[dict]) -> Optional[float]:
    """First word start across segments, else first segment start (``utils.py:71-75``)."""
    return next(
        (w["start"] for s in segments for w in s["words"]),
        segments[0]["start"] if segments else None,
    )


def get_end(segments: List[dict]) -> Optional[float]:
    """Last word end across segments, else last segment end (``utils.py:78-82``)."""
    return next(
        (w["end"] for s in reversed(segments) for w in reversed(s["words"])),
        segments[-1]["end"] if segments else None,
    )
