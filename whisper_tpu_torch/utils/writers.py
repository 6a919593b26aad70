# Copied from whisper_tpu/utils/writers.py (jax-free); keep in step with it.
"""Transcript output writers: txt / vtt / srt / tsv / json.

Behavioral parity target: reference ``whisper/utils.py:85-318``. The subtitle
iterator reproduces the same line/word wrapping rules (max_line_width,
max_line_count, max_words_per_line, ``<u>`` word highlighting) so that CLI
outputs are drop-in compatible.
"""

import json
import os
import re
from typing import Callable, Iterator, List, Optional, TextIO, Tuple

from . import format_timestamp, get_start


class ResultWriter:
    extension: str

    def __init__(self, output_dir: str):
        self.output_dir = output_dir

    def __call__(
        self, result: dict, audio_path: str, options: Optional[dict] = None, **kwargs
    ):
        stem = os.path.splitext(os.path.basename(audio_path))[0]
        output_path = os.path.join(self.output_dir, f"{stem}.{self.extension}")
        with open(output_path, "w", encoding="utf-8") as f:
            self.write_result(result, file=f, options=options, **kwargs)

    def write_result(
        self, result: dict, file: TextIO, options: Optional[dict] = None, **kwargs
    ):
        raise NotImplementedError


class WriteTXT(ResultWriter):
    extension = "txt"

    def write_result(
        self, result: dict, file: TextIO, options: Optional[dict] = None, **kwargs
    ):
        for segment in result["segments"]:
            print(segment["text"].strip(), file=file, flush=True)


class SubtitlesWriter(ResultWriter):
    always_include_hours: bool
    decimal_marker: str

    def format_timestamp(self, seconds: float) -> str:
        return format_timestamp(
            seconds=seconds,
            always_include_hours=self.always_include_hours,
            decimal_marker=self.decimal_marker,
        )

    def iterate_result(
        self,
        result: dict,
        options: Optional[dict] = None,
        *,
        max_line_width: Optional[int] = None,
        max_line_count: Optional[int] = None,
        highlight_words: bool = False,
        max_words_per_line: Optional[int] = None,
    ) -> Iterator[Tuple[str, str, str]]:
        options = options or {}
        max_line_width = max_line_width or options.get("max_line_width")
        max_line_count = max_line_count or options.get("max_line_count")
        highlight_words = highlight_words or options.get("highlight_words", False)
        max_words_per_line = max_words_per_line or options.get("max_words_per_line")
        # segments are preserved as subtitle boundaries unless BOTH line limits
        # are given (reference whisper/utils.py:138)
        preserve_segments = max_line_count is None or max_line_width is None
        max_line_width = max_line_width or 1000
        max_words_per_line = max_words_per_line or 1000

        have_words = bool(result["segments"]) and "words" in result["segments"][0]
        if not have_words:
            for segment in result["segments"]:
                yield (
                    self.format_timestamp(segment["start"]),
                    self.format_timestamp(segment["end"]),
                    segment["text"].strip().replace("-->", "->"),
                )
            return

        for subtitle in self._iterate_subtitles(
            result,
            max_line_width=max_line_width,
            max_line_count=max_line_count,
            max_words_per_line=max_words_per_line,
            preserve_segments=preserve_segments,
        ):
            sub_start = self.format_timestamp(subtitle[0]["start"])
            sub_end = self.format_timestamp(subtitle[-1]["end"])
            sub_text = "".join(w["word"] for w in subtitle)
            if not highlight_words:
                yield sub_start, sub_end, sub_text
                continue
            # word-level karaoke: re-emit the subtitle once per word with that
            # word underlined, bridging gaps with an un-highlighted copy
            last = sub_start
            all_words = [w["word"] for w in subtitle]
            for i, this_word in enumerate(subtitle):
                start = self.format_timestamp(this_word["start"])
                end = self.format_timestamp(this_word["end"])
                if last != start:
                    yield last, start, sub_text
                yield start, end, "".join(
                    re.sub(r"^(\s*)(.*)$", r"\1<u>\2</u>", word) if j == i else word
                    for j, word in enumerate(all_words)
                )
                last = end

    @staticmethod
    def _word_stream(
        segments: List[dict], max_words_per_line: int
    ) -> Iterator[Tuple[bool, dict]]:
        """Yield ``(at_chunk_head, word_timing)`` over all segments' words.

        A "chunk" is a run of at most ``max_words_per_line`` words within one
        segment; chunk heads are where segment-preserving mode may force a
        subtitle boundary.
        """
        for segment in segments:
            words = segment["words"]
            for head in range(0, len(words), max_words_per_line):
                for offset, timing in enumerate(
                    words[head : head + max_words_per_line]
                ):
                    yield offset == 0, timing

    def _iterate_subtitles(
        self,
        result: dict,
        *,
        max_line_width: int,
        max_line_count: Optional[int],
        max_words_per_line: int,
        preserve_segments: bool,
    ) -> Iterator[List[dict]]:
        """Group word timings into subtitle cues (lists of word dicts).

        Each word either (1) glues onto the current line, (2) opens a new
        line within the cue, or (3) opens a new cue.  A new cue starts at a
        chunk head in segment-preserving mode, and — when a line-count limit
        is active — after a >3 s pause or once the cue is full.  Words that
        start a line are stripped of surrounding whitespace; continuation
        lines keep an embedded "\\n" prefix on their first word.
        """
        line_len = 0  # characters on the current line; 0 = at a line start
        line_count = 1
        cue: List[dict] = []
        prev_start: float = get_start(result["segments"]) or 0.0
        for at_chunk_head, original in self._word_stream(
            result["segments"], max_words_per_line
        ):
            word = dict(original)
            text = word["word"]
            pause = not preserve_segments and word["start"] - prev_start > 3.0
            forced_cue = at_chunk_head and bool(cue) and preserve_segments
            if line_len and line_len + len(text) <= max_line_width and not (
                pause or forced_cue
            ):
                line_len += len(text)  # (1) same line
            else:
                word["word"] = text = text.strip()
                full = max_line_count is not None and (
                    pause or line_count >= max_line_count
                )
                if forced_cue or (cue and full):
                    yield cue  # (3) new cue
                    cue = []
                    line_count = 1
                elif line_len:
                    line_count += 1  # (2) new line in this cue
                    word["word"] = "\n" + text
                line_len = len(text)
            cue.append(word)
            prev_start = word["start"]
        if cue:
            yield cue


class WriteVTT(SubtitlesWriter):
    extension = "vtt"
    always_include_hours = False
    decimal_marker = "."

    def write_result(
        self, result: dict, file: TextIO, options: Optional[dict] = None, **kwargs
    ):
        print("WEBVTT\n", file=file)
        for start, end, text in self.iterate_result(result, options, **kwargs):
            print(f"{start} --> {end}\n{text}\n", file=file, flush=True)


class WriteSRT(SubtitlesWriter):
    extension = "srt"
    always_include_hours = True
    decimal_marker = ","

    def write_result(
        self, result: dict, file: TextIO, options: Optional[dict] = None, **kwargs
    ):
        for i, (start, end, text) in enumerate(
            self.iterate_result(result, options, **kwargs), start=1
        ):
            print(f"{i}\n{start} --> {end}\n{text}\n", file=file, flush=True)


class WriteTSV(ResultWriter):
    """Integer-millisecond TSV: ``start\\tend\\ttext`` per segment.

    Integer milliseconds avoid locale-dependent decimal markers
    (reference ``whisper/utils.py:265-284``).
    """

    extension = "tsv"

    def write_result(
        self, result: dict, file: TextIO, options: Optional[dict] = None, **kwargs
    ):
        print("start", "end", "text", sep="\t", file=file)
        for segment in result["segments"]:
            print(round(1000 * segment["start"]), file=file, end="\t")
            print(round(1000 * segment["end"]), file=file, end="\t")
            print(segment["text"].strip().replace("\t", " "), file=file, flush=True)


class WriteJSON(ResultWriter):
    extension = "json"

    def write_result(
        self, result: dict, file: TextIO, options: Optional[dict] = None, **kwargs
    ):
        json.dump(result, file)


_WRITERS = {
    "txt": WriteTXT,
    "vtt": WriteVTT,
    "srt": WriteSRT,
    "tsv": WriteTSV,
    "json": WriteJSON,
}


def get_writer(
    output_format: str, output_dir: str
) -> Callable[[dict, TextIO, dict], None]:
    """Return a writer callable; ``"all"`` fans out to every format."""
    if output_format == "all":
        all_writers = [w(output_dir) for w in _WRITERS.values()]

        def write_all(
            result: dict, file: TextIO, options: Optional[dict] = None, **kwargs
        ):
            for writer in all_writers:
                writer(result, file, options, **kwargs)

        return write_all

    return _WRITERS[output_format](output_dir)
