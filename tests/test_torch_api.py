"""whisper_tpu_torch's public signatures against whisper_tpu's.

``transcribe``, ``decode``, ``load_model`` and the many-file entry points
``transcribe_batch``, ``transcribe_chunked`` and ``align``, and the serving
layer's ``BatchingTranscriber``, ``StreamingTranscriber``, ``make_server``
and ``serve`` must take the same parameters (names, kinds and defaults, in
order), ``DecodingOptions`` must have the same fields with the same
defaults, and ``cli`` and ``serve.main`` must declare the same flags with
the same defaults.  A difference fails unless it is on the allow-list below,
which names why it stands: a later slice of the port, or a deliberate
difference of the port.  Annotations are not compared: they name each
framework's own types.
"""

import argparse
import dataclasses
import importlib
import inspect

import pytest

import whisper_tpu
from whisper_tpu.decoding import DecodingOptions as JOptions

import whisper_tpu_torch
from whisper_tpu_torch.decoding import DecodingOptions as TOptions

# the modules (each package's __init__ rebinds the name to the function)
jtranscribe = importlib.import_module("whisper_tpu.transcribe")
ttranscribe = importlib.import_module("whisper_tpu_torch.transcribe")
jserve = importlib.import_module("whisper_tpu.serve")
tserve = importlib.import_module("whisper_tpu_torch.serve")

# (where, name) -> why the port differs
ALLOWED = {
    ("DecodingOptions", "fused_step"): "K2 always runs on the card; the XLA/Pallas switch has no port",
    # the port never picks a device by itself: CUDA unless told otherwise
    ("load_model", "device"): "default 'cuda' (whisper_tpu: None, JAX's default backend)",
    ("cli", "--device"): "default 'cuda' (whisper_tpu: None, JAX's default backend)",
    ("serve.main", "--device"): "the torch device, 'cuda' by default (whisper_tpu: JAX's default backend)",
    # the same parameter in both, which the port refuses for now
    ("BatchingTranscriber", "mesh"): "multi-device serving raises: ROADMAP Queue 1 item 19",
    ("make_server", "mesh"): "multi-device serving raises: ROADMAP Queue 1 item 19",
    ("serve", "mesh"): "multi-device serving raises: ROADMAP Queue 1 item 19",
    ("serve.main", "--mesh"): "multi-device serving raises: ROADMAP Queue 1 item 19",
}


def _params(fn):
    return {
        name: (p.kind, p.default)
        for name, p in inspect.signature(fn).parameters.items()
    }


def _diff(where, ref, port):
    """Names whose presence, kind or default differ, minus the allow-list."""
    names = sorted(set(ref) | set(port))
    bad = [n for n in names if ref.get(n) != port.get(n) and (where, n) not in ALLOWED]
    return bad


@pytest.mark.parametrize(
    "name", ["transcribe", "decode", "load_model", "transcribe_batch", "transcribe_chunked", "align"]
)
def test_function_signatures_match(name):
    ref, port = _params(getattr(whisper_tpu, name)), _params(getattr(whisper_tpu_torch, name))
    if name == "decode":  # the default options object is each package's own class
        ref["options"], port["options"] = ref["options"][0], port["options"][0]
    assert _diff(name, ref, port) == []
    shared = [n for n in ref if n in port]
    assert shared == [n for n in port if n in ref], "parameter order"


def test_decoding_options_fields_match():
    def fields(cls):
        return {f.name: f.default for f in dataclasses.fields(cls)}

    assert _diff("DecodingOptions", fields(JOptions), fields(TOptions)) == []


class _Parsed(Exception):
    pass


def _cli_flags(entry, monkeypatch):
    """The flags a command-line entry point declares, {option: default},
    captured at its parse_args call (which is stopped there)."""
    seen = {}

    def capture(parser, *args, **kwargs):
        seen.update(
            {a.option_strings[0] if a.option_strings else a.dest: a.default for a in parser._actions}
        )
        raise _Parsed

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    with pytest.raises(_Parsed):
        entry()
    monkeypatch.undo()
    return seen


def test_cli_signature_and_flags_match(monkeypatch):
    assert _params(jtranscribe.cli) == _params(ttranscribe.cli) == {}
    ref, port = _cli_flags(jtranscribe.cli, monkeypatch), _cli_flags(ttranscribe.cli, monkeypatch)
    assert "--word_timestamps" in port and "--beam_size" in port
    assert _diff("cli", ref, port) == []


@pytest.mark.parametrize("name", ["BatchingTranscriber", "make_server", "serve"])
def test_serving_signatures_match(name):
    ref, port = _params(getattr(jserve, name)), _params(getattr(tserve, name))
    assert _diff(name, ref, port) == []
    assert list(ref) == list(port), "parameter order"


def test_streaming_transcriber_signature_matches():
    ref = _params(whisper_tpu.StreamingTranscriber)
    port = _params(whisper_tpu_torch.StreamingTranscriber)
    assert _diff("StreamingTranscriber", ref, port) == [] and list(ref) == list(port)
    assert "StreamingTranscriber" in whisper_tpu_torch.__all__


def test_serve_main_flags_match(monkeypatch):
    assert _params(jserve.main) == _params(tserve.main)
    ref, port = _cli_flags(jserve.main, monkeypatch), _cli_flags(tserve.main, monkeypatch)
    assert "--quantize" in port and port["--device"] == "cuda"
    assert _diff("serve.main", ref, port) == []


def test_many_file_entry_points_are_model_methods():
    for name in ("transcribe_batch", "transcribe_chunked", "align"):
        assert getattr(whisper_tpu_torch.Whisper, name) is getattr(whisper_tpu_torch, name)
        assert name in whisper_tpu_torch.__all__


def test_transcribe_takes_the_word_timing_parameters():
    params = inspect.signature(whisper_tpu_torch.transcribe).parameters
    for name in ("prepend_punctuations", "append_punctuations", "hallucination_silence_threshold"):
        assert params[name].kind is inspect.Parameter.KEYWORD_ONLY


def test_all_matches_whisper_tpu():
    port = set(whisper_tpu_torch.__all__)
    assert port == set(whisper_tpu.__all__)
    for name in port:
        assert hasattr(whisper_tpu_torch, name), name


def test_version_matches_whisper_tpu():
    from whisper_tpu_torch.version import __version__

    assert whisper_tpu_torch.__version__ == __version__ == whisper_tpu.__version__
    assert isinstance(__version__, str) and __version__.count(".") == 2
