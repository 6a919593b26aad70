"""The port's copies of whisper_tpu's jax-free files, against their
sources, so that a change to one side shows here.

The port imports nothing of whisper_tpu and reads no path under it
(tests/test_torch_decoding.py), so it keeps copies of what it needs:

- the native C++ sources: byte-equal to whisper_tpu's below the header
  that names the source;
- the assets and the spelling map ``normalizers/english.json``:
  byte-equal;
- the Python modules copied whole: equal to whisper_tpu's once the
  intended differences listed in ``EDITS`` are made (each says why);
- the host-only word-timing code, the functions that align words and place
  segments and seek on the host: each function's syntax tree equal to
  whisper_tpu's, its docstring and formatting aside.
"""

import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE, PORT = os.path.join(ROOT, "whisper_tpu"), os.path.join(ROOT, "whisper_tpu_torch")

NATIVE = ["native/audioio.cpp", "native/bpe.cpp", "native/dtw.cpp"]
BYTE_EQUAL = ["assets/gpt2.tiktoken", "assets/mel_filters.npz", "assets/multilingual.tiktoken",
              "normalizers/english.json"]


def _header(name: str) -> str:
    return f"# Copied from whisper_tpu/{name} (jax-free); keep in step with it.\n"


# file -> the (whisper_tpu's text, the port's text) replacements that make
# the source the copy
EDITS = {
    "tokenizer.py": [
        ('"""', _header("tokenizer.py") + '"""'),
        # the port's own native library and assets directory
        ("""The BPE core is native C++ (whisper_tpu/native/bpe.cpp) replacing the Rust
``tiktoken`` dependency; Unicode pre-tokenization uses the ``regex`` module
with the exact pat_str from reference ``tokenizer.py:360``.  A pure-Python
merge loop backs the native core when the toolchain is unavailable.""",
         """The BPE core is native C++ (the port's copy of whisper_tpu's
native/bpe.cpp) replacing the Rust ``tiktoken`` dependency; Unicode
pre-tokenization uses the ``regex`` module with the exact pat_str from
reference ``tokenizer.py:360``.  A pure-Python merge loop backs the native
core when the toolchain is unavailable."""),
        ("from .native import load_native", "from .native import ASSETS_DIR, load_native"),
        ('os.path.join(os.path.dirname(__file__), "assets", f"{name}.tiktoken")',
         'os.path.join(ASSETS_DIR, f"{name}.tiktoken")'),
    ],
    "utils/__init__.py": [("", _header("utils/__init__.py"))],
    "utils/writers.py": [("", _header("utils/writers.py"))],
    "models/dims.py": [("", _header("models/dims.py"))],
    "normalizers/basic.py": [("", _header("normalizers/basic.py"))],
    "normalizers/english.py": [("", _header("normalizers/english.py"))],
    # the docstrings name the copy
    "normalizers/__init__.py": [
        ('"""Text normalizers for WER evaluation (basic + English)."""',
         _header("normalizers/__init__.py") + '"""Text normalizers for WER evaluation (basic + '
         'English).\n\nenglish.json, the UK -> US spelling map, is a copy of\n'
         'whisper_tpu/normalizers/english.json."""')],
    "version.py": [('"""Package version (single source of truth for pyproject)."""',
                    '"""Package version: the port\'s copy of ``whisper_tpu/version.py``, so that\n'
                    'both packages report the same release."""')],
}

# module -> the host-only word-timing functions and classes it copies
HOST_WORD_TIMING = {
    "timing.py": ["_token_bucket", "WordTiming", "_timings_from_alignment", "merge_punctuations",
                  "add_word_timestamps"],
    "ops/dtw.py": ["_unskew_trace", "backtrace", "dtw_numpy"],
    "transcribe.py": ["_new_segment", "segment_window", "needs_fallback", "_word_anomaly_score",
                      "_is_segment_anomaly", "_first_segment_with_words",
                      "_refine_seek_with_word_timings"],
}


def _read(root: str, name: str, mode: str = "r"):
    with open(os.path.join(root, name), mode) as f:
        return f.read()


@pytest.mark.parametrize("name", NATIVE)
def test_native_sources_equal_below_their_header(name):
    port, source = _read(PORT, name, "rb"), _read(SOURCE, name, "rb")
    header = (f"// Copy of whisper_tpu/{name}, unchanged below this header, so that\n"
              "// whisper_tpu_torch builds its host library from its own tree.\n\n").encode()
    assert port.startswith(header) and port[len(header):] == source


@pytest.mark.parametrize("name", BYTE_EQUAL)
def test_assets_are_byte_equal(name):
    assert _read(PORT, name, "rb") == _read(SOURCE, name, "rb")


@pytest.mark.parametrize("name", sorted(EDITS))
def test_python_copies_equal_but_for_their_listed_edits(name):
    text = _read(SOURCE, name)
    for old, new in EDITS[name]:
        assert old in text, f"{name}: the source no longer holds {old[:60]!r}"
        text = text.replace(old, new, 1)
    assert text == _read(PORT, name)


def _definitions(root: str, name: str) -> dict:
    """Each top-level function's and class's syntax tree, without its
    docstring (ast.dump ignores formatting and comments)."""
    out = {}
    for node in ast.parse(_read(root, name)).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            body = node.body
            if body and isinstance(body[0], ast.Expr) and isinstance(body[0].value, ast.Constant) \
                    and isinstance(body[0].value.value, str):
                node.body = body[1:]
            out[node.name] = ast.dump(node)
    return out


@pytest.mark.parametrize("name", sorted(HOST_WORD_TIMING))
def test_host_word_timing_code_equals_its_source(name):
    port, source = _definitions(PORT, name), _definitions(SOURCE, name)
    for fn in HOST_WORD_TIMING[name]:
        assert fn in source and fn in port, fn
        assert port[fn] == source[fn], f"{name}: {fn} drifted from whisper_tpu's"


def test_every_copy_is_checked():
    """Every file of the port that names whisper_tpu's as its source is one
    of this module's."""
    checked = set(NATIVE) | set(BYTE_EQUAL) | set(EDITS)
    named = set()
    for folder, _, files in os.walk(PORT):
        for f in files:
            if f.endswith((".py", ".cpp")):
                rel = os.path.relpath(os.path.join(folder, f), PORT)
                head = _read(PORT, rel)[:200]
                if "Copied from whisper_tpu/" in head or "Copy of whisper_tpu/" in head \
                        or "copy of ``whisper_tpu/" in head:
                    named.add(rel)
    assert named and named <= checked, sorted(named - checked)
